"""The port's LM training path (reduced qwen1.5-0.5b: 2 layers, d 256, 4
heads of 64, vocab 512) against the JAX package's: the reference's
``make_train_step(comm='xla', mesh=None)`` and the port's, step by step
from the reference's own states and on its own ``token_batch`` batches
(``tests/torch_reference.py lm_train_steps``, XLA rounding at every bf16
operation), with remat off and on and with ``grad_accum`` 2. Also the
port's token stream, remat against no remat, the refusal to train through
the flash kernel, the eval step and the CLI on the CPU.

Both packages take the gradients of the bf16 compute copy; what differs
is where the two libraries' bf16 matmuls round (one element in 10^4
after the first layer, ``test_torch_lm.py``), which moves the bf16
gradients by an ulp here and there. Measured here, over both steps of the
three cases: loss within 5.1e-6 relative; each tensor's update (= the new
momentum, from zero) within 0.024 relative L2 of the reference's (median
0.010), and the new params within 4.6e-5 of each tensor's max. The bounds
are 2e-5, 0.1 (median 0.04) and 2e-4, about four times the measured."""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch_reference as R

from repro.configs import get_config as jget_config
from repro.data.synthetic import token_batch as jtoken_batch
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.configs.base import CommConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.core import lars, pinit
from repro_torch.core.label_smoothing import IGNORE
from repro_torch.core.precision import cast_to_compute
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.data.synthetic import make_batch_fn, token_batch
from repro_torch.launch.mesh import Axis, Mesh
from repro_torch.models.registry import build_model
from repro_torch.train.loop import make_params_reader
from repro_torch.train.state import init_state, sharded_state_kwargs
from repro_torch.train.step import _lm_loss, make_eval_step, make_loss_fn, \
    make_train_step
from repro_torch.tree import tree_flatten, tree_unflatten

pytestmark = pytest.mark.tier1

LOSS_RTOL = 2e-5
UPDATE_WORST, UPDATE_MEDIAN = 0.1, 0.04
PARAM_TOL = 2e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return R.run("lm_train_steps",
                 str(tmp_path_factory.mktemp("ref") / "lmt.npz"))


@pytest.fixture(scope="module")
def base():
    return get_config(R.LM_ARCH).reduced()


def _sched():
    return make_schedule(ScheduleConfig(**R.LR))


def _relnorm(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("k", range(R.LM_TRAIN_STEPS))
@pytest.mark.parametrize("case", list(R.LM_TRAIN_CASES))
def test_step_matches_reference(ref, base, case, k):
    remat, accum = R.LM_TRAIN_CASES[case]
    cfg = dataclasses.replace(base, remat=remat)
    r = ref[case][f"s{k}"]
    step = make_train_step(build_model(cfg), lars.OptConfig(kind="lars"),
                           _sched(), comm="xla", grad_accum=accum)
    state_in = weights.lm_state_from_jax(types.SimpleNamespace(**r["in"]),
                                         cfg, "cpu")
    batch = {n: torch.from_numpy(v) for n, v in r["batch"].items()}
    state, metrics = step(state_in, batch)
    assert state.step == int(r["out"]["step"]) == k + 1
    assert state.bn_state is None
    assert float(metrics["lr"]) == float(r["metrics"]["lr"])
    assert float(metrics["aux"]) == float(r["metrics"]["aux"]) == 0.0
    assert float(metrics["acc"]) == pytest.approx(float(r["metrics"]["acc"]),
                                                  abs=1e-6)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(r["metrics"]["loss"]), rtol=LOSS_RTOL)
    p_in = dict(tree_flatten(weights.to_numpy(state_in.params)))
    got_p = dict(tree_flatten(weights.to_numpy(state.params)))
    got_m = dict(tree_flatten(weights.to_numpy(state.mom)))
    want_p = dict(tree_flatten(r["out"]["params"]))
    want_m = dict(tree_flatten(r["out"]["mom"]))
    assert set(got_p) == set(want_p) and set(got_m) == set(want_m)
    upd = [_relnorm(got_p[p] - p_in[p], want_p[p] - p_in[p]) for p in want_p]
    mom = [_relnorm(got_m[p], want_m[p]) for p in want_m]
    assert max(upd) < UPDATE_WORST and np.median(upd) < UPDATE_MEDIAN
    assert max(mom) < UPDATE_WORST and np.median(mom) < UPDATE_MEDIAN
    for p in want_p:
        d = np.abs(got_p[p] - want_p[p]).max() / np.abs(want_p[p]).max()
        assert d < PARAM_TOL, (p, d)


def _grads(cfg, params, batch):
    flat = tree_flatten(cast_to_compute(params))
    leaves = [x.detach().requires_grad_() for _, x in flat]
    total, _ = make_loss_fn(build_model(cfg))(
        tree_unflatten([p for p, _ in flat], leaves), batch)
    return total, torch.autograd.grad(total, leaves)


def test_remat_gives_the_gradients_of_no_remat(base):
    """Each layer recomputed in the backward (``torch.utils.checkpoint``)
    gives the same loss and gradients as keeping its activations, bit for
    bit, every stacked leaf included."""
    params = pinit.materialize(build_model(base).param_pd, 0, "cpu")
    batch = token_batch(base, batch=2, seq=32, step=0, device="cpu")
    t0, g0 = _grads(dataclasses.replace(base, remat=False), params, batch)
    t1, g1 = _grads(dataclasses.replace(base, remat=True), params, batch)
    assert torch.equal(t0, t1)
    assert len(g0) == len(g1) and all(g.abs().sum() > 0 for g in g0)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_training_through_the_flash_kernel_is_refused(base):
    """Neither the reference nor the port can differentiate the flash
    kernel: a train step with ``flash_attention=True`` raises a clear
    NotImplementedError on every device (here the CPU, whose plain version
    autograd could differentiate). Forward only, the flag still works."""
    model = build_model(dataclasses.replace(base, flash_attention=True))
    state = init_state(model, 0, device="cpu")
    batch = token_batch(base, batch=2, seq=32, step=0, device="cpu")
    step = make_train_step(model, lars.OptConfig(), _sched())
    with pytest.raises(NotImplementedError, match="K5 backward"):
        step(state, batch)
    ev = make_eval_step(model)(state.params, batch)
    assert np.isfinite(float(ev["loss"]))


def test_eval_step_is_the_unsmoothed_lm_loss(base):
    model = build_model(base)
    params = pinit.materialize(model.param_pd, 1, "cpu")
    batch = token_batch(base, batch=2, seq=32, step=5, device="cpu")
    ev = make_eval_step(model)(params, batch)
    (logits, _), _ = model.forward_train(params, batch)
    want, _ = _lm_loss(logits, batch["labels"], smoothing=0.0)
    assert float(ev["loss"]) == float(want) and float(ev["acc"]) == 0.0


def test_explicit_lm_step_names_roadmap(base):
    """The explicit data-parallel LM step runs (it raised before, naming
    the ROADMAP item): psum replicated and ring zero1 on a one-rank mesh,
    from one state and batch, give the same loss and finite params
    (``test_torch_lm_dp.py`` holds every rung against the reference)."""
    model = build_model(dataclasses.replace(base, remat=True))
    mesh = Mesh((Axis("data", 1, 0, (0,), None),), torch.device("cpu"))
    batch = token_batch(base, batch=2, seq=32, step=0, device="cpu")
    losses = []
    for comm in ("psum", CommConfig(strategy="ring", sharding="zero1",
                                    bucket_mb=0.1, update_kernel=True)):
        step = make_train_step(model, lars.OptConfig(), _sched(), mesh=mesh,
                               comm=comm)
        state = init_state(model, 0, device="cpu",
                           **sharded_state_kwargs(step))
        state, metrics = step(state, batch)
        assert state.step == 1
        losses.append(float(metrics["loss"]))
        assert all(bool(torch.isfinite(x).all()) for _, x in
                   tree_flatten(make_params_reader(step)(state)))
    assert losses[0] == losses[1] and np.isfinite(losses[0])


def _lcg_breaks(tokens, V):
    """Share of positions t >= 1 whose token is not (5·prev + 7) mod V."""
    t = np.asarray(tokens, np.int64)
    return float(((5 * t[:, :-1] + 7) % V != t[:, 1:]).mean())


@pytest.mark.parametrize("kind", ["lcg", "uniform"])
def test_token_batch_structure(base, kind):
    """Labels are the tokens shifted by one with IGNORE last; every token in
    [0, V); int32 on the device asked for; a pure function of (seed, step).
    lcg: 5% of positions are noise, so about 1 - 0.95² of the transitions
    break the recurrence, as in the reference's stream; uniform: nearly
    all do."""
    B, S, V = 64, 256, base.vocab_size
    b = token_batch(base, batch=B, seq=S, step=3, seed=2, kind=kind,
                    device="cpu")
    tok, lab = b["tokens"], b["labels"]
    assert tok.shape == lab.shape == (B, S)
    assert tok.dtype == lab.dtype == torch.int32
    assert int(tok.min()) >= 0 and int(tok.max()) < V
    assert torch.equal(lab[:, :-1], tok[:, 1:])
    assert bool((lab[:, -1] == IGNORE).all())
    again = token_batch(base, batch=B, seq=S, step=3, seed=2, kind=kind,
                        device="cpu")
    assert torch.equal(again["tokens"], tok)
    other = token_batch(base, batch=B, seq=S, step=4, seed=2, kind=kind,
                        device="cpu")
    assert not torch.equal(other["tokens"], tok)
    # the stream continues into the last label's position
    full = np.concatenate([tok.numpy(), lab.numpy()[:, -2:-1]], 1)
    got = _lcg_breaks(full, V)
    want = _lcg_breaks(jtoken_batch(jget_config(R.LM_ARCH).reduced(),
                                    batch=B, seq=S, step=3, seed=2,
                                    kind=kind)["tokens"], V)
    if kind == "lcg":
        assert 0.07 < got < 0.125 and 0.07 < want < 0.125
    else:
        assert got > 0.99 and want > 0.99


def test_batch_fn_gives_each_rank_its_rows(base):
    shape = InputShape("t", "train", 16, 8)
    full = make_batch_fn(base, shape, seed=1, device="cpu")(2)
    for r in range(2):
        mesh = Mesh((Axis("data", 2, r, (0, 1), None),), torch.device("cpu"))
        part = make_batch_fn(base, shape, seed=1, device="cpu",
                             mesh=mesh)(2)
        for k in ("tokens", "labels"):
            assert torch.equal(part[k], full[k][4 * r:4 * (r + 1)])


def test_lm_cli_on_cpu_reaches_run_stop():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         R.LM_ARCH, "--reduced", "--device", "cpu", "--seq", "32",
         "--batch", "4", "--steps", "2", "--eval-every", "2", "--data",
         "uniform"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr
    assert "eval_accuracy" in out.stdout
    assert "(repro_torch/train/loop.py) run_stop:" in out.stdout
