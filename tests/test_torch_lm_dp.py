"""The port's explicit data-parallel LM step against the JAX package's:
reduced qwen1.5-0.5b (2 layers, d 256, 4 heads of 64, vocab 512) at
0.1 MB buckets, where every stacked weight and the embedding split into
spans across buckets, under psum and ring (replicated), ring zero1, zero2
and zero3 (``gather='per_group'``), one rank, step by step for two steps
from the reference's own states (``tests/torch_reference.py
lm_dp_steps``: the reference's explicit step under the shard_map shim, on
a (1, 1) Auto-axis mesh, XLA rounding at every bf16 operation). The
tolerances are ``test_torch_lm_train.py``'s: what differs is where the two
libraries' bf16 matmuls round, not the schedule or the rung.

Also: the split-span repair of ``core/ddp.py`` (one f32 buffer a split
leaf a backward instead of a copy of the whole leaf a span) leaves the
overlapped all-reduce's gradients bit-equal to the per-span copies and to
the post-backward all-reduce; and (``tier2``) the LM's ring zero1 step on
two gloo ranks equals the one-rank psum step on the same global batch."""
import types

import numpy as np
import pytest
import torch
import torch_ranks
import torch_reference as R

from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.configs.base import CommConfig
from repro_torch.core import bucketing, ddp, lars, pinit
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.data.synthetic import token_batch
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.registry import build_model
from repro_torch.train.loop import make_params_reader
from repro_torch.train.state import full_params_from_shards
from repro_torch.train.step import make_loss_fn, make_train_step
from repro_torch.tree import tree_flatten, tree_unflatten

pytestmark = pytest.mark.tier1

#: test_torch_lm_train.py's bounds (measured there: loss 5.1e-6, update
#: 0.024 worst and 0.010 median, params 4.6e-5)
LOSS_RTOL = 2e-5
UPDATE_WORST, UPDATE_MEDIAN = 0.1, 0.04
PARAM_TOL = 2e-4


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return R.run("lm_dp_steps", str(tmp_path_factory.mktemp("ref") /
                                    "lmdp.npz"))


@pytest.fixture(scope="module")
def base():
    return get_config(R.LM_ARCH).reduced()


@pytest.fixture(scope="module")
def mesh():
    m = make_local_mesh(device="cpu")
    yield m
    m.destroy()


def _step(base, mesh, case):
    strategy, sharding, gather = R.LM_DP_CASES[case]
    return make_train_step(
        build_model(base), lars.OptConfig(kind="lars"),
        make_schedule(ScheduleConfig(**R.LR)), mesh=mesh,
        comm=CommConfig(strategy=strategy, sharding=sharding, gather=gather,
                        bucket_mb=R.LM_DP_BUCKET_MB))


def _bufs(tree):
    return None if tree is None else [tree[str(b)]
                                      for b in range(len(tree))]


def _relnorm(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_every_stacked_leaf_splits(base):
    """At the test's bucket size each stacked weight kind and the
    embedding span several buckets, as the full-width 4 MB plan splits
    them (224 buckets, 222 split spans)."""
    model = build_model(base)
    plan = bucketing.make_plan(model.param_pd, bucket_mb=R.LM_DP_BUCKET_MB)
    split = {t[0].path for t in plan.tensor_slots if len(t) > 1}
    want = {p for p, pd in tree_flatten(model.param_pd)
            if len(pd.shape) == 3 or p == "embed"}
    assert split == want
    full = bucketing.make_plan(
        build_model(get_config(R.LM_ARCH)).param_pd, bucket_mb=4.0)
    assert (full.n_buckets, full.n_slots) == (224, 228)
    assert sum(len(t) for t in full.tensor_slots if len(t) > 1) == 222


@pytest.mark.parametrize("k", range(R.LM_TRAIN_STEPS))
@pytest.mark.parametrize("case", list(R.LM_DP_CASES))
def test_lm_step_matches_reference(ref, base, mesh, case, k):
    _, sharding, _ = R.LM_DP_CASES[case]
    r = ref[case][f"s{k}"]
    step = _step(base, mesh, case)
    assert step.sharding == sharding and step.n_shards == 1
    plan = step.bucket_plan
    to_state = lambda s: weights.lm_state_from_jax(types.SimpleNamespace(
        step=s["step"], params=s.get("params"),
        mom=s["mom"] if sharding == "replicated" else _bufs(s["mom"]),
        shards=_bufs(s.get("shards"))), base, "cpu")
    state_in = to_state(r["in"])
    read = make_params_reader(step)
    p_in = dict(tree_flatten(weights.to_numpy(read(state_in))))
    batch = {n: torch.from_numpy(v) for n, v in r["batch"].items()}
    state, metrics = step(state_in, batch)
    want = to_state(r["out"])
    assert state.step == want.step == k + 1
    assert (state.params is None) == (want.params is None)
    assert (state.shards is None) == (want.shards is None)
    assert float(metrics["lr"]) == float(r["metrics"]["lr"])
    assert float(metrics["aux"]) == float(r["metrics"]["aux"]) == 0.0
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(r["metrics"]["loss"]), rtol=LOSS_RTOL)
    tree = lambda t: dict(tree_flatten(weights.to_numpy(t)))
    got_p, want_p = tree(read(state)), tree(read(want))
    mom = (lambda s: s.mom) if sharding == "replicated" else \
        (lambda s: full_params_from_shards(s.mom, plan))
    got_m, want_m = tree(mom(state)), tree(mom(want))
    assert set(got_p) == set(want_p) == set(p_in)
    upd = [_relnorm(got_p[p] - p_in[p], want_p[p] - p_in[p]) for p in want_p]
    mo = [_relnorm(got_m[p], want_m[p]) for p in want_m]
    assert max(upd) < UPDATE_WORST and np.median(upd) < UPDATE_MEDIAN
    assert max(mo) < UPDATE_WORST and np.median(mo) < UPDATE_MEDIAN
    for p in want_p:
        d = np.abs(got_p[p] - want_p[p]).max() / np.abs(want_p[p]).max()
        assert d < PARAM_TOL, (p, d)


def _per_span_copies(owned, slot, g, reduced, final):
    """The split-span cotangent before the repair: the whole leaf copied
    for every span."""
    flat = g.float().reshape(-1).clone()
    flat[slot.elem_offset:slot.elem_offset + slot.size] = reduced
    return flat.view(g.shape)


@pytest.mark.parametrize("strategy", ["psum", "ring"])
def test_split_span_repair_is_bit_equal(base, mesh, monkeypatch, strategy):
    """The overlapped all-reduce's reduced gradients at 0.1 MB buckets:
    with one f32 buffer a split leaf, bit-equal to the per-span copies
    they replace and to the post-backward all-reduce; each split leaf's
    spans all write into one buffer."""
    model = build_model(base)
    params = pinit.materialize(model.param_pd, 0, "cpu")
    batch = token_batch(base, batch=2, seq=32, step=0, device="cpu")
    plan = bucketing.make_plan(model.param_pd, bucket_mb=R.LM_DP_BUCKET_MB)
    loss = make_loss_fn(model)
    flat = tree_flatten(params)
    paths = [p for p, _ in flat]
    kw = dict(strategy=strategy, axes=mesh.axes)

    def overlapped():
        leaves = [x.detach().requires_grad_() for _, x in flat]
        p = ddp.wrap_params_for_overlap(tree_unflatten(paths, leaves), plan,
                                        **kw)
        return torch.autograd.grad(loss(p, batch)[0], leaves)

    buffers = {}
    repaired = ddp._split_span_out

    def recording(owned, slot, g, reduced, final):
        out = repaired(owned, slot, g, reduced, final)
        buffers.setdefault(slot.path, set()).add(out.data_ptr())
        return out

    monkeypatch.setattr(ddp, "_split_span_out", recording)
    got = overlapped()
    monkeypatch.setattr(ddp, "_split_span_out", _per_span_copies)
    before = overlapped()
    monkeypatch.setattr(ddp, "_split_span_out", repaired)
    leaves = [x.detach().requires_grad_() for _, x in flat]
    raw = torch.autograd.grad(
        loss(tree_unflatten(paths, leaves), batch)[0], leaves)
    post = ddp.allreduce_grads(tree_unflatten(paths, raw), plan=plan, **kw)
    split = {t[0].path for t in plan.tensor_slots if len(t) > 1}
    assert set(buffers) == split and all(len(v) == 1
                                         for v in buffers.values())
    for (path, a), b, (_, c) in zip(flat, before, tree_flatten(post)):
        g = got[paths.index(path)]
        assert g.dtype == torch.float32
        assert torch.equal(g, b) and torch.equal(g, c), path


@pytest.mark.tier2
def test_lm_zero1_on_two_ranks_equals_the_one_rank_psum_step(tmp_path):
    """The LM's ring zero1 step (K3 and K2 flags on: their plain versions
    on the CPU) on two gloo ranks, each on its half of the global batch,
    against the one-rank psum step on the whole batch, for two steps, f32
    wire. The LM has no batch statistics and every rank's rows hold the
    same number of labels, so the step's math does not depend on the rank
    count; what differs is rounding: each rank's weight gradients come out
    of the bf16 backward rounded to bf16 over half the rows, where one
    rank rounds the sum over all of them. Measured: masters within 6.4e-3
    of each tensor's largest update (3.6e-3 of its max), the mean loss
    within 3.1e-5 relative; bounds 2.5e-2 and 1.2e-4, about four times
    those. Both ranks read the same masters, bit for bit."""
    ranks = torch_ranks.launch("lm_zero1", 2, str(tmp_path))
    for r in ranks:
        assert float(r["masters_of_update"]) <= 2.5e-2
        assert float(r["loss_rel"]) <= 1.2e-4
    assert np.array_equal(ranks[0]["masters_sha"], ranks[1]["masters_sha"])
