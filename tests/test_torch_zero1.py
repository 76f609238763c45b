"""The port's ZeRO-1 explicit data-parallel step against the JAX
package's, on one rank, step by step: reduced ResNet-50, LARS poly2, ring
schedule, f32 wire, 0.25 MB buckets (so tensors split across buckets),
with overlap on and off and the fused update on and off. Each of two
steps starts from the reference's own state (a bf16 ResNet at this size
is chaotic, ``tests/torch_reference.py``), and the bounds are measured on
this comparison. The reference runs its two corner configurations
(``torch_reference.ZERO1_CASES``); each port configuration is held
against the corner with the same ``overlap``."""
import types

import numpy as np
import pytest
import torch
import torch_reference

from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.configs.base import CommConfig
from repro_torch.core import lars
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.registry import build_model
from repro_torch.train.state import full_params_from_shards
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_flatten

pytestmark = pytest.mark.tier1


@pytest.fixture(scope="module")
def ref_steps(tmp_path_factory):
    return torch_reference.run(
        "zero1_steps", str(tmp_path_factory.mktemp("ref") / "z.npz"))


@pytest.fixture(scope="module")
def mesh():
    m = make_local_mesh(device="cpu")
    yield m
    m.destroy()


def _bufs(tree):
    return [tree[str(b)] for b in range(len(tree))]


def _relnorm(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("update_kernel", [False, True])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("k", range(torch_reference.ZERO1_STEPS))
def test_zero1_step_matches_reference(ref_steps, mesh, overlap,
                                      update_kernel, k):
    case = next(c for c in torch_reference.ZERO1_CASES
                if c[0] == int(overlap))
    ref = ref_steps[f"o{case[0]}u{case[1]}"][f"s{k}"]
    cfg = get_config("resnet50").reduced()
    step = make_train_step(
        build_model(cfg), lars.OptConfig(kind="lars"),
        make_schedule(ScheduleConfig(**torch_reference.LR)), mesh=mesh,
        comm=CommConfig(overlap=overlap, update_kernel=update_kernel,
                        **torch_reference.ZERO1_COMM))
    assert step.n_shards == 1 and step.gather_ahead
    plan = step.bucket_plan
    assert any(s.elem_offset for s in plan.slots)      # split tensors
    to_state = lambda s: weights.state_from_jax(types.SimpleNamespace(
        step=s["step"], params=s["params"], bn_state=s["bn_state"],
        mom=_bufs(s["mom"]), shards=_bufs(s["shards"])), cfg, "cpu")
    state_in = to_state(ref["in"])
    masters_in = full_params_from_shards(state_in.shards, plan)
    state, metrics = step(state_in, {
        "images": torch.from_numpy(ref["batch"]["images"]),
        "labels": torch.from_numpy(ref["batch"]["labels"])})
    want = to_state(ref["out"])
    assert state.step == want.step == k + 1
    assert float(metrics["lr"]) == float(ref["metrics"]["lr"])
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(ref["metrics"]["loss"]), rtol=3e-3)
    assert abs(float(metrics["acc"]) - float(ref["metrics"]["acc"])) \
        <= 1 / torch_reference.BATCH + 1e-6
    # gather-ahead: the forward copy is the f32-wire gather of the input
    # masters, bit for bit, in both packages
    for (p, g), (_, w), (_, x) in zip(
            tree_flatten(weights.to_numpy(state.params)),
            tree_flatten(weights.to_numpy(want.params)),
            tree_flatten(weights.to_numpy(masters_in))):
        np.testing.assert_array_equal(g, x, err_msg=p)
        np.testing.assert_array_equal(w, x, err_msg=p)
    p_in = dict(tree_flatten(weights.to_numpy(masters_in)))
    tree = lambda bufs: dict(tree_flatten(weights.to_numpy(
        full_params_from_shards(bufs, plan))))
    got_p, want_p = tree(state.shards), tree(want.shards)
    got_m, want_m = tree(state.mom), tree(want.mom)
    upd = {p: _relnorm(got_p[p] - p_in[p], want_p[p] - p_in[p])
           for p in want_p}
    mom = {p: _relnorm(got_m[p], want_m[p]) for p in want_m}
    par = {p: _relnorm(got_p[p], want_p[p]) for p in want_p}
    bn = {p: np.abs(g - w).max() / np.abs(w).max()
          for (p, g), (_, w) in zip(
              tree_flatten(weights.to_numpy(state.bn_state)),
              tree_flatten(weights.to_numpy(want.bn_state)))}
    # Bounds measured on this comparison (all four port configurations
    # give the same numbers), about twice the worst step or more; they are
    # the replicated step's (tests/test_torch_train.py): the differences
    # come from the bf16 forward and backward, not from the sharded
    # update, which test_torch_shards.py holds to 1e-6 alone. Loss:
    # relative 0, 7.7e-4. BN statistics: 6.5e-7, 5.7e-3 of each tensor's
    # max. Update (= momentum) relative L2 per tensor: worst 0.147, 0.228;
    # median 0.005, 0.119. Params: worst 0.147, 0.116.
    for errs, worst, median in ((upd, 0.5, 0.25), (mom, 0.5, 0.25)):
        assert max(errs.values()) <= worst, max(errs.items(),
                                                key=lambda t: t[1])
        assert np.median(list(errs.values())) <= median
    assert max(par.values()) <= 0.3
    assert max(bn.values()) <= 0.015, max(bn.items(), key=lambda t: t[1])
