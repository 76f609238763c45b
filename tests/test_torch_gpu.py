"""The port's CUDA kernels on the card against their plain versions.

Marked ``gpu``: each test decides inside itself whether there is a card and
skips without one, so every pytest worker collects the same tests. On a
machine with a card (no jax needed, hence --noconftest):
  PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import bucketing, lars, pinit
from repro_torch.core.bucketing import CHUNK
from repro_torch.kernels import batched_norm, ops, ref
from repro_torch.launch.mesh import Axis
from repro_torch.models import resnet
from repro_torch.tree import tree_flatten

pytestmark = [pytest.mark.tier1, pytest.mark.gpu]


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _full_width_plan():
    return bucketing.make_plan(resnet.resnet_pd(get_config("resnet50"))[0])


@pytest.mark.parametrize("case", ["1x1", "4x2", "16x5", "7x7", "32x3",
                                  "ragged", "main_path"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_sumsq_kernel_matches_plain(case, dtype):
    dev = _card()
    rng = np.random.default_rng(0)
    if case == "main_path":           # ResNet-50's plan: 25,021 x 161
        plan = _full_width_plan()
        seg, n_tensors = bucketing.segment_ids(plan), plan.n_tensors
    elif case == "ragged":            # empty segments, long runs
        seg = np.sort(rng.choice([0, 2, 3, 9], 3000)).astype(np.int32)
        n_tensors = 11
    else:
        n_chunks, n_tensors = map(int, case.split("x"))
        seg = np.sort(np.arange(n_chunks) % n_tensors).astype(np.int32)
    x = torch.from_numpy(rng.standard_normal(seg.size * CHUNK)
                         .astype(np.float32)).to(dev, dtype)
    seg_t = torch.from_numpy(seg).to(dev)
    before = batched_norm.batched_sumsq.launches
    got = ops.batched_sumsq(x, seg_t, n_tensors)
    torch.cuda.synchronize()
    assert batched_norm.batched_sumsq.launches == before + 1
    want = ref.batched_sumsq(x, seg_t, n_tensors)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=0)
    # deterministic: no atomics, fixed summation order
    assert torch.equal(ops.batched_sumsq(x, seg_t, n_tensors), got)


def test_batched_sumsq_kernel_rejects_bad_inputs():
    dev = _card()
    seg = torch.zeros(2, dtype=torch.int32, device=dev)
    x = torch.zeros(2 * CHUNK, device=dev)
    with pytest.raises(TypeError):
        batched_norm.batched_sumsq(x.half(), seg, 1)
    with pytest.raises(TypeError):
        batched_norm.batched_sumsq(x, seg.long(), 1)
    with pytest.raises(ValueError):
        batched_norm.batched_sumsq(x[:CHUNK], seg, 1)
    with pytest.raises(ValueError):
        batched_norm.batched_sumsq(torch.zeros(2 * CHUNK + 1, device=dev)[1:],
                                   seg, 1)


def test_tree_norms_on_card_match_per_tensor_norms():
    dev = _card()
    params = pinit.materialize(resnet.resnet_pd(get_config("resnet50"))[0],
                               0, dev)
    got = dict(tree_flatten(ops.tree_norms(params)))
    want = dict(tree_flatten(lars.tensor_norms(params)))
    for path in want:
        torch.testing.assert_close(got[path], want[path], rtol=1e-5, atol=0)


# ---------------------------------------------------------------- K2

#: a one-rank shard axis without a process group: the sums over ranks are
#: the local sums
_ONE_RANK = Axis("data", 1, 0, (0,), None)


def _shard_case(plan, n_shards, k, dev, seed=0):
    """Bucket shards of rank-``k`` at ``plan``'s shapes: p, g, m per
    bucket, the shard segment maps, and trust ratios from K1."""
    rng = np.random.default_rng(seed)
    sizes = bucketing.shard_sizes(plan, n_shards)
    draw = lambda s: [torch.from_numpy(
        (s * rng.standard_normal(c)).astype(np.float32)).to(dev)
        for c in sizes]
    p, g, m = draw(1.0), draw(0.01), draw(0.001)
    segs = [torch.from_numpy(x[k].copy()).to(dev)
            for x in bucketing.shard_segment_ids(plan, n_shards)]
    trust = lars.shard_trust_ratios(p, g, segs, plan, lars.OptConfig(),
                                    shard_axis=_ONE_RANK)
    return p, g, m, segs, trust


@pytest.mark.parametrize("case", ["main_path", "ragged"])
def test_lars_update_kernel_matches_plain(case):
    """Every bucket shard of the full-width 4 MB plan (the main path), and
    a 0.25 MB plan with split tensors sharded 3 ways (padding chunks)."""
    from repro_torch.kernels import lars_update
    dev = _card()
    if case == "main_path":
        plan, n, ks = _full_width_plan(), 1, [0]
    else:
        plan = bucketing.make_plan(
            resnet.resnet_pd(get_config("resnet50"))[0], bucket_mb=0.25)
        assert any(s.elem_offset for s in plan.slots)
        n, ks = 3, [0, 1, 2]
    for k in ks:
        p, g, m, segs, trust = _shard_case(plan, n, k, dev, seed=k)
        lr = torch.tensor(0.37, dtype=torch.float32, device=dev)
        for b in range(plan.n_buckets):
            kw = dict(lr=lr, momentum=0.9, wd=5e-5)
            before = lars_update.lars_packed_update.launches
            got = ops.lars_packed_update(p[b], g[b], m[b], trust, segs[b],
                                         **kw)
            assert lars_update.lars_packed_update.launches == before + 1
            want = ref.lars_packed_update(p[b], g[b], m[b], trust, segs[b],
                                          **kw)
            for x, y in zip(got, want):
                torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
            again = ops.lars_packed_update(p[b], g[b], m[b], trust,
                                           segs[b], **kw)
            assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_lars_update_kernel_in_place():
    from repro_torch.kernels import lars_update
    dev = _card()
    plan = _full_width_plan()
    p, g, m, segs, trust = _shard_case(plan, 1, 0, dev)
    kw = dict(lr=0.5, momentum=0.9, wd=5e-5)
    want = lars_update.lars_packed_update(p[3], g[3], m[3], trust, segs[3],
                                          **kw)
    p_in, m_in = p[3].clone(), m[3].clone()
    got = lars_update.lars_packed_update(p_in, g[3], m_in, trust, segs[3],
                                         inplace=True, **kw)
    assert got[0] is p_in and got[1] is m_in
    assert torch.equal(p_in, want[0]) and torch.equal(m_in, want[1])


def test_lars_update_kernel_rejects_bad_inputs():
    from repro_torch.kernels import lars_update
    dev = _card()
    seg = torch.zeros(2, dtype=torch.int32, device=dev)
    x = torch.zeros(2 * CHUNK, device=dev)
    t = torch.ones(1, device=dev)
    kw = dict(lr=0.1, momentum=0.9, wd=0.0)
    with pytest.raises(TypeError):
        lars_update.lars_packed_update(x, x.bfloat16(), x, t, seg, **kw)
    with pytest.raises(TypeError):
        lars_update.lars_packed_update(x, x, x, t, seg.long(), **kw)
    with pytest.raises(ValueError):
        lars_update.lars_packed_update(x[:CHUNK], x, x, t, seg, **kw)
    with pytest.raises(ValueError):
        y = torch.zeros(2 * CHUNK + 1, device=dev)[1:]
        lars_update.lars_packed_update(y, x, x, t, seg, **kw)
    with pytest.raises(ValueError):
        lars_update.lars_packed_update(x, x.cpu(), x, t, seg, **kw)


def test_sharded_update_on_card_runs_both_kernels():
    """The ZeRO-1 update's call sites: K1 twice a bucket for the trust
    norms, K2 once a bucket, against the same update on the CPU."""
    from repro_torch.kernels import lars_update
    dev = _card()
    plan = _full_width_plan()
    p, g, m, _, _ = _shard_case(plan, 1, 0, dev)
    axis = _ONE_RANK
    cfg = lars.OptConfig()
    want = lars.sharded_update_from_shards(
        [x.cpu() for x in p], [x.cpu() for x in g], [x.cpu() for x in m],
        0.3, cfg, plan, shard_axis=axis, n_shards=1)
    k1 = batched_norm.batched_sumsq.launches
    k2 = lars_update.lars_packed_update.launches
    got = lars.sharded_update_from_shards(
        [x.clone() for x in p], g, [x.clone() for x in m], 0.3, cfg, plan,
        shard_axis=axis, n_shards=1, update_kernel=True)
    torch.cuda.synchronize()
    assert batched_norm.batched_sumsq.launches - k1 == 2 * plan.n_buckets
    assert lars_update.lars_packed_update.launches - k2 == plan.n_buckets
    for gs, ws in zip(got, want):
        for x, y in zip(gs, ws):
            # trust ratios from sums in another order (K1 vs index_add_)
            torch.testing.assert_close(x.cpu(), y, rtol=1e-5, atol=1e-6)
