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


#: (bucket_mb, n_shards) of the ZeRO step's K1 call site at full width:
#: the main path's 4 MB plan (2 x 16 buffers), and the 0.25 MB plan (2 x
#: 211 buffers: past the kernel's 256-buffer table, so two pass-1
#: launches in the one call; tensors split across buckets) on 1 and 3
#: shards
MULTI_SITES = [(4.0, 1), (0.25, 1), (0.25, 3)]


@pytest.mark.parametrize("bucket_mb,n_shards", MULTI_SITES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_sumsq_multi_kernel_matches_plain(bucket_mb, n_shards,
                                                  dtype):
    """One call over every bucket's p and g shards at rank k, every k: one
    launch, within rtol 2e-3 of the plain version, bit-equal twice."""
    dev = _card()
    plan = bucketing.make_plan(resnet.resnet_pd(get_config("resnet50"))[0],
                               bucket_mb=bucket_mb)
    sizes = bucketing.shard_sizes(plan, n_shards)
    for k in range(n_shards):
        rng = np.random.default_rng(k)
        rows = [[torch.from_numpy((s * rng.standard_normal(c))
                                  .astype(np.float32)).to(dev, dtype)
                 for c in sizes] for s in (1.0, 0.01)]
        _, seg = lars._shard_maps(plan, n_shards, k, dev)
        before = batched_norm.batched_sumsq.launches
        got = batched_norm.batched_sumsq_multi(rows, seg, plan.n_tensors)
        torch.cuda.synchronize()
        assert batched_norm.batched_sumsq.launches == before + 1
        assert tuple(got.shape) == (2, plan.n_tensors)
        want = ref.batched_sumsq_multi(rows, seg, plan.n_tensors)
        torch.testing.assert_close(got, want, rtol=2e-3, atol=0)
        again = batched_norm.batched_sumsq_multi(rows, seg, plan.n_tensors)
        assert torch.equal(again, got)


def test_batched_sumsq_multi_kernel_rejects_bad_inputs():
    dev = _card()
    seg = torch.zeros(2, dtype=torch.int32, device=dev)
    x = torch.zeros(CHUNK, device=dev)
    f = batched_norm.batched_sumsq_multi
    with pytest.raises(TypeError, match="mixed dtypes"):
        f([[x, x], [x, x.bfloat16()]], seg, 1)
    with pytest.raises(ValueError, match="one device"):
        f([[x, x.cpu()]], seg, 1)
    with pytest.raises(ValueError, match="seg_ids must be contiguous"):
        f([[x, x]], seg.cpu(), 1)
    with pytest.raises(ValueError, match="aligned"):
        f([[x, torch.zeros(CHUNK + 1, device=dev)[1:]]], seg, 1)
    with pytest.raises(ValueError, match="holds 2 chunks, seg_ids 1"):
        f([[x, x]], seg[:1], 1)


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
    trust = lars.shard_trust_ratios(p, g, torch.cat(segs), plan,
                                    lars.OptConfig(), shard_axis=_ONE_RANK)
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


#: (bucket_mb, n_shards) of K2's one call a sharded step at full width: the
#: main path's 4 MB plan on one shard, the 0.25 MB plan on 3 (split
#: tensors, padding chunks, 211 buckets: two launches in the one call),
#: and the 4 MB plan on 4 (a four-card rank's shards)
K2_SITES = [(4.0, 1), (0.25, 3), (4.0, 4)]


@pytest.mark.parametrize("bucket_mb,n_shards", K2_SITES)
def test_lars_update_multi_kernel_matches_per_bucket_and_plain(bucket_mb,
                                                               n_shards):
    """One call over every bucket's shards at rank k, every k: one count,
    in place, bit-equal to the per-bucket launches, within the reference's
    rtol 1e-5 / atol 1e-6 of the plain version."""
    from repro_torch.kernels import lars_update
    dev = _card()
    plan = bucketing.make_plan(resnet.resnet_pd(get_config("resnet50"))[0],
                               bucket_mb=bucket_mb)
    kw = dict(lr=torch.tensor(0.37, device=dev), momentum=0.9, wd=5e-5)
    for k in range(n_shards):
        p, g, m, segs, trust = _shard_case(plan, n_shards, k, dev, seed=k)
        _, seg_all = lars._shard_maps(plan, n_shards, k, dev)
        per = [lars_update.lars_packed_update(p[b], g[b], m[b], trust,
                                              segs[b], **kw)
               for b in range(plan.n_buckets)]
        want = ref.lars_packed_update_multi([x.clone() for x in p], g,
                                            [x.clone() for x in m], trust,
                                            seg_all, **kw)
        before = lars_update.lars_packed_update.launches
        got = lars_update.lars_packed_update_multi(p, g, m, trust, seg_all,
                                                   **kw)
        torch.cuda.synchronize()
        assert lars_update.lars_packed_update.launches == before + 1
        assert all(x is y for x, y in zip(got[0], p))
        assert all(x is y for x, y in zip(got[1], m))
        for b, (p2, m2) in enumerate(per):
            assert torch.equal(got[0][b], p2) and torch.equal(got[1][b], m2)
            torch.testing.assert_close(got[0][b], want[0][b], rtol=1e-5,
                                       atol=1e-6)
            torch.testing.assert_close(got[1][b], want[1][b], rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("bucket_mb,kernels", [(4.0, 1), (0.25, 2)])
def test_lars_update_multi_launches_a_call(bucket_mb, kernels):
    """The device's own count: one launch for the 4 MB plan's 16 shards,
    two for the 0.25 MB plan's 211 (the table holds 128), in one call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import lars_update
    dev = _card()
    plan = bucketing.make_plan(resnet.resnet_pd(get_config("resnet50"))[0],
                               bucket_mb=bucket_mb)
    p, g, m, _, trust = _shard_case(plan, 1, 0, dev)
    _, seg_all = lars._shard_maps(plan, 1, 0, dev)
    lr = torch.tensor(0.1, device=dev)
    kw = dict(lr=lr, momentum=0.9, wd=5e-5)
    lars_update.lars_packed_update_multi(p, g, m, trust, seg_all, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lars_update.lars_packed_update_multi(p, g, m, trust, seg_all, **kw)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if "lars_update_multi" in e.name]
    assert len(names) == kernels, names


def test_lars_update_multi_kernel_rejects_bad_inputs():
    from repro_torch.kernels import lars_update
    dev = _card()
    z = lambda n: torch.zeros(n * CHUNK, device=dev)
    seg = torch.zeros(3, dtype=torch.int32, device=dev)
    t = torch.ones(1, device=dev)
    kw = dict(lr=0.1, momentum=0.9, wd=0.0)
    f = lars_update.lars_packed_update_multi
    with pytest.raises(ValueError, match="one non-zero length"):
        f([z(1), z(2)], [z(1)], [z(1), z(2)], t, seg, **kw)
    with pytest.raises(ValueError, match="hold 3 chunks, seg_ids 2"):
        f([z(1), z(2)], [z(1), z(2)], [z(1), z(2)], t, seg[:2], **kw)
    with pytest.raises(TypeError, match="float32"):
        f([z(1), z(2)], [z(1), z(2).bfloat16()], [z(1), z(2)], t, seg, **kw)
    with pytest.raises(TypeError, match="int32"):
        f([z(1), z(2)], [z(1), z(2)], [z(1), z(2)], t, seg.long(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        f([z(1), z(2)], [z(1), z(2).cpu()], [z(1), z(2)], t, seg, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        f([z(1), z(4)[::2]], [z(1), z(2)], [z(1), z(2)], t, seg, **kw)
    with pytest.raises(ValueError, match="aligned"):
        y = torch.zeros(2 * CHUNK + 1, device=dev)[1:]
        f([z(1), z(2)], [z(1), z(2)], [z(1), y], t, seg, **kw)


def test_sharded_update_on_card_runs_both_kernels():
    """The ZeRO-1 update's call sites: K1 once a step for the trust norms
    of every bucket's shards, K2 once a step for the update of every
    bucket's shards, against the same update on the CPU."""
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
    assert batched_norm.batched_sumsq.launches - k1 == 1
    assert lars_update.lars_packed_update.launches - k2 == 1
    for gs, ws in zip(got, want):
        for x, y in zip(gs, ws):
            # trust ratios from sums in another order (K1 vs index_add_)
            torch.testing.assert_close(x.cpu(), y, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- K3

#: test_comm.py's ragged (n, length) pairs of the ring-kernel parity test
RING_RAGGED = [(2, 1000), (3, 5000), (4, 4096), (8, 33000)]


def _ring_fold_equal(recv, chunks, k):
    """K3 against its plain version, bit for bit; counts one launch."""
    from repro_torch.comm import ring_kernel
    before = ring_kernel.ring_add_step.launches
    got = ring_kernel.ring_add_step(recv, chunks, k)
    assert ring_kernel.ring_add_step.launches == before + 1
    want = ref.ring_add_step(recv, chunks, k)
    torch.cuda.synchronize()
    assert got.dtype == recv.dtype and torch.equal(got, want), k
    return got


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("which", ["largest", "smallest"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_add_kernel_matches_plain_at_path_rows(n, which, dtype):
    """The chunk rows the ring gives K3 on the ResNet-50 path: the largest
    and the smallest bucket of the 4 MB plan on 4 and 2 ranks, every k."""
    from repro_torch.comm import primitives as prim
    dev = _card()
    sizes = _full_width_plan().bucket_sizes
    L = max(sizes) if which == "largest" else min(sizes)
    rng = np.random.default_rng(L + n)
    x = torch.from_numpy(rng.standard_normal(L).astype(np.float32)).to(
        dev, dtype)
    chunks = prim._as_chunks(x, n, pad_to=CHUNK)
    recv = torch.from_numpy(rng.standard_normal(chunks.shape[1])
                            .astype(np.float32)).to(dev, dtype)
    for k in range(n):
        _ring_fold_equal(recv, chunks, k)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("which", ["largest", "smallest"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_fold_bound_matches_plain_at_path_rows(n, which, dtype):
    """The fold as the ring makes it, through one ``kernel_step_fn`` bound
    once to a bucket's chunks, in place into fresh receives at every k:
    bit for bit the plain fold, one launch a fold; then bound to a second
    bucket's chunks, and a mismatched receive still raises."""
    from repro_torch.comm import primitives as prim
    from repro_torch.comm import ring_kernel
    dev = _card()
    sizes = _full_width_plan().bucket_sizes
    L = max(sizes) if which == "largest" else min(sizes)
    rng = np.random.default_rng(L + n + 1)
    draw = lambda m: torch.from_numpy(rng.standard_normal(m).astype(
        np.float32)).to(dev, dtype)
    step = ring_kernel.kernel_step_fn()
    for chunks in (prim._as_chunks(draw(L), n, pad_to=CHUNK),
                   prim._as_chunks(draw(L), n, pad_to=CHUNK)):
        snapshot = chunks.clone()
        for k in range(n):
            recv = draw(chunks.shape[1])
            want = ref.ring_add_step(recv, chunks, k)
            before = ring_kernel.ring_add_step.launches
            got = step(recv, chunks, k)
            assert ring_kernel.ring_add_step.launches == before + 1
            torch.cuda.synchronize()
            assert got is recv and torch.equal(recv, want), k
        assert torch.equal(chunks, snapshot)
    c = chunks.shape[1]
    with pytest.raises(ValueError, match="k must be"):
        step(draw(c), chunks, n)
    with pytest.raises(ValueError, match="recv has shape"):
        step(draw(c + CHUNK), chunks, 0)
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    with pytest.raises(TypeError, match="chunks are"):
        step(torch.zeros(c, dtype=other, device=dev), chunks, 0)
    with pytest.raises(ValueError, match="on cpu"):
        step(draw(c).cpu(), chunks, 0)
    with pytest.raises(ValueError, match="contiguous"):
        step(draw(2 * c)[::2], chunks, 0)


def test_ring_add_kernel_reference_shapes_and_ragged_rows():
    """test_comm.py's shapes: (4, 2·1024) f32 at k 0 and 3, bf16 ones +
    0.5, and the ragged (n, length) pairs through ``_as_chunks(pad_to=
    CHUNK)`` at every k."""
    from repro_torch.comm import primitives as prim
    dev = _card()
    rng = np.random.default_rng(0)
    chunks = torch.from_numpy(rng.standard_normal((4, 2 * CHUNK))
                              .astype(np.float32)).to(dev)
    recv = torch.from_numpy(rng.standard_normal(2 * CHUNK)
                            .astype(np.float32)).to(dev)
    for k in (0, 3):
        _ring_fold_equal(recv, chunks, k)
    out = _ring_fold_equal(torch.full((CHUNK,), 0.5, dtype=torch.bfloat16,
                                      device=dev),
                           torch.ones((2, CHUNK), dtype=torch.bfloat16,
                                      device=dev), 1)
    assert bool((out == 1.5).all())
    for n, length in RING_RAGGED:
        x = torch.from_numpy(rng.standard_normal(length)
                             .astype(np.float32)).to(dev)
        chunks = prim._as_chunks(x, n, pad_to=CHUNK)
        recv = torch.randn(chunks.shape[1], device=dev)
        for k in range(n):
            _ring_fold_equal(recv, chunks, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_add_kernel_misaligned_and_in_place(dtype):
    """Views off the 16-byte grid: all three operands shifted alike by one
    element (scalar head, vectors, scalar tail) and recv shifted apart
    (every element a scalar); then the fold into recv itself, whose caller
    still holds it. chunks are never written."""
    from repro_torch.comm import ring_kernel
    dev = _card()
    c = 3 * CHUNK
    draw = lambda m: torch.randn(m, device=dev).to(dtype)
    chunks = draw(2 * c + 1)[1:].view(2, c)        # rows shifted by one
    snapshot = chunks.clone()
    for shift in (1, 2):                           # alike, then apart
        recv = draw(c + shift)[shift:]
        out = torch.empty(c + 1, device=dev, dtype=dtype)[1:]
        for k in range(2):
            got = ring_kernel.ring_add_step(recv, chunks, k, out=out)
            torch.cuda.synchronize()
            assert got is out
            assert torch.equal(out, ref.ring_add_step(recv, chunks, k))
    held = draw(c)
    want = ref.ring_add_step(held, chunks, 1)
    got = ring_kernel.kernel_step_fn()(held, chunks, 1)
    torch.cuda.synchronize()
    assert got is held and torch.equal(held, want)
    assert torch.equal(chunks, snapshot)


def test_ring_add_kernel_rejects_bad_inputs():
    from repro_torch.comm import ring_kernel
    dev = _card()
    chunks = torch.zeros((2, CHUNK), device=dev)
    recv = torch.zeros(CHUNK, device=dev)
    for k in (2, -1, True, 1.0):
        with pytest.raises(ValueError, match="k must be"):
            ring_kernel.ring_add_step(recv, chunks, k)
    with pytest.raises(ValueError, match="c %"):
        ring_kernel.ring_add_step(recv[:1000], chunks[:, :1000], 0)
    with pytest.raises(TypeError, match="chunks are"):
        ring_kernel.ring_add_step(recv.bfloat16(), chunks, 0)
    with pytest.raises(TypeError):
        ring_kernel.ring_add_step(recv.half(), chunks.half(), 0)
    with pytest.raises(ValueError):
        ring_kernel.ring_add_step(recv, chunks.cpu(), 0)
    with pytest.raises(ValueError):
        ring_kernel.ring_add_step(recv, chunks, 0, out=recv[:CHUNK // 2])


# ---------------------------------------------------------------- K5

#: (B, S, H, K, Dk, Dv, causal, window): the CPU tests' shapes and masks
#: (``test_kernels.py``'s flash cases), ragged lengths, qwen3-14b's GQA
#: heads with and without a window, MLA's (192, 128) and the serving
#: path's qwen1.5-0.5b heads
FLASH_CASES = [(*s, c, w)
               for s in ((2, 64, 4, 2, 32, 32), (1, 128, 2, 2, 16, 16),
                         (2, 96, 4, 4, 32, 16))
               for c, w in ((True, 0), (True, 24), (False, 0))] + [
    (2, 100, 4, 2, 64, 64, True, 0), (1, 1000, 2, 1, 64, 64, True, 37),
    (1, 1024, 40, 8, 128, 128, True, 0), (1, 1024, 40, 8, 128, 128, True,
                                          256),
    (1, 512, 16, 16, 192, 128, True, 0), (2, 2048, 16, 16, 64, 64, True, 0)]
#: kernel against plain, both on the card: f32 sums in another order; in
#: bf16 that can flip the output's rounding by one ulp (2^-7 relative)
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-5)}


def _flash_inputs(B, S, H, K, Dk, Dv, dtype, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev).to(dtype)
            for s in ((B, S, H, Dk), (B, S, K, Dk), (B, S, K, Dv))]


def _flash_matches_plain(case, dtype, q_scale=1.0):
    """K5 through ``ops.flash_attention_bshd`` against its plain version on
    the card: one launch, the tolerance, equal bits on a second call."""
    from repro_torch.kernels import flash_attention as fa
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, K, Dk, Dv, causal, window = case
    q, k, v = _flash_inputs(B, S, H, K, Dk, Dv, dtype, dev)
    q = (q.float() * q_scale).to(dtype)
    before = fa.flash_attention.launches
    got = ops.flash_attention_bshd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    flat = lambda x: x.transpose(1, 2).reshape(-1, S, x.shape[-1])
    want = ref.flash_attention(flat(q), flat(k), flat(v), causal=causal,
                               window=window, n_q_heads=H, n_kv_heads=K)
    want = want.reshape(B, H, S, Dv).transpose(1, 2)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, **FLASH_TOL[dtype])
    again = ops.flash_attention_bshd(q, k, v, causal=causal, window=window)
    assert torch.equal(got, again)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(case, dtype):
    _flash_matches_plain(case, dtype)


@pytest.mark.parametrize("case", [
    (2, 2048, 16, 16, 64, 64, True, 0), (1, 1024, 40, 8, 128, 128, True, 256),
    (1, 512, 16, 16, 192, 128, True, 0)])
def test_flash_attention_bf16_peaked_softmax(case):
    """q x 8: scores spread over a wide range, so the running max moves
    often and by much, and P is near 0 or 1: the split P_hi + P_lo under
    large corrections."""
    _flash_matches_plain(case, torch.bfloat16, q_scale=8.0)


@pytest.mark.parametrize("causal,window", [(True, 1), (True, 24),
                                           (False, 1)])
def test_flash_attention_bf16_rows_that_see_no_key_in_a_tile(causal, window):
    """S 100 (a ragged last tile): with window 24 the rows 88..99 see no
    key of the first tile they read, with window 1 each row sees one key,
    and the rows past S see none at all, so the -1e30 start (exp(0) on
    masked keys, then a correction of 0) carries through the split."""
    _flash_matches_plain((1, 100, 2, 1, 64, 64, causal, window),
                         torch.bfloat16)


def test_flash_attention_kernel_unequal_lengths():
    """Sq != Sk over the (B·H, S, D) layout, non-causal and causal."""
    from repro_torch.kernels import flash_attention as fa
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(4, 70, 64, generator=gen, device=dev)
    k = torch.randn(2, 130, 64, generator=gen, device=dev)
    v = torch.randn(2, 130, 64, generator=gen, device=dev)
    for causal in (False, True):
        got = fa.flash_attention(q, k, v, causal=causal, n_q_heads=2,
                                 n_kv_heads=1)
        want = ref.flash_attention(q, k, v, causal=causal, n_q_heads=2,
                                   n_kv_heads=1)
        torch.testing.assert_close(got, want, **FLASH_TOL[torch.float32])


def test_flash_attention_kernel_rejects_bad_inputs():
    from repro_torch.kernels import flash_attention as fa
    dev = _card()
    x = torch.zeros(2, 8, 64, device=dev)
    with pytest.raises(TypeError):
        fa.flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(TypeError):
        fa.flash_attention(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="head dims"):
        y = torch.zeros(2, 8, 48, device=dev)
        fa.flash_attention(y, y, y)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(8, 2, 64, device=dev).transpose(0, 1)
        fa.flash_attention(t, x, x)
    with pytest.raises(ValueError):
        fa.flash_attention(x, x.cpu(), x)


def test_prefill_on_card_launches_the_kernel_once_a_layer():
    """Reduced qwen1.5-0.5b with flash_attention: one launch a layer, and
    the same last logits as the chunked path within 3e-2 of their max."""
    import dataclasses
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.registry import build_model
    dev = _card()
    base = get_config("qwen1.5-0.5b").reduced()
    model = build_model(dataclasses.replace(base, flash_attention=True))
    params = pinit.materialize(model.param_pd, 0, dev)
    toks = torch.randint(0, base.vocab_size, (2, 96), device=dev)
    before = fa.flash_attention.launches
    got, _ = model.forward_prefill(params, {"tokens": toks}, 104)
    assert fa.flash_attention.launches == before + base.n_layers
    want, _ = build_model(base).forward_prefill(params, {"tokens": toks},
                                                104)
    err = (got - want).abs().max() / want.abs().max()
    assert float(err) < 3e-2


def test_flash_attention_refuses_autograd_on_card():
    """As on the CPU: no backward, so a graph through K5 is refused before
    any launch, with the ROADMAP item named."""
    from repro_torch.kernels import flash_attention as fa
    dev = _card()
    q = torch.zeros(2, 8, 64, device=dev, requires_grad=True)
    before = fa.flash_attention.launches
    with pytest.raises(NotImplementedError, match="K5 backward"):
        fa.flash_attention(q, q.detach(), q.detach())
    assert fa.flash_attention.launches == before
    with torch.no_grad():
        fa.flash_attention(q, q, q)
    assert fa.flash_attention.launches == before + 1


# ---------------------------------------------------------------- K4

#: (T, V): test_kernels.py's grid, V 513 (rows off the 16-byte grid), the
#: full-width vocabulary for a few rows and for a ragged T
XENT_CASES = [(8, 512), (64, 1000), (128, 4096), (256, 2048), (16, 333),
              (37, 513), (3, 151_936), (77, 151_936)]
#: forward: the reference's own tolerances (test_kernels.py); backward:
#: rtol 1e-5 / atol 1e-7 in f32, and one bf16 ulp (2^-7) when dx is bf16
XENT_FWD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
                torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
XENT_BWD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-7),
                torch.bfloat16: dict(rtol=1e-2, atol=1e-7)}


def _xent_inputs(T, V, dtype, dev, *, ignore=False, offset=0):
    """4·N(0, 1) logits (``offset`` elements into their buffer, so rows
    start off the 16-byte grid), uniform labels (every third IGNORE with
    ``ignore``), and a gradient with every fifth row 0."""
    from repro_torch.core.label_smoothing import IGNORE
    gen = torch.Generator(device=dev).manual_seed(T + V)
    buf = 4.0 * torch.randn(T * V + offset, generator=gen, device=dev)
    logits = buf.to(dtype)[offset:].view(T, V)
    labels = torch.randint(0, V, (T,), generator=gen, device=dev,
                           dtype=torch.int32)
    if ignore:
        labels[::3] = IGNORE
    g = torch.rand(T, generator=gen, device=dev)
    g[1::5] = 0.0
    return logits, labels, g


def _xent_check(logits, labels, g, dtype):
    from repro_torch.kernels import smoothed_xent as sx
    x = logits.detach().requires_grad_()
    f0, b0 = sx.smoothed_xent_rows_forward.launches, \
        sx.smoothed_xent_rows_backward.launches
    nll = ops.smoothed_xent_rows(x, labels, 0.1)
    (dx,) = torch.autograd.grad(nll, x, g)
    torch.cuda.synchronize()
    assert sx.smoothed_xent_rows_forward.launches == f0 + 1
    assert sx.smoothed_xent_rows_backward.launches == b0 + 1
    xp = logits.detach().clone().requires_grad_()
    want = ref.smoothed_xent_rows(xp, labels, smoothing=0.1)
    (want_dx,) = torch.autograd.grad(want, xp, g)
    assert nll.dtype == torch.float32 and dx.dtype == dtype
    torch.testing.assert_close(nll, want, **XENT_FWD_TOL[dtype])
    torch.testing.assert_close(dx, want_dx, **XENT_BWD_TOL[dtype])
    assert not dx[g == 0].any()                # masked rows: exact zeros
    again = ops.smoothed_xent_rows(logits, labels, 0.1)
    assert torch.equal(again, nll.detach())    # deterministic


@pytest.mark.parametrize("case", XENT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smoothed_xent_kernel_matches_plain(case, dtype):
    dev = _card()
    _xent_check(*_xent_inputs(*case, dtype, dev), dtype)


@pytest.mark.parametrize("case", [(16, 333), (64, 1000), (9, 151_936)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smoothed_xent_kernel_ignore_labels_and_misaligned_rows(case,
                                                                dtype):
    """IGNORE labels take no target (forward) and no one-hot (backward);
    logits one element off their buffer's alignment take the scalar head
    in the forward and the scalar path in the backward."""
    dev = _card()
    _xent_check(*_xent_inputs(*case, dtype, dev, ignore=True), dtype)
    _xent_check(*_xent_inputs(*case, dtype, dev, ignore=True, offset=1),
                dtype)


def test_smoothed_xent_kernel_rejects_bad_inputs():
    from repro_torch.kernels import smoothed_xent as sx
    dev = _card()
    x = torch.zeros(4, 8, device=dev)
    lab = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        sx.smoothed_xent_rows(x.half(), lab)
    with pytest.raises(TypeError):
        sx.smoothed_xent_rows(x, lab.float())
    with pytest.raises(ValueError):
        sx.smoothed_xent_rows(x[0], lab)
    with pytest.raises(ValueError):
        sx.smoothed_xent_rows(x, lab[:3])
    with pytest.raises(ValueError, match="contiguous"):
        sx.smoothed_xent_rows(torch.zeros(8, 4, device=dev).T, lab)
    with pytest.raises(ValueError):
        sx.smoothed_xent_rows(x, lab.cpu())


def test_lm_train_step_on_card_runs_k4_and_k1(monkeypatch):
    """Reduced qwen1.5-0.5b, one LARS step with the norm kernel on the
    card: K4 once forward and once backward, K1 twice; the loss and the
    new params as a step whose loss is built on the plain version, to
    1e-5."""
    from repro_torch.data.synthetic import token_batch
    from repro_torch.kernels import smoothed_xent as sx
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.models.registry import build_model
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    dev = _card()
    base = get_config("qwen1.5-0.5b").reduced()
    model = build_model(base)
    step = make_train_step(model, lars.OptConfig(use_kernel=True),
                           make_schedule(ScheduleConfig(base_lr=1.0,
                                                        total_steps=4)))
    state = init_state(model, 0, device=dev)
    batch = token_batch(base, batch=4, seq=64, step=0, device=dev)
    counts = lambda: (sx.smoothed_xent_rows_forward.launches,
                      sx.smoothed_xent_rows_backward.launches,
                      batched_norm.batched_sumsq.launches)
    before = counts()
    got, m = step(state, batch)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 2]
    monkeypatch.setattr(ops, "smoothed_xent_rows",
                        lambda x, y, s: ref.smoothed_xent_rows(
                            x, y, smoothing=s))
    want, wm = step(state, batch)
    assert counts()[:2] == (before[0] + 1, before[1] + 1)
    assert abs(float(m["loss"]) - float(wm["loss"])) \
        <= 1e-5 * abs(float(wm["loss"]))
    for (p, a), (_, b) in zip(tree_flatten(got.params),
                              tree_flatten(want.params)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), p


def _zero1_on_card(guard):
    """The reduced ZeRO-1 step with both kernels (K1 for the norms, K2 for
    the update) on a one-rank NCCL group, and a fresh state for it."""
    from repro_torch.configs.base import CommConfig
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.train import state as st
    from repro_torch.train.step import make_train_step
    _card()
    mesh = make_local_mesh()
    model = build_model(get_config("resnet50").reduced())
    step = make_train_step(
        model, lars.OptConfig(use_kernel=True), make_schedule(
            ScheduleConfig(base_lr=0.5, total_steps=4)), mesh=mesh,
        comm=CommConfig(strategy="psum", bucket_mb=0.25, sharding="zero1",
                        update_kernel=True), guard=guard)
    return mesh, model, step, lambda: st.init_state(
        model, 0, device=mesh.device, **st.sharded_state_kwargs(step))


def test_checkpoint_round_trip_on_the_card(tmp_path):
    """A zero1 state after a step on the card saves and loads back bit for
    bit, in new tensors on the card."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.train import checkpoint as ckpt
    mesh, model, step, fresh = _zero1_on_card(False)
    try:
        batch = make_batch_fn(model.cfg, InputShape("t", "train", 0, 8),
                              device=mesh.device, mesh=mesh)(0)
        s, _ = step(fresh(), batch)
        ckpt.save(s, str(tmp_path), tag="step00000001",
                  comm_plan=step.comm_plan, mesh=mesh)
        template = fresh()
        back = ckpt.load(template, str(tmp_path), mesh=mesh)
    finally:
        mesh.destroy()
    assert back.step == 1
    for a, b, t in zip(back.shards + back.mom, s.shards + s.mom,
                       template.shards + template.mom):
        assert a.is_cuda and torch.equal(a, b)
        assert a.data_ptr() != t.data_ptr()
    for (p, a), (_, b) in zip(tree_flatten(back.params),
                              tree_flatten(s.params)):
        assert a.is_cuda and torch.equal(a, b), p
    for (p, a), (_, b) in zip(tree_flatten(back.bn_state),
                              tree_flatten(s.bn_state)):
        assert torch.equal(a, b), p


def test_skipped_step_launches_neither_norm_nor_update_kernel():
    """The guard's gate comes before K1 and K2: a NaN batch's step
    launches neither (the profiler's kernels and the wrappers' counts), a
    clean step launches each once."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.shapes import InputShape
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.kernels import lars_update
    from repro_torch.train import faults, guard
    mesh, model, step, fresh = _zero1_on_card(True)
    try:
        batch = make_batch_fn(model.cfg, InputShape("t", "train", 0, 8),
                              device=mesh.device, mesh=mesh)(0)
        s = fresh()
        step(s, batch, guard.neutral_inputs())           # warm up
        counts = []
        for b in (faults.poison_nan(batch), batch):
            k1 = batched_norm.batched_sumsq.launches
            k2 = lars_update.lars_packed_update.launches
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                s2, m = step(s, b, guard.neutral_inputs())
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()]
            counts.append((
                float(m["skipped"]),
                sum("chunk_sumsq" in n for n in names),
                sum("lars_update_multi" in n for n in names),
                batched_norm.batched_sumsq.launches - k1,
                lars_update.lars_packed_update.launches - k2))
            if b is batch:
                assert s2.step == s.step + 1
            else:
                assert s2 is s
    finally:
        mesh.destroy()
    assert counts == [(1.0, 0, 0, 0, 0), (0.0, 1, 1, 1, 1)], counts
