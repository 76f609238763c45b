"""The port's kernel wrappers on the CPU (their plain versions) against
the JAX package's Pallas kernels in interpret mode. The CUDA kernels
themselves are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import bucketing as jb
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import resnet as jresnet
from repro_torch.configs import get_config
from repro_torch.core import bucketing as tb
from repro_torch.core import lars
from repro_torch.kernels import batched_norm, ops
from repro_torch.models import resnet as tresnet
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

pytestmark = pytest.mark.tier1

CHUNK = tb.CHUNK


# the reference's own grid (tests/test_kernels.py::test_batched_sumsq)
@pytest.mark.parametrize("n_chunks,n_tensors", [(1, 1), (4, 2), (16, 5),
                                                (7, 7), (32, 3)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batched_sumsq_matches_reference(n_chunks, n_tensors, dtype):
    seg = np.sort(np.arange(n_chunks) % n_tensors).astype(np.int32)
    x = np.random.default_rng(n_chunks).standard_normal(
        n_chunks * CHUNK).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jops.batched_sumsq(jnp.asarray(x).astype(jdt), jnp.asarray(seg),
                              n_tensors)
    before = ops.batched_sumsq.launches
    got = ops.batched_sumsq(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(seg), n_tensors)
    assert ops.batched_sumsq.launches == before   # CPU: no kernel launched
    assert got.dtype == torch.float32 and got.shape == (n_tensors,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3)


def test_batched_sumsq_empty_segment_and_out_of_range_ids():
    """An id with no chunks sums to 0; ids outside [0, n) are dropped, as
    the reference's oracle (``segment_sum``) drops them. The Pallas kernel
    itself leaves an empty segment's row unwritten and clamps an
    out-of-range id onto the last row, so the oracle is the reference
    here; the packed layouts never produce either case."""
    seg = np.array([0, 0, 2, 5], np.int32)
    x = np.random.default_rng(3).standard_normal(4 * CHUNK).astype(np.float32)
    got = ops.batched_sumsq(torch.from_numpy(x), torch.from_numpy(seg), 4)
    want = jref.batched_sumsq(jnp.asarray(x), jnp.asarray(seg), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3)
    assert got[1] == 0 and got[3] == 0


def test_batched_sumsq_rejects_other_devices():
    x = torch.empty(CHUNK, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        batched_norm.batched_sumsq(x, torch.zeros(1, dtype=torch.int32), 1)


def _reduced_params():
    cfg_j = jget_config("resnet50").reduced()
    pd = jresnet.resnet_pd(cfg_j)[0]
    rng = np.random.default_rng(7)
    paths = [p for p, _ in tree_flatten(tresnet.resnet_pd(
        get_config("resnet50").reduced())[0])]
    leaves = [rng.standard_normal(leaf.shape).astype(np.float32)
              for _, leaf in tree_flatten(pd)]
    return tree_unflatten(paths, leaves), pd


@pytest.mark.parametrize("bucket_mb", [None, 0.25])
def test_tree_norms_matches_reference(bucket_mb):
    """Reduced ResNet params; bucket_mb 0.25 splits leaves into spans."""
    tree, pd = _reduced_params()
    jplan = tplan = None
    if bucket_mb is not None:
        jplan = jb.make_plan(pd, bucket_mb=bucket_mb)
        tplan = tb.make_plan(tree, bucket_mb=bucket_mb)
        assert any(s.elem_offset for s in tplan.slots)
    want = dict(tree_flatten(jops.tree_norms(
        tree_map(jnp.asarray, tree), plan=jplan)))
    got = dict(tree_flatten(ops.tree_norms(
        tree_map(torch.from_numpy, tree), plan=tplan)))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(float(got[path]), float(want[path]),
                                   rtol=1e-5, err_msg=path)


# ---------------------------------------------------- K1, the multi form

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _multi(rows_np, seg, n_tensors, tdt):
    """The port's ``batched_sumsq_multi`` on numpy rows, as numpy; on the
    CPU it launches no kernel."""
    rows = [[torch.from_numpy(x).to(tdt) for x in row] for row in rows_np]
    before = batched_norm.batched_sumsq.launches
    got = batched_norm.batched_sumsq_multi(rows, torch.from_numpy(seg),
                                           n_tensors)
    assert batched_norm.batched_sumsq.launches == before
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (len(rows_np), n_tensors)
    return got.numpy()


@pytest.mark.parametrize("n_chunks,n_tensors", [(1, 1), (4, 2), (16, 5),
                                                (7, 7), (32, 3)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batched_sumsq_multi_matches_pallas_kernel(n_chunks, n_tensors,
                                                   dtype):
    """The reference's grid cut into up to 3 buffers a row, 2 rows: the
    Pallas kernel in interpret mode on each buffer with its slice of the
    map, summed over buffers (a segment absent from a buffer is a row the
    Pallas kernel never writes, so it counts 0), and the reference's
    oracle likewise."""
    seg = np.sort(np.arange(n_chunks) % n_tensors).astype(np.int32)
    parts = np.array_split(np.arange(n_chunks), min(3, n_chunks))
    rng = np.random.default_rng(n_chunks + n_tensors)
    rows = [[rng.standard_normal(p.size * CHUNK).astype(np.float32)
             for p in parts] for _ in range(2)]
    jdt, tdt = _DT[dtype]
    got = _multi(rows, seg, n_tensors, tdt)
    for r, row in enumerate(rows):
        pallas = np.zeros(n_tensors, np.float32)
        oracle = np.zeros(n_tensors, np.float32)
        for x, p in zip(row, parts):
            s = seg[p]
            xj = jnp.asarray(x).astype(jdt)
            here = np.isin(np.arange(n_tensors), s)
            pallas += np.where(here, np.asarray(jops.batched_sumsq(
                xj, jnp.asarray(s), n_tensors)), 0.0)
            oracle += np.asarray(jref.batched_sumsq(xj, jnp.asarray(s),
                                                    n_tensors))
        np.testing.assert_allclose(got[r], pallas, rtol=2e-3)
        np.testing.assert_allclose(got[r], oracle, rtol=2e-3)


#: (reduced, bucket_mb, n_shards): the ZeRO step's shard sites. The 0.25
#: MB plan of the reduced config has 15 buckets and tensors split across
#: them; the full-width 4 MB plan is the main path's (16 buckets, 25,021
#: chunks), held against the reference's oracle only (the Pallas kernel in
#: interpret mode would take minutes there)
SHARD_SITES = [(True, 0.25, 1), (True, 0.25, 3), (False, 4.0, 1)]


@pytest.mark.parametrize("reduced,bucket_mb,n_shards", SHARD_SITES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batched_sumsq_multi_matches_reference_at_shard_sites(
        reduced, bucket_mb, n_shards, dtype):
    """Rank k's p and g shards of every bucket, every k: the port's one
    call on the call site's concatenated map (``lars._shard_maps``)
    against the reference's per-bucket sums on its own shard maps, summed
    over buckets."""
    jcfg, tcfg = jget_config("resnet50"), get_config("resnet50")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jplan = jb.make_plan(jresnet.resnet_pd(jcfg)[0], bucket_mb=bucket_mb)
    tplan = tb.make_plan(tresnet.resnet_pd(tcfg)[0], bucket_mb=bucket_mb)
    if reduced:
        assert tplan.n_buckets > 1 and any(s.elem_offset
                                           for s in tplan.slots)
    jdt, tdt = _DT[dtype]
    sizes = tb.shard_sizes(tplan, n_shards)
    jmaps = jb.shard_segment_ids(jplan, n_shards)
    n = tplan.n_tensors
    for k in range(n_shards):
        rng = np.random.default_rng(100 * n_shards + k)
        rows = [[(scale * rng.standard_normal(c)).astype(np.float32)
                 for c in sizes] for scale in (1.0, 0.01)]
        segs, seg_all = lars._shard_maps(tplan, n_shards, k,
                                         torch.device("cpu"))
        np.testing.assert_array_equal(
            seg_all.numpy(), np.concatenate([m[k] for m in jmaps]))
        got = _multi(rows, seg_all.numpy(), n, tdt)
        for r, row in enumerate(rows):
            want = sum(np.asarray(jref.batched_sumsq(
                jnp.asarray(x).astype(jdt), jnp.asarray(m[k]), n))
                for x, m in zip(row, jmaps))
            np.testing.assert_allclose(got[r], want, rtol=2e-3)


def test_batched_sumsq_multi_rejects_bad_inputs_on_cpu():
    seg = torch.zeros(3, dtype=torch.int32)
    a, b = torch.zeros(CHUNK), torch.zeros(2 * CHUNK)
    f = batched_norm.batched_sumsq_multi
    with pytest.raises(TypeError, match="mixed dtypes"):
        f([[a, b], [a, b.bfloat16()]], seg, 1)
    with pytest.raises(TypeError, match="not in"):
        f([[a.half(), b.half()]], seg, 1)
    with pytest.raises(TypeError, match="int32"):
        f([[a, b]], seg.long(), 1)
    with pytest.raises(ValueError, match="not \\(n \\* 1024"):
        f([[a, b[:1000]]], seg, 1)
    with pytest.raises(ValueError, match="holds 3 chunks, seg_ids 2"):
        f([[a, b]], seg[:2], 1)
    with pytest.raises(ValueError, match="row 1 has 1 buffers"):
        f([[a, b], [a]], seg, 1)
    with pytest.raises(ValueError, match="row 1 has a buffer of shape"):
        f([[a, b], [b, a]], seg, 1)
    with pytest.raises(ValueError, match="at least one"):
        f([], seg, 1)
    with pytest.raises(ValueError, match="non-decreasing"):
        f([[a, b]], torch.tensor([0, 1, 0], dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="no kernel"):
        f([[torch.empty(CHUNK, device="meta")]],
          torch.zeros(1, dtype=torch.int32, device="meta"), 1)
    # a row of several buffers is the single-buffer function of their
    # concatenation
    x = torch.randn(3 * CHUNK)
    seg = torch.tensor([0, 0, 1], dtype=torch.int32)
    torch.testing.assert_close(
        f([[x[:CHUNK], x[CHUNK:]]], seg, 2)[0],
        batched_norm.batched_sumsq(x, seg, 2), rtol=1e-6, atol=0)


def test_shard_maps_check_the_concatenated_map(monkeypatch):
    """The call site's map of all buckets must rise: a plan whose rows
    each rise but whose concatenation falls is refused."""
    plan = tb.make_plan(tresnet.resnet_pd(
        get_config("resnet50").reduced())[0], bucket_mb=0.25)
    rows = [np.array([[3, 4]], np.int32), np.array([[1, 2]], np.int32)]
    monkeypatch.setattr(tb, "shard_segment_ids", lambda plan, n: rows)
    with pytest.raises(ValueError, match="not non-decreasing"):
        lars._shard_maps.__wrapped__(plan, 1, 0, torch.device("cpu"))
    rows[:] = rows[::-1]
    segs, cat = lars._shard_maps.__wrapped__(plan, 1, 0,
                                             torch.device("cpu"))
    assert [s.tolist() for s in segs] == [[1, 2], [3, 4]]
    assert cat.tolist() == [1, 2, 3, 4] and cat.dtype == torch.int32
