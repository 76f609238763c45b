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
