"""Parity of the port's bucket plans and packed layout with the JAX
package: slot for slot, bit for bit."""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import bucketing as jb
from repro.models import resnet as jresnet
from repro_torch.configs import get_config
from repro_torch.core import bucketing as tb
from repro_torch.models import resnet as tresnet
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

pytestmark = pytest.mark.tier1


def _plans(reduced, bucket_mb):
    jcfg, tcfg = jget_config("resnet50"), get_config("resnet50")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    return (jb.make_plan(jresnet.resnet_pd(jcfg)[0], bucket_mb=bucket_mb),
            tb.make_plan(tresnet.resnet_pd(tcfg)[0], bucket_mb=bucket_mb))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("bucket_mb", [4.0, 0.25])
def test_plan_matches_reference(reduced, bucket_mb):
    want, got = _plans(reduced, bucket_mb)
    assert got.bucket_sizes == want.bucket_sizes
    assert [dataclasses.astuple(s) for s in got.slots] == \
        [dataclasses.astuple(s) for s in want.slots]
    assert got.n_tensors == want.n_tensors == 161
    assert got.slot_tensor_ids == want.slot_tensor_ids
    np.testing.assert_array_equal(tb.segment_ids(got), jb.segment_ids(want))
    if bucket_mb == 0.25:   # the small budget forces split spans
        assert any(s.elem_offset for s in got.slots)


def test_full_width_plan_shape():
    """The main path's plan: 16 buckets, 3 split leaves, 25,021 chunks."""
    _, plan = _plans(False, 4.0)
    assert plan.n_buckets == 16
    assert plan.n_slots == 164
    assert plan.n_chunks == 25_021
    assert sum(s.size for s in plan.slots) == 25_557_032
    assert [s.path for s in plan.slots[:4]] == \
        ["stem/conv", "stem/bn/scale", "stem/bn/bias", "s3b2/conv3"]


def _random_tree(seed=0):
    _, pd = _plans(True, 0.25)
    rng = np.random.default_rng(seed)
    return tree_unflatten(
        pd.paths, [rng.standard_normal(s.shape).astype(np.float32)
                   for s in pd.slots if s.elem_offset == 0][::-1])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pack_unpack_matches_reference(dtype):
    want_plan, plan = _plans(True, 0.25)
    tree = _random_tree()
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jb.pack(tree, want_plan, dtype=jdt)
    ttree = tree_map(torch.from_numpy, tree)
    got = tb.pack(ttree, plan, dtype=tdt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w).astype(np.float32))
    back = dict(tree_flatten(tb.unpack(got, plan)))
    for path, x in tree_flatten(tree):
        expect = x if dtype == "f32" else \
            x.astype(ml_dtypes.bfloat16).astype(np.float32)
        np.testing.assert_array_equal(back[path].numpy(), expect)
    flat = tb.pack_flat(ttree, plan, dtype=tdt)
    np.testing.assert_array_equal(
        flat.float().numpy(),
        np.asarray(jb.concat_buckets(want)).astype(np.float32))
