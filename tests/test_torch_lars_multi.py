"""The fused LARS update over every bucket's shards in one call
(``kernels.lars_update.lars_packed_update_multi``, the sharded step's call
site) on the CPU, where it takes its plain version: against the
reference's per-bucket ``ref.lars_packed_update`` and its Pallas kernel in
interpret mode, bit for bit against the port's per-bucket plain version,
through ``lars.sharded_update_from_shards`` both ways, and its refusals.
Inputs come from numpy with a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lars_update as jlars_update
from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.core import bucketing, lars
from repro_torch.kernels import lars_update, ref
from repro_torch.launch.mesh import Axis
from repro_torch.models import resnet

pytestmark = pytest.mark.tier1

CHUNK = bucketing.CHUNK
KW = dict(momentum=0.9, wd=5e-5)


def _plan():
    """The reduced ResNet-50's 0.25 MB plan: 15 buckets, tensors split
    across buckets."""
    plan = bucketing.make_plan(
        resnet.resnet_pd(get_config("resnet50").reduced())[0],
        bucket_mb=0.25)
    assert any(s.elem_offset for s in plan.slots)
    return plan


def _axis(n_shards, k):
    """Rank ``k``'s shard axis without a process group: the sums over
    ranks are this rank's own, the shard index is ``(k + 1) % n``."""
    return Axis("data", n_shards, k, tuple(range(n_shards)), None)


def _case(plan, n_shards, k, seed):
    """Rank-k shards of p, g, m (numpy, f32), the rank's per-bucket and
    concatenated segment maps, and trust ratios."""
    rng = np.random.default_rng(seed)
    sizes = bucketing.shard_sizes(plan, n_shards)
    draw = lambda s: [(s * rng.standard_normal(c)).astype(np.float32)
                      for c in sizes]
    segs, seg_all = lars._shard_maps(plan, n_shards, k, torch.device("cpu"))
    trust = rng.uniform(0.001, 1.0, plan.n_tensors).astype(np.float32)
    return draw(1.0), draw(0.01), draw(0.001), segs, seg_all, trust


def _t(xs):
    return [torch.from_numpy(x.copy()) for x in xs]


RANKS = [(1, 0), (3, 0), (3, 1), (3, 2)]


@pytest.mark.parametrize("n_shards,k", RANKS)
@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
def test_multi_matches_reference_per_bucket(n_shards, k, lr_kind):
    """Every bucket of rank k's shards in one call, against the
    reference's ``ref.lars_packed_update`` and its Pallas kernel in
    interpret mode bucket by bucket, at the reference's tolerance
    (``tests/test_kernels.py``): rtol 1e-5 / atol 1e-6; and bit for bit
    against the port's per-bucket plain version. In place: the returned
    buffers are the ones given."""
    plan = _plan()
    p, g, m, segs, seg_all, trust = _case(plan, n_shards, k, seed=7 + k)
    lr = 0.37 if lr_kind == "float" else torch.tensor(0.37)
    pt, mt = _t(p), _t(m)
    got_p, got_m = lars_update.lars_packed_update_multi(
        pt, _t(g), mt, torch.from_numpy(trust), seg_all, lr=lr, **KW)
    assert all(a is b for a, b in zip(got_p, pt))
    assert all(a is b for a, b in zip(got_m, mt))
    for b in range(plan.n_buckets):
        args = (p[b], g[b], m[b], trust, segs[b].numpy())
        per = ref.lars_packed_update(*map(torch.from_numpy, args), lr=lr,
                                     **KW)
        assert torch.equal(got_p[b], per[0]) and torch.equal(got_m[b],
                                                              per[1])
        jargs = tuple(map(jnp.asarray, args))
        for want in (jref.lars_packed_update(*jargs, lr=0.37, **KW),
                     jlars_update.lars_packed_update(*jargs, lr=0.37,
                                                     interpret=True, **KW)):
            for x, y in zip((got_p[b], got_m[b]), want):
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_shards,k", RANKS)
@pytest.mark.parametrize("kind", ["lars", "sgdm"])
def test_sharded_update_kernel_flag_is_bit_equal_on_cpu(n_shards, k, kind):
    """``sharded_update_from_shards(update_kernel=True)`` (one
    ``lars_packed_update_multi`` call, in place) gives the per-bucket plain
    loop's ``update_kernel=False`` result bit for bit."""
    plan = _plan()
    p, g, m, _, _, _ = _case(plan, n_shards, k, seed=20 + k)
    cfg = lars.OptConfig(kind=kind)
    kw = dict(shard_axis=_axis(n_shards, k), n_shards=n_shards)
    want = lars.sharded_update_from_shards(_t(p), _t(g), _t(m),
                                           torch.tensor(0.3), cfg, plan,
                                           **kw)
    pt, mt = _t(p), _t(m)
    calls = lars_update.lars_packed_update.launches
    got = lars.sharded_update_from_shards(pt, _t(g), mt, torch.tensor(0.3),
                                          cfg, plan, update_kernel=True,
                                          **kw)
    # the CPU runs the plain version: no kernel launch is counted
    assert lars_update.lars_packed_update.launches == calls
    assert all(a is b for a, b in zip(got[0], pt))
    assert all(a is b for a, b in zip(got[1], mt))
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws) == plan.n_buckets
        for x, y in zip(gs, ws):
            assert torch.equal(x, y)


def _bad(case):
    """A call of ``lars_packed_update_multi`` on CPU tensors that breaks
    one rule; returns (args, error type)."""
    z = lambda n, **kw: torch.zeros(n * CHUNK, **kw)
    p, g, m = [z(2), z(3)], [z(2), z(3)], [z(2), z(3)]
    trust = torch.ones(4)
    seg = torch.zeros(5, dtype=torch.int32)
    err = ValueError
    if case == "empty":
        p, g, m = [], [], []
    elif case == "unequal_sequences":
        g = g[:1]
    elif case == "seg_length":
        seg = seg[:4]
    elif case == "not_chunks":
        p[0] = torch.zeros(2 * CHUNK + 4)
    elif case == "unequal_shapes":
        m[1] = z(2)
    elif case == "dtype_p":
        p[0], err = p[0].double(), TypeError
    elif case == "dtype_g":
        g[1], err = g[1].bfloat16(), TypeError
    elif case == "dtype_seg":
        seg, err = seg.long(), TypeError
    elif case == "dtype_trust":
        trust, err = trust.double(), TypeError
    elif case == "device_g":
        g[1] = z(3, device="meta")
    elif case == "device_trust":
        trust = torch.ones(4, device="meta")
    elif case == "contiguity":
        m[0] = torch.zeros(4 * CHUNK)[::2]
    elif case == "contiguity_seg":
        seg = torch.zeros(10, dtype=torch.int32)[::2]
    elif case == "alignment":
        p[1] = torch.zeros(3 * CHUNK + 1)[1:]
    return (p, g, m, trust, seg), err


@pytest.mark.parametrize("case", [
    "empty", "unequal_sequences", "seg_length", "not_chunks",
    "unequal_shapes", "dtype_p", "dtype_g", "dtype_seg", "dtype_trust",
    "device_g", "device_trust", "contiguity", "contiguity_seg",
    "alignment"])
def test_multi_rejects_bad_inputs_on_cpu(case):
    """Each broken rule raises before anything is written."""
    (p, g, m, trust, seg), err = _bad(case)
    before = [x.clone() for x in p + m if x.device.type == "cpu"]
    with pytest.raises(err):
        lars_update.lars_packed_update_multi(p, g, m, trust, seg, lr=0.1,
                                             **KW)
    after = [x for x in p + m if x.device.type == "cpu"]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
