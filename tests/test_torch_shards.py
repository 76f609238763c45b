"""Parity of the port's ZeRO-1 layout and sharded LARS update with the JAX
package, in one process: the shard helpers of ``core/bucketing`` and the
packed states of ``train/state`` bit for bit, the plain packed update
(``kernels/ref``) against the reference's and its Pallas kernel in
interpret mode, and ``lars.sharded_update_from_shards`` against the
reference's inside a 1-device ``shard_map``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.core import bucketing as jb
from repro.core import lars as jlars
from repro.kernels import lars_update as jlars_update
from repro.kernels import ref as jref
from repro.models import resnet as jresnet
from repro.train import state as jstate
from repro_torch.configs import get_config
from repro_torch.core import bucketing as tb
from repro_torch.core import ddp, lars
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Axis
from repro_torch.models import resnet as tresnet
from repro_torch.train import state as tstate
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

pytestmark = pytest.mark.tier1

CHUNK = tb.CHUNK
#: one rank, no process group: the sums over ranks are the local sums
ONE_RANK = Axis("data", 1, 0, (0,), None)


def _plans(reduced, bucket_mb):
    jcfg, tcfg = jget_config("resnet50"), get_config("resnet50")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    return (jb.make_plan(jresnet.resnet_pd(jcfg)[0], bucket_mb=bucket_mb),
            tb.make_plan(tresnet.resnet_pd(tcfg)[0], bucket_mb=bucket_mb))


def _tree(plan, seed=0):
    """Random f32 numpy params in the plan's paths and shapes."""
    rng = np.random.default_rng(seed)
    shapes = [s.shape for s in plan.slots if s.elem_offset == 0][::-1]
    return tree_unflatten(plan.paths, [
        rng.standard_normal(s).astype(np.float32) for s in shapes])


PLANS = [(False, 4.0), (True, 0.25)]   # the main path's; split tensors


@pytest.mark.parametrize("reduced,bucket_mb", PLANS)
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_shard_helpers_match_reference(reduced, bucket_mb, n_shards):
    want, got = _plans(reduced, bucket_mb)
    assert [[dataclasses.astuple(s) for s in g] for g in got.groups] == \
        [[dataclasses.astuple(s) for s in g] for g in want.groups]
    assert got.slot_is_final_span == want.slot_is_final_span
    assert tb.shard_sizes(got, n_shards) == jb.shard_sizes(want, n_shards)
    for size in got.bucket_sizes:
        assert tb.shard_elems(size, n_shards) == \
            jb.shard_elems(size, n_shards)
    maps_t = tb.shard_segment_ids(got, n_shards)
    maps_j = jb.shard_segment_ids(want, n_shards)
    assert len(maps_t) == len(maps_j) == got.n_buckets
    for mt, mj in zip(maps_t, maps_j):
        np.testing.assert_array_equal(mt, mj)
        assert mt.dtype == np.int32
        # the batched-norm kernel binary-searches each row's segments
        assert (np.diff(mt, axis=1) >= 0).all()
    np.testing.assert_array_equal(tb.trust_scaled_mask(got),
                                  jb.trust_scaled_mask(want))
    rng = np.random.default_rng(n_shards)
    for size in got.bucket_sizes[:3] + got.bucket_sizes[-1:]:
        buf = rng.standard_normal(size).astype(np.float32)
        for fn in ("pad_to_shards", "rotate_to_shards"):
            g = getattr(tb, fn)(torch.from_numpy(buf), n_shards)
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(getattr(jb, fn)(jnp.asarray(buf),
                                                      n_shards)))
        rot = np.array(jb.rotate_to_shards(jnp.asarray(buf), n_shards))
        np.testing.assert_array_equal(
            tb.unrotate_shards(torch.from_numpy(rot), n_shards).numpy(),
            np.asarray(jb.unrotate_shards(jnp.asarray(rot), n_shards)))


def test_shard_axis_size_matches_reference():
    """The port picks the shard axis with ``comm.schedules.shard_axis``
    (``make_train_step``, ``comm.plan_for``), the reference's cost model
    with ``shard_axis_size``: the same axis and size."""
    from repro.comm.cost import shard_axis_size as want
    from repro_torch.comm.schedules import shard_axis
    for axes, sizes in ((("data", "model"), (8, 1)), (("data", "model"),
                                                      (1, 1)),
                        (("pod", "data"), (2, 4)), (("data",), (3,))):
        got = shard_axis(tuple(Axis(a, s, 0, ()) for a, s in zip(axes,
                                                                 sizes)))
        assert (got.name, got.size) == want(axes, sizes)


def test_rotation_matches_ring_ownership():
    """Row r of the rotated layout holds chunk (r+1)%n, the chunk rank r
    owns after a ring reduce-scatter."""
    n = 4
    rot = tb.rotate_to_shards(torch.arange(n * CHUNK, dtype=torch.float32),
                              n).reshape(n, CHUNK)
    for r in range(n):
        k = (r + 1) % n
        assert torch.equal(rot[r], torch.arange(k * CHUNK, (k + 1) * CHUNK,
                                                dtype=torch.float32))


@pytest.mark.parametrize("reduced,bucket_mb", PLANS)
@pytest.mark.parametrize("n_shards", [1, 3])
def test_packed_state_matches_reference(reduced, bucket_mb, n_shards):
    want_plan, plan = _plans(reduced, bucket_mb)
    tree = _tree(plan)
    want = jstate.init_packed_shards(tree, want_plan, n_shards)
    got = tstate.init_packed_shards(tree_map(torch.from_numpy, tree), plan,
                                    n_shards)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mom = tstate.init_packed_momentum(plan, n_shards)
    assert [m.shape[0] for m in mom] == \
        [w.shape[0] for w in jstate.init_packed_momentum(want_plan,
                                                         n_shards)]
    assert not any(m.any() for m in mom)
    back = tstate.full_params_from_shards(got, plan, n_shards)
    ref_back = jstate.full_params_from_shards(want, want_plan, n_shards)
    for (p, x), (_, y), (_, z) in zip(tree_flatten(tree),
                                      tree_flatten(back),
                                      tree_flatten(jax.device_get(ref_back))):
        np.testing.assert_array_equal(y.numpy(), x, err_msg=p)
        np.testing.assert_array_equal(np.asarray(z), x, err_msg=p)
    # a rank keeps its own row of the global layout
    for r in range(n_shards):
        rows = tstate.local_shards(got, n_shards, r)
        for row, g in zip(rows, got):
            assert torch.equal(row, g.reshape(n_shards, -1)[r])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pack_group_matches_reference(dtype):
    want_plan, plan = _plans(True, 0.25)
    tree = _tree(plan, seed=1)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jleaves = list(reversed(jax.tree_util.tree_leaves(tree)))
    tleaves = list(reversed([torch.from_numpy(x) for _, x in
                             tree_flatten(tree)]))
    i = 0
    for gj, gt in zip(want_plan.groups, plan.groups):
        ids = plan.slot_tensor_ids[i:i + len(gt)]
        i += len(gt)
        want = jb.pack_group([jleaves[t] for t in ids], gj, dtype=jdt)
        got = tb.pack_group([tleaves[t] for t in ids], gt, dtype=tdt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))
        for a, b in zip(tb.unpack_group(got, gt),
                        jb.unpack_group(want, gj)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _shards(plan, n_shards, k, seed):
    """Rank-k shards of p, g, m and the shard segment maps (numpy)."""
    rng = np.random.default_rng(seed)
    sizes = tb.shard_sizes(plan, n_shards)
    draw = lambda s: [(s * rng.standard_normal(c)).astype(np.float32)
                      for c in sizes]
    segs = [m[k].copy() for m in tb.shard_segment_ids(plan, n_shards)]
    return draw(1.0), draw(0.01), draw(0.001), segs


@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
def test_lars_packed_update_plain_matches_reference(lr_kind):
    """The plain K2 (``kernels/ref``, what a CPU tensor runs) against the
    reference's ``ref.lars_packed_update`` and its Pallas kernel in
    interpret mode, at the reference's tolerance
    (``tests/test_kernels.py``): rtol 1e-5 / atol 1e-6. Shards of a plan
    with split tensors, sharded 3 ways (padding chunks repeat an id)."""
    _, plan = _plans(True, 0.25)
    p, g, m, segs = _shards(plan, 3, 1, seed=2)
    trust = np.random.default_rng(3).uniform(
        0.001, 1.0, plan.n_tensors).astype(np.float32)
    lr = 0.37 if lr_kind == "float" else torch.tensor(0.37)
    kw = dict(momentum=0.9, wd=5e-5)
    for b in range(0, plan.n_buckets, 5):
        args = (p[b], g[b], m[b], trust, segs[b])
        got = ops.lars_packed_update(*map(torch.from_numpy, args), lr=lr,
                                     **kw)
        jargs = tuple(map(jnp.asarray, args))
        for want in (jref.lars_packed_update(*jargs, lr=0.37, **kw),
                     jlars_update.lars_packed_update(*jargs, lr=0.37,
                                                     interpret=True, **kw)):
            for x, y in zip(got, want):
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           rtol=1e-5, atol=1e-6)


def test_lars_packed_update_in_place_on_cpu():
    _, plan = _plans(True, 0.25)
    p, g, m, segs = _shards(plan, 1, 0, seed=4)
    t = lambda x: torch.from_numpy(x.copy())
    trust = torch.rand(plan.n_tensors)
    want = ops.lars_packed_update(t(p[0]), t(g[0]), t(m[0]), trust,
                                  t(segs[0]), lr=0.5, momentum=0.9, wd=1e-4)
    pin, min_ = t(p[0]), t(m[0])
    got = ops.lars_packed_update(pin, t(g[0]), min_, trust, t(segs[0]),
                                 lr=0.5, momentum=0.9, wd=1e-4, inplace=True)
    assert got[0] is pin and got[1] is min_
    assert torch.equal(pin, want[0]) and torch.equal(min_, want[1])


def _one_device_mesh():
    return jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))


@pytest.mark.parametrize("kind,update_kernel", [("lars", False),
                                                ("lars", True),
                                                ("sgdm", False)])
def test_sharded_update_matches_reference(kind, update_kernel):
    """``sharded_update_from_shards`` (trust norms from per-shard partial
    sums, then the packed update) against the reference's, run inside a
    1-device ``shard_map``; the reference's ``update_kernel`` is its
    Pallas kernel in interpret mode. f32 sums in another order: 1e-6."""
    want_plan, plan = _plans(True, 0.25)
    p, g, m, _ = _shards(plan, 1, 0, seed=5)
    p[2][:] = 0.0                       # a zero shard: trust falls back to 1
    cfg_j = jlars.OptConfig(kind=kind)
    cfg_t = lars.OptConfig(kind=kind)

    def fn(ps, gs, ms):
        return jlars.sharded_update_from_shards(
            list(ps), list(gs), list(ms), 0.3, cfg_j, want_plan,
            shard_axis="data", n_shards=1, update_kernel=update_kernel,
            interpret=True)
    spec = tuple(P() for _ in p)
    want = jax.jit(jax.shard_map(fn, mesh=_one_device_mesh(),
                                 in_specs=(spec, spec, spec),
                                 out_specs=(spec, spec),
                                 check_vma=False))(
        tuple(p), tuple(g), tuple(m))
    got = lars.sharded_update_from_shards(
        [torch.from_numpy(x) for x in p], [torch.from_numpy(x) for x in g],
        [torch.from_numpy(x) for x in m], torch.tensor(0.3), cfg_t, plan,
        shard_axis=ONE_RANK, n_shards=1, update_kernel=update_kernel)
    for gs, ws in zip(got, want):
        for x, y in zip(gs, ws):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                       atol=1e-6)


def test_make_shard_sinks_match_rs_output_shapes():
    _, plan = _plans(True, 0.25)
    for n_shards in (1, 2, 8):
        sinks = ddp.make_shard_sinks(plan, n_shards)
        assert len(sinks) == plan.n_buckets
        for s, c in zip(sinks, tb.shard_sizes(plan, n_shards)):
            assert s.shape == (c,) and s.dtype == torch.float32
            assert s.requires_grad and not s.detach().any()


@pytest.mark.parametrize("strategy", ["psum", "ring", "bucketed"])
def test_in_backward_scatter_equals_post_backward_on_one_rank(strategy):
    """The gradient-sink identities (split tensors chained through several
    groups) hand back what ``reduce_scatter_grads`` gives after the
    backward, and the replicated overlap identities what
    ``allreduce_grads`` gives: equal, since one rank reduces nothing."""
    _, plan = _plans(True, 0.25)
    tree = tree_map(torch.from_numpy, _tree(plan, seed=6))
    kw = dict(strategy=strategy, axes=(ONE_RANK,), comm_dtype=torch.float32)

    def loss(p):
        return sum((torch.sin(x) * x).sum() for _, x in tree_flatten(p))

    sinks = ddp.make_shard_sinks(plan, 1)
    wrapped = ddp.wrap_params_for_overlap(tree, plan, shard_sinks=sinks,
                                          **kw)
    got = torch.autograd.grad(loss(wrapped), sinks)
    leaves = [x.clone().requires_grad_() for _, x in tree_flatten(tree)]
    grads = tree_unflatten(plan.paths, torch.autograd.grad(
        loss(tree_unflatten(plan.paths, leaves)), leaves))
    want = ddp.reduce_scatter_grads(grads, plan=plan, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    wrapped = ddp.wrap_params_for_overlap(
        tree_unflatten(plan.paths, leaves), plan, **kw)
    got = torch.autograd.grad(loss(wrapped), leaves)
    want = ddp.allreduce_grads(grads, plan=plan, **kw)
    for a, (_, b) in zip(got, tree_flatten(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
