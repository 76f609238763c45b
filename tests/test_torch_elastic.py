"""The port's n→m reshard (``repro_torch.train.elastic``) against the JAX
package's (``repro.train.elastic``), in one process: ``reshard_buffers``
bit-equal to the reference's for every (old, new) shard count in
{1, 2, 4, 8}² across two bucket plans, a legacy split-free plan resharded
into a split-leaf one, the same error paths, and ``load_resharded`` from a
reference n = 4 checkpoint into an n = 2 template (and onto a one-rank
mesh) equal to the reference's own resume. Reference states come from
numpy (no reference step runs)."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.comm import plan as jplan_mod
from repro.configs import get_config as jget_config
from repro.configs.base import CommConfig as JCommConfig
from repro.core import bucketing as jb
from repro.models import resnet as jresnet
from repro.train import checkpoint as jckpt
from repro.train import elastic as jelastic
from repro.train import state as jstate
from repro_torch.comm import plan as tplan_mod
from repro_torch.configs import get_config
from repro_torch.core import bucketing as tb
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import resnet
from repro_torch.models.registry import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import elastic
from repro_torch.train.state import TrainState, full_params_from_shards
from repro_torch.tree import tree_flatten, tree_unflatten

pytestmark = pytest.mark.tier1

OLD_MB, NEW_MB = 0.25, 0.5


def _pds():
    return (jresnet.resnet_pd(jget_config("resnet50").reduced()),
            resnet.resnet_pd(get_config("resnet50").reduced()))


def _np_tree(pd_tree, seed):
    rng = np.random.default_rng(seed)
    flat = tree_flatten(pd_tree)
    return tree_unflatten([p for p, _ in flat], [
        rng.standard_normal(tuple(pd.shape)).astype(np.float32)
        for _, pd in flat])


def _jax(t):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in t.items()}


def _torch(t):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in t.items()}


@pytest.fixture(scope="module")
def setup():
    (jppd, jspd), (tppd, tspd) = _pds()
    params, bn = _np_tree(tppd, 0), _np_tree(tspd, 1)
    plans = {mb: (jb.make_plan(jppd, bucket_mb=mb),
                  tb.make_plan(tppd, bucket_mb=mb)) for mb in (OLD_MB, NEW_MB)}
    return params, bn, plans


@functools.lru_cache(maxsize=None)
def _cached_global(n):
    """``_global`` of the module's params under the 0.25 MB plan."""
    (jppd, _), (tppd, _) = _pds()
    return _global(_np_tree(tppd, 0), jb.make_plan(jppd, bucket_mb=OLD_MB),
                   n, 2)


def _global(params, jplan, n, seed):
    """Masters and momentum of one plan and shard count, as the reference
    lays them out (numpy); the momentum random but zero in every padding
    element, as a real run's is."""
    shards = [np.array(b) for b in
              jstate.init_packed_shards(_jax(params), jplan, n)]
    rng = np.random.default_rng(seed)
    mom_tree = tree_unflatten(*zip(*[
        (p, rng.standard_normal(v.shape).astype(np.float32))
        for p, v in tree_flatten(params)]))
    mom = [np.array(b) for b in
           jstate.init_packed_shards(_jax(mom_tree), jplan, n)]
    return shards, mom


@pytest.mark.parametrize("new_n", [1, 2, 4, 8])
@pytest.mark.parametrize("old_n", [1, 2, 4, 8])
def test_reshard_buffers_bit_equal_to_reference(setup, old_n, new_n):
    _, _, plans = setup
    (ja, ta), (jbp, tbp) = plans[OLD_MB], plans[NEW_MB]
    shards, mom = _cached_global(old_n)
    for bufs in (shards, mom):
        want = jelastic.reshard_buffers([jnp.asarray(b) for b in bufs], ja,
                                        old_n, jbp, new_n)
        got = elastic.reshard_buffers(bufs, ta, old_n, tbp, new_n)
        assert len(got) == len(want) == tbp.n_buckets
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # and back: the masters round-trip exactly
        back = elastic.reshard_buffers(got, tbp, new_n, ta, old_n)
        for g, b in zip(back, bufs):
            np.testing.assert_array_equal(g.numpy(), b)


def test_legacy_unsplit_plan_reshards_into_split_leaves():
    """A v2 plan of the reference's legacy packing (``split_leaves=False``:
    an oversized leaf in a bucket of its own) loads in the port through
    ``CommPlan.bucket_plan`` verbatim and reshards into the port's
    split-leaf plan bit-equal to the reference's reshard."""
    chunk = tb.CHUNK
    rng = np.random.default_rng(2)
    tree = {"giant": rng.standard_normal(7 * chunk + 19).astype(np.float32),
            "w": rng.standard_normal((40, 11)).astype(np.float32)}
    mb = 2 * chunk * 2 / 2 ** 20
    legacy = jb.make_plan(_jax(tree), bucket_mb=mb, split_leaves=False)
    assert max(legacy.bucket_sizes) > 2 * chunk
    cp = jplan_mod.make(JCommConfig(strategy="ring", bucket_mb=mb,
                                    sharding="zero1"), legacy,
                        resolved_bucket_mb=mb, mesh_axes=("data",),
                        mesh_sizes=(8,), shard_axis="data", n_shards=8)
    d = jplan_mod.to_dict(cp)
    d["version"] = 2
    d["slots"] = [list(row)[:6] for row in d["slots"]]
    tp = tplan_mod.from_dict(d).bucket_plan(_torch(tree))
    assert tp.bucket_sizes == legacy.bucket_sizes
    new_j = jb.make_plan(_jax(tree), bucket_mb=mb)
    new_t = tb.make_plan(_torch(tree), bucket_mb=mb)
    assert any(s.elem_offset for s in new_t.slots)
    old = [np.array(b) for b in jstate.init_packed_shards(_jax(tree),
                                                          legacy, 8)]
    want = jelastic.reshard_buffers([jnp.asarray(b) for b in old], legacy,
                                    8, new_j, 4)
    got = elastic.reshard_buffers(old, tp, 8, new_t, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = full_params_from_shards(got, new_t, 4)
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_reshard_error_paths_match_reference(setup):
    params, _, plans = setup
    ja, ta = plans[OLD_MB]
    shards, _ = _global(params, ja, 2, 3)
    for bad in (shards[:-1], [shards[0][:-1024]] + shards[1:]):
        with pytest.raises(jelastic.ElasticResumeError) as want:
            jelastic.reshard_buffers([jnp.asarray(b) for b in bad], ja, 2,
                                     ja, 4)
        with pytest.raises(elastic.ElasticResumeError) as got:
            elastic.reshard_buffers(bad, ta, 2, ta, 4)
        assert str(got.value).replace("torch.Size", "") == \
            str(want.value).replace("torch.Size", "")
    assert issubclass(elastic.ElasticResumeError, ckpt.CheckpointError)


def _ref_ckpt(d, params, bn, plans, n=4, with_plan=True):
    """A reference zero1 checkpoint of n global shards at step 6 (0.25 MB
    plan), with its CommPlan."""
    ja, _ = plans[OLD_MB]
    shards, mom = _global(params, ja, n, 4)
    s = jstate.TrainState(jnp.int32(6), _jax(params),
                          tuple(jnp.asarray(m) for m in mom), _jax(bn),
                          tuple(jnp.asarray(x) for x in shards))
    cp = jcomm.plan_for(JCommConfig(strategy="psum", bucket_mb=OLD_MB,
                                    sharding="zero1"),
                        (("data", "model"), (n, 1)), _pds()[0][0])
    jckpt.save(s, d, tag="step00000006",
               comm_plan=cp if with_plan else None)
    return shards, mom


def _templates(params, bn, plans, n):
    """(port, reference) fresh templates of the 0.5 MB plan on n shards
    (global buffers), other values than the checkpoint's."""
    jbp, tbp = plans[NEW_MB]
    model = build_model(get_config("resnet50").reduced())
    t = elastic.make_template(model, tbp, n, seed=5, device="cpu")
    j = jstate.TrainState(
        jnp.int32(0), _jax(_np_tree(_pds()[1][0], 9)),
        jstate.init_packed_momentum(jbp, n), _jax(bn),
        jstate.init_packed_momentum(jbp, n))
    return t, j


def test_load_resharded_from_reference_n4_into_n2(tmp_path, setup):
    params, bn, plans = setup
    d = str(tmp_path)
    _ref_ckpt(d, params, bn, plans)
    (jbp, tbp) = plans[NEW_MB]
    t_tmpl, j_tmpl = _templates(params, bn, plans, 2)
    want = jelastic.load_resharded(d, j_tmpl, jbp, 2)
    got = elastic.load_resharded(d, t_tmpl, tbp, 2)
    assert got.step == int(want.step) == 6
    for field in ("shards", "mom"):
        for g, w in zip(getattr(got, field), getattr(want, field)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for (p, g), (_, w) in zip(tree_flatten(got.params),
                              tree_flatten(params)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=p)
    for (p, g), (_, w) in zip(tree_flatten(got.bn_state), tree_flatten(bn)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=p)
    # onto a one-rank mesh: that rank's row is the whole n = 1 layout
    mesh = make_local_mesh(device="cpu")
    try:
        model = build_model(get_config("resnet50").reduced())
        one = elastic.load_resharded(
            d, elastic.make_template(model, tbp, 1, mesh=mesh), tbp, 1,
            mesh=mesh)
    finally:
        mesh.destroy()
    want1 = jelastic.reshard_buffers(
        [jnp.asarray(np.asarray(b)) for b in want.shards], jbp, 2, jbp, 1)
    for g, w in zip(one.shards, want1):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_load_resharded_error_paths_match_reference(tmp_path, setup):
    params, bn, plans = setup
    jbp, tbp = plans[NEW_MB]
    t_tmpl, j_tmpl = _templates(params, bn, plans, 2)
    t_plain = TrainState(0, t_tmpl.params, {"x": torch.zeros(1)},
                         t_tmpl.bn_state)
    j_plain = jstate.TrainState(jnp.int32(0), j_tmpl.params,
                                {"x": jnp.zeros(1)}, j_tmpl.bn_state)
    d_sh, d_np, d_plain = (str(tmp_path / x) for x in ("sh", "np", "pl"))
    _ref_ckpt(d_sh, params, bn, plans)
    _ref_ckpt(d_np, params, bn, plans, with_plan=False)
    jckpt.save(j_plain, d_plain, tag="plain")
    cases = [(d_plain, t_tmpl, j_tmpl, "non-sharded"),
             (d_sh, t_plain, j_plain, "sharded resume template"),
             (d_np, t_tmpl, j_tmpl, "carries no CommPlan")]
    for d, tt, jt, what in cases:
        with pytest.raises(jelastic.ElasticResumeError) as want:
            jelastic.load_resharded(d, jt, jbp, 2)
        with pytest.raises(elastic.ElasticResumeError, match=what) as got:
            elastic.load_resharded(d, tt, tbp, 2)
        assert str(got.value) == str(want.value)
    # a non-sharded checkpoint into a non-sharded template: a plain load
    r = elastic.load_resharded(d_plain, t_plain, None, 1)
    assert r.step == 0 and r.shards is None
    # a template of another plan than the one it is resharded into
    t_other, _ = _templates(params, bn, plans, 4)
    with pytest.raises(elastic.ElasticResumeError, match="template layout"):
        elastic.load_resharded(d_sh, t_other, tbp, 2)
    cp = dataclasses.replace(ckpt.load_comm_plan(d_sh), n_shards=2)
    with pytest.raises(elastic.ElasticResumeError, match="expected"):
        elastic.load_resharded(d_sh, t_tmpl, tbp, 2, old_comm_plan=cp)
