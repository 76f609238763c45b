"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
JAX package's (``repro.train.checkpoint``), in one process: the same
on-disk format both ways, bit for bit on every tensor, for a replicated
reduced ResNet-50 state, a zero1 state of n = 4 global buffers (the
reference's layout, built with ``mesh=None``) and a reduced qwen1.5-0.5b
``xla`` state; the same manifest, meta and CommPlan; checksum fallback,
retention and the mismatch messages. A 2-rank gloo zero1 save (each rank
holding its rows) loads in the reference as the gathered global buffers.
Reference states are built from numpy with ``jnp.asarray``: no reference
step runs, so nothing here meets the reference's jax 0.9.0 faults."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks

from repro import comm as jcomm
from repro.configs import get_config as jget_config
from repro.configs.base import CommConfig as JCommConfig
from repro.core import bucketing as jb
from repro.models import resnet as jresnet
from repro.obs import metrics as jmetrics
from repro.train import checkpoint as jckpt
from repro.train import state as jstate
from repro_torch import comm as tcomm
from repro_torch.configs import get_config
from repro_torch.configs.base import CommConfig
from repro_torch.core import bucketing as tb
from repro_torch.models import resnet, transformer
from repro_torch.obs import metrics as tmetrics
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.state import TrainState
from repro_torch.tree import tree_flatten, tree_unflatten

pytestmark = pytest.mark.tier1

N_SHARDS = 4
BUCKET_MB = 0.25       # split tensors in the reduced ResNet's plan


def _np_tree(pd_tree, seed):
    rng = np.random.default_rng(seed)
    flat = tree_flatten(pd_tree)
    return tree_unflatten([p for p, _ in flat], [
        rng.standard_normal(tuple(pd.shape)).astype(np.float32)
        for _, pd in flat])


def _torch(np_tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in np_tree.items()}


def _jax(np_tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in np_tree.items()}


def _case(name):
    """(port state, reference state, port plan, reference plan) of the
    same numpy values; plans None for the unsharded states."""
    if name == "qwen_xla":
        cfg = get_config("qwen1.5-0.5b").reduced()
        pd = transformer.lm_pd(cfg)
        params, mom = _np_tree(pd, 1), _np_tree(pd, 2)
        return (TrainState(5, _torch(params), _torch(mom)),
                jstate.TrainState(jnp.int32(5), _jax(params), _jax(mom)),
                None, None)
    cfg, jcfg = get_config("resnet50").reduced(), \
        jget_config("resnet50").reduced()
    ppd, spd = resnet.resnet_pd(cfg)
    params, bn = _np_tree(ppd, 3), _np_tree(spd, 4)
    if name == "resnet_replicated":
        mom = _np_tree(ppd, 5)
        return (TrainState(3, _torch(params), _torch(mom), _torch(bn)),
                jstate.TrainState(jnp.int32(3), _jax(params), _jax(mom),
                                  _jax(bn)), None, None)
    # zero1, n = 4: the global device-major buffers of both packages
    tplan = tb.make_plan(ppd, bucket_mb=BUCKET_MB)
    jplan = jb.make_plan(jresnet.resnet_pd(jcfg)[0], bucket_mb=BUCKET_MB)
    assert any(s.elem_offset for s in tplan.slots)
    shards = [np.array(b) for b in
              jstate.init_packed_shards(_jax(params), jplan, N_SHARDS)]
    rng = np.random.default_rng(6)
    mom = [rng.standard_normal(b.shape).astype(np.float32) for b in shards]
    port = TrainState(7, _torch(params),
                      tuple(torch.from_numpy(m) for m in mom), _torch(bn),
                      tuple(torch.from_numpy(s) for s in shards))
    ref = jstate.TrainState(jnp.int32(7), _jax(params),
                            tuple(jnp.asarray(m) for m in mom), _jax(bn),
                            tuple(jnp.asarray(s) for s in shards))
    return port, ref, tplan, jplan


def _comm_plans(name):
    if name != "resnet_zero1":
        return None, None
    cc = dict(strategy="psum", bucket_mb=BUCKET_MB, sharding="zero1",
              update_kernel=True)
    mesh = (("data", "model"), (N_SHARDS, 1))
    return (tcomm.plan_for(CommConfig(**cc), mesh,
                           resnet.resnet_pd(get_config("resnet50")
                                            .reduced())[0]),
            jcomm.plan_for(JCommConfig(**cc), mesh,
                           jresnet.resnet_pd(jget_config("resnet50")
                                             .reduced())[0]))


def _np_leaves(tree):
    """{key: numpy} of a state field, keyed as the checkpoint keys it."""
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in ckpt._flatten(tree).items()}


def _assert_state_equal(got_t: TrainState, want_j):
    """A port state against a reference state, bit for bit."""
    assert int(got_t.step) == int(want_j.step)
    for f_t, f_j in (("params", "params"), ("mom", "mom"),
                     ("bn_state", "bn_state"), ("shards", "shards")):
        a, b = getattr(got_t, f_t), getattr(want_j, f_j)
        assert (a is None) == (b is None), f_t
        if a is None:
            continue
        got = _np_leaves(a)
        want = {k: np.asarray(v) for k, v in jckpt._flatten(b).items()}
        assert sorted(got) == sorted(want), f_t
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k


CASES = ("resnet_replicated", "resnet_zero1", "qwen_xla")


@pytest.mark.parametrize("name", CASES)
def test_reference_checkpoint_loads_into_the_port(tmp_path, name):
    port, ref, _, _ = _case(name)
    tcp, jcp = _comm_plans(name)
    d = str(tmp_path)
    jckpt.save(ref, d, tag=ckpt.step_tag(int(ref.step)), comm_plan=jcp)
    template = _case(name)[0]._replace(step=0)
    got = ckpt.load(template, d)
    _assert_state_equal(got, ref)
    # new tensors: the template is not written into
    for (_, a), (_, b) in zip(tree_flatten(got.params),
                              tree_flatten(template.params)):
        assert a.data_ptr() != b.data_ptr()
    meta, _, plan = ckpt.load_arrays(d)
    assert meta == {"step": int(ref.step), "sharded": ref.shards is not None,
                    "tag": ckpt.step_tag(int(ref.step))}
    if jcp is not None:
        assert plan == tcp


@pytest.mark.parametrize("name", CASES)
def test_port_checkpoint_loads_into_the_reference(tmp_path, name):
    port, ref, _, _ = _case(name)
    tcp, jcp = _comm_plans(name)
    d = str(tmp_path)
    path = ckpt.save(port, d, tag=ckpt.step_tag(int(port.step)),
                     comm_plan=tcp)
    assert os.path.basename(path) == f"ckpt_{ckpt.step_tag(port.step)}.npz"
    jckpt.verify(d, ckpt.step_tag(port.step))
    got = jckpt.load(ref, d)
    _assert_state_equal(port, got)
    if jcp is not None:
        import dataclasses
        assert dataclasses.asdict(jckpt.load_comm_plan(d)) == \
            dataclasses.asdict(jcp)


@pytest.mark.parametrize("name", CASES)
def test_manifest_meta_and_payload_keys_equal(tmp_path, name):
    port, ref, _, _ = _case(name)
    tcp, jcp = _comm_plans(name)
    dt, dj = str(tmp_path / "port"), str(tmp_path / "ref")
    for tag in ("step00000001", "best", "step00000002"):
        ckpt.save(port, dt, tag=tag, comm_plan=tcp)
        jckpt.save(ref, dj, tag=tag, comm_plan=jcp)
    mt, mj = ckpt.read_manifest(dt), jckpt.read_manifest(dj)
    assert sorted(mt) == sorted(mj)
    assert {k: v for k, v in mt.items() if k != "entries"} == \
        {k: v for k, v in mj.items() if k != "entries"}
    for tag, ej in mj["entries"].items():
        et = mt["entries"][tag]
        assert sorted(et) == sorted(ej)
        assert {k: v for k, v in et.items() if k not in ("sha256", "bytes")} \
            == {k: v for k, v in ej.items() if k not in ("sha256", "bytes")}
        with open(os.path.join(dt, f"meta_{tag}.json")) as f, \
                open(os.path.join(dj, f"meta_{tag}.json")) as g:
            assert f.read() == g.read()
        with np.load(os.path.join(dt, et["file"])) as zt, \
                np.load(os.path.join(dj, ej["file"])) as zj:
            assert sorted(zt.files) == sorted(zj.files)
            for k in zj.files:
                np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj))
    assert ckpt.available_tags(dt) == jckpt.available_tags(dj)
    assert ckpt.latest_tag(dt) == "step00000002"


def _tiny(step, value=0.0, n=4):
    return TrainState(step, {"w": torch.full((n,), float(value))},
                      {"w": torch.zeros(n)})


def _jtiny(step, value=0.0, n=4):
    return jstate.TrainState(jnp.int32(step), {"w": jnp.full((n,), value)},
                             {"w": jnp.zeros((n,))}, None, None)


def test_checksum_fallback_and_retention(tmp_path):
    """A corrupt newest payload is rejected by its checksum and ``tag=None``
    falls back to the previous save, announcing it; ``keep_last_k`` prunes
    step tags only; the reference reads the directory alike."""
    from repro_torch.train import faults
    d = str(tmp_path)
    for s in range(1, 5):
        ckpt.save(_tiny(s, s), d, tag=ckpt.step_tag(s), keep_last_k=2)
    ckpt.save(_tiny(9, 9), d, tag="best")
    ckpt.save(_tiny(5, 5), d, tag=ckpt.step_tag(5), keep_last_k=2)
    assert ckpt.available_tags(d) == ["step00000004", "best", "step00000005"]
    assert not os.path.exists(os.path.join(d, "ckpt_step00000003.npz"))
    faults.corrupt_file(os.path.join(d, "ckpt_step00000005.npz"))
    with pytest.raises(ckpt.CheckpointCorruptError, match="checksum"):
        ckpt.verify(d, "step00000005")
    sink = tmetrics.MemorySink()
    with tmetrics.default_registry().use_sink(sink):
        got = ckpt.load(_tiny(0), d)
    # "best" was saved after step 4: the newest entry that verifies
    assert got.step == 9 and float(got.params["w"][0]) == 9.0
    fell = sink.find("checkpoint_fallback")
    assert [e.value["rejected_tag"] for e in fell] == ["step00000005"]
    assert fell[0].where == "repro_torch/train/checkpoint.py"
    jsink = jmetrics.MemorySink()
    with jmetrics.default_registry().use_sink(jsink):
        want = jckpt.load(_jtiny(0), d)
    assert int(want.step) == 9
    assert [e.value["rejected_tag"] for e in
            jsink.find("checkpoint_fallback")] == ["step00000005"]
    # every entry corrupt: both refuse
    for t in ("best", "step00000004"):
        faults.corrupt_file(os.path.join(d, f"ckpt_{t}.npz"))
    for mod, tmpl in ((ckpt, _tiny(0)), (jckpt, _jtiny(0))):
        with pytest.raises(mod.CheckpointCorruptError,
                           match="every committed checkpoint"):
            mod.load(tmpl, d)


def test_mismatch_messages_equal_the_reference(tmp_path):
    d = str(tmp_path)
    ckpt.save(_tiny(1), d)
    cases = [
        (_tiny(0, n=9), _jtiny(0, n=9), "resume-elastic"),
        (TrainState(0, {"v": torch.zeros(4)}, {"v": torch.zeros(4)}),
         jstate.TrainState(jnp.int32(0), {"v": jnp.zeros(4)},
                           {"v": jnp.zeros(4)}, None, None), "lacks"),
        (_tiny(0)._replace(shards=(torch.zeros(4),)),
         _jtiny(0)._replace(shards=(jnp.zeros(4),)), "non-sharded")]
    for tmpl, jtmpl, what in cases:
        with pytest.raises(ckpt.CheckpointMismatchError, match=what) as got:
            ckpt.load(tmpl, d)
        with pytest.raises(jckpt.CheckpointMismatchError) as want:
            jckpt.load(jtmpl, d)
        assert str(got.value) == str(want.value)
    d2 = str(tmp_path / "sharded")
    ckpt.save(_tiny(1)._replace(shards=(torch.zeros(4),)), d2)
    with pytest.raises(ckpt.CheckpointMismatchError, match="non-sharded"):
        ckpt.load(_tiny(0), d2)
    for bad in (lambda: ckpt.verify(d, "nope"),
                lambda: ckpt.load(_tiny(0), str(tmp_path / "empty"))):
        with pytest.raises(ckpt.CheckpointError):
            bad()
    with pytest.raises(ckpt.CheckpointError, match="carries no CommPlan"):
        ckpt.load_comm_plan(d)
    # a torn manifest: every load through it refuses, naming the manifest
    with open(os.path.join(d, ckpt.MANIFEST), "r+b") as f:
        f.seek(5)
        f.write(b"\xff\xfe")
    with pytest.raises(ckpt.CheckpointCorruptError, match="manifest"):
        ckpt.load(_tiny(0), d)


@pytest.mark.tier2
def test_two_rank_zero1_save_loads_in_the_reference(tmp_path):
    """Two gloo ranks take two ZeRO-1 steps and save with ``mesh``: the
    shard axis's rows are gathered, rank 0 writes; each rank loads its rows
    back bit for bit (checked inside the rank). The reference loads the
    file as the global device-major buffers, which are the ranks' rows in
    rank order."""
    out = torch_ranks.launch("ckpt_zero1", 2, str(tmp_path))
    d = str(tmp_path / "ckpt")
    tag = ckpt.step_tag(2)
    assert ckpt.available_tags(d) == [tag]
    cfg = jget_config("resnet50").reduced()
    jplan = jb.make_plan(jresnet.resnet_pd(cfg)[0], bucket_mb=BUCKET_MB)
    pd = jresnet.resnet_pd(cfg)
    zeros = lambda t: {k: zeros(v) if isinstance(v, dict)   # noqa: E731
                       else jnp.zeros(v.shape) for k, v in t.items()}
    tmpl = jstate.TrainState(
        jnp.int32(0), zeros(pd[0]), jstate.init_packed_momentum(jplan, 2),
        zeros(pd[1]), jstate.init_packed_momentum(jplan, 2))
    got = jckpt.load(tmpl, d)
    assert int(got.step) == 2
    for b in range(jplan.n_buckets):
        for field in ("shards", "mom"):
            rows = np.concatenate([out[r][f"{field}/{b}"] for r in (0, 1)])
            np.testing.assert_array_equal(
                np.asarray(getattr(got, field)[b]), rows)
    assert out[0]["loaded_equal"] == out[1]["loaded_equal"] == 1
    plan = jckpt.load_comm_plan(d)
    assert (plan.n_shards, plan.mesh_sizes, plan.sharding) == (
        2, (2, 1), "zero1")
    with open(os.path.join(d, f"meta_{tag}.json")) as f:
        assert json.load(f) == {"step": 2, "sharded": True, "tag": tag}
