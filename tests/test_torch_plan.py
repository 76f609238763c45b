"""The port's CommPlan (``repro_torch.comm.plan``) against the JAX
package's (``repro.comm.plan``), in one process: a plan written by either
package loads in the other with every field equal, the reference's v1 and
v2 payloads upgrade to equal v3 plans, both reject the same malformed
payloads, and ``plan_for`` and the explicit step's ``comm_plan`` resolve
as the reference's ``plan_for`` does."""
import dataclasses
import json

import pytest

from repro import comm as jcomm
from repro.comm import plan as jplan
from repro.configs import get_config as jget_config
from repro.configs.base import CommConfig as JCommConfig
from repro.models import resnet as jresnet
from repro_torch import comm as tcomm
from repro_torch.comm import plan as tplan
from repro_torch.configs import get_config
from repro_torch.configs.base import CommConfig
from repro_torch.core import bucketing, lars
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.launch.mesh import Axis, Mesh
from repro_torch.models import resnet
from repro_torch.models.registry import build_model
from repro_torch.train.step import make_train_step

pytestmark = pytest.mark.tier1

#: (CommConfig fields, mesh axes, sizes): every rung and gather policy,
#: split tensors (0.25 MB) and whole ones, one and two data axes
CASES = {
    "zero1_psum_025": (dict(strategy="psum", bucket_mb=0.25,
                            sharding="zero1", update_kernel=True),
                       ("data", "model"), (4, 1)),
    "replicated_ring_4": (dict(strategy="ring", bucket_mb=4.0),
                          ("data", "model"), (1, 1)),
    "zero1_at_end_f32": (dict(strategy="hierarchical", bucket_mb=1.0,
                              sharding="zero1", gather="at_end",
                              wire_dtype="f32", overlap=False),
                         ("pod", "data"), (2, 2)),
    "zero2": (dict(strategy="2d_torus", bucket_mb=0.5, sharding="zero2"),
              ("pod", "data"), (2, 4)),
    "zero3_per_group": (dict(strategy="dbtree", bucket_mb=0.25,
                             sharding="zero3", use_kernel=True),
                        ("data", "model"), (8, 1)),
}


def _pds():
    return (jresnet.resnet_pd(jget_config("resnet50").reduced())[0],
            resnet.resnet_pd(get_config("resnet50").reduced())[0])


def _plans(name):
    fields, axes, sizes = CASES[name]
    jpd, tpd = _pds()
    want = jcomm.plan_for(JCommConfig(**fields), (axes, sizes), jpd)
    got = tcomm.plan_for(CommConfig(**fields), (axes, sizes), tpd)
    return want, got


def _fields(p):
    return dataclasses.asdict(p)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_for_matches_reference_and_round_trips(name):
    want, got = _plans(name)
    assert _fields(got) == _fields(want)
    # written by the reference, read by the port, and back
    from_ref = tplan.loads(jplan.dumps(want))
    assert _fields(from_ref) == _fields(want)
    from_port = jplan.loads(tplan.dumps(got))
    assert _fields(from_port) == _fields(got)
    assert tplan.dumps(got) == jplan.dumps(want)
    assert tplan.loads(tplan.dumps(got)) == got


@pytest.mark.parametrize("name", sorted(CASES))
def test_saved_plan_loads_in_other_package(tmp_path, name):
    want, got = _plans(name)
    jplan.save(want, str(tmp_path / "ref.json"))
    tplan.save(got, str(tmp_path / "port.json"))
    assert _fields(tplan.load(str(tmp_path / "ref.json"))) == _fields(want)
    assert _fields(jplan.load(str(tmp_path / "port.json"))) == _fields(got)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["port.json",
                                                          "ref.json"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_bucket_plan_rebuilds_the_packing(name):
    """``CommPlan.bucket_plan(template)`` rebuilds the port's own plan
    slot for slot, from a tree of tensors or of descriptors."""
    _, got = _plans(name)
    _, tpd = _pds()
    fields = CASES[name][0]
    want = bucketing.make_plan(
        tpd, bucket_mb=fields["bucket_mb"],
        dtype_bytes=4 if fields.get("wire_dtype") == "f32" else 2)
    assert got.bucket_plan(tpd) == want
    cfg = got.comm_config(reautotune=False)
    assert (cfg.strategy, cfg.sharding, cfg.gather, cfg.bucket_mb) == (
        got.schedule, got.sharding, got.gather, got.bucket_mb)


def _v1_v2(plan_dict):
    v1 = dict(plan_dict, version=1)
    del v1["sharding"], v1["gather"]
    v1["slots"] = [list(row)[:6] for row in v1["slots"]]
    v2 = dict(plan_dict, version=2)
    v2["slots"] = [list(row)[:6] for row in v2["slots"]]
    return v1, v2


@pytest.mark.parametrize("sharding,gather", [("zero1", "ahead"),
                                             ("zero1", "at_end"),
                                             ("replicated", "ahead")])
def test_v1_v2_payloads_upgrade_alike(sharding, gather):
    """The reference's legacy payloads (``tests/test_elastic.py``: v1
    booleans and 6-column slot rows, v2 enums and 6-column rows) upgrade to
    v3 plans equal to the reference's upgrade. 1 MB buckets: no split
    tensors, which a 6-column row cannot describe."""
    jpd, _ = _pds()
    jp = jcomm.plan_for(JCommConfig(strategy="ring", bucket_mb=1.0,
                                    sharding=sharding, gather=gather),
                        (("data", "model"), (4, 1)), jpd)
    assert all(s.elem_offset == 0 for s in jp.slots)
    for legacy in _v1_v2(jplan.to_dict(jp)):
        legacy = json.loads(json.dumps(legacy))
        want, got = jplan.from_dict(legacy), tplan.from_dict(legacy)
        assert got.version == tplan.PLAN_VERSION == 3
        assert _fields(got) == _fields(want) == _fields(jp)
        assert tplan.to_dict(got) == jplan.to_dict(want)


BAD_PAYLOADS = {
    "no_version": '{"schedule": "ring"}',
    "future_version": '{"version": 99}',
    "list": "[1, 2]",
    "missing_field": '{"version": 3, "schedule": "ring"}',
    "bad_slot": None,            # a v3 payload with a non-integer slot
    "not_json": "{ not json",
}


@pytest.mark.parametrize("name", sorted(BAD_PAYLOADS))
def test_malformed_payloads_are_rejected_alike(name):
    text = BAD_PAYLOADS[name]
    if text is None:
        d = jplan.to_dict(_plans("zero1_psum_025")[0])
        d["slots"][0][2] = "many"
        text = json.dumps(d)
    with pytest.raises(jplan.CommPlanError) as want:
        jplan.loads(text)
    with pytest.raises(tplan.CommPlanError) as got:
        tplan.loads(text)
    assert str(got.value) == str(want.value)


def test_short_slot_row_is_a_plan_error():
    """A slot row cut short: the reference's parser lets the IndexError
    out; the port's rejects it as a malformed plan."""
    d = jplan.to_dict(_plans("zero1_psum_025")[0])
    d["slots"][0] = d["slots"][0][:3]
    with pytest.raises(IndexError):
        jplan.from_dict(d)
    with pytest.raises(tplan.CommPlanError, match="malformed"):
        tplan.from_dict(d)


def test_corrupt_file_and_wrong_template_are_rejected(tmp_path):
    want, got = _plans("zero1_psum_025")
    path = str(tmp_path / "p.json")
    tplan.save(got, path)
    with open(path, "r+b") as f:           # the corrupt@s:plan XOR flips
        f.seek(40)
        chunk = f.read(16)
        f.seek(40)
        f.write(bytes(b ^ 0xFF for b in chunk))
    for mod in (jplan, tplan):
        with pytest.raises(mod.CommPlanError):
            mod.load(path)
        with pytest.raises(mod.CommPlanError, match="no CommPlan"):
            mod.load(str(tmp_path / "missing.json"))
    # the full-width model's tree does not reproduce the reduced plan
    full = resnet.resnet_pd(get_config("resnet50"))[0]
    jfull = jresnet.resnet_pd(jget_config("resnet50"))[0]
    with pytest.raises(tplan.CommPlanError,
                       match="does not reproduce") as e_got:
        got.bucket_plan(full)
    import jax.numpy as jnp
    import jax
    jtree = jax.tree.map(lambda pd: jnp.zeros(pd.shape), jfull,
                         is_leaf=lambda x: hasattr(x, "init"))
    with pytest.raises(jplan.CommPlanError) as e_want:
        want.bucket_plan(jtree)
    assert str(e_got.value) == str(e_want.value)


def test_autotune_paths_name_the_roadmap_item():
    """The autotuned paths run (they raised before, naming ROADMAP item
    7b), as the reference's do: ``retarget`` of an explicit plan and of a
    plan that requested ``'auto'`` onto (data 2) and (pod 2, data 2),
    ``comm_config(reautotune=True)`` handing back ``'auto'``, and
    ``plan_for(bucket_mb='auto')``; every field equal to the reference's
    when the port is given the reference's constants (the port's own are
    the H100's, ``launch/hw.py``)."""
    from repro.launch import mesh as jmesh
    from repro_torch.comm import cost
    from repro_torch.launch import hw
    ref_hw = hw.Hardware("the reference's", jmesh.ICI_ALPHA, jmesh.ICI_BW,
                         jmesh.DCI_ALPHA, jmesh.DCI_BW, jmesh.HBM_BW,
                         jmesh.PEAK_FLOPS_BF16)
    want, got = _plans("zero1_psum_025")
    jpd, tpd = _pds()
    auto_w = dataclasses.replace(want, requested_bucket_mb="auto")
    auto_g = dataclasses.replace(got, requested_bucket_mb="auto")
    for axes, sizes in ((("data",), (2,)), (("pod", "data"), (2, 2))):
        links = cost.default_links(axes, ref_hw)
        for w, g in ((want, got), (auto_w, auto_g)):
            assert tplan.to_dict(g.retarget(axes, sizes, tpd, family="conv",
                                            links=links, hw=ref_hw)) == \
                jplan.to_dict(w.retarget(axes, sizes, jpd, family="conv"))
        fields = dict(strategy="ring", bucket_mb="auto", sharding="zero1")
        assert tplan.to_dict(tcomm.plan_for(
            CommConfig(**fields), (axes, sizes), tpd, links=links,
            hw=ref_hw)) == jplan.to_dict(jcomm.plan_for(
                JCommConfig(**fields), (axes, sizes), jpd))
    assert auto_g.comm_config(reautotune=True) == \
        CommConfig(**{**dataclasses.asdict(auto_g.comm_config(
            reautotune=False)), "bucket_mb": "auto"})
    assert auto_g.comm_config(reautotune=False).bucket_mb == got.bucket_mb
    assert auto_w.comm_config(reautotune=True).bucket_mb == "auto"


@pytest.mark.parametrize("comm", [
    CommConfig(strategy="psum", bucket_mb=0.25, sharding="zero1",
               update_kernel=True),
    CommConfig(strategy="naive", bucket_mb=4.0, sharding="zero1"),
    CommConfig(strategy="ring", bucket_mb=1.0, overlap=False)])
def test_explicit_step_carries_its_comm_plan(comm):
    """``make_train_step`` records the effective plan ('naive' downgrades
    to replicated with no overlap), as the reference's step builds it
    (``plan_for`` with the effective overrides)."""
    model = build_model(get_config("resnet50").reduced())
    mesh = Mesh((Axis("data", 1, 0, (0,), None),
                 Axis("model", 1, 0, (0,), None)), __import__("torch")
                .device("cpu"))
    step = make_train_step(model, lars.OptConfig(), make_schedule(
        ScheduleConfig(base_lr=0.1, total_steps=2)), mesh=mesh, comm=comm)
    cp = step.comm_plan
    assert cp.bucket_plan(model.param_pd) == step.bucket_plan
    assert (cp.sharding, cp.gather, cp.overlap, cp.n_shards) == (
        step.sharding, step.gather, step.overlap, step.n_shards)
    jpd, _ = _pds()
    jcfg = JCommConfig(**{f.name: getattr(comm, f.name)
                          for f in dataclasses.fields(comm)
                          if f.name not in ("shard_update", "gather_ahead")})
    want = jcomm.plan_for(jcfg, (("data", "model"), (1, 1)), jpd,
                          resolved_bucket_mb=comm.bucket_mb,
                          strategy=comm.strategy, overlap=step.overlap,
                          sharding=step.sharding, gather=step.gather,
                          n_shards=step.n_shards)
    assert _fields(cp) == _fields(want)
