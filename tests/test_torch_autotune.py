"""The port's cost model, bucket autotuner and drift scoring
(``repro_torch.comm.cost``, ``comm.autotune``, ``obs.drift``) against the
JAX package's, in one process, with the reference's own constants passed
in: the port holds only the H100's (``launch/hw.py``), so each function
that reads a constant takes it through ``links=`` or ``hw=``, and with the
reference's link, HBM and FLOP/s figures it must give the reference's
numbers. Covered: every costed schedule on the local, the (pod, data) and
the production meshes; ResNet-50's and qwen1.5-0.5b's full-width trees
(descriptors only, nothing is computed); every ``sharding`` x ``gather``
policy; ``plan_for('auto')``; ``CommPlan.retarget`` of an ``'auto'``
plan; and the drift rows of replicated, zero1 and zero3 plans. The
arithmetic is the same Python float arithmetic in both, so the results
are compared exactly, or to 1e-12 relative where numpy's and the port's
sums may associate differently."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.comm import autotune as jtune
from repro.comm import cost as jcost
from repro.comm import plan as jplan
from repro.configs import get_config as jget_config
from repro.configs.base import CommConfig as JCommConfig
from repro.launch import mesh as jmesh
from repro.models.registry import build_model as jbuild_model
from repro.obs import drift as jdrift
from repro.obs import trace as jtrace
from repro_torch import comm as tcomm
from repro_torch.comm import autotune as ttune
from repro_torch.comm import cost as tcost
from repro_torch.comm import plan as tplan
from repro_torch.configs import get_config
from repro_torch.configs.base import CommConfig
from repro_torch.core import bucketing, pinit
from repro_torch.launch import hw
from repro_torch.models.registry import build_model
from repro_torch.obs import drift as tdrift
from repro_torch.obs import trace as ttrace
from repro_torch.train.step import make_loss_fn

pytestmark = pytest.mark.tier1

#: the reference's constants (``repro/launch/mesh.py``), as a Hardware
#: record: the port itself holds none of them
REF_HW = hw.Hardware(
    name="the reference's constants", link_alpha=jmesh.ICI_ALPHA,
    link_bw=jmesh.ICI_BW, pod_alpha=jmesh.DCI_ALPHA, pod_bw=jmesh.DCI_BW,
    hbm_bw=jmesh.HBM_BW, peak_flops_bf16=jmesh.PEAK_FLOPS_BF16)

MESHES = {"data4": (("data", "model"), (4, 1)),
          "pod2x2": (("pod", "data"), (2, 2)),
          "prod": (("pod", "data", "model"), (2, 16, 16))}
POLICIES = (("replicated", "at_end"), ("zero1", "ahead"),
            ("zero1", "at_end"), ("zero2", "at_end"),
            ("zero3", "per_group"), ("zero3", "ahead"))
SCHEDULES = ("psum", "bucketed", "ring", "hierarchical", "2d_torus",
             "dbtree")
ARCHS = ("resnet50", "qwen1.5-0.5b")


def _links(axes):
    return tcost.default_links(axes, REF_HW)


_TREES = {}


def _trees(arch):
    """(reference tree, port tree) of the full-width model's descriptors."""
    if arch not in _TREES:
        _TREES[arch] = (jbuild_model(jget_config(arch)).param_pd,
                        build_model(get_config(arch)).param_pd)
    return _TREES[arch]


def _same_breakdown(got, want):
    assert got.schedule == want.schedule
    assert got.n_messages == want.n_messages
    assert got.wire_bytes == want.wire_bytes
    assert got.time_s == pytest.approx(want.time_s, rel=1e-12)
    assert [(p.name, p.messages, p.wire_bytes, p.link.alpha, p.link.bw)
            for p in got.phases] == \
        [(p.name, p.messages, p.wire_bytes, p.link.alpha, p.link.bw)
         for p in want.phases]


def _same_sim(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, float):
            assert a == pytest.approx(b, rel=1e-12, abs=1e-300), f.name
        else:
            assert a == b, f.name


def test_registries_and_candidates_agree():
    assert tcomm.available() == jcomm.available()
    assert ttune.CANDIDATES_MB == jtune.CANDIDATES_MB
    for axes, _ in MESHES.values():
        assert {a: (l.alpha, l.bw) for a, l in _links(axes).items()} == \
            {a: (l.alpha, l.bw) for a, l in jcost.default_links(axes).items()}


def test_port_defaults_are_the_cards_not_the_tpus():
    """Without ``links``/``hw`` the port prices with ``launch.hw.H100``,
    none of whose figures is one of the reference's TPU constants."""
    ref = {jmesh.ICI_ALPHA, jmesh.ICI_BW, jmesh.DCI_ALPHA, jmesh.DCI_BW,
           jmesh.HBM_BW, jmesh.PEAK_FLOPS_BF16}
    h = hw.H100
    assert not ref & {h.link_alpha, h.link_bw, h.pod_alpha, h.pod_bw,
                      h.hbm_bw, h.peak_flops_bf16}
    assert tcost.default_links(("data",))["data"].alpha == h.link_alpha
    assert tcost.lars_update_time_s(1000) == 5 * 4 * 1000 / h.hbm_bw


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_predict_matches_reference(schedule, mesh):
    axes, sizes = MESHES[mesh]
    for payload, nb in ((4 * 2 ** 20, 1), (102_400_000, 16), (3e9, 224)):
        _same_breakdown(
            tcost.predict(schedule, axes, sizes, payload, n_buckets=nb,
                          links=_links(axes)),
            jcost.predict(schedule, axes, sizes, payload, n_buckets=nb))
        _same_breakdown(
            tcost.predict_reduce_scatter(schedule, axes, sizes, payload,
                                         n_buckets=nb, links=_links(axes)),
            jcost.predict_reduce_scatter(schedule, axes, sizes, payload,
                                         n_buckets=nb))
    _same_breakdown(
        tcost.predict_all_gather(axes, sizes, 5e8, n_buckets=7,
                                 links=_links(axes)),
        jcost.predict_all_gather(axes, sizes, 5e8, n_buckets=7))
    assert tcost.shard_axis_size(axes, sizes) == \
        jcost.shard_axis_size(axes, sizes)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_predict_table_matches_reference(mesh):
    axes, sizes = MESHES[mesh]
    got = tcost.predict_table(axes, sizes, 1e8, n_buckets=8,
                              links=_links(axes))
    want = jcost.predict_table(axes, sizes, 1e8, n_buckets=8)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_breakdown(g, w)
    with pytest.raises(KeyError):
        tcost.predict("nope", axes, sizes, 1.0, links=_links(axes))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", [2, 4, 16])
def test_param_memory_matches_reference(arch, n):
    jtree, ttree = _trees(arch)
    for mb in (1.0, 4.0):
        jp = jtune.bucketing.make_plan(jtree, bucket_mb=mb)
        tp = bucketing.make_plan(ttree, bucket_mb=mb)
        assert tp.group_elems == jp.group_elems
        assert tp.bucket_bytes(2) == jp.bucket_bytes(2)
        assert [[(s.path, s.elem_offset) for s in t] for t in
                tp.tensor_slots] == \
            [[(s.path, s.elem_offset) for s in t] for t in jp.tensor_slots]
        assert tp.bucket_sizes == jp.bucket_sizes
        for sharding in ("replicated", "zero1", "zero2", "zero3"):
            for wb in (2, 4):
                got = tcost.param_memory(tp, n, sharding=sharding,
                                         wire_dtype_bytes=wb)
                want = jcost.param_memory(jp, n, sharding=sharding,
                                          wire_dtype_bytes=wb)
                assert dataclasses.astuple(got) == dataclasses.astuple(want)
                assert got.peak_bytes == want.peak_bytes
        got = tcost.param_memory(tp, n, sharding="zero3",
                                 streaming_spans=False)
        want = jcost.param_memory(jp, n, sharding="zero3",
                                  streaming_spans=False)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert tcost.param_memory_reduction(tp, n) == \
            jcost.param_memory_reduction(jp, n)
        assert tcost.padded_bucket_elems(tp, n) == \
            jcost.padded_bucket_elems(jp, n)


def test_update_and_backward_estimates_match_reference():
    for n_elems, n in ((25_557_032, 1), (463_987_712, 4), (1000, 8)):
        assert tcost.lars_update_time_s(n_elems, n, hw=REF_HW) == \
            jcost.lars_update_time_s(n_elems, n)
    for family in ("conv", "dense", None):
        assert ttune.backward_flops_per_param(family) == \
            jtune.backward_flops_per_param(family)
        f = ttune.backward_flops_per_param(family)
        assert ttune.estimate_backward_time(
            463_987_712, flops_per_param=f, hw=REF_HW) == \
            jtune.estimate_backward_time(463_987_712, flops_per_param=f)
    for args in ((None, None), ("zero3", None), (None, "at_end"),
                 ("zero2", None)):
        for su in (False, True):
            assert ttune.resolve_policy(*args, shard_update=su) == \
                jtune.resolve_policy(*args, shard_update=su)


#: a measured profile, as one profiled step would give it: the curve's
#: points at 0.5 MB group boundaries, most of the time at the end (the
#: stacked leaves), and a forward time
def _profiles(jtree, ttree):
    plan = bucketing.make_plan(ttree, bucket_mb=0.5)
    cum = tuple(int(c) for c in np.cumsum(plan.bucket_sizes))
    t = np.linspace(0.0, 1.0, len(cum)) ** 6 * 0.7 + 1e-4
    kw = dict(cum_elems=cum, cum_time_s=tuple(float(x) for x in t),
              t_forward_s=0.35)
    return jtune.BackwardProfile(**kw), ttune.BackwardProfile(**kw)


@pytest.mark.parametrize("policy", POLICIES, ids="-".join)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("arch", ARCHS)
def test_autotune_matches_reference(arch, schedule, policy):
    """The chosen bucket size, plan and every field of the simulated
    timeline, on (data 4) with the FLOPs model and on (pod 2, data 2) with
    a measured profile."""
    sharding, gather = policy
    jtree, ttree = _trees(arch)
    family = jget_config(arch).family
    jprof, tprof = _profiles(jtree, ttree)
    for mesh, prof in (("data4", False), ("pod2x2", True)):
        axes, sizes = MESHES[mesh]
        kw = dict(schedule=schedule, axes=axes, sizes=sizes,
                  family=family, sharding=sharding, gather=gather)
        want = jtune.autotune(jtree, profile=jprof if prof else None, **kw)
        got = ttune.autotune(ttree, profile=tprof if prof else None,
                             links=_links(axes), hw=REF_HW, **kw)
        assert got.bucket_mb == want.bucket_mb
        assert got.schedule == want.schedule
        assert got.n_buckets == want.n_buckets
        assert got.plan.bucket_sizes == want.plan.bucket_sizes
        _same_sim(got.sim, want.sim)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mb", [0.5, 4.0, 32.0])
def test_simulate_and_backward_times_match_reference(arch, mb):
    jtree, ttree = _trees(arch)
    jprof, tprof = _profiles(jtree, ttree)
    jp = jtune.bucketing.make_plan(jtree, bucket_mb=mb)
    tp = bucketing.make_plan(ttree, bucket_mb=mb)
    for prof in (None, (jprof, tprof)):
        got = ttune.backward_times(tp, 0.5, prof and prof[1])
        want = jtune.backward_times(jp, 0.5, prof and prof[0])
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    axes, sizes = MESHES["prod"]
    for sharding, gather in POLICIES:
        for tf in (None, 0.2):
            _same_sim(ttune.simulate(tp, "2d_torus", axes, sizes,
                                     t_backward_s=0.5, profile=tprof,
                                     sharding=sharding, gather=gather,
                                     t_forward_s=tf, links=_links(axes),
                                     hw=REF_HW),
                      jtune.simulate(jp, "2d_torus", axes, sizes,
                                     t_backward_s=0.5, profile=jprof,
                                     sharding=sharding, gather=gather,
                                     t_forward_s=tf))
    # the deprecated booleans resolve as the enum does
    _same_sim(ttune.simulate(tp, "ring", ("data",), (8,), t_backward_s=0.1,
                             shard_update=True, gather_ahead=False,
                             links=_links(("data",)), hw=REF_HW),
              jtune.simulate(jp, "ring", ("data",), (8,), t_backward_s=0.1,
                             shard_update=True, gather_ahead=False))


@pytest.mark.parametrize("policy", POLICIES, ids="-".join)
@pytest.mark.parametrize("arch", ARCHS)
def test_best_plan_matches_reference(arch, policy):
    sharding, gather = policy
    jtree, ttree = _trees(arch)
    axes, sizes = MESHES["pod2x2"]
    want = jtune.best_plan(jtree, axes=axes, sizes=sizes, sharding=sharding,
                           gather=gather, family=jget_config(arch).family)
    got = ttune.best_plan(ttree, axes=axes, sizes=sizes, sharding=sharding,
                          gather=gather, family=jget_config(arch).family,
                          links=_links(axes), hw=REF_HW)
    assert (got.schedule, got.bucket_mb, got.n_buckets) == \
        (want.schedule, want.bucket_mb, want.n_buckets)
    _same_sim(got.sim, want.sim)


@pytest.mark.parametrize("strategy", ["ring", "auto", "naive"])
@pytest.mark.parametrize("policy", [("zero1", "ahead"), ("zero3", None)],
                         ids=["zero1", "zero3"])
def test_plan_for_auto_matches_reference(strategy, policy):
    sharding, gather = policy
    jtree, ttree = _trees("resnet50")
    fields = dict(strategy=strategy, bucket_mb="auto", sharding=sharding,
                  gather=gather)
    mesh = MESHES["pod2x2"]
    want = jcomm.plan_for(JCommConfig(**fields), mesh, jtree,
                          family="conv")
    got = tcomm.plan_for(CommConfig(**fields), mesh, ttree, family="conv",
                         links=_links(mesh[0]), hw=REF_HW)
    assert tplan.to_dict(got) == jplan.to_dict(want)


@pytest.mark.parametrize("target", [(("data",), (2,)),
                                    (("pod", "data"), (2, 2))],
                         ids=["data2", "pod2xdata2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_retarget_of_an_auto_plan_matches_reference(arch, target):
    """An ``'auto'`` zero1 plan resolved on (data 4), retargeted onto the
    new mesh (re-autotuned there): every field equal, and its
    ``comm_config(reautotune=True)`` hands back ``'auto'``."""
    jtree, ttree = _trees(arch)
    family = jget_config(arch).family
    fields = dict(strategy="ring", bucket_mb="auto", sharding="zero1")
    src = MESHES["data4"]
    jp = jcomm.plan_for(JCommConfig(**fields), src, jtree, family=family)
    tp = tcomm.plan_for(CommConfig(**fields), src, ttree, family=family,
                        links=_links(src[0]), hw=REF_HW)
    assert tplan.to_dict(tp) == jplan.to_dict(jp)
    axes, sizes = target
    want = jp.retarget(axes, sizes, jtree, family=family)
    got = tp.retarget(axes, sizes, ttree, family=family, links=_links(axes),
                      hw=REF_HW)
    assert tplan.to_dict(got) == jplan.to_dict(want)
    assert got.comm_config(reautotune=True).bucket_mb == "auto"
    assert got.comm_config(reautotune=False).bucket_mb == got.bucket_mb


def _spans(pkg, names, steps=3):
    """Synthetic traced bucket spans of ``steps`` steps: span k of step s
    lasts (k + 1) * (s + 2) microseconds, plus a compute span."""
    out = []
    for s in range(steps):
        t = float(s)
        for k, name in enumerate(names):
            out.append(pkg.Span(name, "comm", t, t + (k + 1) * (s + 2) * 1e-6,
                                step=s))
        out.append(pkg.Span("backward", "compute", t, t + 0.01, step=s))
    return out


@pytest.mark.parametrize("case", [
    dict(strategy="psum", bucket_mb=1.0),
    dict(strategy="ring", bucket_mb=0.25, sharding="zero1"),
    dict(strategy="hierarchical", bucket_mb=0.5, sharding="zero3"),
    dict(strategy="ring", bucket_mb=1.0, sharding="zero2")],
    ids=["psum", "zero1", "zero3", "zero2"])
def test_drift_matches_reference(case):
    """``predicted_span_times`` of a plan resolved by both packages,
    ``compute`` over the same traced spans (the first step skipped, a
    median over the rest), ``aggregate`` and the emitted rows."""
    jtree = jbuild_model(jget_config("resnet50").reduced()).param_pd
    ttree = build_model(get_config("resnet50").reduced()).param_pd
    mesh = MESHES["pod2x2"]
    jp = jcomm.plan_for(JCommConfig(**case), mesh, jtree)
    tp = tcomm.plan_for(CommConfig(**case), mesh, ttree)
    links = _links(mesh[0])
    want = jdrift.predicted_span_times(jp)
    got = tdrift.predicted_span_times(tp, links=links)
    assert got == pytest.approx(want, rel=1e-12)
    names = sorted(want) + ["ar[b999]"]        # one the plan does not know
    jd = jdrift.compute(_spans(jtrace, names), jp)
    td = tdrift.compute(_spans(ttrace, names), tp, links=links)
    assert [(d.name, d.kind) for d in td] == [(d.name, d.kind) for d in jd]
    for a, b in zip(td, jd):
        assert a.measured_s == b.measured_s
        assert a.predicted_s == pytest.approx(b.predicted_s, rel=1e-12)
        assert a.rel_err == pytest.approx(b.rel_err, rel=1e-9)
    assert tdrift.aggregate(td) == pytest.approx(jdrift.aggregate(jd),
                                                 rel=1e-9)
    assert tdrift.measured_span_times({"rs[b0]": 1.5, "forward": 2.0}) == \
        jdrift.measured_span_times({"rs[b0]": 1.5, "forward": 2.0})
    for name in ("rs[b3]", "ag[g0]", "ar[b1]", "backward", "rsx"):
        assert tdrift.span_kind(name) == jdrift.span_kind(name)
    from repro_torch.obs import metrics as tm
    reg = tm.Registry()
    sink = reg.add_sink(tm.MemorySink())
    agg = tdrift.emit(td, tp, registry=reg)
    assert agg == tdrift.aggregate(td)
    assert [e.name for e in sink.events] == \
        ["obs.drift.span"] * len(td) + [f"obs.drift.{tp.schedule}.rel_err"]


def test_measured_profile_on_the_cpu():
    """``measure_backward_profile`` on the reduced LM: every 0.5 MB group
    stamped once, a non-decreasing curve over the plan's cumulative
    elements, a positive forward time; it feeds ``autotune``."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    model = build_model(cfg)
    params = pinit.materialize(model.param_pd, 0, "cpu")
    from repro_torch.data.synthetic import token_batch
    batch = token_batch(cfg, batch=2, seq=32, step=0, device="cpu")
    loss = make_loss_fn(model)
    prof = ttune.measure_backward_profile(lambda p: loss(p, batch)[0],
                                          params)
    plan = bucketing.make_plan(params, bucket_mb=0.5)
    assert prof.cum_elems == tuple(int(c) for c in
                                   np.cumsum(plan.bucket_sizes))
    assert all(b >= a for a, b in zip(prof.cum_time_s, prof.cum_time_s[1:]))
    assert prof.total_s > 0 and prof.t_forward_s > 0
    tuned = ttune.autotune(model.param_pd, schedule="ring", axes=("data",),
                           sizes=(4,), profile=prof, sharding="zero1")
    assert tuned.sim.t_backward_s == prof.total_s
    assert math.isfinite(tuned.sim.t_step_s)


def test_probes_pass_gradients_through_unchanged():
    """The probe identities stamp each group once a backward and change no
    gradient: the same gradients as the plain loss's, bit for bit."""
    from repro_torch.core import ddp
    from repro_torch.tree import tree_flatten, tree_unflatten
    cfg = get_config("qwen1.5-0.5b").reduced()
    model = build_model(cfg)
    params = pinit.materialize(model.param_pd, 1, "cpu")
    from repro_torch.data.synthetic import token_batch
    batch = token_batch(cfg, batch=2, seq=16, step=0, device="cpu")
    loss = make_loss_fn(model)
    plan = bucketing.make_plan(params, bucket_mb=0.1)
    flat = tree_flatten(params)

    def grads(probe):
        leaves = [x.detach().requires_grad_() for _, x in flat]
        p = tree_unflatten([k for k, _ in flat], leaves)
        if probe is not None:
            p = ddp.wrap_params_for_probe(
                ddp.mark_forward_start(p, probe), plan, probe)
        out = loss(p, batch)[0]
        if probe is not None:
            out = ddp.mark_backward_start(out, probe)
        return torch.autograd.grad(out, leaves)

    calls = []
    got = grads(calls.append)
    want = grads(None)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert calls[0] == -2 and calls[1] == -1
    assert sorted(calls[2:]) == list(range(plan.n_buckets))


def test_fit_alpha_beta_recovers_the_cost_models_form():
    """``launch.hw``'s fit of ``alpha + bytes / beta`` gives back a line it
    was given exactly (residual ~0) and fits a noisy one to its own
    residual; its measurements of HBM and matmul rates run on the CPU."""
    nb = hw.LINK_BYTES
    alpha, beta, res = hw.fit_alpha_beta(nb, [3e-5 + x / 2e11 for x in nb])
    assert alpha == pytest.approx(3e-5, rel=1e-9)
    assert beta == pytest.approx(2e11, rel=1e-9) and res < 1e-9
    noisy = [(3e-5 + x / 2e11) * (1.1 if i % 2 else 0.9)
             for i, x in enumerate(nb)]
    alpha, beta, res = hw.fit_alpha_beta(nb, noisy)
    assert 0.05 < res <= 0.2 and alpha > 0 and beta > 0
    dev = torch.device("cpu")
    assert hw.measure_hbm(dev, nbytes=2 ** 20, iters=2) > 0
    assert hw.measure_matmul(dev, n=64, iters=2) > 0
