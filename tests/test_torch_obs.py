"""The port's observability (``repro_torch.obs.metrics``, ``.trace``)
against the JAX package's (``repro.obs``): the JSONL sink's rows, counters
and gauges, the StdoutSink line; the tracer's span assembly, abort and
stale-stamp handling; Chrome JSON that the reference's own
``validate_chrome`` accepts and reads back; and a traced reduced ZeRO-1
step whose spans (names and categories) are the reference's traced
step's (``torch_reference.py traced_zero1_step``, the shim's
subprocess)."""
import dataclasses
import json

import pytest
import torch
import torch_reference

from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch.configs import get_config
from repro_torch.configs.base import CommConfig
from repro_torch.core import lars
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.registry import build_model
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.train import state as st
from repro_torch.train.step import make_train_step

pytestmark = pytest.mark.tier1

#: (kind, name, value, step) emitted through both registries
EMITS = [("event", "run_start", None, None),
         ("event", "train_step", {"step": 0, "loss": 2.5, "lr": 0.1}, None),
         ("counter", "obs.guard.skip_total", 1, 2),
         ("counter", "obs.guard.skip_total", 2, 3),
         ("counter", "obs.watchdog_timeout_total", 1, None),
         ("gauge", "obs.guard.gnorm", 12.5, 4),
         ("event", "checkpoint_saved", {"step": 1, "tag": "step00000001"},
          None),
         ("event", "run_stop", {"steps": 4, "wall_s": 1.5,
                                "preempted": False}, None)]


def _emit(reg, where):
    for kind, name, value, step in EMITS:
        if kind == "event":
            reg.event(name, value, where=where, step=step)
        elif kind == "counter":
            reg.counter(name, value, where=where, step=step)
        else:
            reg.gauge(name, value, where=where, step=step)


def test_jsonl_rows_equal_the_reference(tmp_path):
    """Rows equal but for ``ts`` and ``where``; the sink is line-buffered,
    flushed per row, and closed when the registry removes it."""
    rows = {}
    for name, mod in (("port", tmetrics), ("ref", jmetrics)):
        path = str(tmp_path / name / "m.jsonl")
        reg = mod.Registry()
        sink = reg.add_sink(mod.JsonlSink(path))
        _emit(reg, f"{name}/where.py")
        with open(path) as f:              # flushed before removal
            assert len(f.readlines()) == len(EMITS)
        reg.remove_sink(sink)
        if mod is jmetrics:
            sink.close()
        assert sink._f.closed
        with open(path) as f:
            rows[name] = [json.loads(line) for line in f]
    for got, want in zip(rows["port"], rows["ref"]):
        assert set(got) == set(want)
        assert got["where"] == "port/where.py"
        assert {k: v for k, v in got.items() if k not in ("ts", "where")} == \
            {k: v for k, v in want.items() if k not in ("ts", "where")}
    assert len(rows["port"]) == len(rows["ref"]) == len(EMITS)


def test_counters_gauges_and_module_level_helpers():
    got, want = tmetrics.MemorySink(), jmetrics.MemorySink()
    treg, jreg = tmetrics.Registry((got,)), jmetrics.Registry((want,))
    _emit(treg, "w")
    _emit(jreg, "w")
    key = lambda e: (e.name, e.kind, e.value, e.step)  # noqa: E731
    assert [key(e) for e in got.events] == [key(e) for e in want.events]
    assert [e.value for e in got.find("obs.guard.skip_total")] == [1, 3]
    mem = tmetrics.MemorySink()
    with tmetrics.default_registry().use_sink(mem):
        a = tmetrics.counter("obs.test_total", 2)
        b = tmetrics.counter("obs.test_total")
        tmetrics.gauge("obs.test_gauge", 0.5, step=7)
        tmetrics.event("hello")
    assert b == a + 1
    assert [(e.name, e.kind) for e in mem.events] == [
        ("obs.test_total", "counter"), ("obs.test_total", "counter"),
        ("obs.test_gauge", "gauge"), ("hello", "event")]
    assert mem.events[2].step == 7 and mem.events[0].where == "repro_torch"


def test_stdout_line_is_the_reference_line(capsys):
    for value in (None, {"step": 3, "loss": 1.25}, "text"):
        ev = dict(name="train_step", kind="event", value=value,
                  ts=1234.5678901234, where="repro/train/loop.py")
        tmetrics.StdoutSink().emit(tmetrics.Event(**ev))
        got = capsys.readouterr().out
        jmetrics.StdoutSink().emit(jmetrics.Event(**ev))
        assert got == capsys.readouterr().out


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _fill(stamp, begin, end):
    """One window of stamps: forward, two buckets' reduce-scatters (one
    with only its begin), update."""
    begin()
    for name, cat, phase in (("forward", "compute", "B"),
                             ("rs[b0]", "comm", "B"),
                             ("forward", "compute", "E"),
                             ("rs[b0]", "comm", "E"),
                             ("rs[b1]", "comm", "B"),
                             ("update", "compute", "B"),
                             ("update", "compute", "E")):
        stamp(name, cat, phase)
    end(3)


def test_tracer_assembles_like_the_reference():
    t, j = ttrace.Tracer(clock=_Clock()), jtrace.Tracer(clock=_Clock())
    _fill(lambda n, c, p: t.stamp(n, p, None, cat=c, bucket=1),
          t.begin_step, t.end_step)
    _fill(lambda n, c, p: j.callback(n, cat=c, phase=p, bucket=1)(),
          j.begin_step, lambda s: None)
    # the reference's end_step drains jax's callbacks first; assemble the
    # same window as it does
    with j._lock:
        j._pending.append(("step", "step", "E", j._clock(), ()))
        evs, j._pending = j._pending, []
    j.steps.append((3, jtrace._assemble(evs, 3)))
    fields = lambda spans: [dataclasses.astuple(sp)  # noqa: E731
                            for sp in spans]
    assert fields(t.spans()) == fields(j.spans())
    names = [sp.name for sp in t.spans(3)]
    assert sorted(names) == ["forward", "rs[b0]", "rs[b1]", "step",
                             "update"]
    step_span = next(sp for sp in t.spans(3) if sp.name == "step")
    assert all(step_span.t0 <= sp.t0 <= sp.t1 <= step_span.t1
               for sp in t.spans(3))
    rs1 = next(sp for sp in t.spans(3) if sp.name == "rs[b1]")
    assert rs1.dur_s == 0 and rs1.arg("bucket") == 1
    # abort: the open window is dropped; stale stamps of an abandoned step
    # go at the next begin_step; an end without a begin files nothing
    t.begin_step()
    t.stamp("forward", "B", None)
    t.abort_step()
    t.end_step(4)
    t.stamp("late", "E", None)
    t.begin_step()
    t.end_step(5)
    assert [s for s, _ in t.steps] == [3, 5]
    assert [sp.name for sp in t.spans(5)] == ["step"]
    t.instant("watchdog_timeout", step=4, attempt=1)
    with t.host_span("checkpoint_commit", step=5):
        pass
    assert [sp.name for sp in t.spans(4)] == ["watchdog_timeout"]
    assert {sp.name for sp in t.spans(5)} == {"step", "checkpoint_commit"}
    ttrace.mark(None, "x", "B", [])               # tracer None: a no-op
    ttrace.span_deps(t, "ag[b0]", [torch.zeros(1)], [torch.zeros(1)],
                     bucket=0)
    assert len(t._pending) == 2


def test_chrome_json_passes_the_reference_validator(tmp_path):
    t = ttrace.Tracer(clock=_Clock())
    _fill(lambda n, c, p: t.stamp(n, p, None, cat=c),
          t.begin_step, t.end_step)
    t.instant("guard_skip", step=3, attempt=1)
    path = ttrace.export_chrome(t, str(tmp_path / "sub" / "t.json"))
    obj = jtrace.load_chrome(path)              # the reference's validator
    assert ttrace.load_chrome(path) == obj == ttrace.chrome_trace(t)
    assert [dataclasses.astuple(sp) for sp in jtrace.spans_from_chrome(obj)] \
        == [dataclasses.astuple(sp) for sp in ttrace.spans_from_chrome(obj)]
    back = {(sp.name, sp.step) for sp in ttrace.spans_from_chrome(obj)}
    assert back == {(sp.name, sp.step) for sp in t.spans()}
    for bad in ({}, {"traceEvents": {}}, {"traceEvents": [1]},
                {"traceEvents": [{"ph": "X", "name": "a", "pid": 0,
                                  "tid": 0, "ts": 0, "dur": -1}]}):
        for mod in (ttrace, jtrace):
            with pytest.raises(ValueError):
                mod.validate_chrome(bad)


@pytest.fixture(scope="module")
def ref_spans(tmp_path_factory):
    return torch_reference.run(
        "traced_zero1_step", str(tmp_path_factory.mktemp("ref") / "t.npz"))


def test_traced_zero1_step_spans_equal_the_reference(ref_spans):
    """One traced ZeRO-1 step (gather ahead, in-backward reduce-scatter,
    0.25 MB buckets) has the reference's spans: ``forward``, ``backward``,
    ``update`` and per bucket ``ag[b<i>]`` and ``rs[b<i>]``, each inside
    the step window."""
    cfg = get_config("resnet50").reduced()
    model = build_model(cfg)
    mesh = make_local_mesh(device="cpu")
    try:
        tracer = ttrace.Tracer()
        step = make_train_step(
            model, lars.OptConfig(kind="lars"),
            make_schedule(ScheduleConfig(**torch_reference.GUARD_LR)),
            mesh=mesh, comm=CommConfig(**torch_reference.ZERO1_COMM),
            tracer=tracer)
        s = st.init_state(model, 0, device="cpu",
                          **st.sharded_state_kwargs(step))
        b = torch_reference._batch(cfg, 0)
        tracer.begin_step()
        step(s, {k: torch.from_numpy(v) for k, v in b.items()})
        tracer.end_step(0)
    finally:
        mesh.destroy()
    got = {(sp.name, sp.cat) for sp in tracer.spans(0)}
    want = {tuple(row) for row in ref_spans["spans"]}
    assert got == want
    n = step.bucket_plan.n_buckets
    assert {f"rs[b{i}]" for i in range(n)} <= {name for name, _ in got}
    window = next(sp for sp in tracer.spans(0) if sp.name == "step")
    assert all(window.t0 <= sp.t0 <= sp.t1 <= window.t1
               for sp in tracer.spans(0))
