"""The port's fault injection, guard and recovery ladder
(``repro_torch.train.faults``, ``.guard``, ``.loop``) against the JAX
package's: the fault specs and injector, the detector's trips on one
scripted sequence, the rollback ring and the LR re-warmup bit for bit; the
sentinel's skip gate on the ``xla`` and zero1 steps (no update is run on a
skipped step); the loop's nan-skip replay, spike rollback, checkpoint
restore, exhaustion, watchdog restore and SIGTERM drain; and a guarded
ZeRO-1 ``nan@2`` run against the reference's run of the same loop
(``torch_reference.py guard_zero1_run``, the shard_map shim's subprocess)
at the step tolerance, with the same event sequence."""
import math

import numpy as np
import pytest
import torch
import torch_reference

from repro.train import faults as jfaults
from repro.train import guard as jguard
from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.configs.base import CommConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.core import lars
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.registry import build_model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import faults, guard, loop
from repro_torch.train import state as st
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_flatten

pytestmark = pytest.mark.tier1


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    return torch_reference.run(
        "guard_zero1_run", str(tmp_path_factory.mktemp("ref") / "g.npz"))


@pytest.fixture(scope="module")
def mesh():
    m = make_local_mesh(device="cpu")
    yield m
    m.destroy()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """This file's ResNet steps on two intra-op threads. The suite runs
    six workers on the CPU; with torch's default of a thread a core in
    each, a reduced ResNet step took ~20 s there against ~0.1 s alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------ faults and guard


SPECS = ["stall@3:2.5, kill@7", "nan@3, spike@6:50, corrupt@4:manifest",
         "corrupt@4", "corrupt@4:payload", "corrupt@4:plan", "sigterm@1",
         "", None]
BAD_SPECS = ["explode@3", "stall@3", "kill@x", "stall@1:0", "spike@3",
             "spike@3:0", "corrupt@4:bogus", "nan@x"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_faults_matches_reference(spec):
    want = jfaults.parse_faults(spec)
    got = faults.parse_faults(spec)
    assert [(f.kind, f.step, f.arg, f.target) for f in got] == \
        [(f.kind, f.step, f.arg, f.target) for f in want]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_fault_specs_are_rejected_alike(spec):
    with pytest.raises(jfaults.FaultSpecError) as want:
        jfaults.parse_faults(spec)
    with pytest.raises(faults.FaultSpecError) as got:
        faults.parse_faults(spec)
    assert str(got.value) == str(want.value)


def test_injector_fires_once_like_the_reference(tmp_path):
    spec = "nan@2, spike@3:50, spike@5:2, corrupt@1:plan"
    inj, jinj = (faults.FaultInjector(faults.parse_faults(spec)),
                 jfaults.FaultInjector(jfaults.parse_faults(spec)))
    batch = {"images": torch.ones(2, 3),
             "labels": torch.zeros(2, dtype=torch.int32)}
    for step in range(7):
        got = inj.poison_batch(batch, step)
        want = jinj.poison_batch({k: v.numpy() for k, v in batch.items()},
                                 step)
        for k in batch:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        assert inj.loss_scale(step) == jinj.loss_scale(step)
    assert torch.isnan(batch["images"]).sum() == 0     # a copy is poisoned
    assert inj.any_pending == jinj.any_pending is True  # corrupt not fired
    with pytest.raises(faults.FaultSpecError, match="no float leaf"):
        faults.poison_nan({"tokens": torch.zeros(3, dtype=torch.int64)})
    # corrupt@..:plan against a save with no CommPlan: a loud spec error
    p = ckpt.save(st.TrainState(0, {"w": torch.zeros(2)},
                                {"w": torch.zeros(2)}), str(tmp_path),
                  tag="step00000001")
    with pytest.raises(faults.FaultSpecError, match="CommPlan"):
        inj.on_saved(p, 1)


def test_detector_trips_like_the_reference():
    """One scripted (loss, grad-norm) sequence: cold start, a spike, the
    held trip, re-arming, a loss spike and a nonfinite value."""
    seq = [(2.0, 10.0), (2.1, 11.0), (1.9, 9.0), (2.0, 10.5), (2.0, 200.0),
           (2.0, 150.0), (2.0, 12.0), (2.0, 11.0), (30.0, 10.0),
           (2.0, 10.0), (2.0, 10.0), (math.nan, 1.0), (2.0, 10.0)]
    for cfg in ({}, {"ema_beta": 0.5, "spike_factor": 3.0,
                     "min_history": 1}):
        d, jd = (guard.DivergenceDetector(guard.GuardConfig(**cfg)),
                 jguard.DivergenceDetector(jguard.GuardConfig(**cfg)))
        for loss, gnorm in seq:
            assert d.observe(loss, gnorm) == jd.observe(loss, gnorm)
            assert (d.ema_loss, d.ema_gnorm, d.n_ok, d.tripped) == \
                (jd.ema_loss, jd.ema_gnorm, jd.n_ok, jd.tripped)


@pytest.mark.parametrize("n", [0, 1, 3, 8])
def test_rewarmup_scale_bit_equal(n):
    got, want = guard.rewarmup_scale_fn(n), jguard.rewarmup_scale_fn(n)
    for k in range(-2, n + 4):
        assert got(k) == want(k)
        assert np.float32(got(k)) == got(k)


def test_rollback_ring_keeps_copies():
    """Snapshots share no memory with the live state, which the sharded
    step updates in place, and a restore hands out tensors of its own."""
    ring = guard.RollbackRing(2)
    assert ring.newest() is None and len(guard.RollbackRing(0)) == 0
    s = st.TrainState(1, {"w": torch.zeros(3)}, (torch.zeros(5),), None,
                      (torch.ones(5),))
    ring.snapshot(s)
    s.shards[0].add_(1.0)                  # the in-place update
    s.mom[0].fill_(7.0)
    step, snap = ring.newest()
    assert step == 1 and float(snap.shards[0][0]) == 1.0
    assert float(snap.mom[0][0]) == 0.0
    back = guard.RollbackRing.restore(snap)
    back.shards[0].add_(5.0)
    assert float(ring.newest()[1].shards[0][0]) == 1.0
    for i in (2, 3, 4):
        ring.snapshot(s._replace(step=i))
    assert len(ring) == 2 and ring.newest()[0] == 4


# ------------------------------------------------------------- sentinel


def _resnet():
    cfg = get_config("resnet50").reduced()
    return cfg, build_model(cfg), make_schedule(ScheduleConfig(
        **torch_reference.GUARD_LR))


def _count(monkeypatch, fn_name):
    calls = []
    real = getattr(lars, fn_name)
    monkeypatch.setattr(lars, fn_name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("path", ["xla", "zero1"])
def test_sentinel_skips_before_any_update(monkeypatch, mesh, path):
    """A clean guarded step equals the unguarded step bit for bit (with
    ``gnorm``/``nonfinite``/``skipped`` added) and runs the update once; a
    NaN batch returns the input state itself, ``step`` not advanced, and
    runs no update (so no norm or update kernel on the card)."""
    cfg, model, sched = _resnet()
    kw = (dict(comm=CommConfig(update_kernel=True,
                               **torch_reference.ZERO1_COMM), mesh=mesh)
          if path == "zero1" else {})
    opt = lars.OptConfig(use_kernel=True)
    plain = make_train_step(model, opt, sched, **kw)
    guarded = make_train_step(model, opt, sched, guard=True, **kw)
    assert guarded.guarded and not plain.guarded
    with pytest.raises(TypeError):
        guarded(None, None)                      # guard_in is required
    fresh = lambda: st.init_state(   # noqa: E731
        model, 0, device="cpu", **st.sharded_state_kwargs(plain))
    batch = make_batch_fn(cfg, InputShape("t", "train", 0, 2),
                          device="cpu")(0)
    update = _count(monkeypatch, "sharded_update_from_shards"
                    if path == "zero1" else "update")
    s1, m1 = plain(fresh(), batch)
    s2, m2 = guarded(fresh(), batch, guard.neutral_inputs())
    assert len(update) == 2
    for (p, a), (_, b) in zip(tree_flatten(weights.to_numpy(s1.params)),
                              tree_flatten(weights.to_numpy(s2.params))):
        np.testing.assert_array_equal(a, b, err_msg=p)
    for a, b in zip(s1.shards or (), s2.shards or ()):
        assert torch.equal(a, b)
    assert float(m2["skipped"]) == 0 and float(m2["nonfinite"]) == 0
    assert float(m2["gnorm"]) > 0 and set(m1) | set(
        guard.SENTINEL_KEYS) == set(m2)
    s0 = fresh()
    before = [x.clone() for _, x in tree_flatten(s0.params)]
    s3, m3 = guarded(s0, faults.poison_nan(batch), guard.neutral_inputs())
    assert s3 is s0 and s3.step == 0 and len(update) == 2
    assert float(m3["skipped"]) == 1 and float(m3["nonfinite"]) > 0
    for a, (_, b) in zip(before, tree_flatten(s3.params)):
        assert torch.equal(a, b)


# ----------------------------------------------------------- the loop


def _zero1_run(mesh, faults_spec, init, batches):
    """The guarded reduced ZeRO-1 step (the fused update's plain version,
    in place) through ``loop.train`` from the reference's initial params
    and batches: (final state, history, event names, step)."""
    cfg, model, sched = _resnet()
    step = make_train_step(
        model, lars.OptConfig(kind="lars"), sched, mesh=mesh, guard=True,
        comm=CommConfig(update_kernel=True, **torch_reference.ZERO1_COMM))
    params = weights.params_from_jax(init["params"], cfg, "cpu")
    plan = step.bucket_plan
    s = st.TrainState(
        0, params, st.local_shards(st.init_packed_momentum(plan), 1, 0),
        weights.bn_state_from_jax(init["bn_state"], cfg, "cpu"),
        st.local_shards(st.init_packed_shards(params, plan), 1, 0))
    sink = obs_metrics.MemorySink()
    with obs_metrics.default_registry().use_sink(sink):
        s, hist = loop.train(
            s, step, lambda k: {n: torch.from_numpy(v)
                                for n, v in batches[str(int(k))].items()},
            steps=torch_reference.GUARD_STEPS, log_every=1,
            faults=faults_spec)
    return s, hist, [e.name for e in sink.events], step


@pytest.fixture(scope="module")
def port_runs(mesh, ref_run):
    """The port's guarded ZeRO-1 run with ``GUARD_FAULTS`` and without
    (the oracle), from the reference run's initial params and batches."""
    init = {"params": ref_run["call0"]["in"]["params"],
            "bn_state": ref_run["call0"]["in"]["bn_state"]}
    batches = {str(int(ref_run[f"call{k}"]["in"]["step"])):
               ref_run[f"call{k}"]["batch"] for k in (0, 1, 3, 4)}
    return (_zero1_run(mesh, torch_reference.GUARD_FAULTS, init, batches),
            _zero1_run(mesh, None, init, batches))


def _masters(s, step):
    return dict(tree_flatten(weights.to_numpy(
        st.full_params_from_shards(s.shards, step.bucket_plan))))


def test_nan_skip_replays_to_the_oracle(port_runs):
    """nan@2: exactly one skip, the run ends at step 4 with masters equal
    to the uninjected run's bit for bit (the update in place)."""
    (s, _, events, step), (o, _, o_events, _) = port_runs
    assert s.step == o.step == 4
    assert events.count("guard_skip") == 1 and "guard_skip" not in o_events
    got, want = _masters(s, step), _masters(o, step)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def _inplace_state():
    return st.TrainState(0, {"w": torch.ones(4)}, (torch.zeros(4),), None,
                         (torch.ones(4),))


def _inplace_step(state, batch, guard_in):
    """A guarded step that writes its state in place, as the sharded step
    with the fused update does: a rollback snapshot that were a view of
    the state would follow it, and the replay would differ."""
    g = (state.shards[0] - 0.5) * float(guard_in["loss_scale"])
    ok, metrics = guard.check({"loss": torch.tensor(1.0)}, [g])
    lr = torch.tensor(0.1) * torch.tensor(guard_in["lr_scale"])
    if not ok:
        return state, dict(metrics, lr=lr)
    state.mom[0].mul_(0.9).add_(lr * g)
    state.shards[0].sub_(state.mom[0])
    return (st.TrainState(state.step + 1, state.params, state.mom, None,
                          state.shards), dict(metrics, lr=lr))


_inplace_step.guarded = True


def _ladder(faults_spec, **kw):
    sink = obs_metrics.MemorySink()
    with obs_metrics.default_registry().use_sink(sink):
        s, hist = loop.train(_inplace_state(), _inplace_step, _fake_batch,
                             steps=8, log_every=1, faults=faults_spec, **kw)
    return s, hist, [e.name for e in sink.events]


def test_spike_rolls_back_to_the_oracle():
    """spike@4:1e4 on a step that updates in place: the detector (armed
    after 3 ok steps) trips on the grad-norm, the ring rolls back without
    checkpoint IO, and the replay ends equal to the unspiked run bit for
    bit; a re-warmup window scales the replayed steps' LR."""
    s, hist, events = _ladder("spike@4:1e4")
    o, _, _ = _ladder(None)
    assert events.count("guard_rollback") == 1 and "run_stop" in events
    assert events.count("guard_ckpt_restore") == 0
    assert any("guard_rollback" in h for h in hist)
    assert s.step == o.step == 8 and torch.equal(s.shards[0], o.shards[0])
    assert torch.equal(s.mom[0], o.mom[0])
    r, hist_r, _ = _ladder("spike@4:1e4",
                           guard=guard.GuardConfig(rewarmup_steps=2))
    lrs = [round(h["lr"], 6) for h in hist_r if "lr" in h]
    assert lrs[:4] == [0.1] * 4 and lrs[4:6] == [0.05, 0.1]
    assert not torch.equal(r.shards[0], o.shards[0])


def test_ckpt_restore_rung_and_exhaustion(tmp_path):
    """With no ring the detector's trip escalates to a checkpoint restore
    (in new tensors); with no checkpoint either, the ladder is
    exhausted."""
    gcfg = guard.GuardConfig(ring_capacity=0)
    s, hist, events = _ladder("spike@4:1e4", guard=gcfg,
                              ckpt_dir=str(tmp_path), ckpt_every=2)
    o, _, _ = _ladder(None)
    assert events.count("guard_ckpt_restore") == 1 and s.step == 8
    assert any(h.get("guard_restore") for h in hist)
    assert torch.equal(s.shards[0], o.shards[0])
    with pytest.raises(RuntimeError, match="exhausted its recovery ladder"):
        _ladder("spike@4:1e4", guard=gcfg)
    with pytest.raises(ValueError, match="guarded step"):
        loop.train(None, lambda s, b: None, None, steps=1,
                   guard=guard.GuardConfig())


def _fake_state(v=0.0):
    return st.TrainState(0, {"w": torch.full((4,), v)},
                         {"w": torch.zeros(4)})


def _fake_step(state, batch):
    w = state.params["w"]
    return (st.TrainState(state.step + 1, {"w": w + 1.0}, state.mom),
            {"loss": torch.tensor(1.0), "lr": torch.tensor(0.1)})


def _fake_batch(step):
    return {"x": torch.zeros(1)}


def test_watchdog_restores_and_retries(tmp_path):
    """stall@2: the watchdog abandons the step, restores the last good
    checkpoint (new tensors) and retries; the run ends right."""
    d = str(tmp_path)
    sink = obs_metrics.MemorySink()
    with obs_metrics.default_registry().use_sink(sink):
        s, h = loop.train(_fake_state(), _fake_step, _fake_batch, steps=4,
                          ckpt_dir=d, ckpt_every=1, step_timeout_s=0.5,
                          log_every=0, retry_backoff_s=0.01,
                          faults="stall@2:1.5")
    assert s.step == 4 and torch.equal(s.params["w"], torch.full((4,), 4.0))
    assert [e.name for e in sink.events if e.name.startswith("watchdog")] \
        == ["watchdog_timeout", "watchdog_restore"]
    assert any("watchdog_restore" in e for e in h)
    import time

    def slow(state, batch):
        time.sleep(0.4)
        return _fake_step(state, batch)
    with pytest.raises(RuntimeError, match="bounded retries"):
        loop.train(_fake_state(), slow, _fake_batch, steps=2,
                   step_timeout_s=0.1, max_step_retries=2,
                   retry_backoff_s=0.01, log_every=0)


def test_sigterm_drains_and_saves_once(tmp_path):
    d = str(tmp_path)
    sink = obs_metrics.MemorySink()
    with obs_metrics.default_registry().use_sink(sink):
        s, _ = loop.train(_fake_state(), _fake_step, _fake_batch, steps=10,
                          ckpt_dir=d, ckpt_every=1, log_every=0,
                          faults="sigterm@1")
    assert s.step == 2                  # step 1 drained, then early exit
    saves = [e.value["step"] for e in sink.find("checkpoint_saved")]
    assert saves == [1, 2]
    assert ckpt.load(_fake_state(), d).step == 2
    stop = sink.find("run_stop")[0].value
    assert stop["preempted"] is True and stop["steps"] == 2


def test_corrupt_fault_falls_back_at_load(tmp_path):
    d = str(tmp_path)
    loop.train(_fake_state(), _fake_step, _fake_batch, steps=2, ckpt_dir=d,
               ckpt_every=1, log_every=0, faults="corrupt@2")
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.verify(d, "step00000002")
    assert ckpt.load(_fake_state(), d).step == 1


# ------------------------------------------------- against the reference


def _relnorm(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_guarded_zero1_nan_run_matches_reference(port_runs, ref_run):
    """The reference's guarded ZeRO-1 run through its loop (nan@2, 4 steps,
    the plain update) against the port's: the same event sequence and
    history shape from the same params and batches; then each of the
    reference loop's five step calls (the skipped one included) taken by
    the port's guarded step from the reference's own input state, as
    ``test_torch_zero1.py`` takes steps (a bf16 ResNet at this size is
    chaotic, so parity is step by step): the same skip decision, the
    skipped call returning its input, loss at rtol 3e-3, the grad-norm at
    1e-2 (measured 4e-4) and the update at that file's bounds."""
    s, hist, events, step = port_runs[0]
    assert events == list(ref_run["events"])
    assert s.step == int(ref_run["step"]) == 4
    assert [(h["step"], "guard_skip" in h) for h in hist] == \
        [(int(w[0]), bool(w[4])) for w in ref_run["history"]]
    cfg = get_config("resnet50").reduced()
    plan = step.bucket_plan
    bufs = lambda t: [t[str(b)] for b in range(len(t))]  # noqa: E731
    to_state = lambda x: weights.state_from_jax(   # noqa: E731
        __import__("types").SimpleNamespace(
            step=x["step"], params=x["params"], bn_state=x["bn_state"],
            mom=bufs(x["mom"]), shards=bufs(x["shards"])), cfg, "cpu")
    tree = lambda b: dict(tree_flatten(weights.to_numpy(  # noqa: E731
        st.full_params_from_shards(b, plan))))
    assert int(ref_run["calls"]) == 5
    for k in range(5):
        ref = ref_run[f"call{k}"]
        s_in = to_state(ref["in"])
        p_in = tree(s_in.shards)
        out, m = step(s_in, {n: torch.from_numpy(v)
                             for n, v in ref["batch"].items()},
                      guard.neutral_inputs())
        want_m = ref["metrics"]
        assert float(m["skipped"]) == float(want_m["skipped"]), k
        assert float(m["lr"]) == float(want_m["lr"])
        if float(want_m["skipped"]):
            assert out is s_in and out.step == int(ref["out"]["step"])
            assert float(m["nonfinite"]) > 0 and not math.isfinite(
                float(m["gnorm"]))
            continue
        assert out.step == int(ref["out"]["step"]) == \
            int(ref["in"]["step"]) + 1
        np.testing.assert_allclose(float(m["loss"]), float(want_m["loss"]),
                                   rtol=3e-3)
        np.testing.assert_allclose(float(m["gnorm"]), float(want_m["gnorm"]),
                                   rtol=1e-2)
        got, want = tree(out.shards), tree(to_state(ref["out"]).shards)
        upd = {p: _relnorm(got[p] - p_in[p], want[p] - p_in[p])
               for p in want}
        # test_torch_zero1.py's bounds (measured there: worst 0.147,
        # median 0.005)
        assert max(upd.values()) <= 0.5, max(upd.items(), key=lambda t: t[1])
        assert np.median(list(upd.values())) <= 0.25
