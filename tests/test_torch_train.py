"""The port's replicated train step against the JAX package's
``make_train_step(comm='xla', mesh=None)``, step by step: each of three
LARS steps starts from the reference's own state, with the batched-norm
path off and on. A bf16 ResNet at this size is chaotic (two runs of the
reference that differ only in rounding part after a few free steps), so
parity is per step, against bounds measured on this comparison, and the
optimizer is also held alone to 1e-6. Also the CLI on the CPU, and the
rule that entry points never fall back to the CPU quietly."""
import types

import numpy as np
import pytest
import torch
import torch_reference

from repro_torch import weights
from repro_torch.configs import get_config
from repro_torch.core import lars
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.models.registry import build_model
from repro_torch.train.state import init_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_flatten

pytestmark = pytest.mark.tier1


@pytest.fixture(scope="module")
def ref_steps(tmp_path_factory):
    return torch_reference.run(
        "train_steps", str(tmp_path_factory.mktemp("ref") / "t.npz"))


def _relnorm(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("k", range(torch_reference.STEPS))
def test_step_matches_reference(ref_steps, use_kernel, k):
    ref = ref_steps[f"k{int(use_kernel)}"][f"s{k}"]
    cfg = get_config("resnet50").reduced()
    step = make_train_step(
        build_model(cfg), lars.OptConfig(use_kernel=use_kernel),
        make_schedule(ScheduleConfig(**torch_reference.LR)), mesh=None,
        comm="xla")

    state_in = weights.state_from_jax(
        types.SimpleNamespace(**ref["in"], shards=None), cfg, "cpu")
    batch = {"images": torch.from_numpy(ref["batch"]["images"]),
             "labels": torch.from_numpy(ref["batch"]["labels"])}
    state, metrics = step(state_in, batch)
    want = ref["out"]
    assert state.step == int(want["step"]) == k + 1

    # metrics: the lr is bit-exact; the loss comes from a forward that
    # matches to ~5e-7 (tests/test_torch_resnet.py)
    assert float(metrics["lr"]) == float(ref["metrics"]["lr"])
    # Bounds measured on this comparison (steps 0, 1, 2; both paths give
    # the same numbers), each about twice the worst step or more. The
    # step-0 forward agrees to rounding (tests/test_torch_resnet.py); after
    # the first update at lr 0.5 the BN scales move and more bf16 rounding
    # noise grows through the depth. Loss: relative 0, 7.7e-4, 1.1e-3.
    # BN statistics: 6.5e-7, 5.7e-3, 4.0e-3 of each tensor's max. Update
    # (= momentum) relative L2 per tensor: worst 0.147, 0.228, 0.070;
    # median 0.005, 0.119, 0.029. Params: worst 0.147 (a zero-initialised
    # BN bias, so the update itself). The optimizer alone is held to 1e-6
    # below (test_lars_update_matches_reference).
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(ref["metrics"]["loss"]), rtol=3e-3)
    assert abs(float(metrics["acc"]) - float(ref["metrics"]["acc"])) \
        <= 1 / torch_reference.BATCH + 1e-6
    p_in = dict(tree_flatten(weights.to_numpy(state_in.params)))
    got_p = dict(tree_flatten(weights.to_numpy(state.params)))
    got_m = dict(tree_flatten(weights.to_numpy(state.mom)))
    want_p = dict(tree_flatten(want["params"]))
    want_m = dict(tree_flatten(want["mom"]))
    upd = {p: _relnorm(got_p[p] - p_in[p], want_p[p] - p_in[p])
           for p in want_p}
    mom = {p: _relnorm(got_m[p], want_m[p]) for p in want_m}
    par = {p: _relnorm(got_p[p], want_p[p]) for p in want_p}
    bn = {p: np.abs(g - w).max() / np.abs(w).max()
          for (p, g), (_, w) in zip(
              tree_flatten(weights.to_numpy(state.bn_state)),
              tree_flatten(want["bn_state"]))}
    for errs, worst, median in ((upd, 0.5, 0.25), (mom, 0.5, 0.25)):
        assert max(errs.values()) <= worst, max(errs.items(),
                                                key=lambda t: t[1])
        assert np.median(list(errs.values())) <= median
    assert max(par.values()) <= 0.3
    assert max(bn.values()) <= 0.015, max(bn.items(), key=lambda t: t[1])


@pytest.mark.parametrize("kind,use_kernel", [("lars", False), ("lars", True),
                                             ("sgdm", False), ("lamb", False)])
def test_lars_update_matches_reference(kind, use_kernel):
    """The optimizer alone, on the same params, bf16 grads and momentum:
    conv, BN, head and an all-zero 2-D tensor (trust falls back to 1)."""
    import jax.numpy as jnp
    from repro.core import lars as jlars
    from repro_torch.tree import tree_map, tree_unflatten
    rng = np.random.default_rng(5)
    shapes = dict(tree_flatten({
        "stem": {"conv": (7, 7, 3, 16), "bn": {"scale": (16,),
                                               "bias": (16,)}},
        "s0b0": {"conv2": (3, 3, 16, 16), "proj": (16, 64)},
        "head": {"w": (64, 10), "b": (10,)}}))
    paths = list(shapes)
    draw = lambda s: [(s * rng.standard_normal(shapes[p])).astype(np.float32)
                      for p in paths]
    params = tree_unflatten(paths, draw(1.0))
    params["s0b0"]["proj"][:] = 0.0
    grads = tree_unflatten(paths, [
        np.asarray(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))
        for g in draw(0.1)])
    mom = tree_unflatten(paths, draw(0.01))
    if kind == "lamb":
        mom = {"m": mom, "v": tree_map(np.abs, tree_unflatten(
            paths, draw(0.01))), "count": 3}
    cfg_j = jlars.OptConfig(kind=kind, use_kernel=use_kernel)
    cfg_t = lars.OptConfig(kind=kind, use_kernel=use_kernel)
    lr = np.float32(0.3)
    jmom = dict(mom, count=jnp.int32(3)) if kind == "lamb" else mom
    import jax
    want_p, want_m = jax.jit(jlars.update, static_argnums=4)(
        tree_map(jnp.asarray, params),
        tree_map(lambda g: jnp.asarray(g).astype(jnp.bfloat16), grads),
        tree_map(jnp.asarray, jmom), jnp.float32(lr), cfg_j)
    tmom = (dict(tree_map(torch.from_numpy, {"m": mom["m"], "v": mom["v"]}),
                 count=3) if kind == "lamb" else
            tree_map(torch.from_numpy, mom))
    got_p, got_m = lars.update(
        tree_map(torch.from_numpy, params),
        tree_map(lambda g: torch.from_numpy(g).bfloat16(), grads),
        tmom, torch.tensor(lr), cfg_t)
    # f32 arithmetic in another order (norms, fused multiply-adds): 1e-6;
    # LAMB's step is lr·||w|| per tensor, so its rounding shows at 1e-5
    atol = 1e-5 if kind == "lamb" else 1e-7
    for got, want in ((got_p, want_p), (got_m, want_m)):
        if kind == "lamb" and got is got_m:
            assert got["count"] == int(want["count"]) == 4
            got = {k: got[k] for k in ("m", "v")}
            want = {k: want[k] for k in ("m", "v")}
        for (path, g), (_, w) in zip(tree_flatten(weights.to_numpy(got)),
                                     tree_flatten(want)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                       atol=atol, err_msg=path)


def test_cli_on_cpu_reaches_run_stop(capsys):
    from repro_torch.launch import train as launch
    history = launch.main(["--arch", "resnet50", "--reduced", "--steps", "2",
                           "--batch", "4", "--device", "cpu"])
    assert len(history) == 2 and all(np.isfinite(h["loss"]) for h in history)
    assert "(repro_torch/train/loop.py) run_stop:" in capsys.readouterr().out


def test_cli_flag_not_ported_names_roadmap(capsys):
    from repro_torch.launch import train as launch
    with pytest.raises(SystemExit) as exit_info:
        launch.main(["--arch", "resnet50", "--reduced", "--device", "cpu",
                     "--comm", "ring", "--model-parallel", "2"])
    assert exit_info.value.code != 0
    assert "ROADMAP §1 item 6" in capsys.readouterr().err


def test_cli_refuses_comm_xla_under_multi_rank_launch(capsys, monkeypatch):
    """Under a launcher that sets WORLD_SIZE > 1, the single-device
    '--comm xla' step would train one unsynchronised replica a rank: the
    CLI refuses it before building anything, naming the way out."""
    from repro_torch.launch import train as launch
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(launch, "_run", lambda args: pytest.fail("ran"))
    with pytest.raises(SystemExit) as exit_info:
        launch.main(["--arch", "resnet50", "--reduced", "--steps", "1",
                     "--device", "cpu"])
    assert exit_info.value.code != 0
    err = capsys.readouterr().err
    assert "--comm psum" in err and "ROADMAP §1 item 6" in err
    monkeypatch.setenv("WORLD_SIZE", "1")
    ran = []
    monkeypatch.setattr(launch, "_run", ran.append)
    launch.main(["--arch", "resnet50", "--reduced", "--device", "cpu"])
    assert len(ran) == 1 and ran[0].comm == "xla"


@pytest.mark.parametrize("comm", ["naive", "psum", "ring"])
def test_cli_refuses_grad_accum_with_explicit_schedule(capsys, monkeypatch,
                                                       comm):
    """The explicit schedules do not accumulate; the reference's explicit
    path drops grad_accum silently, the port's CLI refuses it before the
    mesh is built."""
    from repro_torch.launch import train as launch
    monkeypatch.setattr(launch, "_run", lambda args: pytest.fail("ran"))
    with pytest.raises(SystemExit) as exit_info:
        launch.main(["--arch", "resnet50", "--reduced", "--device", "cpu",
                     "--comm", comm, "--grad-accum", "2"])
    assert exit_info.value.code != 0
    err = capsys.readouterr().err
    assert "--grad-accum 2 is a --comm xla option" in err
    assert "never reads grad_accum" in err
    ran = []
    monkeypatch.setattr(launch, "_run", ran.append)
    launch.main(["--arch", "resnet50", "--reduced", "--device", "cpu",
                 "--grad-accum", "2"])
    assert ran[0].grad_accum == 2


@pytest.mark.parametrize("extra", [
    ["--comm", "ring", "--sharding", "zero1", "--update-kernel"],
    ["--comm", "psum", "--sharding", "zero1", "--gather", "at_end",
     "--no-overlap", "--eval-every", "2"],
    ["--comm", "bucketed", "--bucket-mb", "0.25"]])
def test_cli_explicit_dp_on_cpu_reaches_run_stop(capsys, extra):
    """The explicit-DP flags in one process (a one-rank gloo group)."""
    from repro_torch.launch import train as launch
    history = launch.main(["--arch", "resnet50", "--reduced", "--steps", "2",
                           "--batch", "4", "--device", "cpu", *extra])
    assert all(np.isfinite(h["loss"]) for h in history if "loss" in h)
    assert "(repro_torch/train/loop.py) run_stop:" in capsys.readouterr().out
    import torch.distributed as dist
    assert not dist.is_initialized()     # the CLI tore its group down


def test_make_train_step_names_what_is_not_ported():
    from repro_torch.configs.base import CommConfig
    from repro_torch.launch.mesh import Axis, Mesh
    model = build_model(get_config("resnet50").reduced())
    mesh = Mesh((Axis("data", 1, 0, (0,), None),), torch.device("cpu"))
    sched = make_schedule(ScheduleConfig(base_lr=0.1, total_steps=2))
    opt = lars.OptConfig()
    with pytest.raises(ValueError, match="needs a mesh"):
        make_train_step(model, opt, sched, comm="ring")
    with pytest.raises(ValueError, match="explicit-DP schedule"):
        make_train_step(model, opt, sched,
                        comm=CommConfig(strategy="xla", sharding="zero1"))
    # the ring-step fold kernel K3 (use_kernel=True): CPU buffers take its
    # plain version, with CHUNK-aligned chunk rows
    from repro_torch.comm import get_schedule, ring_kernel, schedules
    from repro_torch.core.bucketing import CHUNK
    before = ring_kernel.ring_add_step.launches
    step_fn, pad_to = schedules._step_fn(True)
    assert pad_to == CHUNK
    chunks = torch.randn(3, CHUNK)
    recv = torch.randn(CHUNK)
    want = recv + chunks[2]
    assert torch.equal(step_fn(recv, chunks, 2), want)
    buf = torch.arange(4.0)
    out = get_schedule("ring")(buf.clone(), mesh.axes, use_kernel=True)
    assert torch.equal(out, buf)          # one rank: the sum is the buffer
    assert ring_kernel.ring_add_step.launches == before
    # naive has no bucket plan to shard: replicated, as in the reference
    step = make_train_step(model, opt, sched, mesh=mesh,
                           comm=CommConfig(strategy="naive",
                                           sharding="zero1"))
    assert step.sharding == "replicated" and not step.overlap


def test_entry_points_raise_without_card(monkeypatch):
    """No silent CPU fallback: without a card and without device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_config("resnet50").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(model, 0)
    from repro_torch.launch import train as launch
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "resnet50", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "resnet50", "--reduced", "--steps", "1",
                     "--comm", "ring", "--sharding", "zero1"])
    from repro_torch.launch.mesh import make_local_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_local_mesh()
    assert init_state(model, 0, device="cpu").params["stem"]["conv"] \
        .device.type == "cpu"


@pytest.mark.parametrize("flag, field, value, conflict", [
    ("--shard-update", "sharding", "zero1", ["--sharding", "replicated"]),
    ("--no-gather-ahead", "gather", "at_end", ["--gather", "ahead"])])
def test_cli_deprecated_alias_maps_onto_the_policy(capsys, monkeypatch, flag,
                                                   field, value, conflict):
    """The reference's deprecated booleans: noted as ``launch_deprecated``
    and mapped onto ``--sharding zero1`` / ``--gather at_end``; given with
    the contrary policy they are refused, as the reference refuses them."""
    from repro_torch.launch import train as launch
    ran = []
    monkeypatch.setattr(launch, "_run", ran.append)
    launch.main(["--arch", "resnet50", "--reduced", "--device", "cpu",
                 "--comm", "ring", flag])
    assert getattr(ran[0], field) == value
    assert [n for n, _ in ran[0].notes] == ["launch_deprecated"]
    assert flag in ran[0].notes[0][1]
    with pytest.raises(SystemExit) as exit_info:
        launch.main(["--arch", "resnet50", "--reduced", "--device", "cpu",
                     "--comm", "ring", flag, *conflict])
    assert exit_info.value.code != 0
    assert f"{flag} conflicts with {' '.join(conflict)}" in \
        capsys.readouterr().err


def test_cli_deprecated_aliases_train(capsys):
    from repro_torch.launch import train as launch
    history = launch.main(["--arch", "resnet50", "--reduced", "--steps", "2",
                           "--batch", "4", "--device", "cpu", "--comm",
                           "ring", "--shard-update", "--no-gather-ahead"])
    assert len(history) == 2 and all(np.isfinite(h["loss"]) for h in history)
    out = capsys.readouterr().out
    assert out.count("launch_deprecated: ") == 2
    assert "(repro_torch/train/loop.py) run_stop:" in out


def test_cli_bucket_mb_auto_measured_profile_and_drift(capsys, tmp_path):
    """``--bucket-mb auto --backward-profile measured`` on the LM's ring
    zero1 step: the profiled warm-up backward, the autotuned plan, and
    after ``--trace`` the drift rows of the traced bucket spans."""
    from repro_torch.launch import train as launch
    history = launch.main([
        "--arch", "qwen1.5-0.5b", "--reduced", "--seq", "32", "--batch", "4",
        "--steps", "2", "--device", "cpu", "--comm", "ring", "--sharding",
        "zero1", "--bucket-mb", "auto", "--backward-profile", "measured",
        "--trace", str(tmp_path / "t.json")])
    assert len(history) == 2 and all(np.isfinite(h["loss"]) for h in history)
    out = capsys.readouterr().out
    for tag in ("backward_profile_measured: ", "autotune_plan: autotuned "
                "bucket plan: ", "trace_written: ", "obs.drift.span: ",
                "obs.drift.ring.rel_err: "):
        assert tag in out, tag
    assert "backward_profile_fallback" not in out


def test_cli_backward_profile_needs_auto(monkeypatch):
    from repro_torch.launch import train as launch
    ran = []
    monkeypatch.setattr(launch, "_run", ran.append)
    launch.main(["--arch", "resnet50", "--reduced", "--device", "cpu",
                 "--comm", "ring", "--backward-profile", "measured"])
    assert ran[0].bucket_mb == 4.0 and [n for n, _ in ran[0].notes] == \
        ["launch_note"]
    launch.main(["--arch", "resnet50", "--reduced", "--device", "cpu",
                 "--comm", "ring", "--bucket-mb", "auto",
                 "--backward-profile", "measured"])
    assert ran[1].bucket_mb == "auto" and ran[1].notes == []
