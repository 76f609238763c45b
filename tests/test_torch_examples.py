"""The torch twins of the four examples (``repro_torch.examples``) against
what the JAX package's ``examples/*.py`` build from ``repro`` with the
same arguments: the learning rate at every step bit for bit, the
``OptConfig``, the bucket plan and the eval cadence. Then each twin's
``main`` on the CPU (``--device cpu``) for a step or two at a tiny batch
(the module's sizes that have no flag, such as the eval batch, cut by
monkeypatch), its final line printed; and without ``--device`` on a
machine with no card each raises instead of falling back."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import bucketing as jbucketing
from repro.core import lars as jlars
from repro.core import schedule as jsched
from repro.models.registry import build_model as jbuild_model
from repro_torch.examples import large_batch_ablation as ablation
from repro_torch.examples import quickstart, serve_decode
from repro_torch.examples import train_resnet_imagenet as resnet_ex

pytestmark = pytest.mark.tier1

EXAMPLES = (resnet_ex, quickstart, serve_decode, ablation)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _same_lr(port_sched, steps, **kw):
    """The port's schedule against the reference's, built from ``kw``, at
    every step of the run and a few past it, bit for bit."""
    ref = jsched.make_schedule(jsched.ScheduleConfig(**kw))
    want = np.asarray([ref(s) for s in range(steps + 3)], np.float32)
    got = np.asarray([port_sched(s) for s in range(steps + 3)], np.float32)
    np.testing.assert_array_equal(got, want)


def _same_opt(port, ref):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("comm", ["bucketed", "naive", "xla"])
def test_resnet_setup_is_the_references(comm):
    steps, batch = 24, 16
    run = resnet_ex.setup(steps, batch, comm, "cpu")
    try:
        _same_lr(run.sched, steps,
                 base_lr=jsched.linear_scaled_lr(16.0, batch) / 4,
                 warmup_steps=steps // 8, total_steps=steps, decay="poly2")
        _same_opt(run.opt, jlars.OptConfig(kind="lars", weight_decay=5e-5))
        assert run.eval_every == max(steps // 4, 1) == 6
        assert resnet_ex.EVAL_BATCH == 128
        assert dataclasses.asdict(run.cfg) == dataclasses.asdict(
            jget_config("resnet50").reduced())
        if comm == "xla":
            assert run.mesh is None and run.train_step.sharding == \
                "replicated"
            return
        assert run.train_step.comm == comm and run.train_step.overlap == (
            comm == "bucketed")
        want = jbucketing.make_plan(
            jbuild_model(jget_config("resnet50").reduced()).param_pd,
            bucket_mb=4.0)
        got = run.train_step.bucket_plan
        assert got.bucket_sizes == want.bucket_sizes
        assert [dataclasses.astuple(s) for s in got.slots] == \
            [dataclasses.astuple(s) for s in want.slots]
        assert run.state.step == 0
    finally:
        if run.mesh is not None:
            run.mesh.destroy()


def test_quickstart_setup_is_the_references():
    run = quickstart.setup("cpu")
    _same_lr(run.sched, quickstart.STEPS, base_lr=2.0, warmup_steps=6,
             total_steps=60, decay="poly2")
    _same_opt(run.opt, jlars.OptConfig(kind="lars"))
    assert quickstart.STEPS == 60
    assert dataclasses.asdict(run.cfg) == dataclasses.asdict(
        jget_config("qwen1.5-0.5b").reduced())
    assert tuple(run.batch_fn(0)["tokens"].shape) == (8, 64)


@pytest.mark.parametrize("batch", ablation.BATCHES)
@pytest.mark.parametrize("recipe", [r for r, _ in ablation.RECIPES])
def test_ablation_cell_setup_is_the_references(batch, recipe):
    kw = dict(ablation.RECIPES)[recipe]
    steps = 60
    model = ablation.build_model(ablation.get_config("resnet50").reduced())
    cell = ablation.setup(model, "cpu", batch=batch, steps=steps, **kw)
    _same_lr(cell.sched, steps,
             base_lr=jsched.linear_scaled_lr(16.0, batch) / 4,
             warmup_steps=int(steps * 0.15) if kw["warmup"] else 0,
             total_steps=steps, decay="poly2")
    _same_opt(cell.opt, jlars.OptConfig(kind=kw["opt"]))
    assert cell.step.sharding == "replicated"
    assert ablation.BATCHES == (16, 64, 256) and ablation.EVAL_BATCH == 64


def test_serve_setup_and_refusals():
    run = serve_decode.setup(batch=2, prompt_len=8, max_new=3, device="cpu")
    assert tuple(run.batch["tokens"].shape) == (2, 8)
    assert run.cache_len == 8 + 3 + 8
    again = serve_decode.setup(batch=2, prompt_len=8, max_new=3,
                               device="cpu")
    assert torch.equal(run.batch["tokens"], again.batch["tokens"])
    # whisper and the VLM (item 10.6) carry stub frames, as the reference's
    # example draws them; the VLM's cache has room for its image prefix
    for arch, room in (("whisper-base", 0), ("internvl2-2b", 16)):
        run = serve_decode.setup(arch, batch=2, prompt_len=8, max_new=3,
                                 device="cpu")
        assert tuple(run.batch["frames"].shape) == (2, 16, 256)
        assert run.cache_len == 8 + room + 3 + 8
    with pytest.raises(KeyError, match="unknown arch"):
        serve_decode.setup("whisper-large", device="cpu")


def _last_line(capsys) -> str:
    return capsys.readouterr().out.strip().splitlines()[-1]


@pytest.mark.parametrize("comm", ["bucketed", "xla"])
def test_resnet_main_runs_on_the_cpu(comm, monkeypatch, capsys):
    monkeypatch.setattr(resnet_ex, "EVAL_BATCH", 2)
    history = resnet_ex.main(["--steps", "2", "--batch", "2", "--comm", comm,
                              "--device", "cpu"])
    losses = [h["loss"] for h in history if "loss" in h]
    evals = [h for h in history if "eval_acc" in h]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert [h["step"] for h in evals] == [0, 1]      # eval_every = 1
    assert _last_line(capsys).startswith("final eval accuracy: ")


def test_quickstart_main_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(quickstart, "STEPS", 2)
    history = quickstart.main(["--device", "cpu"])
    assert len(history) == 2 and all(np.isfinite(h["loss"])
                                     for h in history)
    assert _last_line(capsys).startswith("loss ")


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-base",
                                  "internvl2-2b"])
def test_serve_main_runs_on_the_cpu(arch, capsys):
    out = serve_decode.main(["--arch", arch, "--batch", "1", "--prompt-len",
                             "8", "--max-new", "2", "--device", "cpu"])
    assert tuple(out.shape) == (1, 2)
    assert _last_line(capsys).startswith("first request's tokens: [")


def test_ablation_main_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(ablation, "BATCHES", (2,))
    monkeypatch.setattr(ablation, "EVAL_BATCH", 2)
    rows = ablation.main(["--steps", "1", "--device", "cpu"])
    assert [r[:2] for r in rows] == [(2, n) for n, _ in ablation.RECIPES]
    assert all(np.isfinite(r[3]) for r in rows)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split() == ["batch", "recipe", "eval_acc", "loss"]
    assert lines[-1].split()[0] == "2" and len(lines) == 3


@pytest.mark.parametrize("example", EXAMPLES,
                         ids=[m.__name__.rsplit(".", 1)[1] for m in EXAMPLES])
def test_main_needs_a_card_without_device_cpu(example):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
