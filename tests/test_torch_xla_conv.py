"""ResNet-50 under ``comm='xla'`` over several ranks (ROADMAP §1 item
6.2b): the reduced config on two gloo ranks at (data 2, model 1)
(``torch_ranks.py xla_conv``), each rank on its rows, against the JAX
package's GSPMD step on a (2, 1) Auto-axis mesh of two host devices
(``torch_reference.py xla_conv_cases``: one subprocess, the batch placed
over ``data``, the ``sync_bn`` form's ``pmean`` in ``shard_map`` under the
shim), in both ``sync_bn`` forms, and against the port's one-rank step on
the whole batch.

GSPMD's BatchNorm statistics span the global batch, so the port's sum over
the data axes (``models/resnet.py``: GSPMD's form, or with ``sync_bn`` the
reference's cross-replica one); bf16 ResNet at reduced size is chaotic
(ROADMAP §3), so the parity is taken step by step from the reference's own
state. Measured here (``sync_bn`` off / on): the forward's logits 3.7e-7
and the new BN statistics 2.8e-7 of their max in both forms; the
gradients (meaned over the ranks) a median relative L2 of 4.9e-3 / 1.0e-2
per tensor, worst 0.168 / 0.158 (the stem's BN bias). The sync form's
var = mean(v + m·m) - m2·m2 cancels, and its rounding noise reaches the
gradients: the reference's two forms differ from each other by a median
of 1.0e-2 and a worst of 0.155 on the same input. Bounds: logits and BN
statistics 1e-5 (``test_torch_resnet.py``'s), gradients a median of 0.01
/ 0.02 (about twice each measurement) and a worst of 0.3, and each step
within ``test_torch_train.py``'s step bounds (step 1: loss 1.5e-3 /
2.1e-3 relative, update worst 0.162 / 0.213, median 0.082 / 0.116). The
two ranks' masters, momentum and BN state are the same bits. One rank on
the whole batch against the two: step 0's update 7.3e-2 / 0.123 worst,
2.4e-3 / 5.4e-3 median, BN state 1.2e-7 / 6.5e-7.

Without ranks: one BatchNorm with ``sync_bn`` on a one-rank mesh takes
the reference's cross-replica form, as the reference's does on a
one-device mesh."""
import dataclasses

import numpy as np
import pytest
import torch
import torch_ranks
import torch_reference as R

from repro_torch.configs import get_config
from repro_torch.core import lars
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.launch.mesh import Axis, Mesh
from repro_torch.models import resnet
from repro_torch.models.registry import build_model
from repro_torch.train.step import make_train_step

#: (logits, BN statistics) of the forward, and the gradients' median and
#: worst relative L2 per tensor, by ``sync_bn``
FWD_BOUNDS = (1e-5, 1e-5)
GRAD_BOUNDS = {0: (0.01, 0.3), 1: (0.02, 0.3)}
#: a step from the reference's state (``test_torch_train.py``'s): loss
#: relative, update and momentum (worst, median) relative L2, masters'
#: worst relative L2, BN state over its max
STEP_BOUNDS = (3e-3, 0.5, 0.25, 0.5, 0.25, 0.3, 0.015)


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "conv.npz")
    R.run("xla_conv_cases", path, devices=2)
    return path


@pytest.fixture(scope="module")
def ranks(ref_path, tmp_path_factory):
    return torch_ranks.launch(f"xla_conv:{ref_path}", 2,
                              str(tmp_path_factory.mktemp("ranks")),
                              timeout=600)


def _each(ranks, key):
    vals = [np.asarray(r[key]) for r in ranks]
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


@pytest.mark.tier1
def test_sync_bn_on_one_rank_takes_the_cross_replica_form(ref_path):
    """``_bn`` with ``sync`` over a one-rank mesh's data axis: the
    reference's ``pmean`` form (the mean of v + m·m less m²) on its
    one-device mesh, to f32 rounding; without a mesh the per-process
    two-pass form."""
    r = R.load(ref_path)["bn1"]
    x = torch.from_numpy(r["x"]).permute(0, 3, 1, 2)
    p = {k: torch.from_numpy(v) for k, v in r["p"].items()}
    st = {k: torch.from_numpy(v) for k, v in r["st"].items()}
    one = [Axis("data", 1, 0, (0,), None)]
    y, st2 = resnet._bn(x, p, st, train=True, momentum=0.9, dp=one,
                        sync=True)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), r["y"],
                               rtol=0, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(st2[k].numpy(), r["st_out"][k], rtol=1e-6)
    m = x.mean((0, 2, 3))
    v = (x - m.view(1, -1, 1, 1)).square().mean((0, 2, 3))
    torch.testing.assert_close(st2["var"], 0.9 * st["var"] + (1 - 0.9) * (
        (v + m * m) - m * m), rtol=0, atol=0)


@pytest.mark.tier1
def test_the_conv_xla_step_builds_over_a_multi_rank_mesh():
    """``make_train_step(comm='xla')`` over (data 2, model 1) and (data
    2, model 2) meshes: the conv family's refusal (item 6.2b) is lifted,
    and it splits no leaf."""
    sched = make_schedule(ScheduleConfig(base_lr=0.1, total_steps=2))
    model = build_model(get_config("resnet50").reduced())
    for m in (1, 2):
        mesh = Mesh((Axis("data", 2, 0, (0, m), None),
                     Axis("model", m, 0, tuple(range(m)), None)),
                    torch.device("cpu"))
        step = make_train_step(model, lars.OptConfig(), sched, mesh=mesh,
                               comm="xla")
        assert step.mesh is mesh


@pytest.mark.tier2
@pytest.mark.parametrize("sync", [0, 1])
def test_forward_and_gradients_meet_the_reference(ranks, sync):
    logits, stats, grad_worst, grad_median = _each(ranks, f"s{sync}/fwd")
    assert logits <= FWD_BOUNDS[0] and stats <= FWD_BOUNDS[1], \
        (logits, stats)
    assert grad_median <= GRAD_BOUNDS[sync][0], grad_median
    assert grad_worst <= GRAD_BOUNDS[sync][1], grad_worst


@pytest.mark.tier2
@pytest.mark.parametrize("k", range(R.XLA_CONV_STEPS))
@pytest.mark.parametrize("sync", [0, 1])
def test_steps_meet_the_reference(ranks, sync, k):
    got = _each(ranks, f"s{sync}/s{k}")
    assert (got <= np.array(STEP_BOUNDS)).all(), got


@pytest.mark.tier2
@pytest.mark.parametrize("sync", [0, 1])
def test_two_ranks_equal_one_rank_on_the_whole_batch(ranks, sync):
    got = _each(ranks, f"s{sync}/one")
    assert (got <= np.array(STEP_BOUNDS)).all(), got


@pytest.mark.tier2
@pytest.mark.parametrize("sync", [0, 1])
def test_masters_and_bn_state_bit_equal_across_ranks(ranks, sync):
    """The statistics are global, so every rank's new running statistics
    are the same bits, and so are the masters and momentum the meaned
    gradients update."""
    _each(ranks, f"s{sync}/sha")


@pytest.mark.tier2
def test_cli_comm_xla_resnet_over_two_ranks(ranks):
    """``--arch resnet50 --comm xla`` under a two-rank launch reaches
    run_stop on each rank."""
    assert all(bool(r["cli"]) for r in ranks)


@pytest.mark.tier1
def test_sync_bn_config_field_is_the_references():
    """The port's config carries ``sync_bn`` with the reference's
    default (off: the paper's per-process statistics)."""
    from repro.configs import get_config as jget_config
    cfg, jcfg = get_config("resnet50"), jget_config("resnet50")
    assert cfg.sync_bn is jcfg.sync_bn is False
    assert dataclasses.replace(cfg, sync_bn=True).sync_bn
