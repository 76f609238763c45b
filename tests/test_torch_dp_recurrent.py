"""The hybrid (reduced zamba2-7b: 4 Mamba layers in 2 groups, the shared
attention block applied before each) and the xLSTM (reduced xlstm-125m,
its two layers an mLSTM and an sLSTM block: ``torch_reference.
family_config``) on the port's explicit data-parallel ladder, against the
JAX package's explicit step.

The reference (``tests/torch_reference.py lm_family_dp_steps``, one
subprocess for the file: its step under the shard_map shim on a (1, 1)
Auto-axis mesh, 0.1 MB buckets, each program compiled once) runs psum
and ring zero1 for both and ring zero3 (``gather='per_group'``) for the
hybrid, two steps along its own trajectory, wholly in f32 (f32 wire;
``precision.f32_compute`` on the port's side). The port's one-rank step
meets it at the bounds of each family's own two-step training test: the
hybrid's loss within 4e-4 relative, masters and momentum within 5e-2 of
each tensor's largest update and momentum element
(``test_torch_mamba.py``; measured 2.1e-7, 1.1e-4 and 6.4e-6), the
xLSTM's within 1e-5 and 1e-2 (``test_torch_xlstm.py``; measured 7.0e-8,
7.8e-4 and 8.7e-5, all at the sLSTM's b_i, whose gradient vanishes).

Also: every leaf wider than a bucket splits and every leaf's gradient
lands where the plan says (``torch_reference.check_family_plan``: the
shared block's leaves, read at each application, and the xLSTM's
per-layer leaves included); zero3 with the model's remat nested inside
its checkpointed loss, and zero3's gather in the compute dtype, change no
bit; the sharded state's rows made leaf by leaf equal the packed global
layout's; the MoE family stays refused under an explicit schedule (the
reference has no such step: its MoE layer runs only over a mesh), through
``make_train_step`` and the CLI; the CLI's zero3 hybrid
run; and (``tier2``) two gloo ranks against the one-rank psum step on
the whole batch (``torch_ranks.py lm_family_dp``) at
``test_torch_lm_dp.py``'s bounds (measured: masters within 5.9e-5 and
8.8e-5 of the update, losses within 2.1e-7 and 7.3e-8), every rank's
masters bit-equal."""
import dataclasses

import numpy as np
import pytest
import torch
import torch_ranks
import torch_reference as R

from repro_torch.configs import get_config
from repro_torch.configs.base import CommConfig
from repro_torch.core import ddp, lars
from repro_torch.core.schedule import ScheduleConfig, make_schedule
from repro_torch.data.synthetic import token_batch
from repro_torch.launch.mesh import Axis, Mesh, make_local_mesh
from repro_torch.models.registry import build_model
from repro_torch.train import state as st
from repro_torch.train.step import make_train_step

pytestmark = pytest.mark.tier1

ARCHS = (R.HYBRID_ARCH, R.XLSTM_ARCH)
#: (loss rtol, update tol) of each family's two-step training test
BOUNDS = {R.HYBRID_ARCH: (4e-4, 5e-2), R.XLSTM_ARCH: (1e-5, 1e-2)}
CASES = [(a, c) for a in ARCHS for c in R.LM_FAMILY_DP[a]]
#: test_torch_lm_dp.py's two-rank bounds
RANKS_UPDATE, RANKS_LOSS = 2.5e-2, 1.2e-4
MOE_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v2-236b")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return R.run("lm_family_dp_steps:" + ",".join(ARCHS),
                 str(tmp_path_factory.mktemp("ref") / "dp_recurrent.npz"))


@pytest.fixture(scope="module")
def mesh():
    m = make_local_mesh(device="cpu")
    yield m
    m.destroy()


@pytest.mark.parametrize("arch", ARCHS)
def test_every_wide_leaf_splits_and_each_gradient_lands(mesh, arch):
    """The hybrid's Mamba stacks and the shared block's matrices, the
    xLSTM's per-layer matrices and both embeddings split; the gradients
    land in the plan's slots, the shared block's summed over both of its
    applications before its group's identity runs."""
    split = R.check_family_plan(arch, mesh)
    want = {R.HYBRID_ARCH: {"layers/mamba/in_x", "layers/mamba/in_z",
                            "layers/mamba/out", "shared_attn/attn/wq",
                            "shared_attn/mlp/w_up"},
            R.XLSTM_ARCH: {"layer_00/blk/wq", "layer_00/blk/w_up",
                           "layer_01/blk/w_z", "layer_01/blk/ffn_up"}}[arch]
    assert want | {"embed", "lm_head"} <= split


@pytest.mark.parametrize("k", range(R.LM_TRAIN_STEPS))
@pytest.mark.parametrize("arch,case", CASES)
def test_step_matches_reference(ref, mesh, arch, case, k):
    loss_rtol, update_tol = BOUNDS[arch]
    R.check_family_dp_step(ref[arch], arch, case, k, mesh,
                           loss_rtol=loss_rtol, update_tol=update_tol)


def _zero3(model, mesh, **kw):
    return make_train_step(
        model, lars.OptConfig(kind="lars"), make_schedule(
            ScheduleConfig(**R.LR)), mesh=mesh,
        comm=CommConfig(strategy="ring", sharding="zero3", gather="per_group",
                        bucket_mb=R.LM_DP_BUCKET_MB, **kw))


def _zero3_run(model, mesh, step, batch):
    state = st.init_state(model, 0, device="cpu",
                          **st.sharded_state_kwargs(step))
    state, metrics = step(state, batch)
    return float(metrics["loss"]), [s.clone() for s in state.shards]


def test_zero3_remat_and_compute_dtype_gather_change_no_bit(mesh,
                                                            monkeypatch):
    """The hybrid's zero3 step (bf16 wire and compute) with the model's
    remat (each Mamba layer and shared-block application recomputed inside
    the recomputed loss: a checkpoint nested in a checkpoint, the shared
    leaves read in both) and without, and with the tree gathered in the
    compute dtype (the step's choice) and in f32 (the reference's): the
    same loss and master shards, bit for bit."""
    base = R.family_config(get_config, R.HYBRID_ARCH)
    batch = token_batch(base, batch=2, seq=R.LM_TRAIN_SEQ, step=0,
                        device="cpu")
    runs = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(base, remat=remat))
        runs[remat] = _zero3_run(model, mesh, _zero3(model, mesh), batch)
    model = build_model(dataclasses.replace(base, remat=True))
    step = _zero3(model, mesh)
    gather, dtypes = ddp.jit_gather_params, []

    def f32_gather(*a, dtype, **kw):
        dtypes.append(dtype)
        return gather(*a, dtype=torch.float32, **kw)
    monkeypatch.setattr(ddp, "jit_gather_params", f32_gather)
    runs["f32"] = _zero3_run(model, mesh, step, batch)
    assert set(dtypes) == {torch.bfloat16}
    for key in (True, "f32"):
        assert runs[key][0] == runs[False][0], key
        assert all(torch.equal(a, b)
                   for a, b in zip(runs[key][1], runs[False][1])), key


@pytest.mark.parametrize("sharding", ["zero1", "zero3"])
def test_sharded_state_rows_equal_the_packed_layout(mesh, sharding):
    """``init_state``'s master shard and momentum rows, made leaf by leaf
    (zero3: each leaf drawn on the host, no full tree), equal each rank's
    row of the reference's global layout (``init_packed_shards``,
    ``init_packed_momentum``, ``local_shards``) bit for bit, on 1 and 3
    shards and every rank, over the hybrid's split leaves."""
    model = build_model(R.family_config(get_config, R.HYBRID_ARCH))
    plan = make_train_step(model, lars.OptConfig(), make_schedule(
        ScheduleConfig(**R.LR)), mesh=mesh,
        comm=CommConfig(strategy="ring", sharding=sharding,
                        bucket_mb=R.LM_DP_BUCKET_MB)).bucket_plan
    params = st.init_state(model, 3, device="cpu").params
    for n in (1, 3):
        for i in range(n):
            at = Mesh((Axis("data", n, i, tuple(range(n)), None),),
                      torch.device("cpu"))
            s = st.init_state(model, 3, device="cpu", sharded_plan=plan,
                              n_shards=n, mesh=at,
                              materialize_params=sharding == "zero1")
            assert (s.params is None) == (sharding == "zero3")
            for got, want in (
                    (s.shards, st.init_packed_shards(params, plan, n)),
                    (s.mom, st.init_packed_momentum(plan, n))):
                want = st.local_shards(want, n, i)
                assert len(got) == len(want) == plan.n_buckets
                assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_explicit_schedule_refuses_moe_naming_item_6_3(mesh, capsys, arch):
    """The reference's explicit step runs the model without a mesh, and
    its MoE layer runs only over one: there is no such step to port (no
    ROADMAP item; ``comm='xla'`` trains the family), and the port refuses
    it, through ``make_train_step`` and the CLI, saying so."""
    from repro_torch.launch import train as launch
    words = "no such step exists to port"
    model = build_model(get_config(arch).reduced())
    for comm in ("psum", CommConfig(strategy="ring", sharding="zero3")):
        with pytest.raises(NotImplementedError, match=words):
            make_train_step(model, lars.OptConfig(), make_schedule(
                ScheduleConfig(**R.LR)), mesh=mesh, comm=comm)
    with pytest.raises(SystemExit) as exit_info:
        launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--comm", "ring", "--sharding", "zero1"])
    assert exit_info.value.code != 0
    assert words in capsys.readouterr().err


def test_cli_zero3_hybrid_reaches_run_stop(capsys):
    """``python -m repro_torch.launch.train --arch zamba2-7b --reduced
    --comm ring --sharding zero3`` on one rank, called in this process."""
    from repro_torch.launch import train as launch
    history = launch.main(["--arch", R.HYBRID_ARCH, "--reduced", "--device",
                           "cpu", "--seq", "16", "--batch", "2", "--steps",
                           "2", "--comm", "ring", "--sharding", "zero3"])
    assert len(history) == 2 and all(np.isfinite(h["loss"])
                                     for h in history)
    assert "run_stop" in capsys.readouterr().out


@pytest.mark.tier2
@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_equal_the_one_rank_psum_step(tmp_path, arch):
    """Each case on two gloo ranks, each on its half of the global batch,
    against the one-rank psum step on the whole batch, wholly in f32:
    what differs is the order of the f32 sums. Every rank reads the same
    masters, bit for bit, and holds as many labels as the other."""
    ranks = torch_ranks.launch(f"lm_family_dp:{arch}", 2, str(tmp_path))
    for case in R.LM_FAMILY_DP[arch]:
        for r in ranks:
            assert float(r[f"{case}/masters_of_update"]) <= RANKS_UPDATE
            assert float(r[f"{case}/loss_rel"]) <= RANKS_LOSS
        assert np.array_equal(ranks[0][f"{case}/masters_sha"],
                              ranks[1][f"{case}/masters_sha"])
        assert int(ranks[0][f"{case}/labels"]) == \
            int(ranks[1][f"{case}/labels"])
