"""Whisper (reduced whisper-base: two encoder and two decoder layers over
16 stub frames, their learned position tables) and the VLM (reduced
internvl2-2b: a 16-patch image prefix through the stub projector, its
labels left-padded with IGNORE) on the port's explicit data-parallel
ladder, against the JAX package's explicit step.

The reference (``tests/torch_reference.py lm_family_dp_steps``, one
subprocess for the file: its step under the shard_map shim on a (1, 1)
Auto-axis mesh, 0.1 MB buckets, each program compiled once) runs psum
and ring zero1, two steps along its own trajectory on its token batches,
threefry frames and all, in bf16 (bf16 wire). The port's one-rank step
meets it at the bounds of each family's own two-step training test
(``test_torch_{whisper,vlm}.py``): the loss within 4e-4 relative,
masters and momentum within 5e-2 of each tensor's largest update and
momentum element (measured: whisper 5.2e-5, 2.2e-2 and 2.2e-2 at the
decoder MLP's b_out; the VLM 1.4e-4, 1.2e-2 and 1.2e-2).

Both packages take the step's loss as the mean of the ranks' masked means
(the reference's pmean, the port's ``pmean_tree``): the global mean only
where every rank holds as many labels, which the token batches give (the
last column IGNORE in every row; the VLM's prefix rows carry no label on
any rank). Also: every leaf wider than a bucket splits (whisper's two
stacks, its 32,768-row decoder position table, whose gradient is zero past
the sequence and still travels every bucket) and every gradient lands
where the plan says (``torch_reference.check_family_plan``); the CLI's
ring zero1 runs; and (``tier2``) two gloo ranks against the one-rank psum
step on the whole batch (``torch_ranks.py lm_family_dp``), frames split
with the rows, at ``test_torch_lm_dp.py``'s bounds (measured: masters
within 1.1e-2 and 6.7e-3 of the update, losses within 5.7e-5 and
3.0e-5), every rank's masters bit-equal and its label count equal."""
import numpy as np
import pytest
import torch
import torch_ranks
import torch_reference as R

from repro_torch.launch.mesh import make_local_mesh

pytestmark = pytest.mark.tier1

ARCHS = (R.WHISPER_ARCH, R.VLM_ARCH)
#: (loss rtol, update tol) of each family's two-step training test
BOUNDS = {R.WHISPER_ARCH: (4e-4, 5e-2), R.VLM_ARCH: (4e-4, 5e-2)}
CASES = [(a, c) for a in ARCHS for c in R.LM_FAMILY_DP[a]]
#: test_torch_lm_dp.py's two-rank bounds
RANKS_UPDATE, RANKS_LOSS = 2.5e-2, 1.2e-4


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
                 str(tmp_path_factory.mktemp("ref") / "dp_frames.npz"))


@pytest.fixture(scope="module")
def mesh():
    m = make_local_mesh(device="cpu")
    yield m
    m.destroy()


@pytest.mark.parametrize("arch", ARCHS)
def test_every_wide_leaf_splits_and_each_gradient_lands(mesh, arch):
    """Whisper's encoder and decoder stacks (self-, cross-attention and
    MLP matrices) and its decoder position table, the VLM's stacks and its
    projector, and both embeddings split; the gradients land in the plan's
    slots."""
    split = R.check_family_plan(arch, mesh)
    want = {R.WHISPER_ARCH: {"dec_pos", "enc_layers/attn/wq",
                             "enc_layers/mlp/w_in", "layers/cross/wk",
                             "layers/attn/wo", "layers/mlp/w_out"},
            R.VLM_ARCH: {"proj", "layers/attn/wq", "layers/mlp/w_gate"}}[arch]
    assert want | {"embed", "lm_head"} <= split


@pytest.mark.parametrize("k", range(R.LM_TRAIN_STEPS))
@pytest.mark.parametrize("arch,case", CASES)
def test_step_matches_reference(ref, mesh, arch, case, k):
    loss_rtol, update_tol = BOUNDS[arch]
    R.check_family_dp_step(ref[arch], arch, case, k, mesh,
                           loss_rtol=loss_rtol, update_tol=update_tol)


@pytest.mark.parametrize("arch,comm", [(R.WHISPER_ARCH, ("ring", "zero1")),
                                       (R.VLM_ARCH, ("psum", "replicated"))])
def test_cli_explicit_step_reaches_run_stop(capsys, arch, comm):
    """``python -m repro_torch.launch.train --arch ARCH --reduced --comm
    ... --sharding ...`` on one rank, called in this process."""
    from repro_torch.launch import train as launch
    history = launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--seq", "16", "--batch", "2", "--steps", "2",
                           "--comm", comm[0], "--sharding", comm[1]])
    assert len(history) == 2 and all(np.isfinite(h["loss"])
                                     for h in history)
    assert "run_stop" in capsys.readouterr().out


@pytest.mark.tier2
@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_equal_the_one_rank_psum_step(tmp_path, arch):
    """Each case on two gloo ranks, each on its half of the global batch
    and its frames, against the one-rank psum step on the whole batch, f32
    wire: what differs is where the bf16 backward rounds each rank's
    weight gradients over its half of the rows. Every rank reads the same
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
