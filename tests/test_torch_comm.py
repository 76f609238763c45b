"""The port's explicit data parallelism across ranks: each check runs in
processes of ``tests/torch_ranks.py``, one rank each, over gloo.

* Four ranks: the psum, ring and bucketed schedules, after the backward
  and inside it, in their all-reduce and reduce-scatter forms, equal the
  naive mean of the ranks' gradients to 1e-6 (f32 wire), and the
  in-backward reduce-scatter equals the post-backward one; each rank's
  shard is the chunk ``(r+1) % n`` that the reference's reduce-scatter
  leaves on device r of four (``torch_reference.comm_shards``).
* Two ranks: the ZeRO-1 step equals the replicated explicit step of the
  same schedule to 1e-6 of each tensor's max (masters, momentum, BN
  statistics; f32 wire), psum and ring, overlap and the fused update each
  on and off.
"""
import re

import numpy as np
import pytest
import torch_ranks
import torch_reference

pytestmark = pytest.mark.tier2


def test_schedules_match_naive_and_reference_on_4_ranks(tmp_path):
    n = torch_reference.COMM_RANKS
    ranks = torch_ranks.launch("schedules", n, str(tmp_path))
    ref = torch_reference.run("comm_shards", str(tmp_path / "ref.npz"),
                              devices=n)
    for strategy in ("psum", "ring"):
        for b, glob in ref[strategy].items():
            rows = glob.reshape(n, -1)
            for r in range(n):
                np.testing.assert_allclose(ranks[r][f"{strategy}/{b}"],
                                           rows[r], rtol=0, atol=1e-6)
    # bucketed is psum by another name
    for r in range(n):
        for key, x in ranks[r].items():
            if key.startswith("bucketed/"):
                np.testing.assert_array_equal(
                    x, ranks[r][key.replace("bucketed", "psum")])


def test_zero1_step_matches_replicated_on_2_ranks(tmp_path):
    ranks = torch_ranks.launch("zero1_step", 2, str(tmp_path))
    assert set(ranks[0]) == {f"{s}/o{int(o)}u{int(u)}"
                             for s, o, u in torch_ranks.ZERO1_CASES}
    for r in ranks:
        assert all(float(v) <= torch_ranks.TOL for v in r.values())


def test_cli_zero1_under_torchrun_on_2_gloo_ranks(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train ...
    --device cpu`` reaches run_stop on both ranks."""
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.join(torch_ranks.ROOT, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           "2", "--master-port", str(torch_ranks._free_port()), "-m",
           "repro_torch.launch.train", "--arch", "resnet50", "--reduced",
           "--steps", "2", "--batch", "8", "--comm", "ring", "--sharding",
           "zero1", "--update-kernel", "--eval-every", "2", "--device", "cpu"]
    out = subprocess.run(cmd, cwd=torch_ranks.ROOT, env=env, timeout=300,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("run_stop") == 2, out.stdout[-3000:]
    # both ranks write to one pipe, so their lines may interleave
    evals = re.findall(r"eval_accuracy: (\{[^}]*\})", out.stdout)
    # the eval reads the masters and averages over the ranks
    assert len(evals) == 2 and evals[0] == evals[1], evals
