"""The port's explicit data parallelism across ranks: each check runs in
processes of ``tests/torch_ranks.py``, one rank each, over gloo.

* Four ranks: every schedule (naive, psum, bucketed, ring, hierarchical,
  2d_torus, dbtree) with ``use_kernel`` both ways, after the backward and
  inside it, in their all-reduce and reduce-scatter forms, on the flat
  ``(data 4)``, the ``(data 4, model 1)`` and the ``(pod 2, data 2)``
  meshes, equals the naive mean of the ranks' gradients to 1e-6 (f32
  wire), and the in-backward reduce-scatter equals the post-backward one;
  each rank's shard is the one the reference's reduce-scatter leaves on
  that device (``torch_reference.comm_shards``). Three ranks: the same
  on the flat and trailing-trivial meshes (the trees' sparse levels).
* Two ranks: the ZeRO-1 step equals the replicated explicit step of the
  same schedule to 1e-6 of each tensor's max (masters, momentum, BN
  statistics; f32 wire), psum and ring, overlap and the fused update each
  on and off; so do the zero2 and the zero3 steps (``per_group`` and
  ``ahead``) over five schedules, the ring-step kernel flag each way.
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
    assert set(ref) == set(torch_reference.COMM_MESHES) == {"flat", "dm",
                                                            "pod"}
    checked = 0
    for mname, (shape, names) in torch_reference.COMM_MESHES.items():
        n_sh = [s for s in shape if s > 1][-1]
        for strategy in torch_reference.COMM_STRATEGIES:
            for b, glob in ref[mname][strategy]["k0"].items():
                rows = glob.reshape(n_sh, -1)
                for r in range(n):
                    # rank r's index on the shard axis: the innermost
                    # non-trivial one, fastest in the row-major layout
                    for k in (0, 1):
                        np.testing.assert_allclose(
                            ranks[r][f"{mname}/{strategy}/k{k}/{b}"],
                            rows[r % n_sh], rtol=0, atol=1e-6,
                            err_msg=f"{mname}/{strategy}/k{k}/{b}")
                        checked += 1
            # the reference's Pallas fold leaves the same shards
            for b, glob in ref[mname][strategy].get("k1", {}).items():
                np.testing.assert_allclose(
                    glob, ref[mname][strategy]["k0"][b], rtol=0, atol=1e-6)
    assert checked > 0
    # bucketed is psum by another name
    for r in range(n):
        for key, x in ranks[r].items():
            if "/bucketed/" in key:
                np.testing.assert_array_equal(
                    x, ranks[r][key.replace("bucketed", "psum")])


def test_dbtree_and_schedules_match_naive_on_3_ranks(tmp_path):
    """Three ranks: the trees' levels are sparse (rank 2 sits out of level
    0 of tree A); every schedule still equals the naive mean and each
    rank's reduce-scatter shard is its row of it (the checks run inside
    the ranks)."""
    ranks = torch_ranks.launch("schedules", 3, str(tmp_path))
    for key in ranks[0]:
        assert key.split("/")[0] in ("flat", "dm")
    assert any("/dbtree/" in k for k in ranks[0])


def test_zero1_step_matches_replicated_on_2_ranks(tmp_path):
    ranks = torch_ranks.launch("zero1_step", 2, str(tmp_path))
    assert set(ranks[0]) == {f"{s}/o{int(o)}u{int(u)}"
                             for s, o, u in torch_ranks.ZERO1_CASES}
    for r in ranks:
        assert all(float(v) <= torch_ranks.TOL for v in r.values())


def test_zero2_zero3_steps_match_replicated_on_2_ranks(tmp_path):
    ranks = torch_ranks.launch("zero23_step", 2, str(tmp_path))
    assert set(ranks[0]) == {torch_ranks.zero23_key(*c)
                             for c in torch_ranks.ZERO23_CASES}
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
