"""The port's CUDA kernels on the card against their plain versions.

Marked ``gpu``: each test decides inside itself whether there is a card and
skips without one, so every pytest worker collects the same tests. On a
machine with a card (no jax needed, hence --noconftest):
  PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import bucketing, lars, pinit
from repro_torch.core.bucketing import CHUNK
from repro_torch.kernels import batched_norm, ops, ref
from repro_torch.models import resnet
from repro_torch.tree import tree_flatten

pytestmark = [pytest.mark.tier1, pytest.mark.gpu]


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _full_width_plan():
    return bucketing.make_plan(resnet.resnet_pd(get_config("resnet50"))[0])


@pytest.mark.parametrize("case", ["1x1", "4x2", "16x5", "7x7", "32x3",
                                  "ragged", "main_path"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_sumsq_kernel_matches_plain(case, dtype):
    dev = _card()
    rng = np.random.default_rng(0)
    if case == "main_path":           # ResNet-50's plan: 25,021 x 161
        plan = _full_width_plan()
        seg, n_tensors = bucketing.segment_ids(plan), plan.n_tensors
    elif case == "ragged":            # empty segments, long runs
        seg = np.sort(rng.choice([0, 2, 3, 9], 3000)).astype(np.int32)
        n_tensors = 11
    else:
        n_chunks, n_tensors = map(int, case.split("x"))
        seg = np.sort(np.arange(n_chunks) % n_tensors).astype(np.int32)
    x = torch.from_numpy(rng.standard_normal(seg.size * CHUNK)
                         .astype(np.float32)).to(dev, dtype)
    seg_t = torch.from_numpy(seg).to(dev)
    before = batched_norm.batched_sumsq.launches
    got = ops.batched_sumsq(x, seg_t, n_tensors)
    torch.cuda.synchronize()
    assert batched_norm.batched_sumsq.launches == before + 1
    want = ref.batched_sumsq(x, seg_t, n_tensors)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=0)
    # deterministic: no atomics, fixed summation order
    assert torch.equal(ops.batched_sumsq(x, seg_t, n_tensors), got)


def test_batched_sumsq_kernel_rejects_bad_inputs():
    dev = _card()
    seg = torch.zeros(2, dtype=torch.int32, device=dev)
    x = torch.zeros(2 * CHUNK, device=dev)
    with pytest.raises(TypeError):
        batched_norm.batched_sumsq(x.half(), seg, 1)
    with pytest.raises(TypeError):
        batched_norm.batched_sumsq(x, seg.long(), 1)
    with pytest.raises(ValueError):
        batched_norm.batched_sumsq(x[:CHUNK], seg, 1)
    with pytest.raises(ValueError):
        batched_norm.batched_sumsq(torch.zeros(2 * CHUNK + 1, device=dev)[1:],
                                   seg, 1)


def test_tree_norms_on_card_match_per_tensor_norms():
    dev = _card()
    params = pinit.materialize(resnet.resnet_pd(get_config("resnet50"))[0],
                               0, dev)
    got = dict(tree_flatten(ops.tree_norms(params)))
    want = dict(tree_flatten(lars.tensor_norms(params)))
    for path in want:
        torch.testing.assert_close(got[path], want[path], rtol=1e-5, atol=0)
