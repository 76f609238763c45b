"""Batched multi-tensor sum of squares (paper §III-B.2): the LARS norms of
every tensor in one pass over the CHUNK-packed buffer.

Replaces the Pallas kernel ``repro/kernels/batched_norm.py::batched_sumsq``
with the hand-written CUDA kernel ``csrc/batched_norm.cu`` (two passes, no
atomics, deterministic; the source says why and what bounds it).

Layout (produced by ``repro_torch.core.bucketing``):
  flat     : (n_chunks * CHUNK,) f32 or bf16, tensors zero-padded to CHUNK
  seg_ids  : (n_chunks,) int32, non-decreasing: which tensor each chunk is
  result   : (n_tensors,) f32
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.bucketing import CHUNK
from repro_torch.kernels import backend, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = {torch.float32: "batched_sumsq_f32",
          torch.bfloat16: "batched_sumsq_bf16"}


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    fn = getattr(backend.load_library("batched_norm"), _ENTRY[dtype])
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _P]
    fn.restype = _I
    return fn


def batched_sumsq(flat, seg_ids, n_tensors: int):
    """Per-segment f32 sum of squares (see module docstring).

    A CPU tensor takes the plain version (``kernels/ref``). A CUDA tensor
    launches the kernel on the current stream, or raises: there is no
    fallback. ``seg_ids`` must be non-decreasing (the kernel finds each
    segment by binary search); that is not checked, as it would need a
    device sync. ``batched_sumsq.launches`` counts kernel launches."""
    if flat.device.type == "cpu":
        return ref.batched_sumsq(flat, seg_ids, n_tensors)
    if flat.device.type != "cuda":
        raise ValueError(f"batched_sumsq: no kernel for {flat.device}")
    n_chunks = seg_ids.shape[0]
    if flat.dtype not in _ENTRY:
        raise TypeError(f"batched_sumsq: dtype {flat.dtype} not in "
                        f"{list(_ENTRY)}")
    if seg_ids.dtype != torch.int32 or seg_ids.dim() != 1:
        raise TypeError("batched_sumsq: seg_ids must be a 1-D int32 tensor")
    if flat.shape != (n_chunks * CHUNK,):
        raise ValueError(f"batched_sumsq: flat has shape {tuple(flat.shape)}"
                         f", expected ({n_chunks} * {CHUNK},)")
    if seg_ids.device != flat.device:
        raise ValueError("batched_sumsq: seg_ids and flat on different "
                         "devices")
    if not (flat.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("batched_sumsq: inputs must be contiguous")
    if flat.data_ptr() % (4 * flat.element_size()):
        raise ValueError("batched_sumsq: flat must be aligned to 4 elements")
    partial = torch.empty(n_chunks, dtype=torch.float32, device=flat.device)
    out = torch.empty(n_tensors, dtype=torch.float32, device=flat.device)
    with torch.cuda.device(flat.device):
        rc = _entry(flat.dtype)(flat.data_ptr(), seg_ids.data_ptr(),
                                partial.data_ptr(), out.data_ptr(), n_chunks,
                                n_tensors,
                                torch.cuda.current_stream().cuda_stream)
    batched_sumsq.launches += 1
    backend.check_launch(rc, "batched_sumsq")
    return out


batched_sumsq.launches = 0
