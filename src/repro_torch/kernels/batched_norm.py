"""Batched multi-tensor sum of squares (paper §III-B.2): the LARS norms of
every tensor in one pass over the CHUNK-packed buffer.

Replaces the Pallas kernel ``repro/kernels/batched_norm.py::batched_sumsq``
with the hand-written CUDA kernel ``csrc/batched_norm.cu`` (two passes, no
atomics, deterministic; the source says why and what bounds it).

Layout (produced by ``repro_torch.core.bucketing``):
  flat     : (n_chunks * CHUNK,) f32 or bf16, tensors zero-padded to CHUNK
  seg_ids  : (n_chunks,) int32, non-decreasing: which tensor each chunk is
  result   : (n_tensors,) f32

``batched_sumsq_multi`` is the same function over several buffers at once
(the ZeRO step's p and g shards of every bucket): one C call, where a loop
of ``batched_sumsq`` calls would pay the host's cost for every buffer.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.bucketing import CHUNK
from repro_torch.kernels import backend, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    fn = getattr(backend.load_library("batched_norm"),
                 f"batched_sumsq_{_SUFFIX[dtype]}")
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _multi_entry(dtype):
    fn = getattr(backend.load_library("batched_norm"),
                 f"batched_sumsq_multi_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _P, _I, _I,
                   _P, _P, _I, _P]
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
    if flat.dtype not in _SUFFIX:
        raise TypeError(f"batched_sumsq: dtype {flat.dtype} not in "
                        f"{list(_SUFFIX)}")
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
    with backend.on_device(flat.device):
        rc = _entry(flat.dtype)(flat.data_ptr(), seg_ids.data_ptr(),
                                partial.data_ptr(), out.data_ptr(), n_chunks,
                                n_tensors,
                                torch.cuda.current_stream().cuda_stream)
    batched_sumsq.launches += 1
    backend.check_launch(rc, "batched_sumsq")
    return out


batched_sumsq.launches = 0


def _check_multi(rows, seg_ids):
    """The per-buffer chunk counts of ``batched_sumsq_multi``'s rows, or a
    raise where the kernel would read what it must not. Few reads a
    buffer: the step's call checks 32 buffers on the host every step."""
    if not rows or not rows[0]:
        raise ValueError("batched_sumsq_multi: needs at least one row of "
                         "one buffer")
    first = rows[0][0]
    if first.dtype not in _SUFFIX:
        raise TypeError(f"batched_sumsq_multi: dtype {first.dtype} not in "
                        f"{list(_SUFFIX)}")
    if seg_ids.dtype != torch.int32 or seg_ids.dim() != 1:
        raise TypeError("batched_sumsq_multi: seg_ids must be a 1-D int32 "
                        "tensor")
    if seg_ids.device != first.device or not seg_ids.is_contiguous():
        raise ValueError("batched_sumsq_multi: seg_ids must be contiguous, "
                         "on the buffers' device")
    shapes = [x.shape for x in rows[0]]
    for s in shapes:
        if len(s) != 1 or s[0] % CHUNK:
            raise ValueError(f"batched_sumsq_multi: a buffer has shape "
                             f"{tuple(s)}, not (n * {CHUNK},)")
    counts = [s[0] // CHUNK for s in shapes]
    if sum(counts) != seg_ids.shape[0]:
        raise ValueError(f"batched_sumsq_multi: a row holds {sum(counts)} "
                         f"chunks, seg_ids {seg_ids.shape[0]}")
    dtype, dev = first.dtype, first.get_device()
    for r, row in enumerate(rows):
        if len(row) != len(shapes):
            raise ValueError(f"batched_sumsq_multi: row {r} has {len(row)} "
                             f"buffers, row 0 {len(shapes)}")
        if r and [x.shape for x in row] != shapes:
            x, s = next((x, s) for x, s in zip(row, shapes) if x.shape != s)
            raise ValueError(f"batched_sumsq_multi: row {r} has a buffer "
                             f"of shape {tuple(x.shape)}, row 0 {tuple(s)}")
        for x in row:
            if x.dtype != dtype:
                raise TypeError(f"batched_sumsq_multi: mixed dtypes "
                                f"{dtype} and {x.dtype}")
            if x.get_device() != dev or not x.is_contiguous():
                raise ValueError("batched_sumsq_multi: buffers must be "
                                 "contiguous, on one device")
    return counts


def batched_sumsq_multi(rows, seg_ids, n_tensors: int):
    """``batched_sumsq`` of each row's buffers taken as one packed buffer:
    ``rows`` is R sequences of B buffers, buffer b of ``n_b * CHUNK``
    elements in every row; ``seg_ids`` the (sum of n_b,) int32 segment map
    over a row's concatenated chunks, non-decreasing. Returns (R,
    n_tensors) f32.

    A CPU tensor takes the plain version (``kernels/ref``), after the same
    checks and a check that ``seg_ids`` is non-decreasing (on the card
    that would need a device sync; the caller checks its map once on the
    host). A CUDA tensor launches the kernel on the current stream, one C
    call for all buffers, or raises: there is no fallback. Each call adds
    one to ``batched_sumsq.launches``: it is the same kernel."""
    rows = [list(row) for row in rows]
    counts = _check_multi(rows, seg_ids)
    first = rows[0][0]
    if first.device.type == "cpu":
        if seg_ids.numel() > 1 and bool((seg_ids[1:] < seg_ids[:-1]).any()):
            raise ValueError("batched_sumsq_multi: seg_ids must be "
                             "non-decreasing")
        return ref.batched_sumsq_multi(rows, seg_ids, n_tensors)
    if first.device.type != "cuda":
        raise ValueError(f"batched_sumsq_multi: no kernel for "
                         f"{first.device}")
    n_rows, n_chunks = len(rows), seg_ids.shape[0]
    addrs = [x.data_ptr() for row in rows for x in row]
    align = 4 * first.element_size()
    if any(a % align for a in addrs):
        raise ValueError("batched_sumsq_multi: buffers must be aligned to 4 "
                         "elements")
    ptrs = (_P * len(addrs))(*addrs)
    sizes = (_I * len(addrs))(*(counts * n_rows))
    partial = torch.empty(n_rows * n_chunks, dtype=torch.float32,
                          device=first.device)
    out = torch.empty(n_rows, n_tensors, dtype=torch.float32,
                      device=first.device)
    with backend.on_device(first.device):
        rc = _multi_entry(first.dtype)(
            ptrs, sizes, len(addrs), seg_ids.data_ptr(), n_chunks, n_rows,
            partial.data_ptr(), out.data_ptr(), n_tensors,
            torch.cuda.current_stream().cuda_stream)
    batched_sumsq.launches += 1
    backend.check_launch(rc, "batched_sumsq_multi")
    return out
