"""Fused LARS weight update over the CHUNK-packed fp32 shards of the ZeRO-1
path: weight decay, momentum and the trust-scaled step in one pass.

Replaces the Pallas kernel ``repro/kernels/lars_update.py::
lars_packed_update`` with the hand-written CUDA kernel
``csrc/lars_update.cu`` (one block per chunk, one 16-byte vector of each
operand a thread; the source says why and what bounds it).

Layout (produced by ``repro_torch.core.bucketing``'s shard helpers):
  p, g, m  : (n_chunks * CHUNK,) f32
  trust    : (n_tensors,) f32, indexed by tensor id
  seg_ids  : (n_chunks,) int32, which tensor each chunk is
  lr       : float or 0-d f32 tensor (the kernel reads it on the device)
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.bucketing import CHUNK
from repro_torch.kernels import backend, ref

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _entry():
    fn = backend.load_library("lars_update").lars_packed_update_f32
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    return fn


def _check(p, g, m, trust, seg_ids):
    n_chunks = seg_ids.shape[0] if seg_ids.dim() == 1 else -1
    for name, x in (("p", p), ("g", g), ("m", m), ("trust", trust)):
        if x.dtype != torch.float32:
            raise TypeError(f"lars_packed_update: {name} must be float32, "
                            f"not {x.dtype}")
    if seg_ids.dtype != torch.int32 or n_chunks < 0:
        raise TypeError("lars_packed_update: seg_ids must be a 1-D int32 "
                        "tensor")
    for name, x in (("p", p), ("g", g), ("m", m)):
        if x.shape != (n_chunks * CHUNK,):
            raise ValueError(
                f"lars_packed_update: {name} has shape {tuple(x.shape)}, "
                f"expected ({n_chunks} * {CHUNK},)")
    if trust.dim() != 1:
        raise ValueError("lars_packed_update: trust must be 1-D")
    for name, x in (("p", p), ("g", g), ("m", m), ("trust", trust),
                    ("seg_ids", seg_ids)):
        if x.device != p.device:
            raise ValueError(f"lars_packed_update: {name} is on {x.device}, "
                             f"p on {p.device}")
        if not x.is_contiguous():
            raise ValueError(f"lars_packed_update: {name} must be "
                             f"contiguous")
    for name, x in (("p", p), ("g", g), ("m", m)):
        if x.data_ptr() % 16:
            raise ValueError(f"lars_packed_update: {name} must be 16-byte "
                             f"aligned")


def lars_packed_update(p, g, m, trust, seg_ids, *, lr, momentum: float,
                       wd: float, inplace: bool = False):
    """One packed LARS step (see module docstring). Returns (new_p, new_m);
    with ``inplace=True`` they are ``p`` and ``m`` themselves, updated.

    A CPU tensor takes the plain version (``kernels/ref``). A CUDA tensor
    launches the kernel on the current stream, or raises: there is no
    fallback. Segment ids must lie in ``[0, len(trust))``; that is not
    checked, as it would need a device sync (the kernel writes NaN for a
    chunk whose id does not). ``lars_packed_update.launches`` counts
    kernel launches."""
    _check(p, g, m, trust, seg_ids)
    if p.device.type == "cpu":
        p2, m2 = ref.lars_packed_update(p, g, m, trust, seg_ids, lr=lr,
                                        momentum=momentum, wd=wd)
        if not inplace:
            return p2, m2
        p.copy_(p2)
        m.copy_(m2)
        return p, m
    if p.device.type != "cuda":
        raise ValueError(f"lars_packed_update: no kernel for {p.device}")
    if isinstance(lr, torch.Tensor):
        if lr.numel() != 1:
            raise ValueError("lars_packed_update: lr must be a scalar")
        lr_dev = lr.reshape(()).to(device=p.device, dtype=torch.float32,
                                   non_blocking=True)
    else:
        lr_dev = torch.tensor(float(lr), dtype=torch.float32).to(
            p.device, non_blocking=True)
    p_out, m_out = (p, m) if inplace else (torch.empty_like(p),
                                           torch.empty_like(m))
    with torch.cuda.device(p.device):
        rc = _entry()(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                      p_out.data_ptr(), m_out.data_ptr(), trust.data_ptr(),
                      seg_ids.data_ptr(), lr_dev.data_ptr(), momentum, wd,
                      seg_ids.shape[0], trust.shape[0],
                      torch.cuda.current_stream().cuda_stream)
    lars_packed_update.launches += 1
    backend.check_launch(rc, "lars_packed_update")
    return p_out, m_out


lars_packed_update.launches = 0
