"""Fused LARS weight update over the CHUNK-packed fp32 shards of the ZeRO-1
path: weight decay, momentum and the trust-scaled step in one pass.

Replaces the Pallas kernel ``repro/kernels/lars_update.py::
lars_packed_update`` with the hand-written CUDA kernel
``csrc/lars_update.cu`` (one 16-byte vector of each operand a thread and a
chunk; the source says why and what bounds it).

Layout (produced by ``repro_torch.core.bucketing``'s shard helpers):
  p, g, m  : (n_chunks * CHUNK,) f32
  trust    : (n_tensors,) f32, indexed by tensor id
  seg_ids  : (n_chunks,) int32, which tensor each chunk is
  lr       : float or 0-d f32 tensor (the kernel reads it on the device)

``lars_packed_update_multi`` is the same update over every bucket's
shards at once, in place (the sharded step's call site): one C call, where
a loop of ``lars_packed_update`` calls would pay the host's cost and a
launch for every bucket.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

from repro_torch.core.bucketing import CHUNK
from repro_torch.kernels import backend, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _entry():
    fn = backend.load_library("lars_update").lars_packed_update_f32
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _I, _I, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _multi_entry():
    fn = backend.load_library("lars_update").lars_packed_update_multi_f32
    fn.argtypes = [_P, _P, _I, _P, _P, _P, _F, _F, _I, _I, _P]
    fn.restype = _I
    return fn


def _check_side(what, trust, seg_ids, dev):
    """trust and seg_ids: dtype, rank, device, contiguity."""
    if trust.dtype != torch.float32 or trust.dim() != 1:
        raise TypeError(f"{what}: trust must be a 1-D float32 tensor")
    if seg_ids.dtype != torch.int32 or seg_ids.dim() != 1:
        raise TypeError(f"{what}: seg_ids must be a 1-D int32 tensor")
    for name, x in (("trust", trust), ("seg_ids", seg_ids)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous, on "
                             f"{dev}, not {x.device}")


def _check(p, g, m, trust, seg_ids):
    what = "lars_packed_update"
    _check_side(what, trust, seg_ids, p.device)
    n_chunks = seg_ids.shape[0]
    for name, x in (("p", p), ("g", g), ("m", m)):
        if x.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, not {x.dtype}")
        if x.shape != (n_chunks * CHUNK,):
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, "
                             f"expected ({n_chunks} * {CHUNK},)")
        if x.device != p.device or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous, on "
                             f"{p.device}, not {x.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _lr_on(lr, dev):
    """``lr`` as a 0-d f32 tensor on ``dev``: a device tensor as it is,
    anything else put there without waiting for the device (a blocking
    copy, as ``torch.tensor(x, device=)`` makes, would)."""
    if isinstance(lr, torch.Tensor):
        if lr.numel() != 1:
            raise ValueError("lars_packed_update: lr must be a scalar")
        if lr.device == dev and lr.dtype == torch.float32:
            return lr
        return lr.reshape(()).to(device=dev, dtype=torch.float32,
                                 non_blocking=True)
    return torch.full((), float(lr), dtype=torch.float32, device=dev)


def _stream(dev):
    # the handle itself: torch.cuda.current_stream() builds a Stream
    # object under a device switch, several us on the host
    return torch._C._cuda_getCurrentRawStream(dev.index)


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
    lr_dev = _lr_on(lr, p.device)
    p_out, m_out = (p, m) if inplace else (torch.empty_like(p),
                                           torch.empty_like(m))
    with backend.on_device(p.device):
        rc = _entry()(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                      p_out.data_ptr(), m_out.data_ptr(), trust.data_ptr(),
                      seg_ids.data_ptr(), lr_dev.data_ptr(), momentum, wd,
                      seg_ids.shape[0], trust.shape[0], _stream(p.device))
    lars_packed_update.launches += 1
    backend.check_launch(rc, "lars_packed_update")
    return p_out, m_out


lars_packed_update.launches = 0


def _check_multi(p_shards, g_shards, m_shards, trust, seg_ids):
    """The buffers p, g, m in that order and the per-bucket chunk counts of
    ``lars_packed_update_multi``'s shards, or a raise where the kernel
    would read or write what it must not. Few reads a buffer: the step's
    call checks 48 buffers on the host every step, and on a four-card
    rank the kernel takes ~46 us."""
    what = "lars_packed_update_multi"
    n = len(p_shards)
    if not n or len(g_shards) != n or len(m_shards) != n:
        raise ValueError(f"{what}: needs p, g and m sequences of one "
                         f"non-zero length, not {n}, {len(g_shards)} and "
                         f"{len(m_shards)}")
    bufs = (*p_shards, *g_shards, *m_shards)
    dev = bufs[0].device
    _check_side(what, trust, seg_ids, dev)
    f32 = torch.float32
    bad = [x for x in bufs if x.dtype is not f32 or x.device != dev
           or not x.is_contiguous()]
    if bad and bad[0].dtype is not f32:
        raise TypeError(f"{what}: buffers must be float32, not "
                        f"{bad[0].dtype}")
    if bad:
        raise ValueError(f"{what}: buffers must be contiguous, on {dev}, "
                         f"not {bad[0].device}")
    shapes = [x.shape for x in bufs]
    if shapes[n:2 * n] != shapes[:n] or shapes[2 * n:] != shapes[:n]:
        raise ValueError(f"{what}: p, g and m have shapes "
                         f"{[tuple(s) for s in shapes]}, not equal bucket "
                         f"by bucket")
    counts = []
    for s in shapes[:n]:
        if len(s) != 1 or s[0] % CHUNK:
            raise ValueError(f"{what}: a buffer has shape {tuple(s)}, not "
                             f"(n * {CHUNK},)")
        counts.append(s[0] // CHUNK)
    if sum(counts) != seg_ids.shape[0]:
        raise ValueError(f"{what}: the shards hold {sum(counts)} chunks, "
                         f"seg_ids {seg_ids.shape[0]}")
    return bufs, counts


def lars_packed_update_multi(p_shards, g_shards, m_shards, trust, seg_ids,
                             *, lr, momentum: float, wd: float):
    """``lars_packed_update`` of every bucket's shards in place:
    ``p_shards``, ``g_shards`` and ``m_shards`` are B buffers each, bucket
    b's three of ``n_b * CHUNK`` f32 elements; ``seg_ids`` the (sum of
    n_b,) int32 segment map over the buckets' chunks concatenated. Returns
    ``(p_shards, m_shards)`` as tuples of the buffers given, updated.

    A CPU tensor takes the plain version (``kernels/ref``) after the same
    checks. A CUDA tensor makes one C call for all buckets on the current
    stream (one launch for up to 128 buckets), or raises: there is no
    fallback. Each call adds one to ``lars_packed_update.launches``: it is
    the same kernel."""
    bufs, counts = _check_multi(p_shards, g_shards, m_shards, trust,
                                seg_ids)
    addrs = [x.data_ptr() for x in bufs]
    if any(a % 16 for a in addrs):
        raise ValueError("lars_packed_update_multi: buffers must be 16-byte "
                         "aligned")
    dev = bufs[0].device
    if dev.type == "cpu":
        return ref.lars_packed_update_multi(p_shards, g_shards, m_shards,
                                            trust, seg_ids, lr=lr,
                                            momentum=momentum, wd=wd)
    if dev.type != "cuda":
        raise ValueError(f"lars_packed_update_multi: no kernel for {dev}")
    n = len(counts)
    lr_dev = _lr_on(lr, dev)
    with backend.on_device(dev):
        # the pointer and count tables packed in C order in one step each:
        # ctypes arrays cost ~1 us a buffer to build
        rc = _multi_entry()(struct.pack(f"{3 * n}Q", *addrs),
                            struct.pack(f"{n}i", *counts), n,
                            trust.data_ptr(), seg_ids.data_ptr(),
                            lr_dev.data_ptr(), momentum, wd,
                            seg_ids.shape[0], trust.shape[0], _stream(dev))
    lars_packed_update.launches += 1
    backend.check_launch(rc, "lars_packed_update_multi")
    return tuple(p_shards), tuple(m_shards)
