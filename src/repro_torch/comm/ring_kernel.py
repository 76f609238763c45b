"""The ring-step fold kernel: the add inside every ring reduce-scatter step
(paper §III-C), ``out = recv + chunks[k]``.

Replaces the Pallas kernel ``repro/comm/ring_kernel.py::ring_add_step``
with the hand-written CUDA kernel ``kernels/csrc/ring_add.cu`` (a
grid-stride pass over 16-byte vectors, added in f32 and rounded once: bit
for bit the plain version; the source says why and what bounds it).

Layout contract, kept by the ring schedules through ``pad_to=CHUNK``:
  chunks : (n, c) with c % CHUNK == 0, the zero-padded chunk rows
  recv   : (c,), the partial sum received from the ring neighbour
  k      : host int in [0, n), which local chunk to fold in
The result is in recv's dtype, the wire dtype (bf16 by default); chunks
must share it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.bucketing import CHUNK
from repro_torch.kernels import backend, ref

_P = ctypes.c_void_p
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = backend.load_library("ring_add").ring_add_step
    fn.argtypes = [_P, _P, ctypes.c_int, _P, ctypes.c_longlong, ctypes.c_int,
                   _P]
    fn.restype = ctypes.c_int
    return fn


def _check(recv, chunks, k, out):
    if chunks.dim() != 2 or chunks.shape[1] % CHUNK:
        raise ValueError(f"ring_add_step: chunks must be (n, c) with c % "
                         f"{CHUNK} == 0, not {tuple(chunks.shape)}")
    n, c = chunks.shape
    if tuple(recv.shape) != (c,):
        raise ValueError(f"ring_add_step: recv has shape {tuple(recv.shape)},"
                         f" chunks rows are ({c},)")
    _check_k(k, n)
    if recv.dtype not in _DTYPES:
        raise TypeError(f"ring_add_step: dtype {recv.dtype} not in "
                        f"{list(_DTYPES)}")
    if chunks.dtype != recv.dtype:
        raise TypeError(f"ring_add_step: chunks are {chunks.dtype}, recv "
                        f"{recv.dtype}")
    if out is not None:
        if out.shape != recv.shape or out.dtype != recv.dtype:
            raise ValueError("ring_add_step: out must match recv's shape and "
                             "dtype")
        if out.device != recv.device or not out.is_contiguous():
            raise ValueError("ring_add_step: out must be contiguous, on "
                             "recv's device")
    if chunks.device != recv.device:
        raise ValueError(f"ring_add_step: chunks on {chunks.device}, recv on "
                         f"{recv.device}")
    if not (recv.is_contiguous() and chunks.is_contiguous()):
        raise ValueError("ring_add_step: recv and chunks must be contiguous")


def _check_k(k, n):
    if isinstance(k, bool) or not isinstance(k, int) or not 0 <= k < n:
        raise ValueError(f"ring_add_step: k must be a host int in [0, {n}), "
                         f"not {k!r}")


def _fold(recv, chunks, k, out):
    """The checked fold: the plain version on the CPU, else one launch."""
    if recv.device.type == "cpu":
        want = ref.ring_add_step(recv, chunks, k)
        return want if out is None else out.copy_(want)
    if recv.device.type != "cuda":
        raise ValueError(f"ring_add_step: no kernel for {recv.device}")
    if out is None:
        out = torch.empty_like(recv)
    with backend.on_device(recv.device):
        rc = _entry()(recv.data_ptr(), chunks.data_ptr(), k, out.data_ptr(),
                      chunks.shape[1], _DTYPES[recv.dtype],
                      torch.cuda.current_stream().cuda_stream)
    ring_add_step.launches += 1
    backend.check_launch(rc, "ring_add_step")
    return out


def ring_add_step(recv, chunks, k: int, *, out=None):
    """``recv + chunks[k]`` (see the module docstring), into ``out`` when
    given (it may be ``recv`` itself); ``chunks`` is never written.

    A CPU tensor takes the plain version (``kernels/ref``). A CUDA tensor
    launches the kernel on the current stream, or raises: there is no
    fallback. ``ring_add_step.launches`` counts kernel launches."""
    _check(recv, chunks, k, out)
    return _fold(recv, chunks, k, out)


ring_add_step.launches = 0


@functools.lru_cache(maxsize=None)
def _inplace_entry(dtype):
    fn = getattr(backend.load_library("ring_add"),
                 "ring_add_f32" if dtype == torch.float32 else "ring_add_bf16")
    fn.argtypes = [_P, _P, ctypes.c_longlong, _P]
    fn.restype = ctypes.c_int
    return fn


def kernel_step_fn():
    """Adapter with ``primitives.default_step_fn``'s signature. It folds
    in place into ``recv``: the ring primitive owns that buffer (a fresh
    receive) and reads it only through the fold.

    One ring reduce-scatter folds every step against the same ``chunks``
    with receives of one shape, on one device and one stream. So the
    first fold against a ``chunks`` runs the wrapper's full check and, on
    the card, binds what every later fold reuses: the typed in-place C
    entry, chunks' base pointer and row stride, ``c``, the dtype, the
    device (which must be the current one) and the current stream's
    handle, read once: the ring does not change streams within a
    reduce-scatter, and a caller that does needs a new adapter. A later
    fold checks ``k`` and that recv has the bound dtype, shape and device
    and is contiguous (a mismatch is one the full check rejects, with the
    wrapper's message), then makes one C call at row k. A CPU tensor takes
    the plain version, checked in full every fold. One adapter serves one
    bucket's reduce-scatter (``comm/schedules.py``), so nothing bound
    outlives the bucket."""
    bound = fn = base = row_bytes = n = c = shape = dtype = dev = None
    stream = None

    def fold(recv, chunks, k):
        nonlocal bound, fn, base, row_bytes, n, c, shape, dtype, dev, stream
        if chunks is not bound:
            _check(recv, chunks, k, None)     # out is recv: nothing more
            if recv.device.type != "cuda":
                return _fold(recv, chunks, k, recv)
            dev = recv.get_device()
            if dev != torch.cuda.current_device():
                raise ValueError(f"ring_add_step: recv on {recv.device}, "
                                 f"the current device is cuda:"
                                 f"{torch.cuda.current_device()}")
            fn = _inplace_entry(recv.dtype)
            base = chunks.data_ptr()
            row_bytes = chunks.stride(0) * chunks.element_size()
            (n, c), shape, dtype = chunks.shape, recv.shape, recv.dtype
            # the handle itself: torch.cuda.current_stream() builds a
            # Stream object under a device switch, several us on the host
            stream = torch._C._cuda_getCurrentRawStream(dev)
            bound = chunks
        else:
            if type(k) is not int or not 0 <= k < n:
                _check_k(k, n)
            if (recv.dtype != dtype or recv.shape != shape
                    or recv.get_device() != dev or not recv.is_contiguous()):
                _check(recv, chunks, k, recv)      # raises the message
        rc = fn(recv.data_ptr(), base + k * row_bytes, c, stream)
        ring_add_step.launches += 1
        if rc:
            backend.check_launch(rc, "ring_add_step")
        return recv
    return fold
