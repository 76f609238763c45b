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

import contextlib
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
    # a device switch is host time on every fold; the ring folds on the
    # rank's current device, where none is needed
    ctx = (contextlib.nullcontext()
           if recv.device.index == torch.cuda.current_device()
           else torch.cuda.device(recv.device))
    with ctx:
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


def kernel_step_fn():
    """Adapter with ``primitives.default_step_fn``'s signature. It folds
    in place into ``recv``: the ring primitive owns that buffer (a fresh
    receive) and reads it only through the fold.

    One ring reduce-scatter folds every step against the same ``chunks``
    with receives of one shape, so the full check runs on the first fold
    of each ``chunks``; later folds check ``k`` and recv's shape and dtype
    only."""
    checked = None

    def fold(recv, chunks, k):
        nonlocal checked
        if checked is not chunks:
            _check(recv, chunks, k, recv)
            checked = chunks
        else:
            _check_k(k, chunks.shape[0])
            if (recv.shape, recv.dtype) != (chunks.shape[1:], chunks.dtype):
                _check(recv, chunks, k, recv)
        return _fold(recv, chunks, k, recv)
    return fold
