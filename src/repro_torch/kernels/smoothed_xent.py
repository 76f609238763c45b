"""Label-smoothed cross entropy per row (the LM loss's per-row NLL), with
its gradient.

Replaces the Pallas kernel ``repro/kernels/smoothed_xent.py::
smoothed_xent_rows`` with the hand-written CUDA kernels
``csrc/smoothed_xent.cu`` (one 256-thread block a row, online max and
sum-exp in f32 registers; the source says why and what bounds it). The
reference differentiates its jnp loss; here the gradient is a kernel of
its own, so no (T, V) softmax is materialised beside the logits:

  forward   nll[t] = lse[t] - ((1-ε)·x[t, y_t] + ε·mean_v x[t, v])
  backward  dx[t, v] = g[t]·(exp(x[t, v] - lse[t]) - (1-ε)·[v = y_t] - ε/V)

Layout: logits (T, V) f32 or bf16, contiguous; labels (T,) integer (a
label outside [0, V), IGNORE, takes no target logit); result (T,) f32; dx
in the logits' dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import backend, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _entries():
    lib = backend.load_library("smoothed_xent")
    fwd, bwd = lib.smoothed_xent_fwd, lib.smoothed_xent_bwd
    fwd.argtypes = [_P, _I, _P, _P, _P, _L, _L, _F, _F, _P]
    bwd.argtypes = [_P, _I, _P, _P, _P, _P, _L, _L, _F, _F, _P]
    fwd.restype = bwd.restype = _I
    return fwd, bwd


def _check(logits, labels, what):
    if logits.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {logits.device}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"{what}: logits dtype {logits.dtype} not in "
                        f"{list(_DTYPES)}")
    if logits.dim() != 2 or logits.shape[1] == 0:
        raise ValueError(f"{what}: logits must be (T, V) with V > 0, not "
                         f"{tuple(logits.shape)}")
    if labels.shape != logits.shape[:1]:
        raise ValueError(f"{what}: labels {tuple(labels.shape)} do not fit "
                         f"logits {tuple(logits.shape)}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{what}: labels must be int32 or int64")
    if labels.device != logits.device:
        raise ValueError(f"{what}: labels on {labels.device}, logits on "
                         f"{logits.device}")
    if not logits.is_contiguous():
        raise ValueError(f"{what}: logits must be contiguous")
    if logits.data_ptr() % logits.element_size():
        raise ValueError(f"{what}: logits must be element-aligned")
    return labels.to(torch.int32).contiguous()


def smoothed_xent_rows_forward(logits, labels, smoothing: float):
    """Launch the forward kernel: (nll, lse), both (T,) f32.
    ``smoothed_xent_rows_forward.launches`` counts kernel launches."""
    labels = _check(logits, labels, "smoothed_xent_rows")
    T, V = logits.shape
    nll = torch.empty(T, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(nll)
    with torch.cuda.device(logits.device):
        rc = _entries()[0](logits.data_ptr(), _DTYPES[logits.dtype],
                           labels.data_ptr(), nll.data_ptr(), lse.data_ptr(),
                           T, V, 1.0 - smoothing, smoothing,
                           torch.cuda.current_stream().cuda_stream)
    smoothed_xent_rows_forward.launches += 1
    backend.check_launch(rc, "smoothed_xent_rows")
    return nll, lse


smoothed_xent_rows_forward.launches = 0


def smoothed_xent_rows_backward(logits, labels, lse, grad,
                                smoothing: float):
    """Launch the backward kernel: dx (T, V) in the logits' dtype from the
    forward's ``lse`` and ``grad`` = dloss/dnll, both (T,) f32. A row whose
    grad is 0 comes out exactly 0. ``smoothed_xent_rows_backward.launches``
    counts kernel launches."""
    labels = _check(logits, labels, "smoothed_xent_rows_backward")
    T, V = logits.shape
    grad = grad.to(torch.float32).contiguous()
    lse = lse.to(torch.float32).contiguous()
    for name, x in (("lse", lse), ("grad", grad)):
        if x.shape != (T,) or x.device != logits.device:
            raise ValueError(f"smoothed_xent_rows_backward: {name} must be "
                             f"({T},) on {logits.device}")
    dx = torch.empty_like(logits)
    with torch.cuda.device(logits.device):
        rc = _entries()[1](logits.data_ptr(), _DTYPES[logits.dtype],
                           labels.data_ptr(), lse.data_ptr(), grad.data_ptr(),
                           dx.data_ptr(), T, V, 1.0 - smoothing,
                           smoothing / V,
                           torch.cuda.current_stream().cuda_stream)
    smoothed_xent_rows_backward.launches += 1
    backend.check_launch(rc, "smoothed_xent_rows_backward")
    return dx


smoothed_xent_rows_backward.launches = 0


class _Rows(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing):
        nll, lse = smoothed_xent_rows_forward(logits, labels, smoothing)
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing = smoothing
        return nll

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        logits, labels, lse = ctx.saved_tensors
        return (smoothed_xent_rows_backward(logits, labels, lse, grad,
                                            ctx.smoothing), None, None)


def smoothed_xent_rows(logits, labels, smoothing: float = 0.1):
    """Per-row smoothed NLL (see module docstring), differentiable in
    ``logits``.

    A CPU tensor takes the plain version (``kernels/ref``), differentiated
    by autograd. A CUDA tensor launches the forward kernel on the current
    stream, and the backward kernel when autograd asks for the gradient, or
    raises: there is no fallback. The launchers count their launches
    (``smoothed_xent_rows_forward.launches``,
    ``smoothed_xent_rows_backward.launches``)."""
    if logits.device.type == "cpu":
        return ref.smoothed_xent_rows(logits, labels, smoothing=smoothing)
    return _Rows.apply(logits, labels, float(smoothing))
