"""Flash attention forward (causal / sliding-window GQA, f32 online
softmax) on the (B·H, S, D) layout.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention`` with the hand-written CUDA kernel
``csrc/flash_attention.cu``: one block per (b·h, 64 query rows) walking
64-key tiles. bf16 inputs run on the tensor cores (mma.sync bf16 MMAs,
P split into two bf16 halves for PV, K/V tiles double-buffered with
cp.async); f32 inputs on the CUDA cores. The source says why and what
bounds it.

Layout (``kernels/ops.flash_attention_bshd`` makes it from (B, S, H, D)):
  q : (B·H, Sq, Dk)   k : (B·K, Sk, Dk)   v : (B·K, Sk, Dv)
  f32 or bf16, one dtype; output (B·H, Sq, Dv) in q's dtype
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import backend, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
#: (Dk, Dv) pairs the kernel is instantiated for: the LM heads (64, 128),
#: MLA's (192, 128), and the small dims of the tests
HEAD_DIMS = ((16, 16), (32, 16), (32, 32), (64, 64), (128, 128), (192, 128))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = backend.load_library("flash_attention").flash_attention_fwd
    fn.argtypes = [_P, _P, _P, _P] + [_I] * 10 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


def _heads(q, k, v, n_q_heads, n_kv_heads):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention: q, k, v must be 3-D "
                         "(B·H, S, D)")
    BH, BK = q.shape[0], k.shape[0]
    H = n_q_heads or BH
    K = n_kv_heads or BK
    if (BH % H or H % K or (BH // H) * K != BK or v.shape[0] != BK
            or k.shape[1] != v.shape[1] or k.shape[2] != q.shape[2]):
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit H {H}, K {K}")
    return H, K


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    n_q_heads: int = None, n_kv_heads: int = None):
    """Attention over the (B·H, S, D) layout (see module docstring).

    A CPU tensor takes the plain version (``kernels/ref``). A CUDA tensor
    launches the kernel on the current stream, or raises: there is no
    fallback. ``flash_attention.launches`` counts kernel launches.

    Forward only, on every device: with grad enabled and any of q, k, v
    requiring grad it raises ``NotImplementedError``, as the reference
    cannot differentiate its Pallas kernel either (no ``custom_vjp``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention has no backward: training with "
            "flash_attention=True waits for the K5 backward kernel "
            "(ROADMAP §2, K5 backward); train with flash_attention=False")
    H, K = _heads(q, k, v, n_q_heads, n_kv_heads)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   n_q_heads=H, n_kv_heads=K)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype of "
                        f"{list(_DTYPES)}, not {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    BH, Sq, Dk = q.shape
    Sk, Dv = v.shape[1], v.shape[2]
    if (Dk, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims ({Dk}, {Dv}) not in "
                         f"{HEAD_DIMS}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {x.device}, q "
                             f"on {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned")
    out = torch.empty((BH, Sq, Dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), _DTYPES[q.dtype], BH, Sq, Sk, H, K,
                      Dk, Dv, int(causal), int(window), Dk ** -0.5,
                      torch.cuda.current_stream().cuda_stream)
    flash_attention.launches += 1
    backend.check_launch(rc, "flash_attention")
    return out


flash_attention.launches = 0
