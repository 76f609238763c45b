"""The rounding points of K5's bf16 tensor-core forward
(``kernels/csrc/flash_attention.cu``), emulated tile by tile in PyTorch on
the CPU, so that the design's numerics are held to the tolerances before
any card runs it:

- 64-key tiles, walked in order from the first visible one, with the f32
  online state (m, l, acc) carried between them;
- S = q·kᵀ from bf16 products summed in f32 (exact products, as the
  m16n8k16 MMA forms them), the scale Dk^-0.5·log2(e) applied to S after
  the dot, masked scores -1e30;
- P = exp2(S - m) in f32, l summed from that f32 P;
- P split into ``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)``, and
  ``acc += P_hi·V + P_lo·V`` in f32 (two exact bf16 MMAs);
- output ``acc / max(l, 1e-30)`` rounded to bf16.

It is held against the Pallas kernel in interpret mode at
``test_kernels.py``'s flash shapes, and against the plain version
(``kernels/ref.flash_attention``) at an S 1024 GQA shape with a window, at
the card tests' bf16 tolerance (rtol 1e-2, atol 1e-5). A guard case
shows why the split is there: the same emulation with P rounded once to
bf16 puts elements outside that tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ref

pytestmark = pytest.mark.tier1

TILE = 64
NEG = -1e30
LOG2E = 1.4426950408889634
#: the card tests' bf16 tolerance (tests/test_torch_gpu.py FLASH_TOL)
RTOL, ATOL = 1e-2, 1e-5


def emulate(q, k, v, *, causal, window, n_q_heads, n_kv_heads, split=True):
    """q (B·H, Sq, Dk), k (B·K, Sk, Dk), v (B·K, Sk, Dv), all bf16; the
    kernel's arithmetic, tile by tile, returning bf16 (B·H, Sq, Dv)."""
    BH, Sq, Dk = q.shape
    Sk = k.shape[1]
    H, K = n_q_heads, n_kv_heads
    bh = torch.arange(BH)
    kv = (bh // H) * K + (bh % H) // (H // K)
    qf, kf, vf = q.float(), k.float()[kv], v.float()[kv]
    qpos = torch.arange(Sq)[:, None]
    scale = Dk ** -0.5 * LOG2E          # exp(x) = exp2(x·log2(e))
    m = torch.full((BH, Sq, 1), NEG)
    l = torch.zeros((BH, Sq, 1))
    acc = torch.zeros((BH, Sq, v.shape[2]))
    for k0 in range(0, Sk, TILE):
        kpos = torch.arange(k0, min(k0 + TILE, Sk))[None, :]
        ok = torch.ones(Sq, kpos.shape[1], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        if not ok.any():                 # the kernel never loads this tile
            continue
        # bf16 x bf16 is exact in f32; the f32 sums run in another order
        # than the MMA's, which only the tolerance sees
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, k0:k0 + TILE]) * scale
        s = s.masked_fill(~ok, NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        vt = vf[:, k0:k0 + TILE]
        p_hi = p.bfloat16().float()
        pv = p_hi @ vt
        if split:
            pv = pv + (p - p_hi).bfloat16().float() @ vt
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


def _bf16(rng, *shape, scale=1.0):
    x = scale * rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).bfloat16()


def _outside(got, want):
    """Elements of ``got`` outside rtol/atol of ``want`` (both as f32)."""
    got, want = got.float(), want.float()
    return int(((got - want).abs() > ATOL + RTOL * want.abs()).sum())


#: test_kernels.py's flash shapes (B, S, H, K, Dk, Dv) and masks
SHAPES = [(2, 64, 4, 2, 32, 32), (1, 128, 2, 2, 16, 16),
          (2, 96, 4, 4, 32, 16)]
MASKS = [(True, 0), (True, 24), (False, 0)]


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_tile_emulation_matches_pallas_kernel(shape, causal, window):
    """The emulation against the Pallas kernel (interpret mode, one block
    of S keys: f32 online softmax over the whole row) on the same bf16
    inputs."""
    B, S, H, K, Dk, Dv = shape
    rng = np.random.default_rng(S + H + Dk)
    q, k, v = (_bf16(rng, B * n, S, d) for n, d in ((H, Dk), (K, Dk),
                                                    (K, Dv)))
    kw = dict(causal=causal, window=window, n_q_heads=H, n_kv_heads=K)
    got = emulate(q, k, v, **kw)
    as_jax = lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want = pallas_flash(as_jax(q), as_jax(k), as_jax(v), interpret=True, **kw)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert got.shape == want.shape
    assert _outside(got, want) == 0


#: an S 1024 GQA shape with a window that crosses tile edges
LONG = dict(B=1, S=1024, H=4, K=2, Dk=64, Dv=64, window=200)


def _long_inputs(q_scale=1.0):
    B, S, H, K, Dk, Dv = (LONG[n] for n in ("B", "S", "H", "K", "Dk", "Dv"))
    rng = np.random.default_rng(16)
    q = _bf16(rng, B * H, S, Dk, scale=q_scale)
    return q, _bf16(rng, B * K, S, Dk), _bf16(rng, B * K, S, Dv)


@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_tile_emulation_matches_plain_at_s1024(q_scale):
    """The split holds the card tests' bf16 tolerance against the f32 plain
    version, with q as drawn and with q x 8 (a peaked softmax, large
    corrections)."""
    q, k, v = _long_inputs(q_scale)
    kw = dict(causal=True, window=LONG["window"], n_q_heads=LONG["H"],
              n_kv_heads=LONG["K"])
    got = emulate(q, k, v, **kw)
    want = ref.flash_attention(q.float(), k.float(), v.float(), **kw)
    assert _outside(got, want) == 0


def test_tile_emulation_without_p_lo_fails_the_tolerance():
    """The guard: with P rounded once to bf16 (no ``P_lo``) the same
    inputs put elements outside the tolerance, so a kernel that drops the
    split is seen to be wrong here, before any card."""
    q, k, v = _long_inputs()
    kw = dict(causal=True, window=LONG["window"], n_q_heads=LONG["H"],
              n_kv_heads=LONG["K"])
    want = ref.flash_attention(q.float(), k.float(), v.float(), **kw)
    assert _outside(emulate(q, k, v, split=False, **kw), want) > 0
    assert _outside(emulate(q, k, v, **kw), want) == 0
