"""Frozen config dataclasses, the port's own copy of ``repro.configs.base``.

The fields and defaults are the JAX package's, so one config means the same
run in both packages. ``repro_torch.configs.get_config(arch_id)`` resolves
the architectures the port covers so far. ``reduced()`` returns the
smoke-test variant of the same family.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Optional, Tuple

SHARDING_LEVELS = ("replicated", "zero1", "zero2", "zero3")
GATHER_MODES = ("ahead", "at_end", "per_group")


@dataclass(frozen=True)
class CommConfig:
    """Gradient-communication knob (paper §III-C), with the JAX package's
    fields and validation so one config resolves the same in both.

    ``train.step.make_train_step`` runs every strategy and sharding level
    of the reference; ``bucket_mb='auto'`` sizes the buckets with
    ``comm.autotune``, which alone reads ``backward_profile``. See
    ``repro.configs.base.CommConfig`` for what each field selects.
    ``use_kernel`` runs the ring folds through the ring-step
    kernel K3, ``update_kernel`` the sharded update through the fused
    LARS kernel K2.
    """
    strategy: str = "xla"
    bucket_mb: float = 4.0       # the paper's "several megabytes", | 'auto'
    wire_dtype: str = "bf16"     # bf16 | f32 on the wire (paper §IV)
    use_kernel: bool = False     # ring-step fold kernel K3 (comm/ring_kernel)
    overlap: bool = True         # issue bucket collectives inside backward
    shard_update: Optional[bool] = None   # DEPRECATED: use sharding=
    update_kernel: bool = False  # fused LARS update kernel K2 on shards
    gather_ahead: Optional[bool] = None   # DEPRECATED: use gather=
    backward_profile: str = "model"   # 'model' | 'measured' (autotune)
    sharding: Optional[str] = None    # 'replicated' | 'zero1' | 'zero3'
    gather: Optional[str] = None      # 'ahead' | 'at_end' | 'per_group'

    def __post_init__(self):
        assert self.wire_dtype in ("bf16", "f32"), self.wire_dtype
        assert self.backward_profile in ("model", "measured"), \
            self.backward_profile
        if isinstance(self.bucket_mb, str):
            assert self.bucket_mb == "auto", self.bucket_mb
        else:
            assert self.bucket_mb > 0, self.bucket_mb
        sharding, gather = self.sharding, self.gather
        # -- resolve the sharding level ---------------------------------
        if sharding is None:
            if self.shard_update is not None:
                warnings.warn(
                    "CommConfig(shard_update=...) is deprecated; use "
                    "sharding='zero1' (True) / 'replicated' (False)",
                    DeprecationWarning, stacklevel=3)
            sharding = "zero1" if self.shard_update else "replicated"
        else:
            if sharding not in SHARDING_LEVELS:
                raise ValueError(
                    f"sharding={sharding!r} not in {SHARDING_LEVELS}")
            if (self.shard_update is not None
                    and self.shard_update != (sharding != "replicated")):
                raise ValueError(
                    f"conflicting CommConfig: sharding={sharding!r} but "
                    f"deprecated shard_update={self.shard_update} — drop "
                    f"the boolean")
        # -- resolve the gather issue point -----------------------------
        if gather is None:
            if self.gather_ahead is not None:
                warnings.warn(
                    "CommConfig(gather_ahead=...) is deprecated; use "
                    "gather='ahead' (True) / 'at_end' (False)",
                    DeprecationWarning, stacklevel=3)
                gather = "ahead" if self.gather_ahead else "at_end"
            else:
                gather = {"zero3": "per_group",
                          "zero2": "at_end"}.get(sharding, "ahead")
        else:
            if gather not in GATHER_MODES:
                raise ValueError(f"gather={gather!r} not in {GATHER_MODES}")
            if (self.gather_ahead is not None
                    and self.gather_ahead != (gather == "ahead")):
                raise ValueError(
                    f"conflicting CommConfig: gather={gather!r} but "
                    f"deprecated gather_ahead={self.gather_ahead} — drop "
                    f"the boolean")
        if sharding == "zero3" and gather == "at_end":
            raise ValueError(
                "sharding='zero3' has no step-end gather — use "
                "gather='per_group' (re-gather in backward, default) or "
                "'ahead' (retain the forward copy)")
        if sharding != "zero3" and gather == "per_group":
            raise ValueError(
                "gather='per_group' is the zero3 just-in-time policy — "
                f"meaningless with sharding={sharding!r}")
        if sharding == "zero2" and gather == "ahead":
            raise ValueError(
                "sharding='zero2' keeps replicated params — there is no "
                "start-of-step gather to move ahead; the step-end fp32 "
                "all-gather IS the policy (gather='at_end', the default)")
        object.__setattr__(self, "sharding", sharding)
        object.__setattr__(self, "gather", gather)
        # resolved booleans stay readable for backward compatibility
        object.__setattr__(self, "shard_update", sharding != "replicated")
        object.__setattr__(self, "gather_ahead", gather == "ahead")


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 0          # number of routed experts
    top_k: int = 0             # experts per token
    n_shared: int = 0          # always-on shared experts
    d_expert: int = 0          # per-expert FFN hidden dim
    router_aux_coef: float = 0.01  # load-balance loss coefficient
    capacity_factor: float = 1.25  # per-expert buffer = T*top_k/E * this


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64          # SSM state dim per head
    d_conv: int = 4            # depthwise conv width
    expand: int = 2            # d_inner = expand * d_model
    head_dim: int = 64         # mamba2 head dim
    chunk: int = 64            # SSD chunk length (train-time parallel form)


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512    # compressed KV latent dim (cached at decode)
    q_lora_rank: int = 0       # 0 = full-rank queries
    rope_head_dim: int = 64    # decoupled rope key/query dim
    nope_head_dim: int = 128   # non-rope per-head dim
    v_head_dim: int = 128


@dataclass(frozen=True)
class XLSTMConfig:
    # block pattern is cycled over layers: 'm' = mLSTM, 's' = sLSTM
    pattern: Tuple[str, ...] = ("m", "m", "m", "m", "m", "m", "s")
    proj_factor_m: float = 2.0   # mLSTM up-projection factor
    proj_factor_s: float = 4/3   # sLSTM FFN projection factor
    chunk: int = 64              # chunkwise-parallel length for mLSTM


@dataclass(frozen=True)
class EncoderConfig:
    """Audio/vision frontend STUB: the transformer consumes precomputed
    frame/patch embeddings of shape (batch, n_frames, d_model)."""
    n_layers: int = 0            # encoder transformer layers (0 = prefix-only)
    n_frames: int = 0            # stub embedding sequence length
    n_heads: int = 8
    cross_attend: bool = False   # True: enc-dec cross attention (whisper)
                                 # False: prefix tokens in the decoder (vlm)


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm | conv
    source: str                  # citation bracket from the assignment
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0            # 0 → d_model // n_heads
    d_ff: int = 0
    vocab_size: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    sliding_window: int = 0      # 0 = full attention; >0 = window size
    attn_every: int = 0          # hybrid: shared attn block every N ssm layers
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encoder: Optional[EncoderConfig] = None
    # distribution hints
    fsdp: bool = False           # additionally shard master params over 'data'
    remat: bool = True           # activation checkpointing on the layer scan
    attn_chunk: int = 1024       # online-softmax attention chunk (train/prefill)
    flash_attention: bool = False  # Pallas flash kernel for train/prefill
                                   # (TPU target; interpret-mode on CPU)
    # conv (resnet) only
    image_size: int = 224
    n_classes: int = 1000
    width: int = 64
    bn_momentum: float = 0.9     # paper §III-A.2: tuned BN moving averages
    sync_bn: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 524k context without quadratic attention?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    @property
    def has_decode(self) -> bool:
        return self.family != "conv"

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/features, tiny dims."""
        kw = dict(
            n_layers=min(self.n_layers, 2) or 2,
            d_model=min(self.d_model, 256) or 256,
            vocab_size=min(self.vocab_size, 512) or 512,
            fsdp=False,
            remat=False,
            attn_chunk=64,
        )
        if self.n_heads:
            kw["n_heads"] = min(self.n_heads, 4)
            ratio = max(self.n_heads // max(self.n_kv_heads, 1), 1)
            kw["n_kv_heads"] = max(kw["n_heads"] // ratio, 1)
            kw["head_dim"] = kw["d_model"] // kw["n_heads"]
        if self.d_ff:
            kw["d_ff"] = min(self.d_ff, 512)
        if self.sliding_window:
            kw["sliding_window"] = 32
        if self.attn_every:
            kw["attn_every"] = 2
            kw["n_layers"] = 4  # 2 groups of 2 to exercise the shared block
        if self.moe:
            kw["moe"] = replace(
                self.moe,
                n_routed=min(self.moe.n_routed, 4),
                top_k=min(self.moe.top_k, 2),
                n_shared=min(self.moe.n_shared, 1),
                d_expert=min(self.moe.d_expert, 128),
            )
        if self.ssm:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=32, chunk=16)
        if self.mla:
            kw["mla"] = replace(
                self.mla, kv_lora_rank=64, rope_head_dim=16,
                nope_head_dim=32, v_head_dim=32)
            kw["head_dim"] = 0  # head dims come from mla fields
        if self.xlstm:
            kw["xlstm"] = replace(self.xlstm, chunk=16)
        if self.encoder:
            kw["encoder"] = replace(
                self.encoder,
                n_layers=min(self.encoder.n_layers, 2),
                n_frames=min(self.encoder.n_frames, 16) or 16,
                n_heads=min(self.encoder.n_heads, 4),
            )
        if self.family == "conv":
            kw["image_size"] = 32
            kw["n_classes"] = 16
            kw["width"] = 16
        return replace(self, **kw)


def param_count(cfg: ModelConfig) -> int:
    """Analytic total parameter count (used for roofline MODEL_FLOPS)."""
    if cfg.family == "conv":
        # ResNet-50 canonical ≈ 25.6M scaled by (width/64)^2
        return int(25_557_032 * (cfg.width / 64) ** 2)
    d, L = cfg.d_model, cfg.n_layers
    hd = cfg.resolved_head_dim
    n = cfg.vocab_size * d  # embed
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * d
    per_layer = 0
    if cfg.family in ("dense", "vlm", "audio"):
        per_layer += d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd)
        per_layer += (cfg.n_heads * hd) * d
        per_layer += 3 * d * cfg.d_ff
    if cfg.mla is not None:
        m = cfg.mla
        qd = m.nope_head_dim + m.rope_head_dim
        per_layer = (d * cfg.n_heads * qd                    # q proj
                     + d * (m.kv_lora_rank + m.rope_head_dim)  # kv down
                     + m.kv_lora_rank * cfg.n_heads * (m.nope_head_dim + m.v_head_dim)
                     + cfg.n_heads * m.v_head_dim * d)
    if cfg.moe is not None:
        e = cfg.moe
        per_layer += 3 * d * e.d_expert * (e.n_routed + e.n_shared)
        per_layer += d * e.n_routed  # router
        if cfg.mla is None and cfg.family == "moe" and cfg.d_ff and not cfg.moe:
            pass
    elif cfg.family == "moe":
        pass
    if cfg.family in ("ssm",):
        pass
    if cfg.xlstm is not None:
        # rough: mLSTM ~ (2*expand + small) d^2
        per_layer = int(6 * d * d)
    if cfg.ssm is not None and cfg.family in ("ssm", "hybrid"):
        di = cfg.ssm.expand * d
        mamba = d * (2 * di + 2 * cfg.ssm.d_state * (di // cfg.ssm.head_dim)) + di * d
        per_layer += int(mamba)
    n += L * per_layer
    if cfg.attn_every and cfg.n_heads:  # zamba shared attention block (once)
        n += 4 * d * (cfg.n_heads * hd) + 3 * d * cfg.d_ff
    if cfg.encoder and cfg.encoder.n_layers:
        enc = cfg.encoder
        n += enc.n_layers * (4 * d * d + 2 * d * cfg.d_ff)
    return int(n)


def active_param_count(cfg: ModelConfig) -> int:
    """Params active per token (MoE: shared + top_k of routed)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    e = cfg.moe
    all_expert = 3 * cfg.d_model * e.d_expert * (e.n_routed + e.n_shared) * cfg.n_layers
    act_expert = 3 * cfg.d_model * e.d_expert * (e.top_k + e.n_shared) * cfg.n_layers
    return int(total - all_expert + act_expert)
