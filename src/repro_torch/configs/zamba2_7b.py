"""zamba2-7b [hybrid] — Mamba2 + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=81,          # mamba2 layers; shared attn applied every attn_every
    d_model=3584,
    n_heads=32,           # shared attention block heads
    n_kv_heads=32,
    d_ff=14_336,          # shared block FFN
    vocab_size=32_000,
    attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=64),
)
