"""qwen3-14b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-14b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17_408,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
