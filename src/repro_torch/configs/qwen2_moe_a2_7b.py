"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen2-moe-a2.7b",
    family="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,        # per-expert FFN hidden dim
    vocab_size=151_936,
    qkv_bias=True,
    moe=MoEConfig(n_routed=60, top_k=4, n_shared=4, d_expert=1408),
)
