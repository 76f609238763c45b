"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,   # MLA: logical heads; KV cached as a 512-d latent
    d_ff=1536,        # per-expert FFN hidden dim
    vocab_size=102_400,
    moe=MoEConfig(n_routed=160, top_k=6, n_shared=2, d_expert=1536),
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    fsdp=True,
)
