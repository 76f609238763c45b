"""qwen1.5-32b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-32b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27_392,
    vocab_size=152_064,
    qkv_bias=True,
    fsdp=True,
)
