"""mistral-nemo-12b [dense] — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

Dense full-attention arch; to qualify it for the long_500k decode shape we
implement the sliding-window attention variant (window 131,072) — the
"dense carve-in" allowed by the assignment (DESIGN.md §3).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mistral-nemo-12b",
    family="dense",
    source="hf:mistralai/Mistral-Nemo-Base-2407",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    rope_theta=1_000_000.0,
    sliding_window=131_072,
)
