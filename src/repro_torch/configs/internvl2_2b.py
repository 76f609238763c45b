"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

The InternViT vision encoder + projector is stubbed: the batch carries
precomputed (batch, 256, d_model) patch embeddings that are prepended to
the token embeddings of the InternLM2 decoder implemented here.
"""
from repro_torch.configs.base import ModelConfig, EncoderConfig

CONFIG = ModelConfig(
    arch_id="internvl2-2b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_553,
    encoder=EncoderConfig(n_layers=0, n_frames=256, cross_attend=False),
)
