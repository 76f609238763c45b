"""whisper-base [audio] — enc-dec, conv frontend STUB [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is stubbed: the batch carries
precomputed (batch, 1500, d_model) frame embeddings consumed by the
encoder transformer; the decoder cross-attends to the encoder's output.
"""
from repro_torch.configs.base import ModelConfig, EncoderConfig

CONFIG = ModelConfig(
    arch_id="whisper-base",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=6,            # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    rope_theta=0.0,        # whisper uses learned absolute positions
    encoder=EncoderConfig(n_layers=6, n_frames=1500, n_heads=8,
                          cross_attend=True),
)
