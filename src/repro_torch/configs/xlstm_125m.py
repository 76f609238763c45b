"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    arch_id="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,   # GQA kv=4 (used inside mLSTM head split)
    d_ff=0,         # no separate FFN: projection lives inside the blocks
    vocab_size=50_304,
    xlstm=XLSTMConfig(),   # pattern cycles m,m,m,m,m,m,s over the 12 layers
)
