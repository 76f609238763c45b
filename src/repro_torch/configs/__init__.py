"""Config registry of the port: the JAX package's eleven architectures.

ResNet-50 (training), the dense GQA LMs qwen1.5-0.5b, qwen1.5-32b,
qwen3-14b (``qk_norm``) and mistral-nemo-12b (sliding window), the MoE LM
qwen2-moe-a2.7b (serving and training) and the MLA MoE LM
deepseek-v2-236b (serving; training on the CPU), the hybrid zamba2-7b
(Mamba2 layers and a shared attention block), the xLSTM xlstm-125m, the
encoder-decoder whisper-base (stub audio frames) and the prefix VLM
internvl2-2b (stub patch embeddings).
"""
from __future__ import annotations

import importlib
from repro_torch.configs.base import ModelConfig, param_count, active_param_count  # noqa: F401
from repro_torch.configs.shapes import SHAPES, InputShape, shapes_for  # noqa: F401

# arch id -> module name in this package
_REGISTRY = {
    "resnet50": "resnet50",   # the paper's own architecture
    "qwen1.5-0.5b": "qwen1_5_0_5b",   # dense LMs: GQA, QKV bias
    "qwen1.5-32b": "qwen1_5_32b",
    "qwen3-14b": "qwen3_14b",         # qk_norm
    "mistral-nemo-12b": "mistral_nemo_12b",   # sliding window
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",     # MoE
    "deepseek-v2-236b": "deepseek_v2_236b",   # MLA + MoE
    "zamba2-7b": "zamba2_7b",                 # hybrid: Mamba2 + shared attn
    "xlstm-125m": "xlstm_125m",               # mLSTM + sLSTM
    "whisper-base": "whisper_base",           # audio enc-dec
    "internvl2-2b": "internvl2_2b",           # vlm: image prefix
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r} (known: "
                       f"{sorted(_REGISTRY)})")
    mod = importlib.import_module(
        f"repro_torch.configs.{_REGISTRY[arch_id]}")
    return mod.CONFIG

