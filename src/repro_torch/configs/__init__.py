"""Config registry of the port: the architectures ported so far.

The JAX package registers eleven architectures; the port lists only those
whose model it runs: ResNet-50 (training) and the dense LM qwen1.5-0.5b
(serving: prefill and greedy decode). The other LM families (MoE, MLA,
hybrid, xLSTM, whisper, VLM) are ROADMAP §1 item 10.
"""
from __future__ import annotations

import importlib
from repro_torch.configs.base import ModelConfig, param_count, active_param_count  # noqa: F401
from repro_torch.configs.shapes import SHAPES, InputShape, shapes_for  # noqa: F401

# arch id -> module name in this package
_REGISTRY = {
    "resnet50": "resnet50",   # the paper's own architecture
    "qwen1.5-0.5b": "qwen1_5_0_5b",   # dense GQA LM, served
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"arch {arch_id!r} is not ported yet (ported: "
            f"{sorted(_REGISTRY)}); the other LM families are ROADMAP §1 "
            f"item 10")
    mod = importlib.import_module(
        f"repro_torch.configs.{_REGISTRY[arch_id]}")
    return mod.CONFIG

