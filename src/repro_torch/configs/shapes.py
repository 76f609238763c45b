"""Assigned input shapes (public-pool contract) + the paper's own shape."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class InputShape:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k",    "train",  4_096,   256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768,  32),
    "decode_32k":  InputShape("decode_32k",  "decode", 32_768,  128),
    "long_500k":   InputShape("long_500k",   "decode", 524_288,   1),
    # paper's own architecture (ResNet-50 / ImageNet): 81,920 global batch
    "train_imagenet": InputShape("train_imagenet", "train", 0, 81_920),
}


def shapes_for(cfg) -> Dict[str, InputShape]:
    """Which of the assigned shapes apply to this architecture (skip rules
    are documented in DESIGN.md §3)."""
    if cfg.family == "conv":
        return {"train_imagenet": SHAPES["train_imagenet"]}
    out = {"train_4k": SHAPES["train_4k"], "prefill_32k": SHAPES["prefill_32k"]}
    if cfg.has_decode:
        out["decode_32k"] = SHAPES["decode_32k"]
        if cfg.subquadratic:
            out["long_500k"] = SHAPES["long_500k"]
    return out
