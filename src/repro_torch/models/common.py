"""Parameter descriptors.

Parameters are described abstractly first (``PD``: shape, dtype,
initializer) and materialized by ``repro_torch.core.pinit`` — the basis of
the paper's §III-B.1 broadcast-free initialization: every process derives
the same per-leaf seed from the tree path and a shared seed. The JAX
package's descriptor also carries a PartitionSpec; the port's single-device
slice has no use for one.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PD:
    """Abstract parameter descriptor (a tree leaf)."""
    shape: Tuple[int, ...]
    init: str = "normal"             # normal | zeros | ones | const
    scale: float = 0.02
    dtype: torch.dtype = torch.float32
