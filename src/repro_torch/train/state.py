"""Train state: fp32 master params + momentum (the paper's mixed-precision
scheme keeps the update in fp32), BN statistics for the conv family.

The step counter is a host integer: the schedule and the data are
functions of it, and keeping it off the device spares a sync per step.
The sharded states of the ZeRO ladder are ROADMAP §1 item 7.
"""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.core import lars, pinit
from repro_torch.kernels.backend import resolve_device


class TrainState(NamedTuple):
    step: int
    params: Any          # fp32 master tree
    mom: Any             # fp32 momentum tree (lamb: {'m', 'v', 'count'})
    bn_state: Any = None  # resnet only


def init_state(model, seed: int = 0, *, device=None,
               opt_kind: str = "lars") -> TrainState:
    """Replicated single-device state on ``device`` (default: the card)."""
    device = resolve_device(device)
    params = pinit.materialize(model.param_pd, seed, device)
    mom = lars.init_momentum(params, opt_kind)
    bn = None
    if model.bn_state_pd is not None:
        bn = pinit.materialize(model.bn_state_pd, seed, device)
    return TrainState(0, params, mom, bn)
