"""Name -> collective-schedule registry (a port of ``repro.comm.registry``).

``core.ddp`` resolves its ``strategy`` knob here: a schedule in
``schedules.py`` decorated with ``@register`` (and its reduce-scatter
form with ``@register_rs``) is selectable from configs and the CLI.
"""
from __future__ import annotations

from typing import Callable, Dict, List

_SCHEDULES: Dict[str, Callable] = {}
_RS_SCHEDULES: Dict[str, Callable] = {}   # reduce-scatter-terminal forms

# legacy ddp strategy names that map onto registered schedules
ALIASES = {"bucketed": "psum"}


def register(name: str):
    def deco(fn: Callable) -> Callable:
        assert name not in _SCHEDULES, f"duplicate schedule {name!r}"
        _SCHEDULES[name] = fn
        return fn
    return deco


def register_rs(name: str):
    """Register a schedule's reduce-scatter-terminal form (ZeRO-1 path):
    same signature, but returns this rank's contiguous CHUNK-aligned shard
    of the summed buffer instead of the full reduction."""
    def deco(fn: Callable) -> Callable:
        assert name not in _RS_SCHEDULES, f"duplicate rs schedule {name!r}"
        _RS_SCHEDULES[name] = fn
        return fn
    return deco


def get_schedule(name: str) -> Callable:
    name = ALIASES.get(name, name)
    # importing schedules populates the registry lazily (avoids a cycle)
    if not _SCHEDULES:
        from repro_torch.comm import schedules  # noqa: F401
    if name not in _SCHEDULES:
        raise KeyError(
            f"unknown comm schedule {name!r}; available: {available()}")
    return _SCHEDULES[name]


def get_reduce_scatter(name: str) -> Callable:
    """Resolve a schedule's reduce-scatter-terminal form."""
    name = ALIASES.get(name, name)
    if not _RS_SCHEDULES:
        from repro_torch.comm import schedules  # noqa: F401
    if name not in _RS_SCHEDULES:
        raise KeyError(f"no reduce-scatter form for schedule {name!r}; "
                       f"available: {sorted(_RS_SCHEDULES)}")
    return _RS_SCHEDULES[name]


def available() -> List[str]:
    if not _SCHEDULES:
        from repro_torch.comm import schedules  # noqa: F401
    return sorted(_SCHEDULES)
