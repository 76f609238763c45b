"""Numerical-integrity guard (a port of ``repro.train.guard``): the
recovery ladder for a step that goes nonfinite or spikes.

1. **Sentinel and skip gate** (:func:`check`): the nonfinite count over
   the loss and the reduced gradient, and the gradient's squared norm,
   taken inside the guarded step BEFORE anything is written. The
   reference commits with ``lax.cond(ok, new, prev)`` at the end of its
   functional step; the port's sharded step updates shards, momentum and
   the gathered params in place (K1, K2), so the gate must come first: the
   step reads the two reductions on the host (one sync), and on a bad step
   returns its input state untouched, ``step`` not advanced, without
   launching the norm (K1) or update (K2) kernels. The loop sees
   ``metrics['skipped'] == 1`` and replays.
2. **Divergence detector** (:class:`DivergenceDetector`): an EMA of loss
   and grad-norm in Python floats with hysteresis, the reference's
   arithmetic, so a scripted sequence trips at the same steps.
3. **Rollback ring** (:class:`RollbackRing`): bounded snapshots of the
   whole state every ``snapshot_every`` steps, as device copies
   (``train.state.host_snapshot``); a detector trip rolls back to the
   newest without checkpoint IO, optionally re-warming the LR
   (:func:`rewarmup_scale_fn`).
4. Escalation: ring empty or used up → checkpoint restore → bounded
   exhaustion (``RuntimeError``), as the step watchdog.

Opt-in per run: ``make_train_step(..., guard=True)`` and
``loop.train(..., guard=GuardConfig(...))``; with it off the step is
exactly the unguarded one.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.schedule import ScheduleConfig, make_schedule


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Knobs for the whole ladder (the reference's defaults)."""
    # rung 1 — sentinel skip
    max_skips: int = 3          # consecutive skips before escalating
    # rung 2 — divergence detector
    ema_beta: float = 0.9       # EMA decay for loss/grad-norm
    spike_factor: float = 10.0  # trip at value > spike_factor * EMA
    rearm_factor: float = 2.0   # re-arm once value <= rearm_factor * EMA
    min_history: int = 3        # ok steps observed before the detector arms
    # rung 3 — in-memory rollback ring
    ring_capacity: int = 2      # snapshots held (0 disables the ring)
    snapshot_every: int = 1     # snapshot cadence in steps
    max_rollbacks: int = 2      # ring rollbacks before escalating further
    rewarmup_steps: int = 0     # LR re-warmup window after a recovery
    # rung 4 — checkpoint restore
    max_restores: int = 2       # checkpoint restores before giving up


# ------------------------------------------------------------- sentinel


def _leaves(tree):
    if isinstance(tree, dict):
        from repro_torch.tree import tree_leaves
        return tree_leaves(tree)
    return list(tree)


def nonfinite_count(tree) -> torch.Tensor:
    """int64 count of nonfinite entries over every tensor of ``tree`` (a
    dict tree or a sequence of tensors)."""
    return sum(torch.count_nonzero(~torch.isfinite(x))
               for x in _leaves(tree))


def sq_sum(tree) -> torch.Tensor:
    """f32 sum of squares over every tensor (grad-norm² before any
    reduction across ranks)."""
    total = None
    for x in _leaves(tree):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return total


def scale_loss(loss_fn: Callable, scale) -> Callable:
    """Wrap a ``(total, aux)`` loss so that the differentiated total is
    scaled: the spike hook (``spike@s:mag`` comes in through the guarded
    step's ``loss_scale``; 1.0 on every other step). The metrics keep the
    unscaled loss, so the detector sees a spike through the grad-norm."""
    def scaled(*args):
        total, aux = loss_fn(*args)
        return total * scale, aux
    return scaled


def check(metrics, grads, *, axes=None):
    """The sentinel and skip decision, taken before the guarded step
    writes anything. ``grads`` is what the step differentiated into: the
    rank's reduced gradient shards on the sharded rungs (pass ``axes``,
    the shard axis, so the count and the norm add up over its ranks, as
    the reference's ``psum_axis``), or the full reduced gradient tree on
    the replicated paths (the same on every rank: no ``axes``).
    ``metrics['loss']`` must already be the ranks' mean. Returns ``(ok,
    metrics)``: the metrics gain ``gnorm``, ``nonfinite`` and ``skipped``
    (0-d f32 CPU tensors). One host sync."""
    bad = nonfinite_count(grads).double()
    sq = sq_sum(grads)
    if axes:
        both = torch.stack([bad, sq.double()])
        for a in axes:
            if a.group is not None:
                dist.all_reduce(both, group=a.group)
        bad, sq = both[0], both[1].float()
    loss = metrics["loss"].detach().float()
    flags = torch.stack([bad + (~torch.isfinite(loss)).double(),
                         sq.double()]).tolist()
    n_bad = int(flags[0])
    # sqrt in f64 of an f32 value, rounded once to f32, is the correctly
    # rounded f32 sqrt (the reference's jnp.sqrt)
    gnorm = np.float32(math.sqrt(flags[1]) if flags[1] >= 0 else math.nan)
    ok = n_bad == 0 and bool(np.isfinite(gnorm))
    as_metric = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return ok, dict(metrics, gnorm=as_metric(gnorm),
                    nonfinite=as_metric(n_bad),
                    skipped=as_metric(0.0 if ok else 1.0))


#: metrics keys a guarded step appends
SENTINEL_KEYS = ("gnorm", "nonfinite", "skipped")


def neutral_inputs():
    """The happy-path ``guard_in``: no LR rescale, no loss spike."""
    return {"lr_scale": np.float32(1.0), "loss_scale": np.float32(1.0)}


# -------------------------------------------------- host-side detector


class DivergenceDetector:
    """EMA of (loss, grad-norm) with hysteresis.

    ``observe`` returns ``'ok'`` or ``'diverged'``. The detector arms only
    after ``min_history`` ok steps, trips when either value exceeds
    ``spike_factor``× its EMA, and then holds (no repeated trips, no EMA
    absorption of suspicious values) until both values re-enter the
    ``rearm_factor``× band, so a rolled-back run replaying clean steps
    re-arms on its first normal observation."""

    def __init__(self, cfg: GuardConfig):
        self.cfg = cfg
        self.ema_loss: Optional[float] = None
        self.ema_gnorm: Optional[float] = None
        self.n_ok = 0
        self.tripped = False

    def _update(self, loss: float, gnorm: float) -> None:
        b = self.cfg.ema_beta
        self.ema_loss = (loss if self.ema_loss is None
                         else b * self.ema_loss + (1 - b) * loss)
        self.ema_gnorm = (gnorm if self.ema_gnorm is None
                          else b * self.ema_gnorm + (1 - b) * gnorm)
        self.n_ok += 1

    def observe(self, loss: float, gnorm: float) -> str:
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            # should have been skipped by the sentinel; treat as divergence
            self.tripped = True
            return "diverged"
        if self.n_ok < self.cfg.min_history:
            self._update(loss, gnorm)
            return "ok"
        over = (gnorm > self.cfg.spike_factor * self.ema_gnorm
                or loss > self.cfg.spike_factor * self.ema_loss)
        if self.tripped:
            if (gnorm <= self.cfg.rearm_factor * self.ema_gnorm
                    and loss <= self.cfg.rearm_factor * self.ema_loss):
                self.tripped = False
                self._update(loss, gnorm)
            return "ok"        # hysteresis: already handled, don't re-trip
        if over:
            self.tripped = True
            return "diverged"
        self._update(loss, gnorm)
        return "ok"


# ------------------------------------------------- in-memory rollback ring


class RollbackRing:
    """Bounded ring of whole-state snapshots (``train.state.host_snapshot``:
    copies that share no memory with the live state, which the sharded step
    updates in place). Snapshots are taken only AFTER a step passes both
    the sentinel and the detector, so a spiked state is never a restore
    target."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._ring = collections.deque(maxlen=max(self.capacity, 1))

    def __len__(self) -> int:
        return len(self._ring) if self.capacity > 0 else 0

    def snapshot(self, state) -> None:
        if self.capacity <= 0:
            return
        from repro_torch.train.state import host_snapshot
        self._ring.append((int(state.step), host_snapshot(state)))

    def newest(self) -> Optional[Tuple[int, object]]:
        """Newest (step, snapshot), or None. Kept in the ring: a second
        trip can roll back to the same point (bounded by
        ``GuardConfig.max_rollbacks``)."""
        if not len(self):
            return None
        return self._ring[-1]

    @staticmethod
    def restore(snapshot):
        """A state to train on, in tensors of its own (the snapshot stays
        intact)."""
        from repro_torch.train.state import restore_snapshot
        return restore_snapshot(snapshot)


# ----------------------------------------------------------- LR re-warmup


def rewarmup_scale_fn(rewarmup_steps: int) -> Callable[[int], float]:
    """LR scale for the ``rewarmup_steps`` after a recovery, composed from
    ``core/schedule.py``: a unit-base-lr warmup whose output multiplies the
    run's schedule, so the re-warmed LR ramps ``lr(step)/n .. lr(step)``
    over the window and is exactly ``lr(step)`` outside it. ``0`` disables
    (scale ≡ 1.0)."""
    if rewarmup_steps <= 0:
        return lambda k: 1.0
    sched = make_schedule(ScheduleConfig(
        base_lr=1.0, warmup_steps=rewarmup_steps,
        total_steps=rewarmup_steps + 1, decay="const"))

    def scale(k: int) -> float:
        if k < 0:
            return 1.0
        return float(sched(min(k, rewarmup_steps)))
    return scale
