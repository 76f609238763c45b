"""Fault injection for the elastic training loop (a port of
``repro.train.faults``: the same spec strings, messages and hooks).

=========  =======================  =========================================
kind       spec                     effect (fires once, at global step s)
=========  =======================  =========================================
kill       ``kill@s``               SIGKILL this process at the start of
                                    step s: no drain, no flush. A committed
                                    checkpoint must survive.
sigterm    ``sigterm@s``            SIGTERM this process at the start of
                                    step s: the loop's handler drains the
                                    in-flight step, saves and exits.
stall      ``stall@s:secs``         Sleep ``secs`` inside step s's watchdog
                                    window: trips the step watchdog, which
                                    restores the last good checkpoint.
corrupt    ``corrupt@s[:target]``   After the first checkpoint committed at
                                    step >= s, flip bytes in one of its
                                    files: ``payload`` (default, the
                                    ``.npz``; the checksum rejects it and the
                                    load falls back), ``manifest`` or
                                    ``plan`` (``commplan_<tag>.json``).
nan        ``nan@s``                Poison step s's batch with NaNs (first
                                    element of every float tensor): the
                                    guarded step must skip the update.
spike      ``spike@s:mag``          Scale step s's differentiated loss by
                                    ``mag`` (the guarded step's
                                    ``loss_scale`` input): the divergence
                                    detector must roll back.
=========  =======================  =========================================

Specs compose comma-separated: ``"stall@3:2.5,kill@7"``. Each fault fires
at most once per process, so a retried or replayed step comes back clean.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Optional, Tuple

import torch

from repro_torch.obs import metrics as obs_metrics

KINDS = ("kill", "sigterm", "stall", "corrupt", "nan", "spike")

#: corrupt-fault targets (``corrupt@s:target``)
CORRUPT_TARGETS = ("payload", "manifest", "plan")

_WHERE = "repro_torch/train/faults.py"


def _log_fault(kind: str, step: int, detail: str) -> None:
    """Injected faults announce themselves on the metrics stream (the
    StdoutSink flushes, so the line survives the SIGKILL kind)."""
    obs_metrics.event("fault_injected",
                      {"kind": kind, "step": step, "detail": detail},
                      where=_WHERE, step=step)


class FaultSpecError(ValueError):
    """Unparseable ``--inject-fault`` spec."""


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str          # one of KINDS
    step: int          # global step the fault is armed for
    arg: float = 0.0   # stall seconds / spike magnitude
    target: str = ""   # corrupt target: '' (payload) | 'manifest' | 'plan'


def parse_faults(spec: Optional[str]) -> Tuple[Fault, ...]:
    """``"stall@3:2.5,kill@7"`` -> (Fault('stall',3,2.5), Fault('kill',7)).
    Empty/None -> ()."""
    if not spec:
        return ()
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            kind, _, rest = part.partition("@")
            if kind not in KINDS:
                raise ValueError(f"unknown fault kind {kind!r} "
                                 f"(known: {', '.join(KINDS)})")
            step_s, _, arg_s = rest.partition(":")
            step = int(step_s)
            arg, target = 0.0, ""
            if kind == "corrupt":
                if arg_s and arg_s not in CORRUPT_TARGETS:
                    raise ValueError(
                        f"corrupt target {arg_s!r} (known: "
                        f"{', '.join(CORRUPT_TARGETS)})")
                target = arg_s if arg_s != "payload" else ""
            elif arg_s:
                arg = float(arg_s)
            if kind == "stall" and arg <= 0:
                raise ValueError("stall needs a duration: stall@STEP:SECS")
            if kind == "spike" and arg <= 0:
                raise ValueError("spike needs a magnitude: spike@STEP:MAG")
        except ValueError as e:
            raise FaultSpecError(
                f"bad fault spec {part!r} ({e}); expected "
                f"kind@step[:arg], e.g. kill@7, stall@3:2.5, nan@3, "
                f"spike@6:50, corrupt@4:manifest") from e
        out.append(Fault(kind, step, arg, target))
    return tuple(out)


class FaultInjector:
    """Fires parsed faults from the loop's hook points. Stateless apart
    from the fired-once set; with no faults every hook is a no-op."""

    def __init__(self, faults: Tuple[Fault, ...] = ()):
        self.faults = tuple(faults)
        self._fired = set()

    def _due(self, kind: str, step: int):
        for f in self.faults:
            if f.kind == kind and f.step <= step and f not in self._fired:
                self._fired.add(f)
                yield f

    # ------------------------------------------------------------- hooks

    def on_step(self, step: int) -> None:
        """Called inside the watchdog window at the start of each step."""
        for f in self._due("stall", step):
            _log_fault("stall", step,
                       f"sleeping {f.arg}s (injected slow device)")
            time.sleep(f.arg)
        for f in self._due("sigterm", step):
            _log_fault("sigterm", step, "simulated preemption notice")
            os.kill(os.getpid(), signal.SIGTERM)
        for f in self._due("kill", step):
            _log_fault("kill", step, "SIGKILL (unannounced preemption)")
            os.kill(os.getpid(), signal.SIGKILL)

    def poison_batch(self, batch, step: int):
        """Called with each step's batch before the step: a due ``nan``
        fault NaN-poisons the first element of every float tensor. It
        fires once, so a guard-skipped step replays with the clean
        batch."""
        for f in self._due("nan", step):
            batch = poison_nan(batch)
            _log_fault("nan", step,
                       "poisoned batch float leaves with NaN")
        return batch

    def loss_scale(self, step: int) -> float:
        """The guarded step's ``loss_scale`` for this step: the product of
        due ``spike`` magnitudes (1.0 when none is due)."""
        scale = 1.0
        for f in self._due("spike", step):
            scale *= f.arg
            _log_fault("spike", step,
                       f"scaling the differentiated loss x{f.arg:g}")
        return scale

    def on_saved(self, ckpt_path: str, step: int) -> None:
        """Called after each checkpoint commit with the payload path."""
        for f in self._due("corrupt", step):
            path = _corrupt_target_path(ckpt_path, f.target)
            corrupt_file(path)
            _log_fault("corrupt", step,
                       f"flipped bytes in {path} (injected bit-rot, "
                       f"target={f.target or 'payload'})")

    @property
    def any_pending(self) -> bool:
        return any(f not in self._fired for f in self.faults)


def _corrupt_target_path(ckpt_path: str, target: str) -> str:
    """A corrupt fault's victim file, from the committed payload path
    (``.../ckpt_<tag>.npz``)."""
    if not target:
        return ckpt_path
    d = os.path.dirname(ckpt_path)
    if target == "manifest":
        return os.path.join(d, "MANIFEST.json")
    base = os.path.basename(ckpt_path)            # ckpt_<tag>.npz
    tag = base[len("ckpt_"):-len(".npz")]
    path = os.path.join(d, f"commplan_{tag}.json")
    if not os.path.exists(path):
        raise FaultSpecError(
            f"corrupt@..:plan armed but checkpoint {tag!r} committed no "
            f"CommPlan ({path!r} missing) — only sharded explicit-DP runs "
            f"save one")
    return path


def poison_nan(batch):
    """A copy of ``batch`` (a dict of tensors) with the first element of
    every float tensor NaN; integer tensors pass through. Raises if no
    float tensor is there to poison (an LM token batch cannot go NaN)."""
    out, hit = {}, False
    for k, x in batch.items():
        if x.is_floating_point():
            x = x.clone(memory_format=torch.contiguous_format)
            x.view(-1)[0] = float("nan")
            hit = True
        out[k] = x
    if not hit:
        raise FaultSpecError(
            "nan fault found no float leaf in the batch to poison (integer "
            "token batches cannot go NaN — inject spike@s:mag instead)")
    return out


def corrupt_file(path: str, *, offset: Optional[int] = None,
                 n_bytes: int = 16) -> None:
    """Flip ``n_bytes`` bytes mid-file in place: bit-rot or a torn write
    that bypassed the atomic rename. The manifest checksum
    (``checkpoint.verify``) must catch it."""
    size = os.path.getsize(path)
    if size == 0:
        raise FaultSpecError(f"cannot corrupt empty file {path!r}")
    off = size // 2 if offset is None else offset
    off = max(0, min(off, size - 1))
    n = min(n_bytes, size - off)
    with open(path, "r+b") as f:
        f.seek(off)
        chunk = f.read(n)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))
        f.flush()
        os.fsync(f.fileno())
