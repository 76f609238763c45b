"""CommPlan: the comm layer's resolved choices as a versioned, JSON
round-trippable object (a port of ``repro.comm.plan``, same names, errors
and on-disk format).

A run's communication is fixed by (a) the ``CommConfig`` knobs, (b) the
resolved ``BucketPlan`` (bucket boundaries and every slot's place in the
packing order) and (c) the mesh it was resolved against (axes, sizes,
shard axis). ``train.checkpoint.save(comm_plan=...)`` writes the plan
beside every checkpoint, and an elastic resume rebuilds the packing
layout of the saved shard buffers from it:

* ``CommPlan.comm_config()`` rebuilds the port's ``CommConfig``;
* ``CommPlan.bucket_plan(template_tree)`` rebuilds the exact
  ``BucketPlan`` the buffers were packed under, taking the slots verbatim
  from the plan and cross-checking every span against a template
  parameter tree of the same model, so a model/plan mismatch fails with a
  diff instead of mis-slicing buffers.

Slot paths are written ``stem/bn/scale`` in both packages, so a plan
written by either loads in the other with every field equal.
``CommPlan.retarget`` re-resolves a plan for another mesh shape (a new
shard axis and count and, for a plan that requested ``'auto'``, a bucket
size re-autotuned against ``comm/cost.py``'s model of that mesh).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional, Sequence, Tuple, Union

#: v3 added per-slot ``elem_offset`` (leaf-splitting spans); v1/v2
#: payloads load with every span at offset 0
PLAN_VERSION = 3
_SHARDING_FOR_BOOL = {False: "replicated", True: "zero1"}


class CommPlanError(RuntimeError):
    """Raised on version, schema or layout mismatches (a real exception,
    not an assert: validation must survive ``python -O``)."""


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    """Serializable mirror of ``bucketing.TensorSlot``."""
    path: str
    shape: Tuple[int, ...]
    size: int
    padded: int
    bucket: int
    offset: int
    elem_offset: int = 0        # v3: span start inside the flattened tensor


def _slot_spec(s) -> SlotSpec:
    return SlotSpec(s.path, tuple(s.shape), s.size, s.padded, s.bucket,
                    s.offset, s.elem_offset)


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """One run's resolved comm choices; ``loads(dumps(plan)) == plan``."""
    schedule: str                       # resolved strategy name
    bucket_mb: float                    # RESOLVED bucket size
    requested_bucket_mb: Union[str, float]   # 'auto' or the explicit value
    wire_dtype: str                     # 'bf16' | 'f32'
    overlap: bool
    shard_update: bool
    update_kernel: bool
    gather_ahead: bool
    backward_profile: str
    mesh_axes: Tuple[str, ...]
    mesh_sizes: Tuple[int, ...]
    shard_axis: str
    n_shards: int
    bucket_sizes: Tuple[int, ...]
    slots: Tuple[SlotSpec, ...]
    sharding: str = "replicated"   # 'replicated'|'zero1'|'zero2'|'zero3'
    gather: str = "ahead"               # 'ahead' | 'at_end' | 'per_group'
    version: int = PLAN_VERSION

    def __post_init__(self):
        # Reconcile the v1 boolean spellings with the v2 policy enum so that
        # legacy constructions (shard_update=True without sharding=) and v2
        # ones normalize to the same object. The enum wins where it carries
        # what the booleans cannot (zero3/per_group); otherwise a
        # non-default boolean upgrades the defaulted enum.
        sharding, gather = self.sharding, self.gather
        if sharding == "replicated" and self.shard_update:
            sharding = "zero1"
        if sharding != "zero3" and gather == "ahead" and not self.gather_ahead:
            gather = "at_end"
        object.__setattr__(self, "sharding", sharding)
        object.__setattr__(self, "gather", gather)
        object.__setattr__(self, "shard_update", sharding != "replicated")
        object.__setattr__(self, "gather_ahead", gather == "ahead")

    # ------------------------------------------------------------- rebuild

    def comm_config(self, *, reautotune: bool = True):
        """The port's ``CommConfig`` this plan resolves from.
        ``reautotune=True`` (the elastic-resume default) hands back the
        *requested* bucket size: ``'auto'`` then runs the autotuner again
        against whatever mesh the next ``make_train_step`` is built on.
        ``False`` pins the resolved size (bit-identical bucket boundaries
        on the same tree)."""
        from repro_torch.configs.base import CommConfig
        return CommConfig(
            strategy=self.schedule,
            bucket_mb=(self.requested_bucket_mb if reautotune
                       else self.bucket_mb),
            wire_dtype=self.wire_dtype, overlap=self.overlap,
            sharding=self.sharding, update_kernel=self.update_kernel,
            gather=self.gather,
            backward_profile=self.backward_profile)

    @property
    def wire_dtype_bytes(self) -> int:
        return 2 if self.wire_dtype == "bf16" else 4

    def bucket_plan(self, template_tree):
        """The ``BucketPlan`` these buffers were packed under. Leaf paths
        come from ``template_tree`` (a parameter tree of the same model,
        tensors or descriptors); the slot layout is taken VERBATIM from the
        plan, not re-derived by ``make_plan``, so a legacy packing still
        loads. Every span is cross-checked against the template's leaf
        sequence (paths, shapes, contiguous ``elem_offset`` coverage)."""
        import math

        from repro_torch.core import bucketing
        from repro_torch.tree import tree_flatten
        flat = tree_flatten(template_tree)
        want = [(path, tuple(leaf.shape)) for path, leaf in reversed(flat)]
        # partition the serialized slots per tensor (spans: elem_offset > 0)
        groups, diffs = [], []
        for s in self.slots:
            if s.elem_offset == 0:
                groups.append([])
            if not groups:
                diffs.append(f"  first slot {s.path!r} has elem_offset "
                             f"{s.elem_offset} != 0")
                break
            groups[-1].append(s)
        if not diffs and len(groups) != len(want):
            diffs.append(f"  tensor count {len(want)} != {len(groups)} "
                         f"serialized")
        if not diffs:
            for (path, shape), spans in zip(want, groups):
                size = math.prod(shape)
                cover = 0
                for s in spans:
                    if (s.path, tuple(s.shape)) != (path, shape) or \
                            s.elem_offset != cover:
                        diffs.append(f"  {path!r} {shape} != serialized "
                                     f"{s.path!r} {tuple(s.shape)} @ "
                                     f"elem_offset {s.elem_offset}")
                        break
                    cover += s.size
                if cover != size and not diffs:
                    diffs.append(f"  {path!r} spans cover {cover} of "
                                 f"{size} elements")
                if diffs:
                    break
        if diffs:
            raise CommPlanError(
                "template parameter tree does not reproduce the serialized "
                "bucket plan — wrong model/config for this checkpoint?\n"
                + "\n".join(diffs[:5]))
        slots = tuple(bucketing.TensorSlot(s.path, tuple(s.shape), s.size,
                                           s.padded, s.bucket, s.offset,
                                           s.elem_offset)
                      for s in self.slots)
        return bucketing.BucketPlan(slots, tuple(self.bucket_sizes),
                                    tuple(p for p, _ in flat))

    def retarget(self, axes: Sequence[str], sizes: Sequence[int],
                 template_tree, *, family: Optional[str] = None,
                 links=None, hw=None) -> "CommPlan":
        """Re-resolve this plan for another mesh shape: the new shard axis
        and count (``cost.shard_axis_size``) and, when the run requested
        ``bucket_mb='auto'``, a bucket size re-autotuned for the new mesh
        (``comm.autotune``, the card's constants of ``launch/hw.py``).
        Metadata only: a step built from ``comm_config()`` on the new mesh
        does the rest."""
        from repro_torch.comm.cost import shard_axis_size
        from repro_torch.core import bucketing
        axes, sizes = tuple(axes), tuple(int(s) for s in sizes)
        shard_axis, n_shards = shard_axis_size(axes, sizes)
        bucket_mb = self.bucket_mb
        if self.requested_bucket_mb == "auto":
            from repro_torch.comm.autotune import autotune
            bucket_mb = autotune(
                template_tree, schedule=self.schedule, axes=axes,
                sizes=sizes, dtype_bytes=self.wire_dtype_bytes,
                family=family, sharding=self.sharding, gather=self.gather,
                param_dtype_bytes=self.wire_dtype_bytes, links=links,
                hw=hw).bucket_mb
        plan = bucketing.make_plan(template_tree, bucket_mb=bucket_mb,
                                   dtype_bytes=self.wire_dtype_bytes)
        return dataclasses.replace(
            self, bucket_mb=bucket_mb, mesh_axes=axes, mesh_sizes=sizes,
            shard_axis=shard_axis,
            n_shards=n_shards if self.shard_update else 1,
            bucket_sizes=tuple(plan.bucket_sizes),
            slots=tuple(_slot_spec(s) for s in plan.slots))


def make(comm_cfg, bucket_plan, *, resolved_bucket_mb: float,
         mesh_axes: Sequence[str], mesh_sizes: Sequence[int],
         shard_axis: str, n_shards: int, strategy: Optional[str] = None,
         overlap: Optional[bool] = None, shard_update: Optional[bool] = None,
         gather_ahead: Optional[bool] = None,
         sharding: Optional[str] = None,
         gather: Optional[str] = None) -> CommPlan:
    """A ``CommPlan`` from a resolved train step's pieces. The
    ``overlap``/``sharding``/``gather`` overrides record the *effective*
    values (``make_train_step`` downgrades them for 'naive' or replicated
    paths); ``None`` keeps the config's. The boolean ``shard_update``/
    ``gather_ahead`` overrides are the deprecated spellings and apply only
    when the enum override is absent."""
    pick = lambda ov, cfg: cfg if ov is None else ov  # noqa: E731
    if sharding is None and shard_update is not None:
        sharding = _SHARDING_FOR_BOOL[bool(shard_update)]
    if gather is None and gather_ahead is not None:
        gather = "ahead" if gather_ahead else "at_end"
    return CommPlan(
        schedule=strategy or comm_cfg.strategy,
        bucket_mb=float(resolved_bucket_mb),
        requested_bucket_mb=comm_cfg.bucket_mb,
        wire_dtype=comm_cfg.wire_dtype,
        overlap=pick(overlap, comm_cfg.overlap),
        shard_update=pick(sharding, comm_cfg.sharding) != "replicated",
        update_kernel=comm_cfg.update_kernel,
        gather_ahead=pick(gather, comm_cfg.gather) == "ahead",
        backward_profile=comm_cfg.backward_profile,
        mesh_axes=tuple(mesh_axes),
        mesh_sizes=tuple(int(s) for s in mesh_sizes),
        shard_axis=shard_axis, n_shards=int(n_shards),
        bucket_sizes=tuple(int(s) for s in bucket_plan.bucket_sizes),
        slots=tuple(_slot_spec(s) for s in bucket_plan.slots),
        sharding=pick(sharding, comm_cfg.sharding),
        gather=pick(gather, comm_cfg.gather))


# ----------------------------------------------------------- JSON (de)ser

def to_dict(plan: CommPlan) -> dict:
    d = dataclasses.asdict(plan)
    d["slots"] = [list(dataclasses.astuple(s)) for s in plan.slots]
    return d


def from_dict(d: dict) -> CommPlan:
    """Parse a serialized plan. Version 3 is native; v1/v2 payloads load
    and upgrade in place (a re-save writes v3): v1's booleans map onto the
    policy enum, and v1/v2 slot rows (6-tuples) gain ``elem_offset=0``."""
    if not isinstance(d, dict) or "version" not in d:
        raise CommPlanError("not a CommPlan payload (no 'version' field)")
    if d["version"] not in (1, 2, PLAN_VERSION):
        raise CommPlanError(
            f"CommPlan version {d['version']!r} is not supported by this "
            f"build (expected {PLAN_VERSION} or the v1/v2 compat forms) — "
            f"resume with a matching repro version or re-serialize the plan")
    try:
        slots = tuple(
            SlotSpec(row[0], tuple(int(x) for x in row[1]), int(row[2]),
                     int(row[3]), int(row[4]), int(row[5]),
                     int(row[6]) if len(row) > 6 else 0)
            for row in d["slots"])
        req = d["requested_bucket_mb"]
        if d["version"] == 1:
            sharding = _SHARDING_FOR_BOOL[bool(d["shard_update"])]
            gather = "ahead" if d["gather_ahead"] else "at_end"
        else:
            sharding, gather = str(d["sharding"]), str(d["gather"])
        return CommPlan(
            schedule=str(d["schedule"]), bucket_mb=float(d["bucket_mb"]),
            requested_bucket_mb=(req if req == "auto" else float(req)),
            wire_dtype=str(d["wire_dtype"]), overlap=bool(d["overlap"]),
            shard_update=sharding != "replicated",
            update_kernel=bool(d["update_kernel"]),
            gather_ahead=gather == "ahead",
            backward_profile=str(d["backward_profile"]),
            mesh_axes=tuple(d["mesh_axes"]),
            mesh_sizes=tuple(int(s) for s in d["mesh_sizes"]),
            shard_axis=str(d["shard_axis"]), n_shards=int(d["n_shards"]),
            bucket_sizes=tuple(int(s) for s in d["bucket_sizes"]),
            slots=slots, sharding=sharding, gather=gather,
            version=PLAN_VERSION)
    except (KeyError, IndexError, TypeError, ValueError) as e:
        raise CommPlanError(f"malformed CommPlan payload: {e!r}") from e


def dumps(plan: CommPlan) -> str:
    return json.dumps(to_dict(plan), indent=1, sort_keys=True)


def loads(s: str) -> CommPlan:
    try:
        d = json.loads(s)
    except json.JSONDecodeError as e:
        raise CommPlanError(f"CommPlan JSON does not parse: {e}") from e
    return from_dict(d)


def atomic_write(path: str, data: bytes) -> None:
    """Write ``data`` to a temp file in ``path``'s directory, fsync, and
    ``os.replace`` it into place: a kill mid-write never leaves a torn file
    under the final name."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save(plan: CommPlan, path: str) -> str:
    """Atomic write (``atomic_write``)."""
    atomic_write(path, dumps(plan).encode())
    return path


def load(path: str) -> CommPlan:
    if not os.path.exists(path):
        raise CommPlanError(f"no CommPlan at {path!r}")
    try:
        with open(path) as f:
            return loads(f.read())
    except UnicodeDecodeError as e:
        # bit-rot (the corrupt@s:plan fault's XOR flips) breaks UTF-8
        # before it breaks JSON: the same rejection either way
        raise CommPlanError(
            f"CommPlan {path!r} is not valid UTF-8 ({e}) — corrupt "
            f"plan file") from e
