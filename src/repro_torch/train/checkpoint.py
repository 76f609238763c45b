"""Fault-tolerant checkpoints (a port of ``repro.train.checkpoint``, in
the same on-disk format, so either package loads the other's).

* **Format.** The payload is ``ckpt_<tag>.npz`` (``np.savez``; loaded with
  ``allow_pickle=False``) with keys ``params|…``, ``mom|…``, ``bn|…`` and
  ``shards|…``: each tree path with ``/`` written ``|``, a tuple index as
  its decimal string. Beside it: ``meta_<tag>.json`` (step, sharded, tag),
  ``commplan_<tag>.json`` (the ``comm.plan.CommPlan``) and
  ``MANIFEST.json`` (per tag: file, sha256, bytes, step, sharded,
  comm_plan, seq; ``latest``, ``seq``). Step tags are ``step%08d``.
* **Atomic.** Every file is written to a temp file in the same directory
  and ``os.replace``d into place; a checkpoint exists once the manifest
  records it with its payload's sha256. The loader verifies the checksum
  first, and ``tag=None`` falls back to the newest entry that verifies.
* **Retention.** ``keep_last_k`` prunes the oldest step-tagged entries;
  hand-named tags are never pruned.
* **Sharded states.** A rank's ``TrainState.shards`` and packed ``mom``
  hold only its row of each bucket, where the reference saves the global
  device-major buffer. With ``mesh`` given, ``save`` all-gathers each
  bucket's rows along the shard axis (``comm.schedules.shard_axis``) into
  the ``(n * shard_elems,)`` buffer in rank order, global rank 0 writes,
  and every rank waits for the commit; ``load`` reads the global buffer
  and gives each rank its row. Without ``mesh`` the state's buffers are
  taken as the global ones (a one-process view).
* **The model axis.** Under a mesh's ``model`` axis (the ``comm='xla'``
  step over ``(data, model)``: ROADMAP §1 item 6.2c) a rank's ``params``
  and momentum (LAMB's two moments) hold its slices of the split leaves.
  The file holds the reference's whole arrays all the same: ``save``
  gathers each split leaf whole over ``model`` by the descriptors of
  ``param_pd`` (the ``comm='xla'`` step's ``param_pd``, the model's: an
  explicit schedule's state, whole over every axis, has none), so a file
  written at ``(2, 2)`` holds the bytes one written at model 1 from the
  same state would, and ``load`` reads the whole arrays and keeps this rank's
  slices (``weights.shard_tree``'s cut), on any ``(data, model)`` shape.
  A split leaf whose saved shape is not the whole one raises
  :class:`CheckpointMismatchError` naming it (a file of one rank's
  slices, as saves before this repair wrote them, ROADMAP §3 fault 3.7).
* **Fresh tensors.** ``load`` returns new tensors on the template's
  device and never writes into the template: the sharded step updates its
  state in place, and the watchdog's abandoned step may still hold one.

Validation raises real exceptions, never ``assert``.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm import plan as comm_plan_mod
from repro_torch.models.common import local_shape, local_slice, model_axis
from repro_torch.obs import metrics as obs_metrics
from repro_torch.train.state import TrainState, gather_rows

_SEP = "|"
MANIFEST = "MANIFEST.json"
_STEP_TAG = re.compile(r"^step(\d{8})$")
_WHERE = "repro_torch/train/checkpoint.py"


class CheckpointError(RuntimeError):
    """Base for all checkpoint failures."""


class CheckpointCorruptError(CheckpointError):
    """Payload bytes do not match the manifest checksum (torn write,
    bit-rot, tampering), or the file vanished."""


class CheckpointMismatchError(CheckpointError):
    """Checkpoint verifies but does not fit the template (shapes, missing
    keys, sharded-vs-replicated layout)."""


def step_tag(step: int) -> str:
    """Canonical step-indexed tag: sortable, unique per step, prunable."""
    return f"step{int(step):08d}"


def _is_step_tag(tag: str) -> Optional[int]:
    m = _STEP_TAG.match(tag)
    return int(m.group(1)) if m else None


def is_writer() -> bool:
    """The process that writes checkpoints: global rank 0 (index 0 on
    every mesh axis), or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{key: leaf}``, keys ``a|b|c`` in the reference's order (dict keys
    sorted, tuple indices in order); ``None`` holds no leaf."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k))
    return out


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def read_manifest(ckpt_dir: str) -> Optional[dict]:
    path = os.path.join(ckpt_dir, MANIFEST)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            m = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        # bit-rot (the corrupt@s:manifest fault's XOR flips) usually breaks
        # UTF-8 before it breaks JSON
        raise CheckpointCorruptError(
            f"manifest {path!r} does not parse ({e}) — the directory needs "
            f"manual repair; individual ckpt_<tag>.npz files may still load "
            f"via an explicit tag") from e
    return m


def _write_manifest(ckpt_dir: str, manifest: dict) -> None:
    comm_plan_mod.atomic_write(
        os.path.join(ckpt_dir, MANIFEST),
        json.dumps(manifest, indent=1, sort_keys=True).encode())


def available_tags(ckpt_dir: str) -> List[str]:
    """Committed tags, oldest save first."""
    m = read_manifest(ckpt_dir)
    if not m:
        return []
    ents = sorted(m["entries"].items(), key=lambda kv: kv[1]["seq"])
    return [k for k, _ in ents]


def latest_tag(ckpt_dir: str) -> Optional[str]:
    m = read_manifest(ckpt_dir)
    return m["latest"] if m else None


def _shard_axis(mesh):
    if mesh is None:
        return None
    from repro_torch.comm.schedules import shard_axis
    return shard_axis(mesh.axes)


def _packed(state: TrainState, field: str) -> bool:
    """Whether ``field`` holds per-bucket sharded rows (shards, and the
    momentum of a sharded rung)."""
    return isinstance(getattr(state, field), (tuple, list))


def _split_pds(tree, param_pd):
    """The descriptor tree of a params-shaped field ``tree``: ``param_pd``
    itself, or LAMB's ``{'m', 'v'}`` moments' (its ``count`` is a host
    integer, never split)."""
    if isinstance(tree, dict) and "count" in tree:
        return {"m": param_pd, "v": param_pd}
    return param_pd


def _tp_of(state: TrainState, mesh, param_pd):
    """The model axis the state's params and momentum are split over (a
    ``launch.mesh.Axis``) by ``param_pd``, or None: no model axis, no
    descriptors (an explicit schedule's state, whose leaves are whole
    over every axis), or a packed (sharded rung) state."""
    tp = model_axis(mesh)
    if tp is None or param_pd is None or _packed(state, "mom"):
        return None
    return tp


def _whole(tree, param_pd, mesh):
    """A params-shaped field with each split leaf gathered whole over the
    model axis (collective over its group)."""
    from repro_torch.weights import gather_tree
    if isinstance(tree, dict) and "count" in tree:
        return dict(tree, m=gather_tree(tree["m"], param_pd, mesh),
                    v=gather_tree(tree["v"], param_pd, mesh))
    return gather_tree(tree, param_pd, mesh)


def _payload(state: TrainState, mesh=None,
             param_pd=None) -> Dict[str, np.ndarray]:
    """The npz entries; a sharded field's rows gathered along the shard
    axis, the split leaves of ``params`` and ``mom`` whole over the model
    axis (collective: every rank calls it)."""
    axis = _shard_axis(mesh)
    tp = _tp_of(state, mesh, param_pd)
    fields = (("params", "params"), ("mom", "mom"), ("bn", "bn_state"),
              ("shards", "shards"))
    payload = {}
    for prefix, field in fields:
        tree = getattr(state, field)
        if _packed(state, field):
            tree = tuple(gather_rows(b, axis) for b in tree)
        elif tp is not None and field in ("params", "mom") \
                and tree is not None:
            tree = _whole(tree, param_pd, mesh)
        payload.update({f"{prefix}{_SEP}{k}": _to_numpy(v)
                        for k, v in _flatten(tree).items()})
    return payload


def save(state: TrainState, ckpt_dir: str, *, tag: str = "last",
         comm_plan=None, keep_last_k: int = 0, mesh=None,
         param_pd=None) -> str:
    """Atomically commit ``state`` under ``tag``. ``comm_plan`` (a
    ``comm.plan.CommPlan``) is written beside it so that an elastic resume
    can rebuild the packing layout. ``keep_last_k > 0`` prunes older
    step-tagged checkpoints beyond k. With ``mesh``, every rank calls
    this: sharded rows are gathered, and over a model axis the split
    leaves by ``param_pd`` (the model's descriptors, the ``comm='xla'``
    step's ``param_pd``), rank 0 writes, all return once the manifest is
    committed. Returns the payload's path."""
    payload = _payload(state, mesh, param_pd)
    fname = f"ckpt_{tag}.npz"
    if is_writer():
        os.makedirs(ckpt_dir, exist_ok=True)
        buf = io.BytesIO()
        np.savez(buf, **payload)
        data = buf.getvalue()
        meta = {"step": int(state.step), "sharded": state.shards is not None,
                "tag": tag}
        sha = hashlib.sha256(data).hexdigest()
        comm_plan_mod.atomic_write(os.path.join(ckpt_dir, fname), data)
        comm_plan_mod.atomic_write(os.path.join(ckpt_dir, f"meta_{tag}.json"),
                                   json.dumps(meta).encode())
        has_plan = comm_plan is not None
        if has_plan:
            comm_plan_mod.save(comm_plan,
                               os.path.join(ckpt_dir, f"commplan_{tag}.json"))
        manifest = read_manifest(ckpt_dir) or {"version": 1, "latest": None,
                                               "seq": 0, "entries": {}}
        manifest["seq"] = int(manifest.get("seq", 0)) + 1
        manifest["entries"][tag] = {
            "file": fname, "sha256": sha, "bytes": len(data),
            "step": meta["step"], "sharded": meta["sharded"],
            "comm_plan": f"commplan_{tag}.json" if has_plan else None,
            "seq": manifest["seq"]}
        manifest["latest"] = tag
        _write_manifest(ckpt_dir, manifest)
        if keep_last_k:
            prune(ckpt_dir, keep_last_k)
    if mesh is not None and dist.is_initialized() \
            and dist.get_world_size() > 1:
        # every rank returns once the commit is on disk
        dist.all_reduce(torch.zeros(1, device=mesh.device))
    return os.path.join(ckpt_dir, fname)


def prune(ckpt_dir: str, keep_last_k: int) -> List[str]:
    """Drop the oldest step-tagged checkpoints beyond ``keep_last_k``
    (manifest entry first, then files: a kill mid-prune leaves orphaned
    files, never an entry pointing at nothing). Hand-named tags ('last',
    'best', ...) are never pruned. Returns the dropped tags."""
    manifest = read_manifest(ckpt_dir)
    if not manifest or keep_last_k <= 0:
        return []
    stepped = sorted((t for t in manifest["entries"]
                      if _is_step_tag(t) is not None),
                     key=lambda t: manifest["entries"][t]["seq"])
    drop = stepped[:-keep_last_k] if keep_last_k < len(stepped) else []
    for tag in drop:
        ent = manifest["entries"].pop(tag)
        if manifest["latest"] == tag:       # cannot happen in practice
            manifest["latest"] = stepped[-1]
        _write_manifest(ckpt_dir, manifest)
        for f in (ent["file"], f"meta_{tag}.json", ent.get("comm_plan")):
            if f:
                try:
                    os.unlink(os.path.join(ckpt_dir, f))
                except FileNotFoundError:
                    pass
    return drop


def verify(ckpt_dir: str, tag: str) -> dict:
    """Check ``tag``'s payload against its manifest checksum. Returns the
    manifest entry; raises :class:`CheckpointCorruptError` on a mismatch
    or a missing file, :class:`CheckpointError` for an unknown tag."""
    manifest = read_manifest(ckpt_dir)
    if not manifest or tag not in manifest["entries"]:
        raise CheckpointError(
            f"tag {tag!r} is not committed in {ckpt_dir!r} (manifest has "
            f"{available_tags(ckpt_dir)})")
    ent = manifest["entries"][tag]
    path = os.path.join(ckpt_dir, ent["file"])
    if not os.path.exists(path):
        raise CheckpointCorruptError(
            f"checkpoint payload {path!r} is missing but committed in the "
            f"manifest — the directory was partially deleted")
    with open(path, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    if sha != ent["sha256"]:
        raise CheckpointCorruptError(
            f"checksum mismatch for {path!r}: manifest sha256 "
            f"{ent['sha256'][:12]}…, file {sha[:12]}… — the payload is "
            f"torn or bit-rotted; falling back to an older checkpoint "
            f"(load with tag=None) is the safe recovery")
    return ent


def _resolve_tag(ckpt_dir: str, tag: Optional[str]) -> str:
    """``tag=None`` -> the newest entry that verifies (each rejected one
    announced as a ``checkpoint_fallback`` event); explicit tags are
    returned as-is (legacy directories without a manifest keep working
    that way)."""
    if tag is not None:
        return tag
    tags = available_tags(ckpt_dir)
    if not tags:
        if os.path.exists(os.path.join(ckpt_dir, "ckpt_last.npz")):
            return "last"
        raise CheckpointError(
            f"no committed checkpoint in {ckpt_dir!r} (no manifest, no "
            f"legacy ckpt_last.npz)")
    last_err = None
    for t in reversed(tags):
        try:
            verify(ckpt_dir, t)
            return t
        except CheckpointCorruptError as e:
            obs_metrics.event(
                "checkpoint_fallback",
                {"rejected_tag": t, "error": str(e), "dir": ckpt_dir},
                where=_WHERE)
            last_err = e
    raise CheckpointCorruptError(
        f"every committed checkpoint in {ckpt_dir!r} fails verification; "
        f"last error: {last_err}")


def load_arrays(ckpt_dir: str, *, tag: Optional[str] = None
                ) -> Tuple[dict, Dict[str, np.ndarray], Any]:
    """Raw restore: ``(meta, {flat key: array}, comm_plan | None)`` with
    checksum verification but no template (what elastic resume uses to
    reshard before a template of the new layout exists)."""
    tag = _resolve_tag(ckpt_dir, tag)
    manifest = read_manifest(ckpt_dir)
    if manifest and tag in manifest["entries"]:
        verify(ckpt_dir, tag)
    path = os.path.join(ckpt_dir, f"ckpt_{tag}.npz")
    if not os.path.exists(path):
        raise CheckpointError(f"no checkpoint payload at {path!r}")
    with open(os.path.join(ckpt_dir, f"meta_{tag}.json")) as f:
        meta = json.load(f)
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    plan = None
    plan_path = os.path.join(ckpt_dir, f"commplan_{tag}.json")
    if os.path.exists(plan_path):
        try:
            plan = comm_plan_mod.load(plan_path)
        except comm_plan_mod.CommPlanError as e:
            # the plan is not covered by the payload checksum: a corrupt
            # one is a checkpoint rejection, not a crash in the parser
            raise CheckpointCorruptError(
                f"CommPlan {plan_path!r} committed with tag {tag!r} does "
                f"not parse ({e}) — the checkpoint is corrupt; load an "
                f"older tag explicitly") from e
    return meta, data, plan


def load_comm_plan(ckpt_dir: str, *, tag: Optional[str] = None):
    """The CommPlan committed with ``tag`` (default: the newest verifying
    checkpoint); raises :class:`CheckpointError` if none was saved."""
    tag = _resolve_tag(ckpt_dir, tag)
    path = os.path.join(ckpt_dir, f"commplan_{tag}.json")
    if not os.path.exists(path):
        raise CheckpointError(
            f"checkpoint {tag!r} in {ckpt_dir!r} carries no CommPlan — it "
            f"predates the elastic layer (or was saved without "
            f"comm_plan=...); elastic resume needs the serialized packing "
            f"layout")
    return comm_plan_mod.load(path)


def _leaf(arr: np.ndarray, like):
    """``arr`` as a new leaf of ``like``'s kind: a tensor on its device in
    its dtype, or a host scalar."""
    if not isinstance(like, torch.Tensor):
        return type(like)(arr.item()) if arr.ndim == 0 else arr
    return torch.from_numpy(np.array(arr)).to(device=like.device,
                                              dtype=like.dtype)


def _cut(arr: np.ndarray, key: str, pd, tp) -> np.ndarray:
    """This rank's slice over the model axis ``tp`` of the whole array
    ``arr`` saved for the leaf ``pd`` (itself for a replicated leaf)."""
    d, start, k = local_slice(pd, tp)
    if d is None:
        return arr
    if tuple(arr.shape) != tuple(pd.shape):
        what = ("one rank's slice (a save from before the repair of "
                "ROADMAP §3 fault 3.7)"
                if tuple(arr.shape) == local_shape(pd, tp) else
                "neither the whole leaf nor a slice of it")
        raise CheckpointMismatchError(
            f"{key}: the checkpoint holds {tuple(arr.shape)}, {what}; a "
            f"leaf split over the model axis is saved whole, "
            f"{tuple(pd.shape)}")
    return np.take(arr, range(start, start + k), axis=d)


def _restore(prefix: str, tree, data, rows=None, pds=None, tp=None):
    """The tree of ``prefix`` entries in ``tree``'s structure. ``rows``
    (index, n): each entry is a global sharded buffer of which this rank
    takes row ``index`` of ``n``. ``pds`` (the field's descriptor tree)
    and ``tp``: each split leaf's entry is the whole array, of which this
    rank takes its slice over the model axis ``tp``."""
    if tree is None:
        return None
    flat = _flatten(tree)
    missing = [k for k in flat if f"{prefix}{_SEP}{k}" not in data]
    if missing:
        raise CheckpointMismatchError(
            f"checkpoint lacks {len(missing)} {prefix!r} entr"
            f"{'y' if len(missing) == 1 else 'ies'} the template expects "
            f"(first: {missing[:3]}) — wrong model/optimizer/shard layout "
            f"for this checkpoint")
    got = {}
    pd_of = _flatten(pds) if tp is not None else {}
    for k, like in flat.items():
        arr = data[f"{prefix}{_SEP}{k}"]
        want = tuple(like.shape) if isinstance(like, torch.Tensor) else ()
        if rows is not None and arr.ndim == 1 and arr.size % rows[1] == 0:
            arr = arr.reshape(rows[1], -1)[rows[0]]
        if k in pd_of:
            arr = _cut(arr, f"{prefix}{_SEP}{k}", pd_of[k], tp)
        if tuple(arr.shape) != want:
            raise CheckpointMismatchError(
                f"shape mismatch restoring {prefix}{_SEP}{k}: checkpoint "
                f"has {arr.shape}, template expects {want} — the "
                f"checkpoint was written under a different config or shard "
                f"count (for a device-count change, resume via "
                f"train.elastic.load_resharded / --resume-elastic)")
        got[k] = _leaf(arr, like)
    return _rebuild(tree, got)


def _rebuild(tree, got, prefix: str = ""):
    """``tree``'s structure with the leaves of ``got`` (keyed as
    ``_flatten`` keys them)."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], got,
                            f"{prefix}{_SEP}{k}" if prefix else str(k))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, got,
                                   f"{prefix}{_SEP}{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return got[prefix]


def load(template: TrainState, ckpt_dir: str, *, tag: Optional[str] = None,
         mesh=None, param_pd=None) -> TrainState:
    """Restore into the structure of ``template``, in new tensors on its
    device (shapes must match: for an n→m device-count change use
    ``train.elastic.load_resharded``). ``tag=None`` picks the newest
    checkpoint that passes checksum verification. With ``mesh``, each
    rank takes its row of every sharded buffer, and over a model axis its
    slices of the whole split leaves by ``param_pd`` (as ``save``), on
    whatever ``(data, model)`` shape the file was written."""
    meta, data, _ = load_arrays(ckpt_dir, tag=tag)
    if template.shards is not None and not meta.get("sharded"):
        raise CheckpointMismatchError(
            "template expects ZeRO-1 master shards but the checkpoint was "
            "saved from a non-sharded state — restore into a non-sharded "
            "template (init_state without sharded_plan) instead")
    if template.shards is None and meta.get("sharded"):
        raise CheckpointMismatchError(
            "checkpoint holds ZeRO-1 master shards (and its params copy "
            "may lag them by one update) but the template is non-sharded "
            "— rebuild with init_state(..., sharded_plan=..., n_shards=...)")
    axis = _shard_axis(mesh)
    rows = (axis.index, axis.size) if axis is not None else None
    mom_rows = rows if _packed(template, "mom") else None
    tp = _tp_of(template, mesh, param_pd)
    return TrainState(
        int(meta["step"]),
        _restore("params", template.params, data, pds=param_pd, tp=tp),
        _restore("mom", template.mom, data, mom_rows,
                 pds=_split_pds(template.mom, param_pd), tp=tp),
        _restore("bn", template.bn_state, data),
        _restore("shards", template.shards, data, rows))
