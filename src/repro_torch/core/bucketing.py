"""Gradient bucketing (paper §III-C.1): the CHUNK-aligned packed layout.

A port of ``repro.core.bucketing``. ``BucketPlan`` is computed once from a
tree of descriptors or tensors in **reverse flatten order** (the JAX
package's order: dict keys sorted, so ``stem/conv, stem/bn/scale,
stem/bn/bias, s3b2/conv3, …``), and must equal the reference's plan slot
for slot. Every tensor is padded to CHUNK elements; a tensor larger than
the bucket budget is split into CHUNK-aligned spans, one ``TensorSlot``
each (``elem_offset`` marks where the span starts in the flattened
tensor), and segment maps key on the *tensor* id.

The packed buffer plus its per-chunk segment ids is the input layout of the
batched-norm kernel (``kernels/batched_norm``). The shard-aware layout of
the ZeRO-1 path (``shard_elems`` … ``trust_scaled_mask``) is at the end.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

CHUNK = 1024  # the packing quantum (8 sublanes x 128 lanes on the TPU)


@dataclasses.dataclass(frozen=True)
class TensorSlot:
    path: str
    shape: Tuple[int, ...]  # FULL tensor shape (shared by every span)
    size: int              # unpadded element count of THIS span
    padded: int            # span padded to CHUNK
    bucket: int            # bucket index
    offset: int            # element offset within its bucket
    elem_offset: int = 0   # span start inside the flattened tensor


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    slots: Tuple[TensorSlot, ...]     # in packing order (reverse flatten)
    bucket_sizes: Tuple[int, ...]     # elements per bucket (CHUNK-aligned)
    paths: Tuple[str, ...]            # leaf paths in flatten order

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_sizes)

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    @property
    def n_tensors(self) -> int:
        """Distinct tensors (a split tensor counts once, not per span)."""
        return sum(1 for s in self.slots if s.elem_offset == 0)

    @property
    def n_chunks(self) -> int:
        return sum(self.bucket_sizes) // CHUNK

    @property
    def slot_tensor_ids(self) -> Tuple[int, ...]:
        """Per-slot tensor index in packing order: spans of one split
        tensor share an id."""
        ids, t = [], -1
        for s in self.slots:
            if s.elem_offset == 0:
                t += 1
            ids.append(t)
        return tuple(ids)

    @property
    def groups(self) -> Tuple[Tuple[TensorSlot, ...], ...]:
        """Slots grouped per bucket, in packing (= backward-completion)
        order: the static layer groups of §III-C.2, one collective each."""
        out: List[List[TensorSlot]] = [[] for _ in self.bucket_sizes]
        for slot in self.slots:
            out[slot.bucket].append(slot)
        return tuple(tuple(g) for g in out)

    def bucket_bytes(self, dtype_bytes: int = 2) -> Tuple[int, ...]:
        """Wire payload per bucket (padded elements x wire dtype width)."""
        return tuple(s * dtype_bytes for s in self.bucket_sizes)

    @property
    def group_elems(self) -> Tuple[int, ...]:
        """Unpadded parameter elements per bucket group: what a ZeRO-3
        gather unpacks (``bucket_sizes`` is the padded wire buffer)."""
        out = [0] * self.n_buckets
        for slot in self.slots:
            out[slot.bucket] += slot.size
        return tuple(out)

    @property
    def tensor_slots(self) -> Tuple[Tuple[TensorSlot, ...], ...]:
        """Slots regrouped per tensor, in packing order (a split tensor's
        spans are consecutive in ``slots``)."""
        out: List[List[TensorSlot]] = []
        for s in self.slots:
            if s.elem_offset == 0:
                out.append([])
            out[-1].append(s)
        return tuple(tuple(g) for g in out)

    @property
    def slot_is_final_span(self) -> Tuple[bool, ...]:
        """Per slot: True on the LAST span of its tensor (every slot of an
        unsplit plan). The final span lives in the tensor's highest bucket,
        whose in-backward identity fires last."""
        n = len(self.slots)
        return tuple(i + 1 == n or self.slots[i + 1].elem_offset == 0
                     for i in range(n))


def make_plan(tree, *, bucket_mb: float = 4.0,
              dtype_bytes: int = 2) -> BucketPlan:
    """Greedy fill in reverse flatten order: open a new bucket whenever the
    current one would exceed ``bucket_mb``; split a leaf whose padded size
    exceeds the budget into CHUNK-aligned spans (full spans fill a bucket
    each, the tail span opens a bucket that later leaves keep filling).
    Leaves are descriptors or tensors: only ``.shape`` is read. A bucket
    past the budget is a packing bug and raises."""
    flat = tree_flatten(tree)
    target_elems = int(bucket_mb * 2 ** 20 / dtype_bytes)
    span_elems = max(CHUNK, (target_elems // CHUNK) * CHUNK)
    slots: List[TensorSlot] = []
    bucket_sizes: List[int] = []
    cur, cur_off = 0, 0
    for path, leaf in reversed(flat):
        shape = tuple(leaf.shape)
        size = math.prod(shape)
        padded = -(-size // CHUNK) * CHUNK
        if padded > target_elems:
            # close the open bucket, then one bucket per full span
            if cur_off:
                bucket_sizes.append(cur_off)
                cur, cur_off = cur + 1, 0
            eo = 0
            while size - eo > span_elems:
                slots.append(TensorSlot(path, shape, span_elems, span_elems,
                                        cur, 0, eo))
                bucket_sizes.append(span_elems)
                cur, eo = cur + 1, eo + span_elems
            rem = size - eo
            rem_padded = -(-rem // CHUNK) * CHUNK
            slots.append(TensorSlot(path, shape, rem, rem_padded, cur, 0, eo))
            cur_off = rem_padded     # tail span leaves its bucket open
            continue
        if cur_off and cur_off + padded > target_elems:
            bucket_sizes.append(cur_off)
            cur, cur_off = cur + 1, 0
        slots.append(TensorSlot(path, shape, size, padded, cur, cur_off))
        cur_off += padded
    if cur_off or not bucket_sizes:
        bucket_sizes.append(cur_off)
    plan = BucketPlan(tuple(slots), tuple(bucket_sizes),
                      tuple(p for p, _ in flat))
    worst = max(plan.bucket_sizes, default=0)
    if worst > max(target_elems, CHUNK):
        raise ValueError(
            f"bucket {plan.bucket_sizes.index(worst)} packs {worst} elems > "
            f"budget {target_elems} despite leaf splitting — packing bug")
    return plan


def pack_flat(tree, plan: BucketPlan, dtype=torch.bfloat16) -> torch.Tensor:
    """Tree -> ONE flat buffer holding every bucket back to back (what
    ``concat_buckets(pack(...))`` gives, without the second copy), in
    ``dtype``, zero-padded per slot. Split tensors hand the same leaf to
    every bucket that holds one of their spans."""
    leaves = list(reversed(tree_leaves(tree)))
    if len(leaves) != plan.n_tensors:
        raise ValueError(f"tree has {len(leaves)} leaves, plan "
                         f"{plan.n_tensors} tensors")
    flat = torch.zeros(sum(plan.bucket_sizes), dtype=dtype,
                       device=leaves[0].device)
    starts = np.cumsum((0,) + plan.bucket_sizes[:-1])
    for ti, slot in zip(plan.slot_tensor_ids, plan.slots):
        src = leaves[ti].reshape(-1)[slot.elem_offset:
                                     slot.elem_offset + slot.size]
        at = int(starts[slot.bucket]) + slot.offset
        flat[at:at + slot.size].copy_(src)
    return flat


def pack(tree, plan: BucketPlan, dtype=torch.bfloat16) -> List[torch.Tensor]:
    """Tree -> list of flat per-bucket buffers (views of one allocation)."""
    return list(pack_flat(tree, plan, dtype).split(plan.bucket_sizes))


def unpack(bufs: List[torch.Tensor], plan: BucketPlan,
           dtype=torch.float32) -> dict:
    """Inverse of :func:`pack`: buffers -> tree in ``dtype``. Split tensors
    are reassembled by concatenating their spans in order."""
    leaves, pieces = [], []
    n = len(plan.slots)
    for i, slot in enumerate(plan.slots):
        buf = bufs[slot.bucket]
        pieces.append(buf[slot.offset:slot.offset + slot.size].to(dtype))
        if i + 1 == n or plan.slots[i + 1].elem_offset == 0:
            full = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
            leaves.append(full.reshape(slot.shape))
            pieces = []
    return tree_unflatten(plan.paths, list(reversed(leaves)))


def pack_group(leaves, slots, dtype=torch.bfloat16) -> torch.Tensor:
    """One bucket group's leaves -> its flat wire buffer in ``dtype``
    (``leaves`` ordered like ``slots``; each leaf is the FULL tensor, the
    slot's ``elem_offset`` span is sliced out here), zero-padded per slot."""
    buf = torch.zeros(sum(s.padded for s in slots), dtype=dtype,
                      device=leaves[0].device)
    at = 0
    for slot, leaf in zip(slots, leaves):
        buf[at:at + slot.size].copy_(
            leaf.reshape(-1)[slot.elem_offset:slot.elem_offset + slot.size])
        at += slot.padded
    return buf


def unpack_group(buf: torch.Tensor, slots, dtype=torch.float32):
    """Inverse of :func:`pack_group`: per-slot values in ``dtype``. A slot
    covering its whole tensor yields the reshaped tensor; a split span its
    flat ``(size,)`` piece. The dtype is applied once on the buffer."""
    buf = buf.to(dtype)
    out = []
    for s in slots:
        piece = buf[s.offset:s.offset + s.size]
        if s.elem_offset == 0 and s.size == math.prod(s.shape):
            piece = piece.reshape(s.shape)
        out.append(piece)
    return out


def segment_ids(plan: BucketPlan) -> np.ndarray:
    """Per-CHUNK tensor index over the *concatenated* buckets — the
    batched-norm kernel's segment map, non-decreasing. Split spans repeat
    their tensor's id. Shape: (total_chunks,)."""
    ids = []
    for ti, slot in zip(plan.slot_tensor_ids, plan.slots):
        ids.extend([ti] * (slot.padded // CHUNK))
    return np.asarray(ids, np.int32)


def concat_buckets(bufs: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat(bufs) if len(bufs) > 1 else bufs[0]


# --------------------------------------------------------------------------
# shard-aware layout (ZeRO-1 sharded-update path)
#
# A bucket of L elements sharded n ways is zero-padded to n * shard_elems
# and viewed as n contiguous CHUNK-aligned shards; shard k covers elements
# [k * c, (k + 1) * c). This is ``comm.primitives.ring_reduce_scatter``'s
# chunk view, so a reduce-scatter-terminal schedule's output on rank r IS
# shard k = (r + 1) % n of this layout.

def shard_elems(bucket_elems: int, n_shards: int) -> int:
    """Per-shard element count c: the bucket padded to ``n_shards * c``
    with ``c`` CHUNK-aligned."""
    return -(-bucket_elems // (n_shards * CHUNK)) * CHUNK


def pad_to_shards(buf: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Zero-pad one packed bucket buffer to the sharded layout length."""
    c = shard_elems(buf.shape[0], n_shards)
    if n_shards * c != buf.shape[0]:
        buf = torch.nn.functional.pad(buf, (0, n_shards * c - buf.shape[0]))
    return buf


def shard_sizes(plan: BucketPlan, n_shards: int) -> Tuple[int, ...]:
    """Per-bucket shard length c (``shard_elems``)."""
    return tuple(shard_elems(s, n_shards) for s in plan.bucket_sizes)


def rotate_to_shards(buf: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Packed bucket buffer -> the rank-major persistent-shard layout:
    zero-pad to ``n_shards * c``, view as ``(n, c)`` rows, and rotate so
    row r holds chunk ``(r + 1) % n``, the chunk rank r owns after a ring
    reduce-scatter (``comm.primitives.shard_index``)."""
    buf = pad_to_shards(buf, n_shards)
    if n_shards == 1:
        return buf
    c = buf.shape[0] // n_shards
    return torch.roll(buf.reshape(n_shards, c), -1, dims=0).reshape(-1)


def unrotate_shards(buf: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Inverse of ``rotate_to_shards`` (still padded to ``n_shards * c``;
    callers slice to the bucket size)."""
    if n_shards == 1:
        return buf
    c = buf.shape[0] // n_shards
    return torch.roll(buf.reshape(n_shards, c), 1, dims=0).reshape(-1)


def shard_segment_ids(plan: BucketPlan, n_shards: int) -> List[np.ndarray]:
    """Per-bucket shard-aware segment maps: one ``(n_shards,
    chunks_per_shard)`` int32 array per bucket whose row k holds the
    tensor id (``slot_tensor_ids``) of each CHUNK in shard k. Padding
    chunks past the bucket's last tensor repeat its id (their p/g/m are
    zeros, so the packed update is a no-op there), which keeps every row
    non-decreasing, as the batched-norm kernel's binary search needs."""
    tids = plan.slot_tensor_ids
    out = []
    for b, size in enumerate(plan.bucket_sizes):
        c = shard_elems(size, n_shards)
        ids = []
        for ti, slot in zip(tids, plan.slots):
            if slot.bucket == b:
                ids.extend([ti] * (slot.padded // CHUNK))
        total = n_shards * c // CHUNK
        ids.extend([ids[-1]] * (total - len(ids)))
        out.append(np.asarray(ids, np.int32).reshape(n_shards, c // CHUNK))
    return out


def trust_scaled_mask(plan: BucketPlan) -> np.ndarray:
    """Per-tensor bool mask, indexed by tensor id: True where LARS trust
    scaling applies (>= 2-D tensors, as ``lars._is_scaled``)."""
    return np.asarray([len(s.shape) >= 2 for s in plan.slots
                       if s.elem_offset == 0], bool)
