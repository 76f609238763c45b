"""Mixture-of-Experts (a port of ``repro.models.moe``).

The JAX package runs the layer inside ``shard_map`` over the mesh's
``model`` axis, and so does the port over a ``launch.mesh`` model axis
``tp`` (ROADMAP §1 item 6.3's experts): the three expert stacks split on
their expert dim (``("model", None, None)``: a rank holds E/M experts of
the padded stack), the router is replicated. The activations are the
rank's rows, whole on every model rank; two bodies, as the reference
picks them:

* train/prefill with S >= M (``_a2a``, the reference's ``_moe_a2a``):
  each rank takes its chunk of the sequence (S/M tokens of each of its
  rows) and routes it alone, with its own capacity C (from its own token
  count) and its own aux loss. Each token picks its top-k experts; the
  (T·k) choices, token-major, take the slots of per-expert buffers of
  capacity C in order, so later tokens are dropped first; empty and
  dropped slots read a zero row (the sentinel row T). One ``all_to_all``
  sends each expert's (C, d) buffer to the rank that holds it ((E/M,
  M·C, d) there), the local experts run on it, a second brings the
  results back; ``ys · gate`` in f32 comes back to its tokens as the
  reference's scatter-add sums it, each token's slots in ascending expert
  order (``_combine``: a gather, so that the card sums in that one order
  every run). The chunks are gathered over the sequence, and the aux is
  their mean over the axis. The reference cannot shard a length M does
  not divide (``uneven_tokens``).
* decode, or S < M (``_local_psum``, the reference's ``_moe_local_psum``):
  every rank routes every token and runs its E/M experts on all of them,
  weighted by the gates in its range; the f32 sums are added over the
  axis. No capacity and no drop, and every expert's weights are read each
  step; the aux is every rank's alike.

So at M model ranks the layer computes the reference's model-M answer,
which is not its model-1 one: capacity, drops and aux are taken a (data
rank, sequence chunk). ``moe_apply_chunked`` computes that answer on one
device: the one-card yardsticks of the model-axis runs swap it in for
``moe_apply``.

Shared ("always-on") experts are a dense SwiGLU of width
``n_shared * d_expert`` applied outside this module
(``transformer._dense_block``), split over the axis as every SwiGLU.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import PD, all_to_all, copy_in, \
    counted_once, dense_pd, gather_out, reduce_out
from repro_torch.models.mlp import silu

EP_ALIGN = 16   # the JAX package's production model-axis size


def padded_experts(cfg) -> int:
    """Expert-stack size: n_routed padded to a multiple of EP_ALIGN, so
    that the stack splits evenly over a model axis that divides 16
    (qwen2-moe's 60 -> 64: 16 experts a rank at model 4). The router has
    n_routed outputs and never selects a padded slot: those buffers stay
    empty and their gates zero."""
    e = cfg.moe
    if e.n_routed % EP_ALIGN == 0 or e.n_routed < EP_ALIGN:
        return e.n_routed
    return -(-e.n_routed // EP_ALIGN) * EP_ALIGN


def moe_pd(cfg):
    d = cfg.d_model
    e = cfg.moe
    E = padded_experts(cfg)
    scale_in = d ** -0.5
    scale_out = e.d_expert ** -0.5 / math.sqrt(2 * cfg.n_layers)
    split = ("model", None, None)
    return {
        "router": dense_pd(d, e.n_routed, scale=scale_in),
        "w_gate": PD((E, d, e.d_expert), spec=split, scale=scale_in),
        "w_up": PD((E, d, e.d_expert), spec=split, scale=scale_in),
        "w_down": PD((E, e.d_expert, d), spec=split, scale=scale_out),
    }


def capacity(n_tokens: int, e) -> int:
    """Slots per expert of the train/prefill buffers."""
    return max(4, int(math.ceil(n_tokens * e.top_k / e.n_routed
                                * e.capacity_factor)))


def _top_k(x, k: int):
    """``lax.top_k`` over the last axis: the k largest, largest first, the
    lower index first among equal values (``torch.topk`` leaves the order
    of ties unspecified, and the slots depend on the order)."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _route(x_flat, router_w, e):
    """Top-k routing in f32. Returns gates (T, k) f32 (renormalised over
    the k), ids (T, k) int64 and the Switch load-balance loss
    ``n_routed · Σ_e f_e · p_e`` (f: share of the choices, p: mean
    probability)."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, ids = _top_k(probs, e.top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    f = torch.bincount(ids.reshape(-1), minlength=e.n_routed).float() \
        / ids.numel()
    aux = e.n_routed * (f * probs.mean(0)).sum()
    return gates, ids, aux


def _expert_ffn(w_gate, w_up, w_down, xs):
    """xs: (E, C, d) -> (E, C, d), each expert's SwiGLU on its rows."""
    h = silu(torch.bmm(xs, w_gate)) * torch.bmm(xs, w_up)
    return torch.bmm(h, w_down)


def dispatch(ids, gates, n_tokens: int, n_experts: int, cap: int):
    """The slot of each (token, choice): the running count of its expert
    over the token-major choices; a choice past ``cap`` is dropped.
    Returns disp (E, C) int64, the token row each slot reads (``n_tokens``:
    the zero row, for an empty slot), and gate_ec (E, C) f32, the gate each
    slot's output is weighted by (0 where empty)."""
    dev = ids.device
    ids_f = ids.reshape(-1)
    # the running count of each expert over the choices, expert-major so
    # the scan runs along the inner dim (along the outer one it took 23
    # ms a layer on the H100 at 16,384 tokens)
    hits = ids_f[None, :] == torch.arange(n_experts, device=dev)[:, None]
    counts = hits.cumsum(1, dtype=torch.int32)
    pos_f = counts.gather(0, ids_f[None, :])[0].long() - 1
    keep = pos_f < cap
    # dropped choices write row E, which is cut off: no host sync
    ids_safe = torch.where(keep, ids_f, n_experts)
    pos_safe = torch.where(keep, pos_f, 0)
    tok_f = torch.arange(n_tokens, device=dev).repeat_interleave(
        ids.shape[1])
    disp = torch.full((n_experts + 1, cap), n_tokens, dtype=torch.long,
                      device=dev)
    disp[ids_safe, pos_safe] = tok_f
    gate_ec = gates.new_zeros((n_experts + 1, cap)).index_put(
        (ids_safe, pos_safe), gates.reshape(-1))
    return disp[:n_experts], gate_ec[:n_experts]


def _combine(contrib, disp, ids, n_tokens: int):
    """(n_tokens, d) f32: each token's slot outputs (``contrib``, (E·C, d)
    f32, the slots E-major as ``disp`` lays them out) added up in
    ascending expert order, a dropped choice adding nothing. That is the
    order of the reference's scatter-add and of a sequential
    ``index_add``; here a gather for each of the k choices, since a scatter
    on the card adds with f32 atomics in another order each run, and two
    prefills of the same prompts could then part in the last bit (and in
    a near-tied argmax)."""
    E, C = disp.shape
    dev = disp.device
    # the slot of each (token, expert); E·C (the zero row) where none. The
    # empty slots all write the sentinel row n_tokens, which is cut off
    slot_of = torch.full((n_tokens + 1, E), E * C, dtype=torch.long,
                         device=dev)
    slot_of[disp, torch.arange(E, device=dev)[:, None]] = torch.arange(
        E * C, device=dev).view(E, C)
    slots = slot_of[:n_tokens].gather(1, ids.sort(dim=-1).values)
    rows = torch.cat([contrib, contrib.new_zeros((1, contrib.shape[1]))])
    out = rows[slots[:, 0]]
    for j in range(1, slots.shape[1]):
        out = out + rows[slots[:, j]]
    return out


def uneven_tokens(what: str, s: int, m: int) -> NotImplementedError:
    """The error of a MoE train or prefill over ``s`` tokens a row that
    ``m`` model ranks do not divide: the all_to_all body splits the
    sequence over the axis, and the reference cannot shard such a length
    either (its ``shard_map`` raises that ``m`` does not evenly divide
    it)."""
    return NotImplementedError(
        f"{what}: {s} tokens over model={m}: the MoE layer splits the "
        f"sequence over the model axis, and the reference cannot shard a "
        f"length that {m} does not evenly divide either")


def moe_apply(p, x, cfg, *, decode: bool, tp=None):
    """x: (B, S, d), the rank's rows (whole on every rank of the model
    axis ``tp``). Returns (out (B, S, d) in x's dtype, aux loss 0-d f32).
    ``p``'s expert stacks are the rank's E/M experts over ``tp``; the
    reference's branch: the local psum where ``decode`` or S < M, else
    the all_to_all."""
    if decode or (tp is not None and x.shape[1] < tp.size):
        return _local_psum(p, x, cfg, tp)
    return _a2a(p, x, cfg, tp)


def _a2a(p, x, cfg, tp=None):
    """The train/prefill body: the rank's sequence chunk routed with its
    own capacity, its buffers sent to the experts' ranks and back."""
    e = cfg.moe
    B, S, d = x.shape
    router = p["router"]
    if tp is not None:
        # an S that M does not divide is refused before any collective
        # (``transformer._check_tokens``). The partial gradients of the
        # replicated x and router (each rank reads its own chunk) are
        # summed over the axis
        k = S // tp.size
        x = copy_in(x, tp).narrow(1, tp.index * k, k)
        router = copy_in(router, tp)
    T = x.shape[0] * x.shape[1]
    x_flat = x.reshape(T, d)
    gates, ids, aux = _route(x_flat, router, e)
    E = p["w_gate"].shape[0] * (1 if tp is None else tp.size)
    disp, gate_ec = dispatch(ids, gates, T, E, capacity(T, e))
    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))])
    # (E, C, d) -> (E/M, M·C, d): each expert's buffers from every rank
    xs = all_to_all(x_pad[disp], tp, 0, 1)
    ys = all_to_all(_expert_ffn(p["w_gate"], p["w_up"], p["w_down"], xs),
                    tp, 1, 0)
    del xs
    # ys · gate in f32 (the product promotes: one f32 buffer, not two)
    contrib = (ys * gate_ec[..., None]).reshape(-1, d)
    del ys
    out = _combine(contrib, disp, ids, T).reshape(B, -1, d).to(x.dtype)
    if tp is None:
        return out, aux
    # every rank's loss reads the mean: its cotangent is each rank's alike
    return gather_out(out, tp, dim=1), reduce_out(aux, tp) / tp.size


def _local_psum(p, x, cfg, tp=None):
    """The decode body: every token through the rank's experts, weighted
    by the (T, E/M) gates in its range, the f32 sums added over ``tp``."""
    e = cfg.moe
    B, S, d = x.shape
    T = B * S
    router = p["router"]
    if tp is not None:
        x, router = copy_in(x, tp), copy_in(router, tp)
    x_flat = x.reshape(T, d)
    gates, ids, aux = _route(x_flat, router, e)
    E = p["w_gate"].shape[0]
    if tp is None:
        comb = gates.new_zeros((T, E)).scatter_add(1, ids, gates)
    else:
        local = ids - tp.index * E
        mine = (local >= 0) & (local < E)
        comb = gates.new_zeros((T, E)).scatter_add(
            1, torch.where(mine, local, 0), torch.where(mine, gates, 0.0))
        # every rank routes every token: the aux is whole on each, and its
        # gradient through the router and x must be summed once
        aux = counted_once(aux, tp)
    h = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"],
                    x_flat.expand(E, T, d))
    out = reduce_out(torch.einsum("te,etd->td", comb, h.float()), tp)
    return out.reshape(B, S, d).to(x.dtype), aux


def moe_apply_chunked(p, x, cfg, *, decode: bool, data: int = 1,
                      model: int = 1):
    """On one device (``p`` whole), what the ranks of a (data, model)
    mesh compute on the batch ``x``: its rows cut into ``data`` equal
    parts; where ``decode`` or S < ``model`` each part through the local
    body, else each part's sequence cut into ``model`` equal chunks, each
    chunk routed with its own capacity; the aux the mean of the parts'
    (or chunks'). No collective; on no path of the port."""
    B, S, _ = x.shape
    if B % data:
        raise ValueError(f"{B} rows over data={data}")
    rows = x.chunk(data, 0)
    if decode or S < model:
        parts = [[_local_psum(p, r, cfg)] for r in rows]
    elif S % model:
        raise uneven_tokens("the MoE layer", S, model)
    else:
        parts = [[_a2a(p, c, cfg) for c in r.chunk(model, 1)] for r in rows]
    out = torch.cat([torch.cat([o for o, _ in row], 1) for row in parts], 0)
    return out, torch.stack([a for row in parts for _, a in row]).mean()
