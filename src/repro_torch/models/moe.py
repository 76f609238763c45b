"""Mixture-of-Experts (a port of ``repro.models.moe``) on one device.

The JAX package runs both paths inside ``shard_map`` over the mesh's
``model`` axis: in train/prefill a pair of ``all_to_all`` collectives moves
each token to the device that holds its expert and back; in decode every
device runs its shard of the experts on all tokens and a ``psum`` combines
them. The port's model axis covers the dense decoder only (the MoE
layer's is ROADMAP §1 item 6.3), so it computes
the per-device bodies at model-axis size 1, where those collectives are
identities:

* train/prefill (``decode=False``): ``_moe_a2a``'s body. Each token picks
  its top-k experts; the (T·k) choices, token-major, take the slots of
  per-expert buffers of capacity C in order, so later tokens are dropped
  first; empty and dropped slots read a zero row (the sentinel row T); the
  expert FFN runs on the (E, C, d) buffers, and ``ys · gate`` in f32 comes
  back to its tokens as the reference's scatter-add sums it, each token's
  slots in ascending expert order (``_combine``: a gather, so that the
  card sums in that one order every run).
* decode (``decode=True``): ``_moe_local_psum``'s body. Every expert of the
  padded stack runs on every token, weighted by the (T, E) gates: no
  capacity and no drop, and every expert's weights are read each step.

Shared ("always-on") experts are a dense SwiGLU of width
``n_shared * d_expert`` applied outside this module
(``transformer._dense_block``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import PD, dense_pd
from repro_torch.models.mlp import silu

EP_ALIGN = 16   # the JAX package's production model-axis size


def padded_experts(cfg) -> int:
    """Expert-stack size: n_routed padded to a multiple of EP_ALIGN (so the
    JAX package's stack shards evenly over its model axis; qwen2-moe's 60
    -> 64). The router has n_routed outputs and never selects a padded
    slot: those buffers stay empty and their gates zero."""
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
    return {
        "router": dense_pd(d, e.n_routed, scale=scale_in),
        "w_gate": PD((E, d, e.d_expert), scale=scale_in),
        "w_up": PD((E, d, e.d_expert), scale=scale_in),
        "w_down": PD((E, e.d_expert, d), scale=scale_out),
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


def moe_apply(p, x, cfg, *, decode: bool):
    """x: (B, S, d). Returns (out (B, S, d) in x's dtype, aux loss 0-d
    f32)."""
    e = cfg.moe
    B, S, d = x.shape
    T = B * S
    x_flat = x.reshape(T, d)
    gates, ids, aux = _route(x_flat, p["router"], e)
    E = p["w_gate"].shape[0]
    if decode:
        comb = gates.new_zeros((T, E)).scatter_add(1, ids, gates)
        h = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"],
                        x_flat.expand(E, T, d))
        out = torch.einsum("te,etd->td", comb, h.float())
        return out.reshape(B, S, d).to(x.dtype), aux
    disp, gate_ec = dispatch(ids, gates, T, E, capacity(T, e))
    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))])
    ys = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], x_pad[disp])
    # ys · gate in f32 (the product promotes: one f32 buffer, not two)
    contrib = (ys * gate_ec[..., None]).reshape(-1, d)
    del ys
    out = _combine(contrib, disp, ids, T)
    return out.reshape(B, S, d).to(x.dtype), aux
