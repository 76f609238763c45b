"""Carry weights and train states across from the JAX package.

The JAX package draws its parameters and data from threefry and the port
from ``torch.Generator``s, so the two never draw the same numbers. To hold
the port against the reference, the tests feed both the reference's own
values: numpy trees at the reference's paths and shapes (HWIO weights stay
HWIO), checked here against the port's descriptor trees. Over a mesh's
model axis ``shard_tree`` cuts a whole tree into a rank's shards by the
descriptors' specs and ``gather_tree`` puts them back together.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models import resnet, transformer
from repro_torch.models.common import local_slice, model_axis
from repro_torch.train.state import TrainState
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def _to_torch(np_tree, pd_tree, device, what: str) -> dict:
    got = dict(tree_flatten(np_tree))
    want = dict(tree_flatten(pd_tree))
    if set(got) != set(want):
        raise ValueError(
            f"{what}: paths differ from the port's; missing "
            f"{sorted(set(want) - set(got))}, unexpected "
            f"{sorted(set(got) - set(want))}")
    leaves = []
    for path, pd in want.items():
        x = np.asarray(got[path])
        if tuple(x.shape) != tuple(pd.shape):
            raise ValueError(f"{what}: {path} has shape {x.shape}, the "
                             f"port's is {pd.shape}")
        # numpy has no bf16: such leaves come in via f32 (exact)
        t = torch.from_numpy(np.ascontiguousarray(x.astype(np.float32)))
        leaves.append(t.to(device=device, dtype=pd.dtype))
    return tree_unflatten(list(want), leaves)


def params_from_jax(np_tree, cfg, device) -> dict:
    """Reference ResNet params (numpy leaves) -> the port's tree."""
    return _to_torch(np_tree, resnet.resnet_pd(cfg)[0], device, "params")


def bn_state_from_jax(np_tree, cfg, device) -> dict:
    """Reference BN statistics (numpy leaves) -> the port's tree."""
    return _to_torch(np_tree, resnet.resnet_pd(cfg)[1], device, "bn_state")


def state_from_jax(jax_state, cfg, device) -> TrainState:
    """A reference ``TrainState`` (numpy leaves: ``jax.device_get(state)``)
    of a replicated LARS/SGD-M run, or of a sharded run on ONE shard (its
    global shard layout is then the one rank's) -> the port's
    ``TrainState``. The sharded states: zero1 (params, packed momentum and
    master shards), zero2 (params and packed momentum, no shards), zero3
    (no params: ``params`` None; packed momentum and master shards)."""
    params = (None if jax_state.params is None
              else params_from_jax(jax_state.params, cfg, device))
    bn = bn_state_from_jax(jax_state.bn_state, cfg, device)
    bufs = lambda xs: tuple(
        torch.from_numpy(np.array(x, np.float32)).to(device) for x in xs)
    if isinstance(jax_state.mom, dict):          # replicated: a tree
        return TrainState(int(jax_state.step), params,
                          params_from_jax(jax_state.mom, cfg, device), bn)
    shards = None if jax_state.shards is None else bufs(jax_state.shards)
    return TrainState(int(jax_state.step), params, bufs(jax_state.mom), bn,
                      shards)


def lm_params_from_jax(np_tree, cfg, device, mesh=None) -> dict:
    """Reference LM params (numpy leaves, stacked (L, ...) layers; whisper's
    encoder stack and position tables, the VLM's projector among them) ->
    the port's tree, checked path by path and shape by shape against
    ``transformer.lm_pd``; with a ``mesh``, this rank's shards of it."""
    pd = transformer.lm_pd(cfg)
    return shard_tree(_to_torch(np_tree, pd, device, "params"), pd, mesh)


def shard_tree(tree, pd_tree, mesh):
    """A tree of whole leaves -> this rank's shards over ``mesh``'s model
    axis by the specs of ``pd_tree`` (copies of the slices; replicated
    leaves as they are). No model axis: ``tree`` itself."""
    tp = model_axis(mesh)
    if tp is None:
        return tree
    pds = dict(tree_flatten(pd_tree))

    def cut(path, x):
        d, start, k = local_slice(pds[path], tp)
        return x if d is None else x.narrow(d, start, k).clone()
    flat = tree_flatten(tree)
    return tree_unflatten([p for p, _ in flat], [cut(p, x) for p, x in flat])


def gather_tree(tree, pd_tree, mesh):
    """The inverse of ``shard_tree``: every rank's shards of each split
    leaf gathered over the model axis (a collective every rank of the
    mesh must join)."""
    tp = model_axis(mesh)
    if tp is None:
        return tree
    pds = dict(tree_flatten(pd_tree))

    def whole(path, x):
        d = local_slice(pds[path], tp)[0]
        if d is None:
            return x
        parts = [torch.empty_like(x) for _ in range(tp.size)]
        dist.all_gather(parts, x.contiguous(), group=tp.group)
        return torch.cat(parts, dim=d)
    flat = tree_flatten(tree)
    return tree_unflatten([p for p, _ in flat],
                          [whole(p, x) for p, x in flat])


def lm_state_from_jax(jax_state, cfg, device) -> TrainState:
    """A reference LM ``TrainState`` (numpy leaves:
    ``jax.device_get(state)``; its ``bn_state`` is None) -> the port's.
    Replicated: the fp32 params and the momentum, both at the params'
    paths. A sharded run on ONE shard, as ``state_from_jax`` takes it: the
    packed momentum and master shards as buffers, the params None under
    zero3."""
    params = (None if jax_state.params is None
              else lm_params_from_jax(jax_state.params, cfg, device))
    if isinstance(jax_state.mom, dict):
        return TrainState(int(jax_state.step), params,
                          lm_params_from_jax(jax_state.mom, cfg, device))
    bufs = lambda xs: tuple(
        torch.from_numpy(np.array(x, np.float32)).to(device) for x in xs)
    shards = getattr(jax_state, "shards", None)
    return TrainState(int(jax_state.step), params, bufs(jax_state.mom),
                      None, None if shards is None else bufs(shards))


def cache_from_jax(np_tree, cfg, batch: int, max_seq: int, device) -> dict:
    """A reference cache (numpy leaves, bf16 as f32) of ``batch`` requests
    and ``max_seq`` rows -> the port's (``transformer.cache_pd``): stacked
    bf16 k and v (whisper's ``self`` and ``cross`` subtrees; the VLM's
    rows counting its image prefix), MLA's latent, the recurrent states."""
    return _to_torch(np_tree, transformer.cache_pd(cfg, batch, max_seq),
                     device, "cache")


def to_numpy(tree):
    """The inverse: a tree of tensors -> numpy leaves (bf16 as f32)."""
    def f(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return x
    return tree_map(f, tree)
