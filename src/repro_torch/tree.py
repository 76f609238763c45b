"""Nested-dict parameter trees, flattened the way ``jax.tree_util`` flattens
the JAX package's trees: dict keys in sorted order, depth first, with the
path of each leaf written ``"stem/bn/scale"``. Bucket plans, packing order
and per-leaf seeds depend on this order, so both packages must agree on it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple


def tree_flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in sorted-key, depth-first order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(tree_flatten(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_unflatten(paths: Sequence[str], leaves: Sequence[Any]) -> Dict:
    """Inverse of :func:`tree_flatten` for nested dicts."""
    if len(paths) != len(leaves):
        raise ValueError(f"{len(paths)} paths but {len(leaves)} leaves")
    out: Dict = {}
    for path, leaf in zip(paths, leaves):
        *parents, last = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
