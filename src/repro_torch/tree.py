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


class _Leaves:
    """Leaf ``i`` of a lazy tree: ``make(i)``, called once, then kept."""

    def __init__(self, make: Callable[[int], Any]):
        self.make, self.made = make, {}

    def __call__(self, i: int):
        if i not in self.made:
            self.made[i] = self.make(i)
        return self.made[i]


class _Slot:
    """Where a lazy tree's leaf goes until it is read: its flatten index."""
    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __repr__(self):
        return f"<leaf {self.i}, not read yet>"


class LazyTree(dict):
    """A nested-dict tree whose leaves are made when first read. The keys
    exist from the start; leaf ``i`` (in :func:`tree_flatten` order of
    ``paths``) is ``make(i)``, called once, on the first ``[]``, ``get``,
    ``items`` or ``values`` that reaches it (``tree_flatten`` and
    ``tree_map`` read every leaf, in their own order). Reading a subtree
    makes none of its leaves. ``core.ddp`` wraps each bucket group's
    leaves this way, so that the group's identity is made where the
    forward first uses the group, not before the forward."""

    def __init__(self, paths: Sequence[str] = (), make=None):
        super().__init__()
        self._leaves = _Leaves(make)
        for i, path in enumerate(paths):
            *parents, last = path.split("/")
            node = self
            for k in parents:
                if not dict.__contains__(node, k):
                    dict.__setitem__(node, k, node._child())
                node = dict.__getitem__(node, k)
            dict.__setitem__(node, last, _Slot(i))

    def _child(self, leaves=None) -> "LazyTree":
        node = LazyTree()
        node._leaves = self._leaves if leaves is None else leaves
        return node

    def _with(self, leaves: _Leaves) -> "LazyTree":
        """This tree's structure over other leaves."""
        out = self._child(leaves)
        for k, v in dict.items(self):
            dict.__setitem__(out, k, v._with(leaves)
                             if isinstance(v, LazyTree) else v)
        return out

    def __getitem__(self, k):
        v = dict.__getitem__(self, k)
        return self._leaves(v.i) if isinstance(v, _Slot) else v

    def get(self, k, default=None):
        return self[k] if k in self else default

    def __iter__(self):
        # a dict subclass with its own __iter__ is copied through keys()
        # and __getitem__ (dict(t), {**t}), never as raw slots
        return iter(self.keys())

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def values(self):
        return [self[k] for k in self.keys()]

    def copy(self):
        return dict(self.items())


def lazy_map(fn: Callable, tree):
    """``tree_map(fn, tree)``, except that a :class:`LazyTree` stays lazy:
    ``fn`` runs on each leaf when the result's leaf is first read, just
    after the leaf itself is made."""
    if not isinstance(tree, LazyTree):
        return tree_map(fn, tree)
    src = tree._leaves
    return tree._with(_Leaves(lambda i: fn(src(i))))
