"""Nested-dict parameter trees, flattened in the reference's order.

The JAX package keeps parameters, gradients and optimizer state as
pytrees (nested dicts, tuples and NamedTuples) and walks them with
``jax.tree``, which visits a dict's entries in **sorted key order**.  The
order matters beyond style: ``optim.lp_clip`` poses LP ``i`` for leaf
``i``, and ``optim.adamw.global_norm`` sums the leaves in that order, so
the port walks its trees the same way.  Only the containers the training
path uses are handled: dicts, tuples, lists and NamedTuples; anything
else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch


def _is_node(x) -> bool:
    return isinstance(x, (dict, tuple, list))


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree``, dict entries in sorted key order (as
    ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure; the
    result keeps ``tree``'s containers (NamedTuples included)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        vals = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*vals)
        return type(tree)(vals)
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in
    :func:`tree_leaves` order, by ``leaves`` (as ``jax.tree.unflatten``)."""
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            vals = {k: rec(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, (tuple, list)):
            vals = [rec(x) for x in node]
            if hasattr(node, "_fields"):
                return type(node)(*vals)
            return type(node)(vals)
        return next(it)
    out = rec(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"blocks/wq": leaf, ...}``: slash-joined dict keys and sequence
    indices, the path names of the reference's checkpoints and
    ``sync_duplicated_grads``."""
    out: Dict[str, Any] = {}
    if _is_node(tree):
        items = (tree.items() if isinstance(tree, dict)
                 else enumerate(tree))
        for k, v in items:
            out.update(flatten_with_paths(v, f"{prefix}/{k}" if prefix
                                          else str(k)))
    else:
        out[prefix] = tree
    return out


def unflatten_with_paths(flat: Dict[str, Any], like):
    """Inverse of :func:`flatten_with_paths` into the structure of
    ``like``."""
    def rec(prefix, node):
        if isinstance(node, dict):
            return {k: rec(f"{prefix}/{k}" if prefix else k, v)
                    for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            vals = [rec(f"{prefix}/{i}" if prefix else str(i), v)
                    for i, v in enumerate(node)]
            if hasattr(node, "_fields"):
                return type(node)(*vals)
            return type(node)(vals)
        return flat[prefix]
    return rec("", like)


@torch.no_grad()
def copy_into_(dst, src) -> None:
    """Write ``src``'s leaves into ``dst``'s tensors in place (shapes
    must match; dtypes and devices are converted), e.g. loaded or carried
    values into a module's parameters."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src), strict=True):
        s = torch.as_tensor(s)
        if tuple(d.shape) != tuple(s.shape):
            raise ValueError(f"shape {tuple(s.shape)} does not fit a leaf "
                             f"of shape {tuple(d.shape)}")
        d.copy_(s)
