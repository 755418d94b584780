"""Nested dicts and lists of tensors: the port's parameter, optimizer-state
and checkpoint trees.

The port keeps a model's repeated layers as a list of per-group dicts
(``params["blocks"]``; an encoder-decoder's ``encoder`` and ``decoder``)
where the reference stacks them along a leading axis. :func:`leaf_sets`
walks a tree in the reference's order (dict keys sorted, as
``jax.tree_util`` flattens them) and hands a list of G groups over as one
leaf set a path: the G per-group tensors of the reference's one
``(G, ...)`` leaf. Code that must see the reference's leaves (the
optimizer's state, checkpoints) stacks them; :func:`fill` puts values kept
by path back into a tree's own layout.
"""
from __future__ import annotations

from typing import Callable, Iterator

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on each leaf of ``tree`` and the leaves at the same place in
    ``rest``, keeping the dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def leaf_sets(tree, path: tuple = ()) -> Iterator[tuple]:
    """``(path, leaf)`` for each leaf of ``tree``, dict keys sorted. Below a
    list of G groups of one structure, ``leaf`` is the list of the G
    groups' tensors at ``path`` (the list adds no key to the path)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_sets(tree[k], path + (k,))
    elif isinstance(tree, list):
        groups = [list(leaf_sets(t, path)) for t in tree]
        for items in zip(*groups, strict=True):
            if any(p != items[0][0] or isinstance(t, list) for p, t in items):
                raise ValueError(f"the groups of the list at {path_str(path)} differ "
                                 "in structure or nest lists")
            yield items[0][0], [t for _, t in items]
    else:
        yield path, tree


def stack(leaf) -> torch.Tensor:
    """A leaf set as one tensor: a list of per-group tensors stacked
    ``(G, ...)`` (a copy), a single tensor as it is."""
    return torch.stack(leaf) if isinstance(leaf, list) else leaf


def fill(like, values: dict, path: tuple = ()):
    """``like``'s layout with the leaf set at each path replaced by
    ``values[path]``; below a list, group ``g`` takes ``values[path][g]``
    (an element of a list, or a view of a stacked tensor)."""
    if isinstance(like, dict):
        return {k: fill(v, values, path + (k,)) for k, v in like.items()}
    if isinstance(like, list):
        n = len(path)
        return [fill(t, {p: v[g] for p, v in values.items() if p[:n] == path}, path)
                for g, t in enumerate(like)]
    return values[path]


def nest(values: dict) -> dict:
    """``{path: value}`` as nested dicts."""
    out: dict = {}
    for path, value in values.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return out


def at(tree, path: tuple):
    """The subtree of nested dicts at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def path_str(path: tuple) -> str:
    """A path as the reference's checkpoints name it: ``jax.tree_util``'s
    key strings joined by ``/`` (``['params']/['embed']``)."""
    return "/".join(f"[{k!r}]" for k in path)
