"""Nested containers of tensors: the part of ``jax.tree_util`` that the
optimizer and the checkpoint store need.

A tree is a dict, list or tuple of trees, ``None`` (an empty subtree),
or a leaf (anything else). Leaves come in JAX's order: dict keys
sorted, sequences in order. Paths are JAX's key strings joined by "/"
(``['params']/['blocks']/[0]/['wq']``), so a checkpoint's manifest reads
the same in both packages.
"""
from __future__ import annotations


def _children(tree):
    """(key strings, children, rebuild) of a container, or None for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ([f"[{k!r}]" for k in keys], [tree[k] for k in keys],
                lambda kids: dict(zip(keys, kids)))
    if isinstance(tree, (list, tuple)):
        kind = type(tree)
        return ([f"[{i}]" for i in range(len(tree))], list(tree),
                lambda kids: kind(kids))
    return None


def flatten_with_paths(tree, is_leaf=None) -> tuple[list[str], list, object]:
    """(paths, leaves, treedef); ``unflatten(treedef, leaves)`` rebuilds
    the tree. ``is_leaf(node)`` true makes a container a leaf."""
    if tree is None:
        return [], [], None
    node = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if node is None:
        return [""], [tree], "leaf"
    keys, kids, rebuild = node
    paths, leaves, defs = [], [], []
    for key, kid in zip(keys, kids):
        p, l, d = flatten_with_paths(kid, is_leaf)
        paths += [key if not s else f"{key}/{s}" for s in p]
        leaves += l
        defs.append((d, len(l)))
    return paths, leaves, (rebuild, defs)


def flatten(tree, is_leaf=None) -> tuple[list, object]:
    _, leaves, treedef = flatten_with_paths(tree, is_leaf)
    return leaves, treedef


def unflatten(treedef, leaves):
    leaves = list(leaves)
    if treedef is None:
        return None
    if treedef == "leaf":
        (leaf,) = leaves
        return leaf
    rebuild, defs = treedef
    kids, at = [], 0
    for d, n in defs:
        kids.append(unflatten(d, leaves[at:at + n]))
        at += n
    return rebuild(kids)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), in a tree of ``tree``'s shape."""
    leaves, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
