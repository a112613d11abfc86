"""Parameter and state trees: nested dicts and lists of tensors, walked
in the order ``jax.tree`` walks a pytree (dict entries by sorted key,
list entries by index).

The reference's global-norm sum runs over leaves in that order, and its
checkpoint keys are the leaves' paths in it, so the port walks its trees
the same way.
"""
from __future__ import annotations


def tree_items(tree, prefix: tuple = ()):
    """``(path, leaf)`` pairs in ``jax.tree`` order; a path is a tuple of
    dict keys and list indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, prefix + (i,))
    else:
        yield prefix, tree


def subtree(tree, path: tuple):
    """The node of ``tree`` at ``path`` (as ``tree_items`` gives it)."""
    for k in path:
        tree = tree[k]
    return tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); a tree of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, is_leaf=None, prefix: tuple = ()):
    """``fn(path, leaf)`` over the leaves of ``tree`` (paths as in
    ``tree_items``); a tree of the results.  ``is_leaf(node)`` true stops
    the walk at a node (a tuple spec, say)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, is_leaf, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, is_leaf, prefix + (i,))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)
