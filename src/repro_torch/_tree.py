"""Trees of dicts and lists with tensor leaves (parameters, optimizer
state, gradients): walk them and map over them. A dict is walked in its
insertion order, where the reference's pytrees sort their keys; checkpoints
key each leaf by its path, so the order does not reach them.
"""
from __future__ import annotations


def tree_leaves(tree, path=()):
    """``(path, leaf)`` pairs in order; a path holds dict keys and list
    positions."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from tree_leaves(sub, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from tree_leaves(sub, path + (i,))
    else:
        yield path, tree


def tree_map(fn, tree, *rest):
    """``fn(leaf, *other_leaves)`` over trees of one structure (dicts must
    have the same keys, lists the same lengths)."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or other.keys() != tree.keys():
                raise ValueError(f"tree structures differ: keys "
                                 f"{sorted(tree)} against "
                                 f"{sorted(other) if isinstance(other, dict) else type(other).__name__}")
        return {k: tree_map(fn, tree[k], *(o[k] for o in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        for other in rest:
            if not isinstance(other, (list, tuple)) or len(other) != len(tree):
                raise ValueError(f"tree structures differ: a list of "
                                 f"{len(tree)} against {other!r:.80}")
        return [tree_map(fn, *subs) for subs in zip(tree, *rest)]
    return fn(tree, *rest)
