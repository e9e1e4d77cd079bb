"""Parameter and state trees: dicts, tuples and lists of tensors.

The port keeps the reference's trees as plain containers (no
``nn.Module``), so these helpers stand in for ``jax.tree``: the leaf order
is JAX's (dict keys sorted, sequences by index, ``None`` an empty
subtree) and a leaf's path prints as the reference's checkpoint keys do
(``pattern/0/attn/wq``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def flatten(tree: Any) -> List[Tuple[Path, Any]]:
    """(path, leaf) of every leaf, in JAX's order."""
    out: List[Tuple[Path, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append((path, node))
    walk(tree, ())
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten(tree)]


def flatten_up_to(tree: Any, other: Any) -> list:
    """The subtree of ``other`` at each leaf of ``tree``, in
    :func:`flatten`'s order (JAX's ``flatten_up_to``): a spec tree's
    entries, say, whose specs are tuples themselves."""
    out: list = []

    def walk(node, sub):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], sub[k])
        elif isinstance(node, (tuple, list)):
            for v, s in zip(node, sub):
                walk(v, s)
        else:
            out.append(sub)
    walk(tree, other)
    return out


def key(path: Path) -> str:
    """A path as the reference's checkpoint key: ``pattern/0/attn/wq``."""
    return "/".join(str(p) for p in path)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest`` (which may go deeper: an int8 moment is a ``{"q", "s"}``
    dict where its parameter is a leaf); the structure and dict order of
    ``tree`` are kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *parts)
                          for v, *parts in zip(tree, *rest))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, path: Path = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``, keeping its
    structure (``jax.tree_util.tree_map_with_path``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def unflatten(like: Any, new_leaves: list) -> Any:
    """The structure of ``like`` with its leaves, in :func:`flatten`'s
    order, replaced by ``new_leaves``."""
    slot = {id_path: i for i, (id_path, _) in enumerate(flatten(like))}
    if len(slot) != len(new_leaves):
        raise ValueError(f"{len(new_leaves)} leaves for a tree of "
                         f"{len(slot)}")

    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v, path + (i,))
                              for i, v in enumerate(node))
        return new_leaves[slot[path]]
    return walk(like, ())
