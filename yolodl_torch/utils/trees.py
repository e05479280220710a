"""Key-path naming of nested parameter trees, shared by the checkpoint key
layout (``train/checkpoint.py``).

Counterpart of ``yolodl_tpu/utils/trees.py``.  The reference walks JAX
pytrees; the port's trees are nested dicts (the reference's layout, numpy
or tensor leaves), walked in the order ``jax.tree_util`` walks a dict:
sorted keys.  A key path spells as the reference spells it, entries joined
by ``/`` (``params/layer0/bn/scale``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple


def tree_path_name(path) -> str:
    """A full key path (a tuple of dict keys) joined with '/' — the
    checkpoint key spelling, the reference's ``tree_path_name``."""
    return "/".join(str(p) for p in path)


def tree_leaves_with_path(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(key path, leaf) of every leaf of a tree of dicts, keys sorted; None
    is an empty subtree, as in ``jax.tree_util``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves_with_path(tree[key], path + (key,))
    else:
        yield path, tree


def tree_map_with_path(fn, tree: Any, path: Tuple = ()) -> Any:
    """The same tree of dicts with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {key: tree_map_with_path(fn, value, path + (key,))
                for key, value in tree.items()}
    return fn(path, tree)


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{prefix + tree_path_name(path): leaf}`` over a tree of dicts."""
    return {prefix + tree_path_name(path): leaf
            for path, leaf in tree_leaves_with_path(tree)}
