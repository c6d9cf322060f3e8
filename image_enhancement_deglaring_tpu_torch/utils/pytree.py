"""Flat ``a/b/c``-keyed npz <-> nested dict conversion.

The JAX package's convention for every artifact that stores a parameter
tree as a flat .npz (the train CLI's model_weights.npz among them): nested
dict path segments joined with "/".
"""

from __future__ import annotations


def flatten_tree(tree, prefix=()) -> dict:
    """Nested dict -> {"a/b/c": leaf}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, prefix + (str(k),)))
    else:
        out["/".join(prefix)] = tree
    return out


def unflatten_tree(flat: dict) -> dict:
    """{"a/b/c": leaf} -> nested dict."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def load_npz_tree(path: str) -> dict:
    """Read a flat-keyed .npz back into a nested dict."""
    import numpy as np

    with np.load(path) as flat:
        return unflatten_tree({k: flat[k] for k in flat.files})
