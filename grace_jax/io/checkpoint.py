"""Checkpoint / resume for built scenes.

The reference has no checkpointing (SURVEY.md section 5: trees are rebuilt
from scratch every run); for production serving we persist the sorted
particle array + built Tree so a renderer can restart without the build
pass. Plain .npz keeps the dependency surface minimal; arrays are fetched
to host, metadata (max_per_leaf) rides along.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from grace_jax.core.tree import Tree

_FORMAT_VERSION = 1


def save_scene(path: str, sorted_spheres, tree: Tree, weights=None) -> None:
    arrays = dict(
        version=np.int32(_FORMAT_VERSION),
        spheres=np.asarray(sorted_spheres),
        children=np.asarray(tree.children),
        child_aabbs=np.asarray(tree.child_aabbs),
        leaves=np.asarray(tree.leaves),
        root=np.asarray(tree.root),
        n_nodes=np.asarray(tree.n_nodes),
        n_leaves=np.asarray(tree.n_leaves),
        max_per_leaf=np.int32(tree.max_per_leaf),
    )
    if weights is not None:
        arrays["weights"] = np.asarray(weights)
    np.savez_compressed(path, **arrays)


def load_scene(path: str) -> Tuple[jnp.ndarray, Tree, Optional[jnp.ndarray]]:
    """Returns (sorted_spheres, tree, weights-or-None)."""
    data = np.load(path)
    version = int(data["version"])
    if version != _FORMAT_VERSION:
        raise IOError(f"unsupported checkpoint version {version}")
    tree = Tree(
        children=jnp.asarray(data["children"]),
        child_aabbs=jnp.asarray(data["child_aabbs"]),
        leaves=jnp.asarray(data["leaves"]),
        root=jnp.asarray(data["root"]),
        n_nodes=jnp.asarray(data["n_nodes"]),
        n_leaves=jnp.asarray(data["n_leaves"]),
        max_per_leaf=int(data["max_per_leaf"]),
    )
    weights = jnp.asarray(data["weights"]) if "weights" in data else None
    return jnp.asarray(data["spheres"]), tree, weights
