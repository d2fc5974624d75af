"""BVH tree container (analog of ref include/grace/cuda/nodes.h:14-87).

The reference stores the hierarchy as 4 interleaved int4/float4 per internal
node plus an int4 per leaf, tuned for CUDA texture fetches. Here the natural
layout is flat SoA arrays in device memory that XLA can gather from, so
``Tree`` is an immutable pytree of:

  children   i32[Cap, 2]    left/right child of each internal node. A child
                            c >= 0 is an internal node index; c < 0 encodes
                            leaf index ``~c`` (bitwise-not), replacing the
                            reference's index-offset encoding of leaf children.
  child_aabbs f32[Cap, 2, 2, 3]
                            per (node, child, {min,max}, xyz) bounding boxes —
                            the traversal tests both children of a node at
                            once, exactly like the reference's packed L/R/LR
                            AABB layout (ref: nodes.h:26-37) and fused
                            two-child AABB test (ref: device/intersect.cuh).
  leaves     i32[CapL, 2]   (first_primitive, count) per leaf
                            (ref: nodes.h:39-43).
  root       i32[]          root node index — like the reference, the root is
                            not necessarily node 0 (ref: nodes.h:44-45).
  n_nodes    i32[]          number of valid internal nodes (<= Cap).
  n_leaves   i32[]          number of valid leaves (<= CapL).
  max_per_leaf  static int  max primitives per leaf (ref: nodes.h:52).

Arrays are padded to static capacities so the whole build/trace pipeline is
shape-static under ``jax.jit``; ``n_nodes``/``n_leaves`` are traced scalars.
Padding nodes/leaves have empty AABBs ([+inf, -inf]) and count 0, so they can
never be hit — the analog of the reference's ``is_empty_node`` predicate
(ref: nodes.h:78-87).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclass
class Tree:
    children: jax.Array      # i32[Cap, 2]
    child_aabbs: jax.Array   # f32[Cap, 2, 2, 3]
    leaves: jax.Array        # i32[CapL, 2]
    root: jax.Array          # i32[]
    n_nodes: jax.Array       # i32[]
    n_leaves: jax.Array      # i32[]
    max_per_leaf: int        # static

    def tree_flatten(self):
        children = (
            self.children,
            self.child_aabbs,
            self.leaves,
            self.root,
            self.n_nodes,
            self.n_leaves,
        )
        return children, self.max_per_leaf

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, max_per_leaf=aux)

    @property
    def capacity(self) -> int:
        """Static capacity of the internal-node arrays."""
        return self.children.shape[0]

    @property
    def leaf_capacity(self) -> int:
        return self.leaves.shape[0]

    def replace(self, **kw) -> "Tree":
        return replace(self, **kw)


def is_leaf_child(child: jax.Array) -> jax.Array:
    """True where an entry of ``Tree.children`` refers to a leaf."""
    return child < 0


def leaf_index(child: jax.Array) -> jax.Array:
    """Decode a leaf child entry (c < 0) to its leaf-array index."""
    return jnp.invert(child)


def encode_leaf_child(leaf_idx: jax.Array) -> jax.Array:
    """Encode leaf index as a ``Tree.children`` entry."""
    return jnp.invert(leaf_idx)
