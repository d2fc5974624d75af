"""SPH sphere build pipeline facade (analog of ref include/grace/cuda/build_sph.cuh).

Functional pipeline over f32[N, 4] spheres (x, y, z, h):

    keys = morton_keys_sph(spheres)                (ref: build_sph.cuh:18-34)
    spheres_sorted = sort by key                   (ref: build_sph.cuh:40-82)
    d = *_deltas_sph(spheres_sorted)               (ref: build_sph.cuh:86-114)
    tree = ALBVH_sph(spheres_sorted, d, mpl)       (ref: build_sph.cuh:117-124)

or the one-call ``build_sph_tree``. The sort is ``jax.lax.sort`` over
(key, sphere columns) — XLA's on-device sort replaces thrust::sort_by_key.
Everything is jit-compatible; the returned permutation lets callers carry
auxiliary per-particle data (masses, densities) through the reorder.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from grace_jax.build import deltas as deltas_mod
from grace_jax.build.lbvh import build_lbvh
from grace_jax.core.tree import Tree
from grace_jax.ops import morton
from grace_jax.ops.primitives import SPHERE, PrimitiveKind


def morton_keys_sph(spheres, aabb_min=None, aabb_max=None, bits: int = 30):
    """30/63-bit Morton keys of sphere centers (ref: build_sph.cuh:18-34).

    If the scene AABB is not given it is computed from the centroids, like the
    reference's wrapper (ref: kernels/morton.cuh:139-174).
    """
    centroids = SPHERE.centroid(spheres)
    if aabb_min is None:
        aabb_min = jnp.min(centroids, axis=0)
    if aabb_max is None:
        aabb_max = jnp.max(centroids, axis=0)
    return morton.morton_keys_from_centroids(centroids, aabb_min, aabb_max, bits=bits)


def sort_by_morton(
    spheres, aabb_min=None, aabb_max=None, bits: int = 30
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Fused key-gen + sort (ref: morton_keys30_sort_sph, build_sph.cuh:40-82).

    Returns (sorted_keys, sorted_spheres, permutation).
    """
    keys = morton_keys_sph(spheres, aabb_min, aabb_max, bits=bits)
    n = spheres.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    if bits == 30:
        keys_sorted, perm = jax.lax.sort((keys, iota), num_keys=1)
    else:
        hi, lo = keys
        hi_s, lo_s, perm = jax.lax.sort((hi, lo, iota), num_keys=2)
        keys_sorted = (hi_s, lo_s)
    return keys_sorted, spheres[perm], perm


def euclidean_deltas_sph(sorted_spheres) -> jax.Array:
    """(ref: build_sph.cuh:86-93)"""
    return deltas_mod.euclidean_deltas(sorted_spheres, SPHERE.centroid)


def surface_area_deltas_sph(sorted_spheres) -> jax.Array:
    """(ref: build_sph.cuh:96-103)"""
    return deltas_mod.surface_area_deltas(sorted_spheres, SPHERE.aabb)


def xor_deltas_sph(sorted_keys) -> jax.Array:
    """(ref: build_sph.cuh:106-114)"""
    if isinstance(sorted_keys, tuple):
        return deltas_mod.xor_deltas_63bit(*sorted_keys)
    return deltas_mod.xor_deltas(sorted_keys)


def albvh_sph(sorted_spheres, d, max_per_leaf: int) -> Tree:
    """Build the tree over Morton-sorted spheres (ref: build_sph.cuh:117-124)."""
    mins, maxs = SPHERE.aabb(sorted_spheres)
    return build_lbvh(mins, maxs, d, max_per_leaf)


def build_sph_tree(
    spheres,
    max_per_leaf: int,
    delta_kind: str = "euclidean",
    bits: int = 30,
    aabb_min=None,
    aabb_max=None,
) -> Tuple[jax.Array, Tree, jax.Array]:
    """One-call SPH build: the canonical pipeline of the reference test helper
    (ref: tests/helper/tree.cuh:14-43 build_tree).

    Returns (sorted_spheres, tree, permutation).
    """
    keys, sorted_spheres, perm = sort_by_morton(spheres, aabb_min, aabb_max, bits)
    if delta_kind == "euclidean":
        d = euclidean_deltas_sph(sorted_spheres)
    elif delta_kind == "surface_area":
        d = surface_area_deltas_sph(sorted_spheres)
    elif delta_kind == "xor":
        d = xor_deltas_sph(keys)
    else:
        raise ValueError(f"unknown delta_kind {delta_kind!r}")
    tree = albvh_sph(sorted_spheres, d, max_per_leaf)
    return sorted_spheres, tree, perm


def build_primitive_tree(
    prims,
    kind: PrimitiveKind,
    max_per_leaf: int,
    delta_kind: str = "xor",
    bits: int = 30,
) -> Tuple[jax.Array, Tree, jax.Array]:
    """Generic-primitive build (the reference's extension path, e.g. the
    triangle demo's tris_tree.cuh:17-30: morton keys w/ custom centroid ->
    sort -> DeltaXOR -> build_ALBVH w/ custom AABB)."""
    centroids = kind.centroid(prims)
    aabb_min = jnp.min(centroids, axis=0)
    aabb_max = jnp.max(centroids, axis=0)
    keys = morton.morton_keys_from_centroids(centroids, aabb_min, aabb_max, bits=bits)
    n = prims.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    if bits == 30:
        keys_sorted, perm = jax.lax.sort((keys, iota), num_keys=1)
    else:
        hi, lo = keys
        hi_s, lo_s, perm = jax.lax.sort((hi, lo, iota), num_keys=2)
        keys_sorted = (hi_s, lo_s)
    sorted_prims = prims[perm]
    if delta_kind == "xor":
        d = (
            deltas_mod.xor_deltas_63bit(*keys_sorted)
            if isinstance(keys_sorted, tuple)
            else deltas_mod.xor_deltas(keys_sorted)
        )
    elif delta_kind == "euclidean":
        d = deltas_mod.euclidean_deltas(sorted_prims, kind.centroid)
    elif delta_kind == "surface_area":
        d = deltas_mod.surface_area_deltas(sorted_prims, kind.aabb)
    else:
        raise ValueError(f"unknown delta_kind {delta_kind!r}")
    mins, maxs = kind.aabb(sorted_prims)
    tree = build_lbvh(mins, maxs, d, max_per_leaf)
    return sorted_prims, tree, perm
