"""Geometry "functors": per-primitive centroid and AABB computation.

Analog of the reference's compile-time functor library
(ref: include/grace/generic/functors/{aabb,centroid}.h and
cuda/kernels/aabb.cuh:14-48). Here a "functor" is a plain Python
callable mapping a batch of primitives to batches of centroids / AABBs; it is
closed over at trace/build time, which gives the same compile-time
specialization through jax tracing.

A primitive-type descriptor is a pair of callables:
  centroid(prims) -> f32[N, 3]
  aabb(prims)     -> (f32[N, 3] mins, f32[N, 3] maxs)
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax.numpy as jnp

AabbFn = Callable[[jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]]
CentroidFn = Callable[[jnp.ndarray], jnp.ndarray]


class PrimitiveKind(NamedTuple):
    """Bundle of geometry callables describing a primitive type."""

    centroid: CentroidFn
    aabb: AabbFn


def sphere_aabb(spheres) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """AABB of spheres f32[N, 4] = center +- radius (ref: functors/aabb.h:9-26)."""
    c = spheres[..., :3]
    r = spheres[..., 3:4]
    return c - r, c + r


def sphere_centroid(spheres) -> jnp.ndarray:
    """Sphere centers (ref: functors/centroid.h:33-40)."""
    return spheres[..., :3]


def centroid_from_aabb(aabb_fn: AabbFn) -> CentroidFn:
    """Generic centroid = AABB midpoint (ref: functors/centroid.h:16-31)."""

    def centroid(prims):
        mins, maxs = aabb_fn(prims)
        return 0.5 * (mins + maxs)

    return centroid


SPHERE = PrimitiveKind(centroid=sphere_centroid, aabb=sphere_aabb)


def triangle_aabb(tris) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """AABB of triangles stored as f32[N, 3, 3] (three vertices).

    Analog of the reference triangle demo's TriangleAABB
    (ref: tests/render_triangle/triangle.cuh), which stores (v, e1, e2);
    we store plain vertices — the edge form is derived where needed.
    """
    return jnp.min(tris, axis=-2), jnp.max(tris, axis=-2)


TRIANGLE = PrimitiveKind(centroid=centroid_from_aabb(triangle_aabb), aabb=triangle_aabb)
