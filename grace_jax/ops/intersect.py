"""Ray-primitive and ray-AABB intersection tests.

Re-implementation of:
  * ``sphere_hit`` — ray vs sphere returning impact parameter^2 and along-ray
    distance, with the reference's inside-origin / inside-terminus edge cases
    treated as misses (ref: include/grace/generic/intersect.h:10-55).
  * ``aabbs_hit`` — the slab-method fused test of one ray against a node's two
    child AABBs, clamped to [0, ray.length]
    (ref: include/grace/cuda/device/intersect.cuh:10-40; the PTX
    vmin/vmax video instructions of intrinsics.cuh:8-51 become plain
    jnp.minimum/maximum).

All functions are written branch-free over batched arrays; predicates are
returned as bool arrays for ``jnp.where`` masking. NaN behavior of the slab
test matches the reference: min/max with the 0 / len clamps resolves the
0 * inf = NaN case when an axis-aligned ray origin lies on a slab.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def sphere_hit(origins, directions, lengths, spheres) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched ray-sphere impact-parameter test.

    Args:
      origins:    f32[..., 3] ray origins.
      directions: f32[..., 3] normalized directions.
      lengths:    f32[...] ray lengths.
      spheres:    f32[..., 4] (x, y, z, radius) — broadcast against rays.

    Returns:
      (hit, b2, dot_p):
        hit:   bool[...] — True where the ray passes within the radius with
               0 <= dot_p < length (ref: intersect.h:40-50: a closest-approach
               point behind the origin or beyond the terminus is a miss).
        b2:    f32[...] squared impact parameter (valid regardless of hit).
        dot_p: f32[...] distance along the ray to the closest approach.
    """
    p = spheres[..., :3] - origins
    dot_p = jnp.sum(p * directions, axis=-1)
    b = p - dot_p[..., None] * directions
    b2 = jnp.sum(b * b, axis=-1)
    r = spheres[..., 3]
    hit = (b2 < r * r) & (dot_p >= 0.0) & (dot_p < lengths)
    return hit, b2, dot_p


def aabbs_hit(
    origins, inv_directions, lengths, aabb_mins, aabb_maxs
) -> jnp.ndarray:
    """Batched slab-method ray-AABB test clamped to [0, length].

    Args:
      origins:        f32[..., 3]
      inv_directions: f32[..., 3] — 1 / direction (+-inf on zero components).
      lengths:        f32[...]
      aabb_mins, aabb_maxs: f32[..., 3] — broadcast against rays; to test the
        two children of a node at once (the reference's fused ``AABBs_hit``),
        pass boxes with a leading axis of 2 and rays broadcast accordingly.

    Returns:
      bool[...] hit mask (tmax >= tmin with t clamped to [0, length]).
    """
    t0 = (aabb_mins - origins) * inv_directions
    t1 = (aabb_maxs - origins) * inv_directions
    tnear = jnp.minimum(t0, t1)
    tfar = jnp.maximum(t0, t1)
    # Clamp to the valid ray segment; like the reference, fold the clamps in
    # through min/max so slab NaNs (0 * inf) are absorbed.
    tmin = jnp.maximum(
        jnp.maximum(tnear[..., 0], tnear[..., 1]),
        jnp.maximum(tnear[..., 2], jnp.zeros_like(lengths)),
    )
    tmax = jnp.minimum(
        jnp.minimum(tfar[..., 0], tfar[..., 1]),
        jnp.minimum(tfar[..., 2], lengths),
    )
    return tmax >= tmin


def safe_inverse_direction(directions) -> jnp.ndarray:
    """1 / d with signed-infinity semantics for zero components.

    CUDA's IEEE division produces +-inf for +-0 components and the slab test
    relies on it; jnp division does the same, this wrapper just documents the
    contract.
    """
    return jnp.float32(1.0) / directions
