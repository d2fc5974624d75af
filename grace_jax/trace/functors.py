"""Stock trace functor library (analog of ref include/grace/cuda/functors/trace.cuh).

Composable pieces for the generic engine:

  reference functor                       equivalent here
  -------------------------------------   --------------------------------
  Intersect_sphere_bool / _b2dist         intersect_sphere
  OnHit_increment                         on_hit_count
  OnHit_sphere_cumulate                   on_hit_sphere_cumulate
  OnHit_sphere_individual                 on_hit_sphere_record
  RayEntry_null/_from_array,              plain Python closures over arrays
  RayExit_null/_to_array                  (ray_data is returned directly)
  Init_null / InitGlobalToSmem            no-op — the lookup table is a jit
                                          constant; XLA places it without an
                                          explicit copy (ref: trace.cuh:87-112)

The SPH integral evaluation matches OnHit_sphere_cumulate
(ref: trace.cuh:163-193): b_norm = (N-1) * sqrt(b2) / h, table lerp,
scaled by 1/h^2.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from grace_jax.ops.intersect import sphere_hit
from grace_jax.ops.interpolate import lerp


class SphereHitInfo(NamedTuple):
    b2: jnp.ndarray
    dist: jnp.ndarray


def intersect_sphere(ray_o, ray_d, ray_len, spheres, ray_data):
    """Analog of Intersect_sphere_b2dist (ref: trace.cuh:135-144)."""
    hit, b2, dist = sphere_hit(ray_o, ray_d, ray_len, spheres)
    return hit, SphereHitInfo(b2=b2, dist=dist)


def on_hit_count(carry, ray_ids, prim_ids, info, hit):
    """Analog of OnHit_increment (ref: trace.cuh:149-160)."""
    ray_data, global_state = carry
    return ray_data + jnp.sum(hit, axis=-1).astype(ray_data.dtype), global_state


def sph_integral(b2, h, table):
    """Per-hit SPH line integral: lerp(table, (N-1) * sqrt(b2)/h) / h^2
    (ref: trace.cuh:179-183)."""
    n = table.shape[0]
    ir = 1.0 / h
    b_norm = (n - 1) * (jnp.sqrt(b2) * ir)
    return lerp(b_norm, table) * (ir * ir)


def make_on_hit_sphere_cumulate(spheres, table, weights=None):
    """Analog of OnHit_sphere_cumulate (ref: trace.cuh:163-193).

    Accumulates the kernel line integral of every intersected particle into
    the per-ray sum; optional per-particle weights (masses/densities) extend
    the reference (whose weighting lives in the segmented-scan stage,
    ref: kernels/weights.cuh).
    """
    h_arr = spheres[:, 3]

    def on_hit(carry, ray_ids, prim_ids, info, hit):
        ray_data, global_state = carry
        h = h_arr[prim_ids]
        contrib = sph_integral(info.b2, h, table)
        if weights is not None:
            contrib = contrib * weights[prim_ids]
        contrib = jnp.where(hit, contrib, 0.0)
        return ray_data + jnp.sum(contrib, axis=-1), global_state

    return on_hit


def make_on_hit_sphere_record(spheres, table, capacity: int):
    """Analog of OnHit_sphere_individual (ref: trace.cuh:196-235).

    Scatters (prim_index, integral, distance) per hit into global buffers at
    position offsets[ray] + running per-ray cursor; ray_data carries the
    cursor (seeded from the offsets array by the caller, the analog of
    RayEntry_from_array, ref: trace.cuh:44-60). global_state is a dict with
    'indices' i32[capacity], 'integrals' f32[capacity], 'distances'
    f32[capacity].
    """
    h_arr = spheres[:, 3]

    def on_hit(carry, ray_ids, prim_ids, info, hit):
        cursor, global_state = carry
        h = h_arr[prim_ids]
        contrib = sph_integral(info.b2, h, table)
        # Within-leaf rank of each hit -> unique scatter positions.
        rank = jnp.cumsum(hit.astype(jnp.int32), axis=-1) - hit.astype(jnp.int32)
        pos = cursor[:, None] + rank
        pos = jnp.where(hit & (pos < capacity), pos, capacity)
        global_state = dict(
            indices=global_state["indices"].at[pos].set(prim_ids, mode="drop"),
            integrals=global_state["integrals"].at[pos].set(contrib, mode="drop"),
            distances=global_state["distances"].at[pos].set(info.dist, mode="drop"),
        )
        cursor = cursor + jnp.sum(hit, axis=-1).astype(cursor.dtype)
        return cursor, global_state

    return on_hit


def make_on_hit_record_ids(capacity: int):
    """Record only (ray, prim) id pairs per hit — the residual needed by the
    differentiable integration path (grace_jax.trace.render)."""

    def on_hit(carry, ray_ids, prim_ids, info, hit):
        cursor, global_state = carry
        rank = jnp.cumsum(hit.astype(jnp.int32), axis=-1) - hit.astype(jnp.int32)
        pos = cursor[:, None] + rank
        pos = jnp.where(hit & (pos < capacity), pos, capacity)
        global_state = dict(
            ray=global_state["ray"].at[pos].set(
                jnp.broadcast_to(ray_ids[:, None], prim_ids.shape), mode="drop"
            ),
            prim=global_state["prim"].at[pos].set(prim_ids, mode="drop"),
        )
        cursor = cursor + jnp.sum(hit, axis=-1).astype(cursor.dtype)
        return cursor, global_state

    return on_hit
