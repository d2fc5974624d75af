"""SPH trace facades (analog of ref include/grace/cuda/trace_sph.cuh:57-241).

  trace_hitcounts_sph     per-ray hit counts            (ref: :57-79)
  trace_cumulative_sph    per-ray column density        (ref: :81-109)
  trace_sph               full per-hit records          (ref: :111-168)
  trace_with_sentinels_sph  per-hit + sentinel padding  (ref: :170-241)

The reference's hitcount -> exclusive_scan -> cudaMalloc -> retrace dataflow
cannot allocate dynamically under XLA; ``trace_sph`` instead takes a static
``capacity`` for the hit buffers (callers size it from a hitcount pass or an
upper bound) and returns (offsets, counts, buffers, total_hits). Entries
beyond a ray's count are unspecified; ``total_hits > capacity`` signals
overflow (the caller can re-run with a larger static capacity — one
recompile, same contract as re-allocating).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from grace_jax.core.tree import Tree
from grace_jax.core.types import Rays
from grace_jax.sph.kernel_integrals import DENSE_KERNEL_INTEGRAL_TABLE
from grace_jax.trace import functors as F
from grace_jax.trace.engine import TraceFunctors, trace

_DEFAULT_TABLE = np.asarray(DENSE_KERNEL_INTEGRAL_TABLE, np.float32)


def trace_hitcounts_sph(rays: Rays, spheres, tree: Tree, stack_size: int = 64):
    """Per-ray intersection counts (ref: trace_sph.cuh:57-79)."""
    fx = TraceFunctors(intersect=F.intersect_sphere, on_hit=F.on_hit_count)
    counts, _ = trace(
        rays,
        tree,
        spheres,
        fx,
        ray_data_init=jnp.zeros((rays.n_rays,), jnp.int32),
        stack_size=stack_size,
    )
    return counts


def trace_cumulative_sph(
    rays: Rays,
    spheres,
    tree: Tree,
    table=None,
    weights=None,
    stack_size: int = 64,
):
    """Per-ray accumulated kernel line integrals — column density
    (ref: trace_sph.cuh:81-109)."""
    table = _DEFAULT_TABLE if table is None else table
    fx = TraceFunctors(
        intersect=F.intersect_sphere,
        on_hit=F.make_on_hit_sphere_cumulate(spheres, table, weights),
    )
    sums, _ = trace(
        rays,
        tree,
        spheres,
        fx,
        ray_data_init=jnp.zeros((rays.n_rays,), jnp.float32),
        stack_size=stack_size,
    )
    return sums


class SphTraceResult(NamedTuple):
    offsets: jax.Array     # i32[R] exclusive-scan start of each ray's segment
    counts: jax.Array      # i32[R] per-ray hit counts
    indices: jax.Array     # i32[capacity] intersected sphere indices
    integrals: jax.Array   # f32[capacity] per-hit kernel integrals
    distances: jax.Array   # f32[capacity] per-hit along-ray distances
    total_hits: jax.Array  # i32[] (> capacity indicates overflow)


def trace_sph(
    rays: Rays,
    spheres,
    tree: Tree,
    capacity: int,
    table=None,
    stack_size: int = 64,
) -> SphTraceResult:
    """Two-pass per-hit trace (ref: trace_sph.cuh:111-168).

    Pass 1 counts hits per ray; offsets = exclusive cumsum (the reference's
    thrust::exclusive_scan, :135-137); pass 2 re-traverses and scatters
    (index, integral, distance) at offsets[r] + cursor, the analog of
    RayEntry_from_array seeding the write cursor (:150-167).

    Within-ray record order is traversal order; sort_by_distance
    (ops/segops.py) fixes the order downstream.
    """
    table = _DEFAULT_TABLE if table is None else table
    counts = trace_hitcounts_sph(rays, spheres, tree, stack_size)
    offsets = jnp.cumsum(counts) - counts
    total = jnp.sum(counts)

    fx = TraceFunctors(
        intersect=F.intersect_sphere,
        on_hit=F.make_on_hit_sphere_record(spheres, table, capacity),
    )
    buffers = dict(
        indices=jnp.zeros((capacity,), jnp.int32),
        integrals=jnp.zeros((capacity,), jnp.float32),
        distances=jnp.zeros((capacity,), jnp.float32),
    )
    _, buffers = trace(
        rays,
        tree,
        spheres,
        fx,
        ray_data_init=offsets.astype(jnp.int32),
        global_init=buffers,
        stack_size=stack_size,
    )
    return SphTraceResult(
        offsets=offsets.astype(jnp.int32),
        counts=counts,
        indices=buffers["indices"],
        integrals=buffers["integrals"],
        distances=buffers["distances"],
        total_hits=total,
    )


def trace_with_sentinels_sph(
    rays: Rays,
    spheres,
    tree: Tree,
    capacity: int,
    index_sentinel: int = -1,
    value_sentinel: float = 0.0,
    distance_sentinel: float = -1.0,
    table=None,
    stack_size: int = 64,
) -> SphTraceResult:
    """Per-hit trace with one sentinel entry appended per ray segment
    (ref: trace_sph.cuh:170-241). Segment r occupies
    [offsets[r], offsets[r] + counts[r]] inclusive of its sentinel slot;
    capacity must cover total_hits + n_rays."""
    table = _DEFAULT_TABLE if table is None else table
    counts = trace_hitcounts_sph(rays, spheres, tree, stack_size)
    # +1 slot per ray for the sentinel.
    offsets = jnp.cumsum(counts + 1) - (counts + 1)
    total = jnp.sum(counts + 1)

    fx = TraceFunctors(
        intersect=F.intersect_sphere,
        on_hit=F.make_on_hit_sphere_record(spheres, table, capacity),
    )
    buffers = dict(
        indices=jnp.full((capacity,), index_sentinel, jnp.int32),
        integrals=jnp.full((capacity,), value_sentinel, jnp.float32),
        distances=jnp.full((capacity,), distance_sentinel, jnp.float32),
    )
    _, buffers = trace(
        rays,
        tree,
        spheres,
        fx,
        ray_data_init=offsets.astype(jnp.int32),
        global_init=buffers,
        stack_size=stack_size,
    )
    return SphTraceResult(
        offsets=offsets.astype(jnp.int32),
        counts=counts,
        indices=buffers["indices"],
        integrals=buffers["integrals"],
        distances=buffers["distances"],
        total_hits=total,
    )
