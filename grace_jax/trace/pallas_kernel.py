"""Fused SPH trace as a Pallas kernel through Triton.

The general (any ray bundle) fast path for the reference's trace kernel
(ref: include/grace/cuda/kernels/bintree_trace.cuh:52-197), in two stages:

  broadphase  per ray tile, the ascending unique list of 128-primitive
              ALIGNED segments of the Morton-sorted primitive array whose
              AABB overlaps the tile's AABB (grace_jax.trace.
              pallas_broadphase.dense_tile_segments, plain XLA). Segments
              partition primitive space and lists are unique per tile, so
              each primitive is tested at most once per ray; segment
              padding (h = 0) can never hit.
  THIS KERNEL one program per ray tile loops over its segment list; for
              each (8, 128) component-major primitive slab it reads from
              device memory, it evaluates the dense (tile rays x 128)
              intersection and the Horner-form line integral in registers.

Conservative culling: a hit found from any extra primitive in an
overlapped segment is a true hit (the exact per-ray test decides), and
the unique list guarantees it is counted exactly once.

Layouts:
  rays  f32[8, R_pad]    component-major (ox, oy, oz, dx, dy, dz, len, 0)
  prims f32[8, N_pad]    component-major (x, y, z, h, 1/h^2, h^2, 0, 0)
  out   f32[R_pad]       per-ray value
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from grace_jax.core.types import Rays
from grace_jax.sph.kernel_integrals import (
    HORNER1_DEG,
    cubic_spline_line_integral_direct_raw,
    cubic_spline_line_integral_horner1,
)

DEFAULT_TILE = 64
SEG = 128  # primitives per aligned segment (= one slab of lanes)


def pad_rays(rays: Rays, tile: int) -> Rays:
    """Pad to whole tiles with never-hit rays (length -1) that share the
    last ray's origin and direction, keeping the last tile's AABB tight."""
    pad = (-rays.n_rays) % tile
    if not pad:
        return rays
    return Rays(
        jnp.concatenate([rays.origins,
                         jnp.broadcast_to(rays.origins[-1:], (pad, 3))]),
        jnp.concatenate([rays.directions,
                         jnp.broadcast_to(rays.directions[-1:], (pad, 3))]),
        jnp.concatenate([rays.lengths, jnp.full((pad,), -1.0, jnp.float32)]),
    )


def _pack_rays(rays: Rays):
    cols = [rays.origins.T, rays.directions.T, rays.lengths[None, :],
            jnp.zeros_like(rays.lengths)[None, :]]
    return jnp.concatenate(cols, axis=0)             # (8, R)


def _pack_prims(spheres: jax.Array):
    """Component-major f32[8, N_pad] with h = 0 padding (cannot hit).

    Rows: x, y, z, h, 1/h^2 (0 where h = 0), h^2, 0, 0. The derived rows are
    baked here so the kernel never divides (inv_h2) and the hitcount
    compare uses the identical h*h the XLA engine computes."""
    n = spheres.shape[0]
    n_pad = ((n + SEG - 1) // SEG) * SEG
    pt = jnp.pad(spheres, ((0, n_pad - n), (0, 0))).T     # (4, N_pad)
    h2 = pt[3:4] * pt[3:4]
    inv_h2 = jnp.where(h2 > 0.0, 1.0 / jnp.maximum(h2, 1e-30), 0.0)
    zeros = jnp.zeros_like(h2)
    return jnp.concatenate([pt, inv_h2, h2, zeros, zeros], axis=0)


def _seg_compute(px, py, pz, aux, ray, mode, integral_deg):
    """(tile, SEG) contributions of one primitive slab.

    ``aux`` is the slab's 1/h^2 row (cumulative) or h^2 row (hitcount).
    The integral is the single-piece Horner form
    (kernel_integrals.cubic_spline_line_integral_horner1), whose clamped
    v^3*sqrt(v) prefactor vanishes for u >= 1, so no explicit in-support
    mask is needed on the cumulative path.
    """
    ox, oy, oz, dx, dy, dz, ln = ray
    # sphere_hit (ref: generic/intersect.h:10-55), tile rays x segment.
    rx = px - ox
    ry = py - oy
    rz = pz - oz
    dot = rx * dx + ry * dy + rz * dz
    bx = rx - dot * dx
    by = ry - dot * dy
    bz = rz - dot * dz
    b2 = bx * bx + by * by + bz * bz
    along = (dot >= 0.0) & (dot < ln)
    if mode == "hitcount":
        return jnp.where((b2 < aux) & along, 1.0, 0.0)
    u = b2 * aux
    if integral_deg < 0:
        # Direct fit: fuse its u < 1 support test into the along select.
        f = cubic_spline_line_integral_direct_raw(u, -integral_deg)
        return jnp.where(along & (u < 1.0), f * aux, 0.0)
    f = cubic_spline_line_integral_horner1(u, deg=integral_deg)
    return jnp.where(along, f * aux, 0.0)


def _trace_kernel(n_ref, segs_ref, rays_ref, prims_ref, out_ref, *,
                  mode: str, integral_deg: int):
    tile = pl.program_id(0)
    n = n_ref[tile]
    ray = tuple(rays_ref[c, :][:, None] for c in range(7))    # (T, 1) each
    aux_row = 5 if mode == "hitcount" else 4

    def body(k, acc):
        cols = pl.ds(pl.multiple_of(segs_ref[tile, k] * SEG, SEG), SEG)
        px, py, pz, aux = (prims_ref[r, cols][None, :]
                           for r in (0, 1, 2, aux_row))
        return acc + _seg_compute(px, py, pz, aux, ray, mode, integral_deg)

    acc0 = jnp.zeros((ray[0].shape[0], SEG), jnp.float32)
    out_ref[...] = jnp.sum(jax.lax.fori_loop(0, n, body, acc0), axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("tile", "max_chunks", "mode", "integral_deg",
                     "interpret"),
)
def pallas_trace_sph(
    rays: Rays,
    spheres: jax.Array,
    tile: int = DEFAULT_TILE,
    max_chunks: int = 2048,
    mode: str = "cumulative",
    integral_deg: int = HORNER1_DEG,
    segments: Tuple[jax.Array, jax.Array, jax.Array] | None = None,
    interpret: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Column density (mode='cumulative') or hit counts (mode='hitcount')
    per ray: dense segment broadphase + the Triton tile kernel.

    Returns (per_ray_values f32/i32[R], overflow bool[n_tiles]). An
    overflowed tile listed more than ``max_chunks`` segments and has
    incomplete sums — re-run with a larger ``max_chunks``.
    ``tile`` is the rays per program (a power of two); a program gets one
    warp per 8 rays, so each thread holds 32 (ray, primitive) pairs of the
    (tile, 128) accumulator. 64 rays on 8 warps was the fastest shape
    tried on an H100 at 2^20 particles and 512^2 rays.
    ``segments`` optionally supplies the broadphase product
    (seg_ids i32[n_tiles, max_chunks], n_segs i32[n_tiles],
    overflow bool[n_tiles]) over the SAME tile-padded rays, for callers
    that hoist or reuse it (the ring in parallel/sharding.py).
    ``integral_deg`` selects the cumulative-mode Horner flavour (see
    kernel_integrals.cubic_spline_line_integral_horner1): 14 (default,
    ~2e-5 rel err), lower positive degrees trade accuracy for FMAs, and
    NEGATIVE values select the sqrt-free direct fit of that |degree|.
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU).
    """
    if mode not in ("cumulative", "hitcount"):
        raise ValueError(f"unknown mode {mode!r}")
    n_rays = rays.n_rays
    rays = pad_rays(rays, tile)
    if segments is None:
        from grace_jax.trace.pallas_broadphase import dense_tile_segments

        segments = dense_tile_segments(rays, spheres, tile, max_chunks)
    seg_ids, n_segs, overflow = segments
    out = pl.pallas_call(
        functools.partial(_trace_kernel, mode=mode,
                          integral_deg=integral_deg),
        out_shape=jax.ShapeDtypeStruct((rays.n_rays,), jnp.float32),
        grid=(rays.n_rays // tile,),
        in_specs=[
            pl.no_block_spec,
            pl.no_block_spec,
            pl.BlockSpec((8, tile), lambda i: (0, i)),
            pl.no_block_spec,
        ],
        out_specs=pl.BlockSpec((tile,), lambda i: (i,)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=max(tile // 8, 1),
                                                 num_stages=2),
        interpret=interpret,
        name=f"trace_sph_{mode}",
    )(n_segs, seg_ids, _pack_rays(rays), _pack_prims(spheres))
    values = out[:n_rays]
    if mode == "hitcount":
        values = values.astype(jnp.int32)
    return values, overflow
