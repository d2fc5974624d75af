"""Splatting renderer: SPH column density of a parallel ray bundle as small
matrix products.

The flagship workload (parallel-projection column density of an SPH
snapshot — the reference's project_gadget / integrate use case, ref:
tests/project_gadget/project_gadget.cu:27-115). Instead of tracing each
pixel's ray through a BVH, exploit the structure of a parallel ray grid:
the image is a sum of separable per-particle footprints,

    I[j, i] = sum_p  w_p/h_p^2 * F(sqrt(xhat^2 + yhat^2)),
    xhat = (X_i - pu_p)/h_p,   yhat = (Y_j - pv_p)/h_p

and with the rank-K separable basis F(sqrt(x^2+y^2)) ~= sum_k a_k(x) b_k(y)
(kernel_integrals.fit_splat_basis, max err ~1e-4 relative), each pixel tile
becomes K contractions over the particles that touch it

    I_tile = sum_k A_k @ B_k^T,  A_k[j, p] = a_k(yhat),  B_k[i, p] = b_k(xhat) * w_p

Only the thin A/B factors are built elementwise — O((rows + cols) * P)
work per chunk instead of the O(rows * cols * P) per-pair tests of the
general trace. Semantics match the general cumulative trace exactly for a
parallel ray bundle: the reference's along-ray acceptance (foot of the
perpendicular in [0, len), sphere_hit in generic/intersect.h:26-54)
reduces to a per-particle depth predicate, applied here as a weight mask.

Pipeline:
  1. ``bucket_prims_ortho`` (XLA, per scene + camera): project particles to
     the image plane, expand each footprint to the (up to 2x2) pixel tiles
     it touches, sort instances by tile, and lay them out as
     component-major (n_slabs, 4, chunk) slabs (rows pu, pv, invh, scale).
  2. ``splat_image`` (Pallas through Triton): one program per pixel tile
     loops over its slabs, builds the factors in registers and feeds them
     to ``pl.dot``. ``splat_image_xla`` is the same computation written as
     batched XLA contractions over (tile, slab) pairs, kept as the plain
     version the kernel is measured and tested against.

``splat_reference_jnp`` evaluates the identical separable model densely
(every pixel against every particle) for small scenes, and is the
differentiable reference of the model.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from grace_jax.ops.vecmath import cross, normalize3
from grace_jax.sph.kernel_integrals import (
    SPLAT_A8_COEFFS,
    SPLAT_A_COEFFS,
    SPLAT_B8_COEFFS,
    SPLAT_B_COEFFS,
    SPLAT_DEG,
    SPLAT_DEG8,
    SPLAT_RANK,
)


class SplatBuckets(NamedTuple):
    """Bucketed instance layout. Meta arrays are per pixel TILE of
    ``tile_w`` image rows by ``band`` image columns, shaped [nty, nbx]
    (tile rows x tile columns), so the tile grid is part of the shapes."""

    slabs: jax.Array      # f32[n_slabs_cap, 4, chunk]: rows pu, pv, invh, scale
    slab_lo: jax.Array    # i32[nty, nbx] first slab overlapping each tile's range
    n_slabs: jax.Array    # i32[nty, nbx]
    first: jax.Array      # i32[nty, nbx] global instance range [first, last)
    last: jax.Array       # i32[nty, nbx]
    xcols: jax.Array      # f32[W] pixel-center coordinate along the right axis
    yrows: jax.Array      # f32[H] pixel-center coordinate along the up axis
    overflow: jax.Array   # bool[] — some particle footprint exceeded a tile span


class OrthoCamera(NamedTuple):
    """Static orthographic camera spec (hashable; closed over by the jit)."""

    camera_position: tuple
    look_at: tuple
    view_up: tuple
    vertical_extent: float
    length: float
    resolution_x: int
    resolution_y: int


def _basis_coeffs(basis: str):
    """(deg, a_coeffs, b_coeffs) for a named separable basis fit:
    "deg10" (per-eigenvector, ~1e-4 max rel err) or "deg8" (joint fit,
    ~3.1e-4, ~20% less factor work)."""
    try:
        deg, a_c, b_c = {
            "deg10": (SPLAT_DEG, SPLAT_A_COEFFS, SPLAT_B_COEFFS),
            "deg8": (SPLAT_DEG8, SPLAT_A8_COEFFS, SPLAT_B8_COEFFS),
        }[basis]
    except KeyError:
        raise ValueError(f"unknown basis {basis!r} (expected 'deg10' or "
                         "'deg8')") from None
    return deg, np.asarray(a_c, np.float32), np.asarray(b_c, np.float32)


def _sorted_first_counts(key_s: jax.Array, n_keys: int,
                         chunk: int = 1024) -> jax.Array:
    """first[k] = #elements of SORTED ``key_s`` strictly below k, for
    k = 0..n_keys (inclusive), i32[n_keys + 1].

    Exact two-level count exploiting sortedness: per-chunk maxima decide
    wholly-below chunks in one (K x m) compare, and each threshold
    fine-counts only its single straddling chunk (a K-row gather). O(K*(m
    + C) + n) work instead of the broadcast count's O(K*n).
    """
    n = key_s.shape[0]
    if n == 0:
        # Degenerate: gathering ck[min(0, m-1)] from a (0, chunk) array is
        # ill-defined; every count is trivially zero.
        return jnp.zeros(n_keys + 1, jnp.int32)
    pad = (-n) % chunk
    big = jnp.asarray(np.iinfo(np.int32).max, key_s.dtype)
    ks = jnp.pad(key_s, (0, pad), constant_values=big)
    m = ks.shape[0] // chunk
    ck = ks.reshape(m, chunk)
    cmax = ck[:, -1]                                  # sorted: max = last
    thresholds = jnp.arange(n_keys + 1, dtype=key_s.dtype)[:, None]
    n_full = jnp.sum(cmax[None, :] < thresholds, axis=1)       # (K+1,)
    fine = ck[jnp.minimum(n_full, m - 1)]                      # (K+1, C)
    n_fine = jnp.sum(fine < thresholds, axis=1)
    # n_full == m means every chunk (incl. the gathered duplicate) is wholly
    # below k; padding (INT32_MAX) keeps that reachable only when pad == 0.
    return jnp.where(n_full >= m, n,
                     n_full * chunk + n_fine).astype(jnp.int32)


def _camera_frame(camera_position, look_at, view_up):
    view_dir = normalize3(jnp.asarray(look_at, jnp.float32)
                          - jnp.asarray(camera_position, jnp.float32))
    v = normalize3(cross(view_dir, jnp.asarray(view_up, jnp.float32)))
    u = normalize3(cross(v, view_dir))
    return view_dir, v, u


def _camera_numerics(cam: OrthoCamera):
    view_dir, v, u = _camera_frame(
        cam.camera_position, cam.look_at, cam.view_up)
    c = jnp.asarray(cam.camera_position, jnp.float32)
    w_res, h_res = cam.resolution_x, cam.resolution_y
    aspect = w_res / h_res
    half_w = 0.5 * cam.vertical_extent * aspect
    half_h = 0.5 * cam.vertical_extent
    cu = c @ v
    cv = c @ u
    # Pixel-center affine maps (the formulas of
    # rays.gen.orthographic_projection_rays: pixel (j, i) = ray j*W + i).
    x0 = cu + (2.0 * 0.5 / w_res - 1.0) * half_w
    dx = 2.0 * half_w / w_res
    y0 = cv + (1.0 - 2.0 * 0.5 / h_res) * half_h
    dy = -2.0 * half_h / h_res
    return view_dir, v, u, c, x0, dx, y0, dy


def project_ortho(spheres, weights, cam: OrthoCamera):
    """Per-particle projections: (pu, pv, invh, scale) each f32[n].

    scale folds the weight, the 1/h^2 kernel normalization, and the
    along-ray depth acceptance (for a parallel bundle the foot of the
    perpendicular is at the particle depth for every ray,
    ref: generic/intersect.h:26-54)."""
    view_dir, v, u, c, *_ = _camera_numerics(cam)
    pos = spheres[:, :3]
    h = spheres[:, 3]
    pu = pos @ v
    pv = pos @ u
    depth = (pos - c) @ view_dir
    # NaN-safe where: divide by the SELECTED branch so reverse-mode autodiff
    # through the dead branch stays finite (splat_reference_jnp
    # differentiates straight through this).
    inv_h = jnp.where(h > 0, 1.0 / jnp.where(h > 0, h, 1.0), 0.0)
    live = (h > 0) & (depth >= 0.0) & (depth < cam.length)
    w = jnp.ones_like(h) if weights is None else weights
    scale = jnp.where(live, w * inv_h * inv_h, 0.0)
    return pu, pv, inv_h, scale


@functools.partial(
    jax.jit,
    static_argnames=("resolution_x", "resolution_y", "tile_w", "band",
                     "chunk"),
)
def bucket_prims_ortho(
    spheres: jax.Array,
    camera_position,
    look_at,
    view_up,
    vertical_extent: float,
    length: float,
    resolution_x: int,
    resolution_y: int,
    tile_w: int = 32,
    band: int = 32,
    chunk: int = 64,
    weights: jax.Array | None = None,
) -> SplatBuckets:
    """Per-(scene, camera) prep: project, cull by depth, bucket by pixel
    tile. Camera conventions match rays.gen.orthographic_projection_rays
    exactly (pixel (j, i) = ray j*W + i; ref: kernels/gen_rays.cuh:666-725).

    A pixel tile is ``tile_w`` image rows by ``band`` image columns. Each
    footprint is expanded to at most a 2x2 neighbourhood of tiles; a
    particle with 2h wider than a tile sets the overflow flag (render with
    larger tiles, or trace such scenes with the general kernel). Slabs
    hold ``chunk`` instances each.
    """
    w_res, h_res = resolution_x, resolution_y
    if w_res % band or h_res % tile_w:
        raise ValueError("resolution must be a multiple of the tile shape")
    n = spheres.shape[0]
    cam = OrthoCamera(camera_position, look_at, view_up, vertical_extent,
                      length, w_res, h_res)
    pu, pv, invh, scale = project_ortho(spheres, weights, cam)
    *_, x0, dx, y0, dy = _camera_numerics(cam)
    # Pixel-center coordinates in the image plane (top-left pixel first).
    xcols = x0 + jnp.arange(w_res, dtype=jnp.float32) * dx     # ascending
    yrows = y0 + jnp.arange(h_res, dtype=jnp.float32) * dy     # descending
    live = scale > 0

    # Tile span of each footprint (clamped to a 2x2 neighbourhood; flag if
    # a footprint needs more). dy < 0: the row index grows as pv falls.
    h = spheres[:, 3]
    nbx = w_res // band
    nty = h_res // tile_w
    cb_lo = jnp.floor((pu - h - (x0 - 0.5 * dx)) / (dx * band)).astype(jnp.int32)
    cb_hi = jnp.floor((pu + h - (x0 - 0.5 * dx)) / (dx * band)).astype(jnp.int32)
    rt_lo = jnp.floor(((pv + h) - (y0 - 0.5 * dy)) / (dy * tile_w)).astype(jnp.int32)
    rt_hi = jnp.floor(((pv - h) - (y0 - 0.5 * dy)) / (dy * tile_w)).astype(jnp.int32)
    overflow = jnp.any(live & ((cb_hi - cb_lo > 1) | (rt_hi - rt_lo > 1)))
    cb_hi = jnp.minimum(cb_hi, cb_lo + 1)
    rt_hi = jnp.minimum(rt_hi, rt_lo + 1)

    # 4 instances per particle: the (up to) 2x2 touched tiles; duplicates /
    # out-of-image / dead particles get the sentinel key and sort to the
    # end. Keys are row-major over tiles: key = rt * nbx + cb.
    n_keys = nbx * nty
    insts = []
    for rr in range(2):
        for cc in range(2):
            cb = cb_lo + cc
            rt = rt_lo + rr
            ok = (
                (cb <= cb_hi) & (rt <= rt_hi)
                & (cb >= 0) & (cb < nbx) & (rt >= 0) & (rt < nty) & live
            )
            insts.append(jnp.where(ok, rt * nbx + cb, n_keys))
    tile_ids = jnp.concatenate(insts)                       # [4n]

    # One multi-payload sort carries the projected components with the
    # keys. Unweighted renders drop the 4th payload: scale = invh^2 is
    # derivable from the sorted invh once dead/out-of-depth particles are
    # encoded as invh = 0.
    tiled = lambda a: jnp.tile(a, 4)
    if weights is None:
        invh_live = jnp.where(live, invh, 0.0)
        key_s, pu_s, pv_s, invh_s = jax.lax.sort(
            (tile_ids, tiled(pu), tiled(pv), tiled(invh_live)), num_keys=1)
        scale_s = invh_s * invh_s
    else:
        key_s, pu_s, pv_s, invh_s, scale_s = jax.lax.sort(
            (tile_ids, tiled(pu), tiled(pv), tiled(invh), tiled(scale)),
            num_keys=1,
        )

    # Per-tile instance ranges [first, last). Renderers mask by GLOBAL
    # instance index, so a tile's first and last slabs may share instances
    # with its neighbours and no chunk-alignment padding is needed.
    first = _sorted_first_counts(key_s, n_keys)
    last = first[1:]
    first = first[:-1]

    cap = ((4 * n + chunk - 1) // chunk) * chunk
    pad = cap - 4 * n
    comp = [jnp.pad(a, (0, pad)).reshape(-1, chunk)
            for a in (pu_s, pv_s, invh_s, scale_s)]
    slabs = jnp.stack(comp, axis=1)                         # (cap/chunk, 4, chunk)
    slab_lo = first // chunk
    n_slabs = jnp.where(last > first,
                        (last + chunk - 1) // chunk - slab_lo, 0)
    grid = lambda a: a.reshape(nty, nbx)
    return SplatBuckets(
        slabs, grid(slab_lo), grid(n_slabs), grid(first), grid(last),
        xcols, yrows, overflow,
    )


def _factor(t, coeffs, deg, k):
    """Basis factor k: (1 - t) * q_k(t), shaped like t."""
    acc = jnp.full_like(t, jnp.float32(coeffs[k, deg]))
    for d in range(deg - 1, -1, -1):
        acc = acc * t + jnp.float32(coeffs[k, d])
    return acc * (1.0 - t)


def _tf32_split(x):
    """x = hi + lo with hi exactly representable in TF32 (10 mantissa
    bits): three TF32 products of the halves give ~f32 accuracy."""
    hi = jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(x, jnp.int32) & jnp.int32(-8192),
        jnp.float32)
    return hi, x - hi


def _dot_3xtf32(a, b):
    """a @ b^T in 3xTF32 on the tensor cores (the splat's precision)."""
    a_hi, a_lo = _tf32_split(a)
    b_hi, b_lo = _tf32_split(b)
    d = functools.partial(pl.dot, trans_b=True, allow_tf32=True)
    return d(a_hi, b_hi) + (d(a_hi, b_lo) + d(a_lo, b_hi))


def _splat_kernel(meta_ref, x_ref, y_ref, slab_ref, out_ref, *,
                  n_cols: int, deg: int, a_coeffs: np.ndarray,
                  b_coeffs: np.ndarray):
    """One program per pixel tile: loop over the tile's slabs, build the
    rank-K factors in registers, accumulate the contractions."""
    key = pl.program_id(0) * n_cols + pl.program_id(1)
    slab_lo = meta_ref[key, 0]
    n = meta_ref[key, 1]
    first = meta_ref[key, 2]
    last = meta_ref[key, 3]
    chunk = slab_ref.shape[2]
    ys = y_ref[...][:, None]                        # (TW, 1)
    xs = x_ref[...][:, None]                        # (BW, 1)
    lane = jax.lax.broadcasted_iota(jnp.int32, (chunk,), 0)

    def body(s, acc):
        slab = slab_lo + s
        pu = slab_ref[slab, 0, :]
        pv = slab_ref[slab, 1, :]
        invh = slab_ref[slab, 2, :][None, :]
        # A tile's slab range is not instance-aligned: mask the
        # neighbouring tiles' instances by global instance index.
        gidx = slab * chunk + lane
        scl = jnp.where((gidx >= first) & (gidx < last),
                        slab_ref[slab, 3, :], 0.0)[None, :]
        ya = (ys - pv[None, :]) * invh               # (TW, chunk)
        ty = jnp.minimum(ya * ya, 1.0)
        xb = (xs - pu[None, :]) * invh               # (BW, chunk)
        tx = jnp.minimum(xb * xb, 1.0)
        for k in range(a_coeffs.shape[0]):
            acc = acc + _dot_3xtf32(_factor(ty, a_coeffs, deg, k),
                                    _factor(tx, b_coeffs, deg, k) * scl)
        return acc

    acc0 = jnp.zeros((ys.shape[0], xs.shape[0]), jnp.float32)
    out_ref[...] = jax.lax.fori_loop(0, n, body, acc0)


@functools.partial(jax.jit, static_argnames=("basis", "interpret"))
def splat_image(buckets: SplatBuckets, basis: str = "deg8",
                interpret: bool = False) -> jax.Array:
    """Render the bucketed scene with the Triton kernel: f32 image [H, W]
    (row 0 = top). Tile shapes, ``chunk`` and the image size must be
    powers of two (Triton block shapes); the tile rows and columns must be
    at least 16 (the tensor cores' smallest product). ``interpret=True``
    runs the kernel in the Pallas interpreter (CPU tests)."""
    deg, a_c, b_c = _basis_coeffs(basis)
    nty, nbx = buckets.first.shape
    h_res = buckets.yrows.shape[0]
    w_res = buckets.xcols.shape[0]
    tile_w, band = h_res // nty, w_res // nbx
    meta = jnp.stack([buckets.slab_lo, buckets.n_slabs, buckets.first,
                      buckets.last], axis=-1).reshape(nty * nbx, 4)
    kernel = functools.partial(_splat_kernel, n_cols=nbx, deg=deg,
                               a_coeffs=a_c, b_coeffs=b_c)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((h_res, w_res), jnp.float32),
        grid=(nty, nbx),
        in_specs=[
            pl.no_block_spec,
            pl.BlockSpec((band,), lambda j, i: (i,)),
            pl.BlockSpec((tile_w,), lambda j, i: (j,)),
            pl.no_block_spec,
        ],
        out_specs=pl.BlockSpec((tile_w, band), lambda j, i: (j, i)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="splat_image",
    )(meta, buckets.xcols, buckets.yrows, buckets.slabs)


@functools.partial(jax.jit, static_argnames=("basis", "pair_block"))
def splat_image_xla(buckets: SplatBuckets, basis: str = "deg8",
                    pair_block: int = 512) -> jax.Array:
    """The splat as plain XLA: batched contractions over (tile, slab)
    pairs, then a sorted segment sum of the pair tiles into image tiles.
    The factors are full f32 (``Precision.HIGHEST``). Same result as
    ``splat_image`` up to summation order."""
    deg, a_c, b_c = _basis_coeffs(basis)
    nty, nbx = buckets.first.shape
    h_res = buckets.yrows.shape[0]
    w_res = buckets.xcols.shape[0]
    tile_w, band = h_res // nty, w_res // nbx
    n_keys = nty * nbx
    n_cap, _, chunk = buckets.slabs.shape
    n_slabs = buckets.n_slabs.reshape(-1)
    slab_lo = buckets.slab_lo.reshape(-1)
    first = buckets.first.reshape(-1)
    last = buckets.last.reshape(-1)

    # Neighbouring tiles share at most one boundary slab, so the pair count
    # is bounded by slabs + tiles.
    n_pairs = n_cap + n_keys
    n_pairs += (-n_pairs) % pair_block
    key = jnp.repeat(jnp.arange(n_keys, dtype=jnp.int32), n_slabs,
                     total_repeat_length=n_pairs)
    start = jnp.cumsum(n_slabs) - n_slabs
    p = jnp.arange(n_pairs, dtype=jnp.int32)
    live = p < jnp.sum(n_slabs)
    slab = jnp.clip(slab_lo[key] + p - start[key], 0, n_cap - 1)
    lane = jnp.arange(chunk, dtype=jnp.int32)
    ys_all = buckets.yrows.reshape(nty, tile_w)
    xs_all = buckets.xcols.reshape(nbx, band)

    def pair_tiles(args):
        key, slab, live = args
        blk = buckets.slabs[slab]                         # (B, 4, chunk)
        gidx = slab[:, None] * chunk + lane
        ok = live[:, None] & (gidx >= first[key][:, None]) & (gidx < last[key][:, None])
        scl = jnp.where(ok, blk[:, 3], 0.0)[:, None, :]
        invh = blk[:, 2][:, None, :]
        ya = (ys_all[key // nbx][:, :, None] - blk[:, 1][:, None, :]) * invh
        xb = (xs_all[key % nbx][:, :, None] - blk[:, 0][:, None, :]) * invh
        ty = jnp.minimum(ya * ya, 1.0)
        tx = jnp.minimum(xb * xb, 1.0)
        out = 0.0
        for k in range(a_c.shape[0]):
            out = out + jnp.einsum(
                "prc,pbc->prb", _factor(ty, a_c, deg, k),
                _factor(tx, b_c, deg, k) * scl,
                precision=jax.lax.Precision.HIGHEST)
        return out

    blocks = lambda a: a.reshape(-1, pair_block)
    tiles = jax.lax.map(pair_tiles, (blocks(key), blocks(slab), blocks(live)))
    tiles = tiles.reshape(n_pairs, tile_w, band)
    img = jax.ops.segment_sum(tiles, jnp.where(live, key, n_keys),
                              num_segments=n_keys, indices_are_sorted=True)
    return img.reshape(nty, nbx, tile_w, band).transpose(0, 2, 1, 3).reshape(
        h_res, w_res)


def render_ortho_splat(
    spheres: jax.Array,
    camera_position,
    look_at,
    view_up,
    vertical_extent: float,
    length: float,
    resolution_x: int,
    resolution_y: int,
    weights: jax.Array | None = None,
    tile_w: int = 32,
    band: int = 32,
    chunk: int = 64,
    basis: str = "deg8",
    interpret: bool = False,
):
    """One-call orthographic column-density render.

    Returns (image f32[H, W], overflow bool[]). image[j, i] equals (to the
    basis-fit tolerance, a few 1e-4 relative) trace_cumulative_sph over
    orthographic_projection_rays with identical camera parameters, ray
    index j * W + i. ``basis="deg10"`` is the tighter per-eigenvector fit
    (~1e-4 max rel err vs ~3.1e-4 for the joint deg-8 fit).

    The bucket prep (an instance sort) is paid per (scene, camera) pair;
    call ``bucket_prims_ortho`` once and ``splat_image`` per frame while
    neither changes.
    """
    buckets = bucket_prims_ortho(
        spheres, camera_position, look_at, view_up, vertical_extent, length,
        resolution_x, resolution_y, tile_w=tile_w, band=band, chunk=chunk,
        weights=weights,
    )
    img = splat_image(buckets, basis=basis, interpret=interpret)
    return img, buckets.overflow


def splat_reference_jnp(spheres, weights, cam: OrthoCamera,
                        basis: str = "deg8"):
    """Dense jnp evaluation of the IDENTICAL separable model (same fitted
    coefficients, same clamps): every pixel against every particle, at
    highest matmul precision. O(n_pixels * n); small scenes only. It is
    differentiable, and the reference the splat renderers are tested
    against."""
    deg, a_c, b_c = _basis_coeffs(basis)
    pu, pv, invh, scale = project_ortho(spheres, weights, cam)
    *_, x0, dx, y0, dy = _camera_numerics(cam)
    xs = x0 + jnp.arange(cam.resolution_x, dtype=jnp.float32) * dx
    ys = y0 + jnp.arange(cam.resolution_y, dtype=jnp.float32) * dy
    ya = (ys[:, None] - pv[None, :]) * invh[None, :]       # (H, n)
    xb = (xs[:, None] - pu[None, :]) * invh[None, :]       # (W, n)
    ty = jnp.minimum(ya * ya, 1.0)
    tx = jnp.minimum(xb * xb, 1.0)
    img = jnp.zeros((cam.resolution_y, cam.resolution_x), jnp.float32)
    for k in range(SPLAT_RANK):
        img = img + jnp.matmul(_factor(ty, a_c, deg, k),
                               (_factor(tx, b_c, deg, k) * scale[None, :]).T,
                               precision=jax.lax.Precision.HIGHEST)
    return img
