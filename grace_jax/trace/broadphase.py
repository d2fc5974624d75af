"""Ray-tile bounding boxes for the tile broadphase.

Rays are grouped into coherence-sorted tiles (rays.gen.spatial_sort_rays);
each tile's AABB is culled against primitive segments once
(trace/pallas_broadphase.py), and the fused trace kernel then tests only
the listed segments against the tile's rays. Structurally this is the
binning pass of a tile-based rasterizer; the role the warp-shared stack
plays in the reference's trace kernel (ref: bintree_trace.cuh:96-160) is
played here by the tile cull.

Conservative: the tile AABB (hull of all ray segment endpoints) may overlap
primitives no ray in the tile hits — the per-ray test in the kernel
filters. Tight for coherent tiles (images, plane-parallel, sorted rays);
wide-spread ray bundles overlap nearly everything, and the per-tile list
capacity ``max_chunks`` then reports overflow.
"""

from __future__ import annotations

import jax.numpy as jnp

from grace_jax.core.types import Rays


def tile_aabbs(rays: Rays, tile: int):
    """Per-tile AABB of all ray segments (hull of origin/terminus points)."""
    n = rays.n_rays
    assert n % tile == 0, "ray count must be a multiple of the tile size"
    o = rays.origins.reshape(-1, tile, 3)
    e = (rays.origins + rays.directions * rays.lengths[:, None]).reshape(-1, tile, 3)
    mins = jnp.minimum(jnp.min(o, axis=1), jnp.min(e, axis=1))
    maxs = jnp.maximum(jnp.max(o, axis=1), jnp.max(e, axis=1))
    return mins, maxs
