"""Adjacent-pair "delta" computation for LBVH construction.

Analog of the reference's delta functors + compute_deltas kernel
(ref: include/grace/generic/functors/albvh.h:17-126,
 include/grace/cuda/kernels/albvh.cuh:32-47, 949-978).

A delta array ``d`` has one entry per adjacent pair of Morton-sorted
primitives: ``d[j]`` measures the dissimilarity between primitives j and j+1,
for j in [0, N-1). The conceptual boundary values d[-1] = d[N-1] = +MAX are
*not* stored — the tree builder (grace_jax.build.lbvh) treats out-of-range
queries as MAX, mirroring the reference functors' sentinel returns
(ref: functors/albvh.h:24-27, 65-70).

Larger delta == weaker affinity, with ties broken toward the leftmost
position; any strictly monotone transform of a delta array produces the same
tree, so 63-bit XOR deltas may be order-compressed to uint32.
"""

from __future__ import annotations

import jax.numpy as jnp

from grace_jax.ops.primitives import AabbFn, CentroidFn


def xor_deltas(keys) -> jnp.ndarray:
    """XOR (Karras-style) deltas of u32[N] Morton keys (ref: albvh.h:17-49).

    Returns u32[N-1]; the builder's MAX sentinel for u32 deltas is
    0xFFFFFFFF, unreachable by 30-bit keys.
    """
    return keys[:-1] ^ keys[1:]


def xor_deltas_63bit(key_hi, key_lo) -> jnp.ndarray:
    """Order-compressed XOR deltas of 63-bit (hi, lo) pair keys.

    The 64-bit XOR is monotonically compressed to u32 as
    (bit_length << 26) | (top 26 bits below the leading bit), which preserves
    the comparison order except among values sharing their top 26 bits —
    harmless tie-coarsening (any tie-break still yields a valid BVH).
    Result < 0xFFFFFFFF always, keeping the sentinel unreachable.
    """
    dh = key_hi[:-1] ^ key_hi[1:]
    dl = key_lo[:-1] ^ key_lo[1:]

    def clz32(v):
        # count leading zeros via float32 exponent is lossy; use bit smearing.
        v = v | (v >> 1)
        v = v | (v >> 2)
        v = v | (v >> 4)
        v = v | (v >> 8)
        v = v | (v >> 16)
        # popcount of smeared value = bit_length
        v = v - ((v >> 1) & jnp.uint32(0x55555555))
        v = (v & jnp.uint32(0x33333333)) + ((v >> 2) & jnp.uint32(0x33333333))
        v = (v + (v >> 4)) & jnp.uint32(0x0F0F0F0F)
        return (v * jnp.uint32(0x01010101)) >> 24  # = bit_length

    bl_h = clz32(dh)
    bl_l = clz32(dl)
    bitlen = jnp.where(dh != 0, bl_h + 32, bl_l)
    # Extract top 26 bits below the implicit leading bit.
    shift = jnp.maximum(bitlen.astype(jnp.int32) - 27, 0)

    def shr64(h, l, s):
        # (h, l) >> s for s in [0, 63], returning low u32 of the result.
        s = s.astype(jnp.uint32)
        lo_part = jnp.where(s >= 32, h >> (s - 32), (l >> s) | jnp.where(s > 0, h << (32 - s), jnp.uint32(0)))
        return lo_part

    mant = shr64(dh, dl, shift) & jnp.uint32((1 << 26) - 1)
    return (bitlen.astype(jnp.uint32) << 26) | mant


def euclidean_deltas(prims, centroid: CentroidFn) -> jnp.ndarray:
    """Squared centroid distance between adjacent primitives.

    Ref: functors/albvh.h:52-85 (DeltaEuclidean). The reference's functor
    computes centroids then subtracts the raw .x/.y/.z members — equivalent
    for spheres; we use the centroid callable uniformly, which also fixes the
    behavior for non-sphere primitives.
    """
    c = centroid(prims)
    diff = c[:-1] - c[1:]
    return jnp.sum(diff * diff, axis=-1).astype(jnp.float32)


def surface_area_deltas(prims, aabb: AabbFn) -> jnp.ndarray:
    """Half-surface-area of the union AABB of adjacent primitives.

    Ref: functors/albvh.h:88-126 (DeltaSurfaceArea):
    SA = Lx*Ly + Lx*Lz + Ly*Lz of the merged box.
    """
    mins, maxs = aabb(prims)
    u_min = jnp.minimum(mins[:-1], mins[1:])
    u_max = jnp.maximum(maxs[:-1], maxs[1:])
    ext = u_max - u_min
    return (
        ext[:, 0] * ext[:, 1] + ext[:, 0] * ext[:, 2] + ext[:, 1] * ext[:, 2]
    ).astype(jnp.float32)


def delta_max_sentinel(dtype) -> jnp.ndarray:
    """The out-of-range boundary value for a delta dtype."""
    dtype = jnp.dtype(dtype)
    if dtype == jnp.uint32:
        return jnp.uint32(0xFFFFFFFF)
    if dtype in (jnp.float32, jnp.float64):
        return jnp.asarray(jnp.inf, dtype)
    raise TypeError(f"unsupported delta dtype {dtype}")
