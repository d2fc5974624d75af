"""Morton (Z-order) key generation.

Re-implementation of the reference's Morton machinery:
  * bit-spreading (ref: include/grace/generic/bits.h:24-46)
  * 30-bit and 63-bit key composition (ref: include/grace/generic/morton.h:14-55)
  * centroid quantization against a scene AABB
    (ref: include/grace/cuda/kernels/morton.cuh:30-55, 95-116)

Everything is vectorized jnp over whole arrays (the CUDA grid-stride loop has
no analog — XLA fuses the elementwise chain into one pass).

63-bit keys: jax defaults to 32-bit integers, so 63-bit keys are represented as a (hi, lo) pair of uint32 arrays
ordered lexicographically — ``jax.lax.sort`` sorts multi-operand keys
lexicographically, which makes (hi, lo) a drop-in radix-sort key.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

MORTON30_SPAN = (1 << 10) - 1  # 10 bits per axis (ref: morton.h:36)
MORTON63_SPAN = (1 << 21) - 1  # 21 bits per axis (ref: morton.h:49)


def space_by_two_10bit(x) -> jnp.ndarray:
    """Spread the low 10 bits of x so bit k moves to bit 3k (u32 result).

    Same mask ladder as ref bits.h:24-33 (there is essentially one canonical
    way to write this).
    """
    x = jnp.asarray(x).astype(jnp.uint32) & jnp.uint32((1 << 10) - 1)
    x = (x | (x << 16)) & jnp.uint32(0x030000FF)
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def space_by_two_21bit(x) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Spread the low 21 bits of x so bit k moves to bit 3k.

    Returns the 63-bit result as a (hi, lo) pair of uint32 (bits 32.. / 0..31).
    Matches ref bits.h:35-46 up to the two-word representation: source bits
    0..10 land in bits 0..30 (lo word); source bits 11..20 land in bits
    33..60, i.e. ``space_by_two(x >> 11) << 1`` in the hi word.
    """
    x = jnp.asarray(x).astype(jnp.uint32) & jnp.uint32((1 << 21) - 1)
    lo = space_by_two_10bit(x & jnp.uint32(0x7FF))  # low 11 bits -> bits 0..30
    # space_by_two_10bit masks to 10 bits; handle bit 10 of the low half
    # explicitly: source bit 10 -> bit 30 (still in lo).
    lo = lo | (((x >> 10) & jnp.uint32(1)) << 30)
    hi = space_by_two_10bit(x >> 11) << 1
    return hi, lo


def _shift_left_pair(hi, lo, s: int):
    return (hi << s) | (lo >> (32 - s)), lo << s


def morton_key_30bit(ux, uy, uz) -> jnp.ndarray:
    """30-bit key: interleaved (z, y, x) with x least significant.

    (ref: morton.h:14-20 — key = sz<<2 | sy<<1 | sx)
    """
    return (
        (space_by_two_10bit(uz) << 2)
        | (space_by_two_10bit(uy) << 1)
        | space_by_two_10bit(ux)
    )


def morton_key_63bit(ux, uy, uz) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """63-bit key as a (hi, lo) uint32 pair (ref: morton.h:23-30)."""
    zh, zl = space_by_two_21bit(uz)
    yh, yl = space_by_two_21bit(uy)
    xh, xl = space_by_two_21bit(ux)
    zh, zl = _shift_left_pair(zh, zl, 2)
    yh, yl = _shift_left_pair(yh, yl, 1)
    return zh | yh | xh, zl | yl | xl


def morton_key_30bit_from_unit(x, y, z) -> jnp.ndarray:
    """30-bit key from floats in (0, 1) (ref: morton.h:32-43)."""
    span = jnp.float32(MORTON30_SPAN)
    to_u = lambda v: (span * jnp.asarray(v, jnp.float32)).astype(jnp.uint32)
    return morton_key_30bit(to_u(x), to_u(y), to_u(z))


def morton_key_63bit_from_unit(x, y, z) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """63-bit key from floats in (0, 1) (ref: morton.h:45-55)."""
    span = jnp.float32(MORTON63_SPAN)
    to_u = lambda v: (span * jnp.asarray(v, jnp.float32)).astype(jnp.uint32)
    return morton_key_63bit(to_u(x), to_u(y), to_u(z))


def morton_keys_from_centroids(centroids, aabb_min, aabb_max, bits: int = 30):
    """Quantize centroids into the scene AABB and compose Morton keys.

    Mirrors ref morton.cuh:30-55 + 95-116: per-axis
    ``u = cast<uint>(span / (top - bot) * (c - bot))``.

    Args:
      centroids: f32[N, 3]
      aabb_min, aabb_max: f32[3]
      bits: 30 or 63.

    Returns:
      u32[N] for 30-bit keys, or a (hi, lo) pair of u32[N] for 63-bit keys.
    """
    centroids = jnp.asarray(centroids, jnp.float32)
    aabb_min = jnp.asarray(aabb_min, jnp.float32)
    aabb_max = jnp.asarray(aabb_max, jnp.float32)
    span = jnp.float32(MORTON30_SPAN if bits == 30 else MORTON63_SPAN)
    scale = span / (aabb_max - aabb_min)
    u = (scale * (centroids - aabb_min)).astype(jnp.uint32)
    if bits == 30:
        return morton_key_30bit(u[:, 0], u[:, 1], u[:, 2])
    elif bits == 63:
        return morton_key_63bit(u[:, 0], u[:, 1], u[:, 2])
    raise ValueError(f"bits must be 30 or 63, got {bits}")
