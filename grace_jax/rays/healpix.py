"""HEALPix NESTED pixel-center ray vectors.

Analog of the reference's standalone HEALPix ray-vector generator
(ref: RayVectorGeneration/src/generateRays.c:44-110 + vendored chealpix
pix2vec_nest). Re-implemented as vectorized jnp integer/float math — the
nested scheme is bit de-interleaving onto the 12 base faces followed by the
standard ring geometry. Valid for nside a power of two up to 8192 (int32).

``healpix_rays`` mirrors generateRays.c: 12 * nside^2 isotropically
distributed unit vectors, optionally rotated by a uniformly random rotation
(the reference applies a random 3-axis rotation matrix, :70-96).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from grace_jax.core.types import Rays

_JRLL = jnp.asarray([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4], jnp.int32)
_JPLL = jnp.asarray([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7], jnp.int32)


def _compact_bits(v):
    """Inverse of bit spreading by one: keep even bits -> low half."""
    v = v & jnp.uint32(0x55555555)
    v = (v | (v >> 1)) & jnp.uint32(0x33333333)
    v = (v | (v >> 2)) & jnp.uint32(0x0F0F0F0F)
    v = (v | (v >> 4)) & jnp.uint32(0x00FF00FF)
    v = (v | (v >> 8)) & jnp.uint32(0x0000FFFF)
    return v


def pix2vec_nest(nside: int, ipix) -> jnp.ndarray:
    """Unit vectors of NESTED-scheme pixel centers; ipix: i32[N] -> f32[N, 3]."""
    if nside & (nside - 1) or nside <= 0 or nside > 8192:
        raise ValueError("nside must be a power of two in [1, 8192]")
    ipix = jnp.asarray(ipix, jnp.uint32)
    npface = jnp.uint32(nside * nside)
    face = (ipix // npface).astype(jnp.int32)
    pf = ipix % npface
    x = _compact_bits(pf).astype(jnp.int32)
    y = _compact_bits(pf >> 1).astype(jnp.int32)

    jr = _JRLL[face] * nside - x - y - 1
    north = jr < nside
    south = jr > 3 * nside
    nr = jnp.where(north, jr, jnp.where(south, 4 * nside - jr, nside))
    fnr = nr.astype(jnp.float32)
    z_pole = 1.0 - fnr * fnr / (3.0 * nside * nside)
    z = jnp.where(
        north,
        z_pole,
        jnp.where(south, -z_pole, (2.0 * nside - jr) * (2.0 / (3.0 * nside))),
    )
    kshift = jnp.where(north | south, 0, (jr - nside) & 1)

    jp = (_JPLL[face] * nr + x - y + 1 + kshift) // 2
    jp = jnp.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = jnp.where(jp < 1, jp + 4 * nr, jp)
    phi = (jp.astype(jnp.float32) - (kshift.astype(jnp.float32) + 1.0) * 0.5) * (
        jnp.float32(jnp.pi / 2) / fnr
    )
    st = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), z], axis=-1)


def random_rotation_matrix(key) -> jnp.ndarray:
    """Uniform random rotation (the reference composes random rotations about
    the three axes, generateRays.c:70-96; we draw a uniform quaternion)."""
    q = jax.random.normal(key, (4,), jnp.float32)
    q = q / jnp.sqrt(jnp.sum(q * q))
    w, xq, yq, zq = q
    return jnp.asarray(
        [
            [1 - 2 * (yq * yq + zq * zq), 2 * (xq * yq - zq * w), 2 * (xq * zq + yq * w)],
            [2 * (xq * yq + zq * w), 1 - 2 * (xq * xq + zq * zq), 2 * (yq * zq - xq * w)],
            [2 * (xq * zq - yq * w), 2 * (yq * zq + xq * w), 1 - 2 * (xq * xq + yq * yq)],
        ],
        dtype=jnp.float32,
    )


def healpix_rays(key, nside: int, origin, length, rotate: bool = True) -> Rays:
    """12 * nside^2 rays along NESTED pixel-center directions from one origin."""
    n = 12 * nside * nside
    vec = pix2vec_nest(nside, jnp.arange(n, dtype=jnp.uint32))
    if rotate:
        rot = random_rotation_matrix(key)
        vec = vec @ rot.T
    origins = jnp.broadcast_to(jnp.asarray(origin, jnp.float32), (n, 3))
    lengths = jnp.full((n,), length, jnp.float32)
    return Rays(origins, vec, lengths)
