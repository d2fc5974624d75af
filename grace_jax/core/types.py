"""Core types for grace_jax.

Re-design of the reference's core types:
  - ``Ray`` (ref: include/grace/ray.h:5-10) becomes a structure-of-arrays
    pytree ``Rays`` — every operation runs on batches of rays, and the SoA
    layout gives coalesced, vectorized component access, unlike the
    array-of-structs float-7 ``Ray`` that suits CUDA's per-thread model.
  - ``Octants`` / ``RaySortType`` enums (ref: include/grace/types.h:29-51).

A single logical ray r is (origin[r], direction[r], length[r]); direction is
always normalized (the reference documents the same invariant).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


class Octants(enum.IntEnum):
    """Octant encoding; bit 2 = +x, bit 1 = +y, bit 0 = +z.

    Mirrors the reference's PPP..MMM bit encoding (ref: types.h:36-45),
    where P(lus) sets the bit and M(inus) clears it.
    """

    MMM = 0
    MMP = 1
    MPM = 2
    MPP = 3
    PMM = 4
    PMP = 5
    PPM = 6
    PPP = 7


class RaySortType(enum.IntEnum):
    """Ray-coherence sorting strategies (ref: types.h:47-51)."""

    NoSort = 0
    DirectionSort = 1
    EndPointSort = 2


@jax.tree_util.register_pytree_node_class
@dataclass
class Rays:
    """Batch of rays in SoA layout.

    Attributes:
      origins:    f32[R, 3] ray origins.
      directions: f32[R, 3] normalized ray directions.
      lengths:    f32[R]    maximum parametric distance along each ray.
    """

    origins: jax.Array
    directions: jax.Array
    lengths: jax.Array

    @property
    def n_rays(self) -> int:
        return self.origins.shape[0]

    def tree_flatten(self):
        return (self.origins, self.directions, self.lengths), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_arrays(cls, origins, directions, lengths) -> "Rays":
        origins = jnp.asarray(origins, jnp.float32)
        directions = jnp.asarray(directions, jnp.float32)
        lengths = jnp.asarray(lengths, jnp.float32)
        return cls(origins, directions, lengths)

    def __getitem__(self, idx) -> "Rays":
        return Rays(self.origins[idx], self.directions[idx], self.lengths[idx])


def make_spheres(xyz, h) -> jax.Array:
    """Pack sphere/SPH-particle data as f32[N, 4] = (x, y, z, h).

    Matches the reference convention of float4 spheres with w = radius /
    smoothing length (ref: build_sph.cuh:13-16 comment, trace functors use
    ``sphere.w`` as h).
    """
    xyz = jnp.asarray(xyz, jnp.float32)
    h = jnp.asarray(h, jnp.float32)
    return jnp.concatenate([xyz, h[:, None]], axis=1)


def octant_signs(octant: int) -> np.ndarray:
    """(sx, sy, sz) in {-1, +1} for an Octants value (ref: gen_rays.cuh:175-179)."""
    o = int(octant)
    return np.array(
        [1.0 if (o & 4) else -1.0, 1.0 if (o & 2) else -1.0, 1.0 if (o & 1) else -1.0],
        dtype=np.float32,
    )
