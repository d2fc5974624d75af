"""Component-wise extrema reductions (analog of ref cuda/util/extrema.cuh:190-767).

The reference provides min/max reductions over x/y/z/w components of vec2/3/4
arrays via Thrust. A single ``jnp.min``/``jnp.max`` over axis 0 XLA-
compiles to a tree reduction, so the whole 774-line family reduces
to a few wrappers kept for API parity.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def min_vec(points) -> jnp.ndarray:
    """Component-wise minimum over axis 0 of f32[N, C] (C = 2, 3 or 4)."""
    return jnp.min(points, axis=0)


def max_vec(points) -> jnp.ndarray:
    """Component-wise maximum over axis 0 of f32[N, C]."""
    return jnp.max(points, axis=0)


def min_max(points) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(min, max) pair over axis 0 (ref: extrema.cuh min_max)."""
    return jnp.min(points, axis=0), jnp.max(points, axis=0)


def min_max_component(points, component: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(min, max) of one component (ref: extrema.cuh min_max_{x,y,z,w})."""
    col = points[:, component]
    return jnp.min(col), jnp.max(col)
