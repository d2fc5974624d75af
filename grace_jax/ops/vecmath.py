"""Vector math helpers (analog of ref include/grace/generic/vecmath.h:9-49).

These operate on [..., 3] arrays rather than float3 structs; the final
axis vectorizes over components and everything broadcasts over leading axes.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot3(a, b):
    """Dot product over the last axis (ref: vecmath.h dot3)."""
    return jnp.sum(jnp.asarray(a) * jnp.asarray(b), axis=-1)


def cross(a, b):
    """3D cross product over the last axis (ref: vecmath.h cross)."""
    return jnp.cross(jnp.asarray(a), jnp.asarray(b))


def norm3(a):
    return jnp.sqrt(dot3(a, a))


def normalize3(a):
    """Normalize over the last axis (ref: vecmath.h normalize3)."""
    a = jnp.asarray(a)
    inv = jnp.float32(1.0) / norm3(a)
    return a * inv[..., None]


def sgn(x):
    """Sign in {-1, 0, 1} (ref: generic/bits.h:12-15)."""
    x = jnp.asarray(x)
    return (x > 0).astype(jnp.int32) - (x < 0).astype(jnp.int32)
