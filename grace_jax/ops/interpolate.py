"""Table interpolation (analog of ref include/grace/generic/interpolate.h:10-39).

``lerp`` linearly interpolates a lookup table at fractional index x in
[0, N_table); out-of-range x clamps to the last entry, exactly as the
reference does. The fused form ``y = t * (y1 - y0) + y0`` matches the
reference's Sterbenz-lemma FMA form (interpolate.h:26-38); XLA emits an FMA
for it.
"""

from __future__ import annotations

import jax.numpy as jnp


def lerp(x, table) -> jnp.ndarray:
    """Interpolate ``table`` (f32[N]) at fractional indices ``x`` (f32[...]).

    Requires x >= 0; x >= N-1 clamps to table[N-1] (ref: interpolate.h:14-18).
    """
    table = jnp.asarray(table)
    n = table.shape[0]
    x = jnp.asarray(x)
    idx = jnp.clip(x.astype(jnp.int32), 0, n - 2)
    xc = jnp.minimum(x, jnp.asarray(n - 1, x.dtype))
    y0 = table[idx]
    y1 = table[idx + 1]
    t = xc - idx.astype(x.dtype)
    return t * (y1 - y0) + y0
