"""Seeded synthetic SPH scenes (no snapshot file is needed to run)."""

from __future__ import annotations

import numpy as np


def make_clustered_particles(rng: np.random.Generator, n: int) -> np.ndarray:
    """Gadget-like clustered distribution in the unit box: 256 Gaussian
    clumps of width 0.02-0.07, smoothing lengths in [0.005, 0.015).
    Returns f32[n, 4] spheres (x, y, z, h)."""
    n_clumps = 256
    centers = rng.random((n_clumps, 3)).astype(np.float32)
    assign = rng.integers(0, n_clumps, n)
    scale = 0.02 + 0.05 * rng.random((n_clumps, 1)).astype(np.float32)
    pos = centers[assign] + rng.standard_normal((n, 3)).astype(np.float32) * scale[assign]
    pos = np.clip(pos, 0.0, 1.0)
    h = (0.005 + 0.01 * rng.random(n)).astype(np.float32)
    return np.concatenate([pos, h[:, None]], axis=1).astype(np.float32)
