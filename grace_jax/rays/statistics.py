"""Spherical-uniformity statistics for ray directions.

Analog of ref tests/isotropic_ray_stats/ (statistics.cu:24-64, math in
isotropic_stats.md:1-109): Rayleigh z, Beran An, Gine Gn and Fn = An + Gn,
plus critical values from Keilson et al. (1983) / chi-squared(3).

The reference computes the O(n^2) pairwise angle sums with a CUDA kernel per
row; here the pair sums are a blocked jnp computation (each block a dense
[B, n] dot-product matrix — a matrix product), summed in f64-on-host ordering
only at the final reduction (f32 pairwise-tree sums are adequate for the
test sizes used).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

# Critical values (ref: isotropic_stats.md): reject uniformity when exceeded.
RAYLEIGH_Z_CRIT = {0.05: 7.815, 0.01: 11.35}          # chi^2, 3 dof
BERAN_AN_CRIT = {0.2: 1.414, 0.05: 2.207, 0.01: 3.090}
GINE_GN_CRIT = {0.2: 0.646, 0.05: 0.884, 0.01: 1.135}
GINE_FN_CRIT = {0.2: 1.948, 0.05: 2.748, 0.01: 3.633}


def rayleigh_z(directions) -> jnp.ndarray:
    """z = p R^2 / n with R the resultant length (ref: isotropic_stats.md)."""
    d = jnp.asarray(directions)
    n = d.shape[0]
    s = jnp.sum(d, axis=0)
    r2 = jnp.sum(s * s)
    return 3.0 * r2 / n


def _pair_sums(directions, block: int = 512):
    """(sum of psi_ij, sum of sin psi_ij) over ordered pairs i != j."""
    d = jnp.asarray(directions, jnp.float32)
    n = d.shape[0]
    pad = (-n) % block
    dp = jnp.pad(d, ((0, pad), (0, 0)))
    valid = jnp.pad(jnp.ones((n,), jnp.float32), ((0, pad),))

    def per_block(args):
        rows, vrow = args
        dots = jnp.clip(rows @ d.T, -1.0, 1.0)          # [B, n]
        psi = jnp.arccos(dots)
        w = vrow[:, None]
        return jnp.sum(psi * w), jnp.sum(jnp.sin(psi) * w)

    rows = dp.reshape(-1, block, 3)
    vals = valid.reshape(-1, block)
    psi_s, sin_s = jax.lax.map(per_block, (rows, vals))
    # Diagonal terms contribute psi = 0, sin = 0 exactly; no correction needed.
    return jnp.sum(psi_s), jnp.sum(sin_s)


def beran_gine_statistics(directions) -> Dict[str, jnp.ndarray]:
    """An (asymmetric alternatives), Gn (symmetric), Fn = An + Gn
    (ref: statistics.cu An_Gn_statistics)."""
    d = jnp.asarray(directions)
    n = d.shape[0]
    psi_sum, sin_sum = _pair_sums(d)
    # _pair_sums covers the full ordered matrix (diagonal terms are exactly
    # zero); the statistics are defined over unordered pairs i < j.
    psi_sum = psi_sum * 0.5
    sin_sum = sin_sum * 0.5
    coeff = 4.0 / (n * jnp.pi)
    an = n - coeff * psi_sum
    gn = n / 2.0 - coeff * sin_sum
    return {"An": an, "Gn": gn, "Fn": an + gn}


def ripley_k_sphere(directions, angles) -> jnp.ndarray:
    """Ripley's K on the sphere (ref: isotropic_ray_stats/ripleyk_stats.cu):
    K(psi) = (mean number of other points within angular distance psi of a
    point) normalized by the point density n / (4 pi). Under uniformity
    K(psi) = 2 pi (1 - cos psi); returned as the empirical K per angle.
    """
    d = jnp.asarray(directions, jnp.float32)
    n = d.shape[0]
    angles = jnp.asarray(angles, jnp.float32)
    cos_th = jnp.cos(angles)

    def per_block(rows):
        dots = jnp.clip(rows @ d.T, -1.0, 1.0)           # [B, n]
        # counts within each angle (excluding self via the dots == 1 diag —
        # subtract 1 per row below)
        return jnp.sum(dots[..., None] >= cos_th[None, None, :], axis=(0, 1))

    block = 256
    pad = (-n) % block
    dp = jnp.pad(d, ((0, pad), (0, 0)))
    counts = jnp.sum(
        jax.lax.map(per_block, dp.reshape(-1, block, 3)), axis=0
    ).astype(jnp.float32)
    # Remove self-pairs (each true row counts itself at every angle) and the
    # padded zero-rows (dot 0 passes the threshold whenever cos psi <= 0).
    counts = counts - n
    if pad:
        counts = counts - pad * n * (cos_th <= 0.0)
    density = n / (4.0 * jnp.pi)
    return counts / (n * density)


def ripley_k_uniform(angles) -> jnp.ndarray:
    """Expected K under uniformity: 2 pi (1 - cos psi)."""
    a = jnp.asarray(angles, jnp.float32)
    return 2.0 * jnp.pi * (1.0 - jnp.cos(a))


def uniformity_report(directions) -> Dict[str, float]:
    stats = {"z": float(rayleigh_z(directions))}
    bg = beran_gine_statistics(directions)
    stats.update({k: float(v) for k, v in bg.items()})
    return stats
