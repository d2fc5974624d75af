"""Monte-Carlo hypothesis testing + Ripley-K confidence bands for ray
isotropy (analog of the reference's empirical-distribution
companions, ref: tests/isotropic_ray_stats/hypothesis.py:1-407 and
ripley_confidence_band.py:1-284).

Two layers:

  * Classical two-sample tests for comparing statistic DISTRIBUTIONS
    (normal: Welch-t TOST equivalence + noninferiority; non-normal:
    Mann-Whitney equivalence + noninferiority) — host-side numpy/scipy,
    sample sizes are tiny. The reference's O(m n^2) Mann-Whitney triple
    loops collapse into broadcast indicator tensors.
  * Monte-Carlo machinery for the ON-DEVICE statistics: empirical
    p-values with the +1 convention (a permutation p-value is never 0),
    exact order-statistic confidence limits, and a batched on-device sampler of
    the K(s) - CSR(s) null distribution (the reference farms per-sample
    python K functions to a multiprocessing pool; here each sample is a
    blocked matrix-product pair-sum via statistics.ripley_k_sphere under one jit,
    scanned over PRNG keys).

Where the reference scans a 100-point linspace to find the band limit,
this module returns the exact empirical limit: the extreme sample value
whose +1-convention p-value still clears the significance — same
semantics, no discretization."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from grace_jax.rays.statistics import ripley_k_sphere, ripley_k_uniform

# Default test scales (radians), matching the reference's sweep
# (ripley_confidence_band.py:_test_scales / ripleyk_stats.cu Rs).
DEFAULT_SCALES = np.array(
    [0.005, 0.01, 0.02, 0.03, 0.05, 0.1, 0.2, 0.5, 0.75, 1.0, 1.25,
     np.pi / 2.0], np.float32)


# ---------------------------------------------------------------------------
# Monte-Carlo p-values and empirical confidence limits
# ---------------------------------------------------------------------------

def mc_p_value(samples, x, tail: str = "upper") -> float:
    """Empirical p-value of observing ``x`` against MC ``samples``.

    +1 convention (the observed statistic joins the reference
    distribution), so a Monte-Carlo p-value is never exactly zero
    (ref: ripley_confidence_band.py:p_value and citations therein)."""
    s = np.asarray(samples)
    if tail == "upper":
        count = int(np.sum(s >= x))
    elif tail == "lower":
        count = int(np.sum(s <= x))
    else:
        raise ValueError(f"unknown tail {tail!r}")
    return (count + 1) / (s.size + 1)


def mc_limits(samples, confidence: float = 0.95) -> Tuple[float, float]:
    """Exact empirical (lower, upper) limits: the extreme sample values L, U
    with P(x <= L) <= 1-confidence and P(x >= U) <= 1-confidence under the
    +1 convention. (The reference approximates these with a 100-point
    linspace scan; order statistics give the exact answer.)"""
    s = np.sort(np.asarray(samples).ravel())
    n = s.size
    alpha = 1.0 - confidence
    # Tie-exact per-value p-values over the sorted samples:
    #   upper p of s[i] = (#{x >= s[i]} + 1) / (n + 1)
    #   lower p of s[i] = (#{x <= s[i]} + 1) / (n + 1)
    p_up = (n - np.searchsorted(s, s, side="left") + 1) / (n + 1)
    p_lo = (np.searchsorted(s, s, side="right") + 1) / (n + 1)
    ok_up = np.nonzero(p_up <= alpha)[0]
    ok_lo = np.nonzero(p_lo <= alpha)[0]
    # Falling back to the extreme sample mirrors the reference's "p-value
    # unreliable" regime (too few samples for the requested confidence).
    upper = float(s[ok_up[0]]) if ok_up.size else float(s[-1])
    lower = float(s[ok_lo[-1]]) if ok_lo.size else float(s[0])
    return lower, upper


def isotropic_directions(key, n: int) -> jax.Array:
    """n isotropic unit direction vectors (normalized Gaussian triples)."""
    v = jax.random.normal(key, (n, 3), jnp.float32)
    return v / jnp.linalg.norm(v, axis=1, keepdims=True)


class RipleyBand(NamedTuple):
    """Null-distribution samples + band of K(s) - CSR(s) per scale."""

    scales: np.ndarray     # [S]
    samples: np.ndarray    # [N, S] MC samples of K(s) - CSR(s)
    lower: np.ndarray      # [S]
    upper: np.ndarray      # [S]
    confidence: float
    n_dirs: int


def ripley_csr_band(
    key,
    n_dirs: int,
    scales=DEFAULT_SCALES,
    n_samples: int = 1000,
    confidence: float = 0.95,
) -> RipleyBand:
    """Monte-Carlo confidence band for K(s) - CSR(s) under isotropy.

    Each sample draws ``n_dirs`` isotropic directions and evaluates the
    Ripley K residual at every scale — one jit, `lax.map` over PRNG keys,
    each K a blocked pair-sum (the matrix-product path in
    statistics.ripley_k_sphere).
    Returns every sample (for mc_p_value queries) plus exact empirical
    limits per scale."""
    scales = np.asarray(scales, np.float32)
    csr = ripley_k_uniform(scales)

    @jax.jit
    def all_samples(key):
        keys = jax.random.split(key, n_samples)

        def one(k):
            d = isotropic_directions(k, n_dirs)
            return ripley_k_sphere(d, scales) - csr

        return jax.lax.map(one, keys)

    samples = np.asarray(all_samples(key))          # [N, S]
    lims = np.array([mc_limits(samples[:, j], confidence)
                     for j in range(scales.size)])
    return RipleyBand(scales, samples, lims[:, 0], lims[:, 1],
                      confidence, n_dirs)


def ripley_isotropy_test(directions, band: RipleyBand):
    """Test a direction bundle against a precomputed CSR band.

    Returns (reject: bool, residuals [S], p_values [S]) — ``reject`` is
    True when any scale's K residual falls outside the band (the
    reference's per-scale U/L exceedance check). The bundle size must
    match band.n_dirs (K's variance scales with n)."""
    d = np.asarray(directions)
    if d.shape[0] != band.n_dirs:
        raise ValueError(
            f"bundle has {d.shape[0]} directions, band was built for "
            f"{band.n_dirs} — K variance depends on n")
    resid = np.asarray(ripley_k_sphere(jnp.asarray(d), band.scales)
                       - ripley_k_uniform(band.scales))
    p = np.array([min(mc_p_value(band.samples[:, j], resid[j], "upper"),
                      mc_p_value(band.samples[:, j], resid[j], "lower"))
                  for j in range(band.scales.size)])
    outside = (resid < band.lower) | (resid > band.upper)
    return bool(outside.any()), resid, p


# ---------------------------------------------------------------------------
# Two-sample hypothesis tests (normal: Welch-t; non-normal: Mann-Whitney)
# ---------------------------------------------------------------------------

def _welch_interval(x, y, cl: float):
    """Welch-t confidence interval [low, high] for mean(x) - mean(y), with
    the Berger-Hsu 0-clamp for strict type-I conformance in TOST use
    (ref: hypothesis.py:_mean_diff_confidence_interval)."""
    from scipy import stats as sstat

    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    nx, ny = x.size, y.size
    s2x = np.var(x, ddof=1)
    s2y = np.var(y, ddof=1)
    se = np.sqrt(s2x / nx + s2y / ny)
    num = (s2x / nx + s2y / ny) ** 2
    den = s2x ** 2 / (nx ** 2 * (nx - 1)) + s2y ** 2 / (ny ** 2 * (ny - 1))
    if den == 0.0:
        raise ValueError("zero variance in both samples")
    dof = num / den
    t = sstat.t.ppf(cl, df=dof)
    diff = np.mean(x) - np.mean(y)
    return min(0.0, diff - t * se), max(0.0, diff + t * se)


def equivalence_test(x, y, e1: float, e2: float, cl: float = 0.95):
    """TOST equivalence for normal samples: reject "different" iff the
    (100*cl)% Welch interval for mean(x)-mean(y) lies inside (-e1, e2).
    Returns (reject, low, high)."""
    if e1 < 0 or e2 < 0:
        raise ValueError("e1 and e2 must be non-negative")
    if not 0.0 < cl < 1.0:
        raise ValueError("cl must lie in (0, 1)")
    low, high = _welch_interval(x, y, cl)
    return (low > -e1 and high < e2), low, high


def noninferiority_test(x, y, e: float, cl: float = 0.95,
                        inferior: str = "larger"):
    """One-sided noninferiority for normal samples. inferior='larger'
    rejects when x is not significantly larger than y (high < e);
    'smaller' when not significantly smaller (low > -e).
    Returns (reject, low, high)."""
    if e < 0:
        raise ValueError("e must be non-negative")
    if not 0.0 < cl < 1.0:
        raise ValueError("cl must lie in (0, 1)")
    if inferior not in ("larger", "smaller"):
        raise ValueError("inferior must be 'larger' or 'smaller'")
    low, high = _welch_interval(x, y, cl)
    reject = high < e if inferior == "larger" else low > -e
    return reject, low, high


def _mann_whitney_moments(x, y):
    """Mann-Whitney estimator wxy of P[X > Y] and the variance estimator's
    square root — the reference's O(m n^2) indicator loops as three
    broadcast reductions."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    m, n = x.size, y.size
    ind = 0.5 * (np.sign(x[:, None] - y[None, :]) + 1.0)   # [m, n]
    ind = np.floor(ind)  # indicator as int (sign ties -> 0.5 -> 0)
    wxy = ind.sum() / (m * n)

    # wxxy: P[min(X1, X2) > Y] over unordered pairs i1 < i2
    xmin = np.minimum(x[:, None], x[None, :])              # [m, m]
    indm = np.floor(0.5 * (np.sign(xmin[:, :, None] - y[None, None, :]) + 1))
    iu = np.triu_indices(m, k=1)
    wxxy = indm[iu].sum() * 2.0 / (m * (m - 1) * n)

    # wxyy: P[X > max(Y1, Y2)] over unordered pairs j1 < j2
    ymax = np.maximum(y[:, None], y[None, :])              # [n, n]
    indn = np.floor(0.5 * (np.sign(x[:, None, None] - ymax[None, :, :]) + 1))
    ju = np.triu_indices(n, k=1)
    wxyy = indn[:, ju[0], ju[1]].sum() * 2.0 / (n * (n - 1) * m)

    s2 = (wxy - (m + n - 1) * wxy ** 2 + (m - 1) * wxxy
          + (n - 1) * wxyy) / (m * n)
    return wxy, np.sqrt(s2)


def nonnormal_equivalence_test(x, y, e1: float = 0.1, e2: float = 0.1,
                               cl: float = 0.95):
    """Mann-Whitney (Wellek) equivalence test for non-normal samples.
    Returns (reject, wxy, sxy, test_stat, critical)."""
    from scipy import stats as sstat

    if e1 < 0 or e2 < 0:
        raise ValueError("e1 and e2 must be non-negative")
    if not 0.0 < cl < 1.0:
        raise ValueError("cl must lie in (0, 1)")
    wxy, sxy = _mann_whitney_moments(x, y)
    rootnc = (e1 + e2) / (2.0 * sxy)
    crit = np.sqrt(sstat.ncx2.ppf(1 - cl, 1, rootnc * rootnc))
    delta = 0.5 + (e2 - e1) / 2.0
    stat = abs(wxy - delta) / sxy
    return bool(stat < crit), wxy, sxy, stat, crit


def nonnormal_noninferiority_test(x, y, e: float = 0.1, cl: float = 0.95,
                                  inferior: str = "larger"):
    """Mann-Whitney noninferiority test. Returns
    (reject, wxy, sxy, test_stat, critical)."""
    from scipy import stats as sstat

    if e < 0:
        raise ValueError("e must be non-negative")
    if not 0.0 < cl < 1.0:
        raise ValueError("cl must lie in (0, 1)")
    if inferior not in ("larger", "smaller"):
        raise ValueError("inferior must be 'larger' or 'smaller'")
    wxy, sxy = _mann_whitney_moments(x, y)
    crit = sstat.norm.ppf(cl)
    if inferior == "larger":
        stat = ((0.5 + e) - wxy) / sxy
    else:
        stat = (wxy - (0.5 - e)) / sxy
    return bool(stat > crit), wxy, sxy, stat, crit
