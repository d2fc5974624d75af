"""Monte-Carlo hypothesis / confidence-band machinery tests
(ref analogs: tests/isotropic_ray_stats/hypothesis.py __main__ checks and
ripley_confidence_band.py). Validation is against INDEPENDENT oracles:
scipy for the classical tests, brute-force counting for the MC
machinery, and behavioral accept/reject for the band."""

import numpy as np
import jax
import pytest
from scipy import stats as sstat

from grace_jax.rays.hypothesis import (
    DEFAULT_SCALES,
    equivalence_test,
    isotropic_directions,
    mc_limits,
    mc_p_value,
    noninferiority_test,
    nonnormal_equivalence_test,
    nonnormal_noninferiority_test,
    ripley_csr_band,
    ripley_isotropy_test,
)


def test_mc_p_value_plus_one_convention():
    s = np.arange(9, dtype=float)          # 0..8, N=9
    # x = 4: 4 samples >= 4... wait 4,5,6,7,8 -> 5; p = (5+1)/10
    assert mc_p_value(s, 4.0, "upper") == (5 + 1) / 10
    assert mc_p_value(s, 4.0, "lower") == (5 + 1) / 10
    # beyond both extremes: never zero
    assert mc_p_value(s, 100.0, "upper") == 1 / 10
    assert mc_p_value(s, -100.0, "lower") == 1 / 10
    with pytest.raises(ValueError):
        mc_p_value(s, 0.0, "sideways")


def test_mc_limits_exact_order_statistics():
    s = np.arange(1, 100, dtype=float)     # 1..99, n=99
    lo, up = mc_limits(s, confidence=0.95)
    # alpha = 0.05, n+1 = 100: need count(>= U) + 1 <= 5
    assert up == 96.0 and mc_p_value(s, up, "upper") <= 0.05
    assert lo == 4.0 and mc_p_value(s, lo, "lower") <= 0.05
    # one step tighter fails
    assert mc_p_value(s, 95.0, "upper") > 0.05
    assert mc_p_value(s, 5.0, "lower") > 0.05
    # with heavy ties the limits stay valid
    st = np.repeat([0.0, 1.0, 2.0], 33)
    lo_t, up_t = mc_limits(st, 0.95)
    assert mc_p_value(st, up_t, "upper") <= 0.05 or up_t == st.max()


def test_equivalence_test_vs_scipy_welch():
    rng = np.random.default_rng(1)
    x = rng.normal(10.0, 2.0, 40)
    y = rng.normal(10.1, 2.5, 35)
    reject, low, high = equivalence_test(x, y, 2.0, 2.0, cl=0.95)
    # Welch interval endpoints against scipy's ttest_ind machinery
    res = sstat.ttest_ind(x, y, equal_var=False)
    ci = res.confidence_interval(0.90)     # two-sided 90% == one-sided 95%
    assert np.isclose(min(0, low), min(0, ci.low), rtol=1e-10)
    assert np.isclose(max(0, high), max(0, ci.high), rtol=1e-10)
    assert reject  # means differ by 0.1 << e = 2 at these sizes
    # a 5-sigma shift cannot be declared equivalent
    reject2, *_ = equivalence_test(x, y + 10.0, 2.0, 2.0)
    assert not reject2


def test_noninferiority_directions():
    rng = np.random.default_rng(2)
    x = rng.normal(0.0, 1.0, 50)
    y = x + 5.0                            # x is much SMALLER than y
    ok_larger, *_ = noninferiority_test(x, y, 1.0, inferior="larger")
    assert ok_larger                       # x not larger than y: reject null
    ok_smaller, *_ = noninferiority_test(x, y, 1.0, inferior="smaller")
    assert not ok_smaller                  # x IS much smaller: keep null
    with pytest.raises(ValueError):
        noninferiority_test(x, y, -1.0)


def test_mann_whitney_estimator_vs_scipy():
    rng = np.random.default_rng(3)
    x = rng.normal(0.0, 1.0, 18)
    y = rng.normal(0.3, 1.2, 15)
    _, wxy, sxy, _, _ = nonnormal_noninferiority_test(x, y, 0.1)
    u = sstat.mannwhitneyu(x, y, alternative="two-sided").statistic
    assert np.isclose(wxy, u / (len(x) * len(y)), atol=1e-12)
    assert 0 < sxy < 1


def test_nonnormal_equivalence_behaviour():
    rng = np.random.default_rng(4)
    x = rng.standard_exponential(60)
    reject, *_ = nonnormal_equivalence_test(x, x + 3.0, 0.1, 0.1)
    assert not reject                      # clearly shifted
    # identical distributions with generous indifference: equivalence
    y = rng.standard_exponential(60)
    reject2, wxy, *_ = nonnormal_equivalence_test(x, y, 0.3, 0.3)
    assert reject2 and abs(wxy - 0.5) < 0.15


def test_ripley_band_accepts_isotropic_rejects_biased(rng):
    """The reference's core workflow: build the MC band under isotropy,
    then an isotropic bundle must fall inside it and a deliberately
    anisotropic bundle (directions biased toward a pole, the reference's
    biasedrays.py scenario) must be rejected."""
    n_dirs = 256
    scales = np.array([0.1, 0.5, 1.0, np.pi / 2], np.float32)
    band = ripley_csr_band(jax.random.key(0), n_dirs, scales,
                           n_samples=200, confidence=0.95)
    assert np.all(band.lower <= band.upper)

    iso = np.asarray(isotropic_directions(jax.random.key(123), n_dirs))
    rej_iso, resid, p = ripley_isotropy_test(iso, band)
    # an isotropic draw may graze one scale of a 95% band; require most
    # scales inside and a non-vanishing minimum p-value
    outside = (resid < band.lower) | (resid > band.upper)
    assert outside.sum() <= 1 and p.min() > 1 / 201

    d = np.array(isotropic_directions(jax.random.key(7), n_dirs))
    d[:, 2] = 0.4 + np.abs(d[:, 2])        # bias toward +z
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rej_bias, resid_b, p_b = ripley_isotropy_test(d, band)
    assert rej_bias and p_b.min() <= 0.05

    with pytest.raises(ValueError):
        ripley_isotropy_test(iso[:100], band)


def test_ripley_band_scales_default():
    assert DEFAULT_SCALES[-1] == pytest.approx(np.pi / 2)
    assert np.all(np.diff(DEFAULT_SCALES) > 0)
