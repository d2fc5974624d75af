"""Per-hit record facades (ref: trace_sph.cuh:57-241) through the XLA
engine, against a numpy brute-force oracle: counts exactly, per-ray hit
index SETS exactly (within-ray order is not a contract before
sort_by_distance), and payloads to the integral table's tolerance."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from grace_jax.build.sph import build_sph_tree
from grace_jax.core.types import Rays, make_spheres
from grace_jax.ops.segops import sort_by_distance
from grace_jax.sph.kernel_integrals import cubic_spline_line_integral
from grace_jax.trace.sph import (
    trace_hitcounts_sph,
    trace_sph,
    trace_with_sentinels_sph,
)


def setup(rng, n=600, r=96):
    spheres = make_spheres(
        rng.random((n, 3)).astype(np.float32),
        (0.05 + 0.08 * rng.random(n)).astype(np.float32),
    )
    ss, tree, _ = jax.jit(build_sph_tree, static_argnums=1)(spheres, 8)
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(
        jnp.asarray(rng.random((r, 3)).astype(np.float32) * 0.2 - 0.2),
        jnp.asarray(d),
        jnp.full((r,), 3.0, jnp.float32),
    )
    return ss, tree, rays


def oracle(rays, ss):
    """numpy brute force: hit mask, along-ray distance, kernel integral."""
    s = np.asarray(ss, np.float64)
    o = np.asarray(rays.origins, np.float64)
    d = np.asarray(rays.directions, np.float64)
    ln = np.asarray(rays.lengths, np.float64)
    p = s[None, :, :3] - o[:, None, :]
    t = (p * d[:, None, :]).sum(-1)
    b = p - t[..., None] * d[:, None, :]
    b2 = (b * b).sum(-1)
    hit = (b2 < s[None, :, 3] ** 2) & (t >= 0) & (t < ln[:, None])
    beta = np.sqrt(b2) / s[None, :, 3]
    integ = np.asarray(cubic_spline_line_integral(
        jnp.asarray(np.minimum(beta, 1.0), jnp.float32))) / s[None, :, 3] ** 2
    return hit, t, integ


def test_hitcounts_match_numpy_oracle(rng):
    ss, tree, rays = setup(rng)
    hit, _, _ = oracle(rays, ss)
    counts = np.asarray(trace_hitcounts_sph(rays, ss, tree))
    assert np.array_equal(counts, hit.sum(1)) and counts.sum() > 0


@pytest.mark.parametrize("sentinels", [False, True])
def test_records_match_numpy_oracle(rng, sentinels):
    ss, tree, rays = setup(rng)
    hit, t, integ = oracle(rays, ss)
    fn = trace_with_sentinels_sph if sentinels else trace_sph
    res = fn(rays, ss, tree, capacity=8192)
    counts = np.asarray(res.counts)
    off = np.asarray(res.offsets)
    idx, val, dist = map(np.asarray, (res.indices, res.integrals, res.distances))
    assert np.array_equal(counts, hit.sum(1))
    assert int(res.total_hits) == counts.sum() + (len(counts) if sentinels else 0)
    for r in range(rays.n_rays):
        seg = slice(off[r], off[r] + counts[r])
        want = np.nonzero(hit[r])[0]
        assert np.array_equal(np.sort(idx[seg]), want)
        order = np.argsort(idx[seg])
        np.testing.assert_allclose(dist[seg][order], t[r, want], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(val[seg][order], integ[r, want],
                                   rtol=2e-3, atol=1e-3 * integ.max())
        if sentinels:
            end = off[r] + counts[r]
            assert idx[end] == -1 and dist[end] == -1.0 and val[end] == 0.0


def test_records_overflow_is_reported(rng):
    ss, tree, rays = setup(rng)
    res = trace_sph(rays, ss, tree, capacity=16)
    assert int(res.total_hits) > 16


def test_records_sorted_by_distance(rng):
    """trace_sph + the segmented distance sort: per-ray distances
    non-decreasing, each ray's hit set unchanged."""
    ss, tree, rays = setup(rng)
    res = trace_sph(rays, ss, tree, capacity=8192)
    dist_s, idx_s = sort_by_distance(res.distances, res.offsets, res.indices,
                                     total_hits=res.total_hits)
    dist_s, idx_s = np.asarray(dist_s), np.asarray(idx_s)
    off, cnt = np.asarray(res.offsets), np.asarray(res.counts)
    idx = np.asarray(res.indices)
    for r in range(rays.n_rays):
        seg = slice(off[r], off[r] + cnt[r])
        assert np.all(np.diff(dist_s[seg]) >= 0)
        assert np.array_equal(np.sort(idx_s[seg]), np.sort(idx[seg]))
