"""Segmented scan vs an independent reference — analog of
ref tests/segmented_scan/segmented_scan.cu:64-258 (grace scan vs
thrust::exclusive_scan_by_key on random CSR segments incl. empty ones)."""

import numpy as np
import jax.numpy as jnp

from grace_jax.ops.segops import (
    exclusive_segmented_scan,
    offsets_to_segments,
    sort_by_distance,
    weighted_exclusive_segmented_scan,
)


def np_exclusive_scan_by_segments(offsets, values):
    out = np.zeros_like(values)
    bounds = list(offsets) + [len(values)]
    for s in range(len(offsets)):
        a, b = bounds[s], bounds[s + 1]
        out[a:b] = np.cumsum(values[a:b]) - values[a:b]
    return out


def random_csr(rng, n_segments, n_elements):
    # random segment sizes incl. empties
    cuts = np.sort(rng.integers(0, n_elements + 1, n_segments - 1))
    offsets = np.concatenate([[0], cuts]).astype(np.int32)
    return offsets


def test_offsets_to_segments_with_empties(rng):
    offsets = np.array([0, 0, 3, 3, 3, 7], np.int32)
    seg = np.array(offsets_to_segments(jnp.asarray(offsets), 10))
    expect = np.array([1, 1, 1, 4, 4, 4, 4, 5, 5, 5])
    assert np.array_equal(seg, expect)


def test_exclusive_segmented_scan_random(rng):
    n_seg, n = 100, 5000
    offsets = random_csr(rng, n_seg, n)
    values = rng.random(n).astype(np.float32)
    got = np.array(exclusive_segmented_scan(jnp.asarray(offsets), jnp.asarray(values)))
    expect = np_exclusive_scan_by_segments(offsets, values)
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)


def test_weighted_exclusive_segmented_scan(rng):
    n_seg, n = 20, 500
    offsets = random_csr(rng, n_seg, n)
    values = rng.random(n).astype(np.float32)
    wmap = rng.integers(0, 7, n).astype(np.int32)
    weights = rng.random(7).astype(np.float32)
    got = np.array(weighted_exclusive_segmented_scan(
        jnp.asarray(offsets), jnp.asarray(values), jnp.asarray(wmap), jnp.asarray(weights)))
    expect = np_exclusive_scan_by_segments(offsets, values * weights[wmap])
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)


def test_segmented_sort_is_per_segment(rng):
    n_seg, n = 30, 1000
    offsets = random_csr(rng, n_seg, n)
    keys = rng.random(n).astype(np.float32)
    payload = np.arange(n, dtype=np.int32)
    ks, ps = sort_by_distance(jnp.asarray(keys), jnp.asarray(offsets), jnp.asarray(payload))
    ks, ps = np.array(ks), np.array(ps)
    bounds = list(offsets) + [n]
    for s in range(n_seg):
        a, b = bounds[s], bounds[s + 1]
        assert np.all(np.diff(ks[a:b]) >= 0)
        assert np.array_equal(np.sort(payload[a:b]), np.sort(ps[a:b]))
        np.testing.assert_allclose(np.sort(keys[a:b]), ks[a:b])
