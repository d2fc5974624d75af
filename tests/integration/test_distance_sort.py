"""Per-ray hit ordering after sort_by_distance — analog of
ref tests/distance_sort/distance_sort.cu:22-149 (verify_intersection_order:
per-ray distances non-decreasing and non-negative, counts consistent)."""

import numpy as np
import jax

from grace_jax.build.sph import build_sph_tree
from grace_jax.core.types import make_spheres
from grace_jax.ops.segops import sort_by_distance
from grace_jax.rays.gen import uniform_random_rays
from grace_jax.trace.sph import trace_sph


def test_distance_sort_order(rng):
    n, r = 10000, 1024
    spheres = make_spheres(rng.random((n, 3)).astype(np.float32),
                           (0.01 + 0.03 * rng.random(n)).astype(np.float32))
    sorted_spheres, tree, _ = jax.jit(build_sph_tree, static_argnums=1)(spheres, 32)
    rays = uniform_random_rays(jax.random.key(11), r, origin=(0.5, 0.5, 0.5), length=1.5)

    res = trace_sph(rays, sorted_spheres, tree, capacity=200000)
    total = int(res.total_hits)
    assert total > 0 and total <= 200000

    dist_s, idx_s, integ_s = sort_by_distance(
        res.distances, res.offsets, res.indices, res.integrals,
        total_hits=res.total_hits,
    )
    dist_s = np.array(dist_s)
    offsets = np.array(res.offsets)
    counts = np.array(res.counts)
    for ray in range(r):
        seg = dist_s[offsets[ray]: offsets[ray] + counts[ray]]
        assert np.all(seg >= 0), f"ray {ray} negative distance"
        assert np.all(np.diff(seg) >= 0), f"ray {ray} not sorted"

    # The segmented sort must not move hits across rays: per-ray index sets
    # unchanged.
    idx_unsorted = np.array(res.indices)
    idx_sorted = np.array(idx_s)
    for ray in range(0, r, 37):
        a = np.sort(idx_unsorted[offsets[ray]: offsets[ray] + counts[ray]])
        b = np.sort(idx_sorted[offsets[ray]: offsets[ray] + counts[ray]])
        assert np.array_equal(a, b)
