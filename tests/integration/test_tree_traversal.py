"""Traversal correctness vs brute force — the reference's headline
correctness test (ref: tests/tree_traversal/tree_traversal.cu:21-122: GPU
hitcounts must exactly equal the O(N*R) CPU oracle)."""

import numpy as np
import jax
import jax.numpy as jnp

from grace_jax.build.sph import build_sph_tree
from grace_jax.core.types import Rays, make_spheres
from grace_jax.rays.gen import uniform_random_rays
from grace_jax.trace.sph import trace_hitcounts_sph


def brute_force_counts(o, d, length, spheres):
    p = spheres[None, :, :3] - o[:, None, :]
    dot = (p * d[:, None, :]).sum(-1)
    b = p - dot[..., None] * d[:, None, :]
    b2 = (b * b).sum(-1)
    hit = (b2 < spheres[None, :, 3] ** 2) & (dot >= 0) & (dot < length[:, None])
    return hit.sum(1)


def test_hitcounts_match_bruteforce(rng):
    n, r = 20000, 2048
    spheres = make_spheres(rng.random((n, 3)).astype(np.float32),
                           (0.005 + 0.02 * rng.random(n)).astype(np.float32))
    sorted_spheres, tree, _ = jax.jit(build_sph_tree, static_argnums=1)(spheres, 32)
    rays = uniform_random_rays(jax.random.key(7), r, origin=(0.5, 0.5, 0.5), length=2.0)
    counts = np.array(jax.jit(trace_hitcounts_sph)(rays, sorted_spheres, tree))
    oracle = brute_force_counts(np.array(rays.origins), np.array(rays.directions),
                                np.array(rays.lengths), np.array(sorted_spheres))
    assert np.array_equal(counts, oracle)
    assert counts.sum() > 0


def test_hitcounts_match_bruteforce_surface_area_deltas(rng):
    n, r = 5000, 512
    spheres = make_spheres(rng.random((n, 3)).astype(np.float32),
                           (0.005 + 0.03 * rng.random(n)).astype(np.float32))
    sorted_spheres, tree, _ = jax.jit(
        build_sph_tree, static_argnums=(1, 2)
    )(spheres, 16, "surface_area")
    rays = uniform_random_rays(jax.random.key(3), r, origin=(-0.2, 0.5, 0.5), length=3.0)
    counts = np.array(trace_hitcounts_sph(rays, sorted_spheres, tree))
    oracle = brute_force_counts(np.array(rays.origins), np.array(rays.directions),
                                np.array(rays.lengths), np.array(sorted_spheres))
    assert np.array_equal(counts, oracle)


def test_hitcounts_match_bruteforce_xor_deltas(rng):
    n, r = 5000, 512
    spheres = make_spheres(rng.random((n, 3)).astype(np.float32),
                           (0.005 + 0.03 * rng.random(n)).astype(np.float32))
    sorted_spheres, tree, _ = jax.jit(
        build_sph_tree, static_argnums=(1, 2)
    )(spheres, 16, "xor")
    rays = uniform_random_rays(jax.random.key(4), r, origin=(0.9, 0.1, 0.5), length=3.0)
    counts = np.array(trace_hitcounts_sph(rays, sorted_spheres, tree))
    oracle = brute_force_counts(np.array(rays.origins), np.array(rays.directions),
                                np.array(rays.lengths), np.array(sorted_spheres))
    assert np.array_equal(counts, oracle)
