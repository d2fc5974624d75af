"""Fused trace kernel parity tests (Pallas interpreter on CPU).

The Triton tile kernel must reproduce the XLA engine's results exactly for
hit counts and to polynomial-fit tolerance for integrals, for every tile
size, for ray counts that are not a tile multiple, for tiles whose segment
lists are empty, and for scenes spanning many primitive slabs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from grace_jax.build.sph import build_sph_tree
from grace_jax.core.types import Rays, make_spheres
from grace_jax.rays.gen import plane_parallel_random_rays, spatial_sort_rays, uniform_random_rays
from grace_jax.trace.pallas_kernel import pad_rays, pallas_trace_sph
from grace_jax.trace.sph import trace_cumulative_sph, trace_hitcounts_sph


def setup(rng, n=3000):
    spheres = make_spheres(rng.random((n, 3)).astype(np.float32),
                           (0.02 + 0.05 * rng.random(n)).astype(np.float32))
    return jax.jit(build_sph_tree, static_argnums=1)(spheres, 16)


def check(mode, got, rays, ss, tree):
    if mode == "hitcount":
        ref = np.array(trace_hitcounts_sph(rays, ss, tree))
        assert np.array_equal(np.array(got), ref)
        assert ref.sum() > 0
    else:
        ref = np.array(trace_cumulative_sph(rays, ss, tree))
        np.testing.assert_allclose(np.array(got), ref, rtol=5e-4, atol=1e-2)


@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize("mode", ["hitcount", "cumulative"])
def test_kernel_matches_engine(rng, mode, tile):
    ss, tree, _ = setup(rng)
    rays = plane_parallel_random_rays(
        jax.random.key(1), 16, 16, (0, 0, -2.0), (1, 0, 0), (0, 1, 0), 5.0)
    got, ovf = pallas_trace_sph(rays, ss, tile=tile, max_chunks=64,
                                mode=mode, interpret=True)
    assert not bool(np.array(ovf).any())
    assert got.dtype == (jnp.int32 if mode == "hitcount" else jnp.float32)
    check(mode, got, rays, ss, tree)


@pytest.mark.parametrize("mode", ["hitcount", "cumulative"])
def test_ray_count_not_a_tile_multiple(rng, mode):
    """Padding rays never hit and are cut from the result."""
    ss, tree, _ = setup(rng)
    rays = plane_parallel_random_rays(
        jax.random.key(4), 16, 16, (0, 0, -2.0), (1, 0, 0), (0, 1, 0), 5.0)
    rays = jax.tree.map(lambda x: x[:200], rays)
    got, ovf = pallas_trace_sph(rays, ss, tile=64, max_chunks=64, mode=mode,
                                interpret=True)
    assert got.shape == (200,) and ovf.shape == (4,)
    check(mode, got, rays, ss, tree)


def test_pad_rays_shape_and_never_hit():
    rays = Rays(jnp.zeros((5, 3)), jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (5, 1)),
                jnp.ones((5,)))
    p = pad_rays(rays, 8)
    assert p.n_rays == 8
    assert np.all(np.asarray(p.lengths[5:]) == -1.0)
    assert pad_rays(p, 8) is p


def test_empty_segment_lists(rng):
    """Tiles whose rays miss every particle have empty lists and zeros."""
    ss, tree, _ = setup(rng, n=500)
    rays = plane_parallel_random_rays(
        jax.random.key(5), 8, 8, (5.0, 5.0, -2.0), (1, 0, 0), (0, 1, 0), 5.0)
    got, ovf = pallas_trace_sph(rays, ss, tile=16, max_chunks=16,
                                interpret=True)
    assert not bool(np.array(ovf).any())
    assert np.all(np.asarray(got) == 0.0)


def test_multi_slab_scene_and_overflow_flag(rng):
    """A 20k-particle scene spans 157 slabs; every tile lists many of them.
    A list capacity below that must raise the overflow flag."""
    ss, tree, _ = setup(rng, n=20000)
    rays = plane_parallel_random_rays(
        jax.random.key(6), 8, 8, (0, 0, -2.0), (1, 0, 0), (0, 1, 0), 5.0)
    got, ovf = pallas_trace_sph(rays, ss, tile=16, max_chunks=160,
                                mode="hitcount", interpret=True)
    assert not bool(np.array(ovf).any())
    check("hitcount", got, rays, ss, tree)
    _, ovf_small = pallas_trace_sph(rays, ss, tile=16, max_chunks=4,
                                    mode="hitcount", interpret=True)
    assert bool(np.array(ovf_small).all())


def test_isotropic_rays_with_sort(rng):
    ss, tree, _ = setup(rng, n=2000)
    rays = uniform_random_rays(jax.random.key(3), 128, (0.5, 0.5, 0.5), 2.0)
    rays_s, order, inv = spatial_sort_rays(rays)
    got, ovf = pallas_trace_sph(rays_s, ss, tile=32, max_chunks=64,
                                mode="hitcount", interpret=True)
    ref = np.array(trace_hitcounts_sph(rays_s, ss, tree))
    # overflowed tiles (isotropic rays have huge tile AABBs) may undercount;
    # require exactness wherever no overflow occurred.
    okmask = ~np.array(ovf)[np.arange(128) // 32]
    assert np.array_equal(np.array(got)[okmask], ref[okmask])
    # and the inverse permutation restores original ray order
    np.testing.assert_allclose(np.array(rays_s.origins[inv]),
                               np.array(rays.origins))


def test_precomputed_segments_match(rng):
    """Lists supplied by the caller (the ring's hoisted broadphase) give
    the same values as lists built inside the call."""
    from grace_jax.trace.pallas_broadphase import dense_tile_segments

    ss, tree, _ = setup(rng)
    rays = plane_parallel_random_rays(
        jax.random.key(8), 16, 16, (0, 0, -2.0), (1, 0, 0), (0, 1, 0), 5.0)
    segs = dense_tile_segments(rays, ss, 32, 64)
    a, _ = pallas_trace_sph(rays, ss, tile=32, max_chunks=64, interpret=True)
    b, _ = pallas_trace_sph(rays, ss, tile=32, segments=segs, interpret=True)
    assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("deg", [8, -12])
def test_integral_deg_flavors_match_engine(rng, deg):
    """The tunable Horner forms (lower-degree prefactor fits, and the
    sqrt-free direct fit encoded as negative degrees) must stay inside the
    physics-gate tolerance against the engine's exact-table path."""
    ss, tree, _ = setup(rng)
    rays = plane_parallel_random_rays(
        jax.random.key(12), 16, 16, (0, 0, -2.0), (1, 0, 0), (0, 1, 0), 5.0)
    got, _ = pallas_trace_sph(rays, ss, tile=32, max_chunks=64,
                              integral_deg=deg, interpret=True)
    check("cumulative", got, rays, ss, tree)


def test_kernel_without_interpret_raises_on_cpu(rng):
    """Off the GPU the kernel runs only when the caller asks for the
    interpreter; it never falls back on its own."""
    ss, _, _ = setup(rng, n=300)
    rays = plane_parallel_random_rays(
        jax.random.key(2), 8, 8, (0, 0, -2.0), (1, 0, 0), (0, 1, 0), 5.0)
    with pytest.raises(Exception, match="interpret"):
        pallas_trace_sph(rays, ss, tile=16, max_chunks=16)


def test_compact_mask_words_exhaustive(rng):
    """XLA set-bit compaction vs a numpy decode, random sparse + sign-bit
    words, including empty tiles and exact-capacity rows."""
    from grace_jax.trace.pallas_broadphase import compact_mask_words

    T, W, max_q = 9, 70, 64
    words = np.zeros((T, W), np.int32)
    for t in range(1, T):  # tile 0 stays empty
        nset = int(rng.integers(0, 80)) if t < T - 1 else max_q  # exact cap
        qs = rng.choice(W * 32, size=nset, replace=False)
        for q in qs:
            words[t, q // 32] |= np.int32(np.uint32(1 << (q % 32)))

    ids, n_q, ovf = jax.jit(
        lambda w: compact_mask_words(w, max_q))(jnp.asarray(words))
    ids, n_q, ovf = np.asarray(ids), np.asarray(n_q), np.asarray(ovf)
    for t in range(T):
        bits = np.unpackbits(words[t].astype(np.uint32).view(np.uint8),
                             bitorder="little")
        exp = np.nonzero(bits)[0]
        assert ovf[t] == (len(exp) > max_q)
        exp = exp[:max_q]
        assert n_q[t] == len(exp)
        assert np.array_equal(ids[t, :n_q[t]], exp)
        assert np.all(ids[t, n_q[t]:] == 0)
