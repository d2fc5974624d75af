"""Ray-generation tests: camera conventions, plane-parallel geometry,
one-to-many semantics, HEALPix pixel vectors. Statistical isotropy tests for
random directions live in tests/integration/test_isotropy.py (analog of
ref tests/isotropic_ray_stats)."""

import numpy as np
import jax
import jax.numpy as jnp

from grace_jax.core.types import Octants, RaySortType
from grace_jax.rays.gen import (
    one_to_many_rays,
    orthographic_projection_rays,
    pinhole_camera_rays,
    plane_parallel_random_rays,
    uniform_random_rays,
    uniform_random_rays_single_octant,
)
from grace_jax.rays.healpix import healpix_rays, pix2vec_nest


def test_uniform_rays_normalized_and_sorted():
    rays = uniform_random_rays(jax.random.key(0), 4096, (1, 2, 3), 5.0)
    d = np.array(rays.directions)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(np.array(rays.origins)[0], [1, 2, 3])
    assert np.all(np.array(rays.lengths) == 5.0)


def test_single_octant_signs():
    rays = uniform_random_rays_single_octant(
        jax.random.key(1), 512, (0, 0, 0), 1.0, Octants.PMP)
    d = np.array(rays.directions)
    assert np.all(d[:, 0] > 0) and np.all(d[:, 1] < 0) and np.all(d[:, 2] > 0)


def test_one_to_many_lengths_terminate_at_points(rng):
    pts = rng.random((256, 3)).astype(np.float32) * 4
    origin = np.array([-1.0, 0.5, 2.0], np.float32)
    rays = one_to_many_rays(origin, pts, RaySortType.NoSort)
    o = np.array(rays.origins)
    d = np.array(rays.directions)
    ln = np.array(rays.lengths)
    np.testing.assert_allclose(o + d * ln[:, None], pts, atol=1e-4)
    # Sorting variants are permutations of the same ray set.
    for st in (RaySortType.DirectionSort, RaySortType.EndPointSort):
        rs = one_to_many_rays(origin, pts, st)
        ends = np.array(rs.origins) + np.array(rs.directions) * np.array(rs.lengths)[:, None]
        a = np.sort(ends.round(4).view([("x", np.float32), ("y", np.float32), ("z", np.float32)]), axis=0)
        b = np.sort(pts.round(4).view([("x", np.float32), ("y", np.float32), ("z", np.float32)]), axis=0)
        np.testing.assert_array_equal(a, b)


def test_plane_parallel_on_plane_and_jittered():
    w = np.array([2.0, 0, 0], np.float32)
    h = np.array([0, 3.0, 0], np.float32)
    base = np.array([-1.0, -1.5, 0.7], np.float32)
    rays = plane_parallel_random_rays(jax.random.key(2), 16, 24, base, w, h, 9.0)
    o = np.array(rays.origins)
    assert o.shape == (16 * 24, 3)
    # Origins stay on the base plane (z = 0.7) and inside the rectangle.
    np.testing.assert_allclose(o[:, 2], 0.7, atol=1e-6)
    assert o[:, 0].min() >= -1.0 and o[:, 0].max() <= 1.0
    assert o[:, 1].min() >= -1.5 and o[:, 1].max() <= 1.5
    # One origin per grid cell.
    ix = np.floor((o[:, 0] + 1.0) / (2.0 / 16)).astype(int)
    iy = np.floor((o[:, 1] + 1.5) / (3.0 / 24)).astype(int)
    assert len({(a, b) for a, b in zip(ix, iy)}) == 16 * 24
    # Direction is normalize(cross(w, h)) = +z.
    np.testing.assert_allclose(np.array(rays.directions), [[0, 0, 1.0]] * (16 * 24), atol=1e-6)


def test_orthographic_rays_frame():
    res = 8
    rays = orthographic_projection_rays(
        res, res, camera_position=(0, 0, -5), look_at=(0, 0, 0), view_up=(0, 1, 0),
        vertical_extent=2.0, length=10.0)
    o = np.array(rays.origins)
    d = np.array(rays.directions)
    np.testing.assert_allclose(d, [[0, 0, 1.0]] * (res * res), atol=1e-6)
    # Camera basis: right = cross(view_dir, up) = cross(+z, +y) = -x world;
    # up-in-plane = +y. Ray 0 is the top-left pixel (ref gen_rays.cuh:286-289):
    # negative right-component, positive up-component.
    right = np.array([-1.0, 0.0, 0.0])
    up = np.array([0.0, 1.0, 0.0])
    assert o[0] @ right < 0 and o[0] @ up > 0
    # Row-major: ray 1 moves rightward in the image plane at constant height.
    assert o[1] @ right > o[0] @ right and abs(o[1] @ up - o[0] @ up) < 1e-6
    # Pixel centers span (-1, 1) symmetric grid.
    np.testing.assert_allclose(o[:, 0].max(), -o[:, 0].min(), atol=1e-6)
    np.testing.assert_allclose(o[:, 1].max(), -o[:, 1].min(), atol=1e-6)


def test_pinhole_rays_fov():
    res = 9
    fov = np.pi / 2
    rays = pinhole_camera_rays(res, res, (0, 0, 0), (0, 0, 1), (0, 1, 0), fov, 10.0)
    d = np.array(rays.directions)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    # Central pixel looks straight at look_at.
    mid = (res * res) // 2
    np.testing.assert_allclose(d[mid], [0, 0, 1], atol=1e-6)
    # Vertical FOV: top-center pixel elevation ~ atan((1 - 1/res)) for 90 deg.
    top_center = res // 2
    expect = np.arctan(1.0 - 1.0 / res)
    got = np.arctan2(d[top_center, 1], d[top_center, 2])
    np.testing.assert_allclose(got, expect, atol=1e-5)


def test_healpix_pixels_unit_and_balanced():
    nside = 16
    n = 12 * nside * nside
    vec = np.array(pix2vec_nest(nside, jnp.arange(n, dtype=jnp.uint32)))
    np.testing.assert_allclose(np.linalg.norm(vec, axis=1), 1.0, atol=1e-5)
    # All pixels distinct and the set is (exactly) symmetric under z -> -z.
    assert len({tuple(v.round(5)) for v in vec}) == n
    np.testing.assert_allclose(np.sort(vec[:, 2]), -np.sort(-vec[:, 2])[::-1] * 1.0, atol=1e-5)
    # Equal-area pixels: mean of any component ~ 0, z uniformly distributed.
    np.testing.assert_allclose(vec.mean(axis=0), 0.0, atol=1e-6)
    zs = np.sort(vec[:, 2])
    uniform = np.linspace(-1, 1, n + 1)[:-1] + 1.0 / n
    np.testing.assert_allclose(zs, uniform, atol=2.0 / nside)


def test_healpix_rays_rotation_preserves_isotropy():
    rays = healpix_rays(jax.random.key(3), 8, (0, 0, 0), 1.0, rotate=True)
    d = np.array(rays.directions)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(d.mean(axis=0), 0.0, atol=1e-5)
