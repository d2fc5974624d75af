"""Splat renderer parity and physics tests (Pallas interpreter on CPU).

The splat image must match the XLA engine's cumulative trace over an
identical orthographic pixel grid to the separable-basis fit tolerance,
and must satisfy the same plane-integral normalization as the trace paths
(ref: tests/integrate/integrate.cu:88-101 idiom). The Triton kernel and the
plain XLA splat must both match the dense evaluation of the identical
separable model (splat_reference_jnp) to f32 rounding."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from grace_jax.build.sph import build_sph_tree
from grace_jax.core.types import make_spheres
from grace_jax.rays.gen import orthographic_projection_rays
from grace_jax.sph.kernel_integrals import splat_basis_reference, DENSE_KERNEL_INTEGRAL_TABLE, N_DENSE
from grace_jax.trace.splat import (
    OrthoCamera,
    bucket_prims_ortho,
    render_ortho_splat,
    splat_image,
    splat_image_xla,
    splat_reference_jnp,
)
from grace_jax.trace.sph import trace_cumulative_sph

CAM = (0.5, 0.5, -2.0)
LOOK = (0.5, 0.5, 0.5)
UP = (0.0, 1.0, 0.0)


def test_basis_fit_error_bound():
    """The separable model must be within 1.5e-4 relative of F everywhere
    (including outside the support, where it must be exactly 0 beyond the
    clamp)."""
    x = np.linspace(-1.3, 1.3, 401)
    model = splat_basis_reference(x[:, None], x[None, :])
    beta = np.sqrt(np.minimum(x[:, None] ** 2 + x[None, :] ** 2, 4.0))
    xi = np.clip(beta, 0, 1) * (N_DENSE - 1)
    i0 = np.minimum(xi.astype(int), N_DENSE - 2)
    fr = xi - i0
    truth = np.where(
        beta >= 1.0, 0.0,
        DENSE_KERNEL_INTEGRAL_TABLE[i0] * (1 - fr)
        + DENSE_KERNEL_INTEGRAL_TABLE[i0 + 1] * fr)
    err = np.abs(model - truth).max()
    assert err < 1.5e-4 * truth.max()
    # exactly zero at/beyond the per-axis clamp
    assert np.all(model[np.abs(x) >= 1.0, :] == 0.0)


def _scene(rng, n=3000):
    spheres = make_spheres(rng.random((n, 3)).astype(np.float32),
                           (0.02 + 0.05 * rng.random(n)).astype(np.float32))
    return jax.jit(build_sph_tree, static_argnums=1)(spheres, 16)


def test_splat_matches_engine(rng):
    ss, tree, _ = _scene(rng)
    W = H = 128
    rays = orthographic_projection_rays(W, H, CAM, LOOK, UP, 2.0, 6.0)
    ref = np.array(trace_cumulative_sph(rays, ss, tree)).reshape(H, W)
    img, ovf = render_ortho_splat(ss, CAM, LOOK, UP, 2.0, 6.0, W, H,
                                  tile_w=32, band=32,
                                  interpret=True)
    assert not bool(ovf)
    img = np.array(img)
    assert np.abs(img - ref).max() < 4e-4 * ref.max()
    assert abs(img.sum() / ref.sum() - 1.0) < 1e-4


def test_splat_plane_integral_normalization(rng):
    """sum(image) * pixel_area ~= N_inside (each kernel integrates to 1)."""
    n = 500
    # keep particles well inside so every footprint is fully on the image
    pos = (0.2 + 0.6 * rng.random((n, 3))).astype(np.float32)
    h = (0.02 + 0.03 * rng.random(n)).astype(np.float32)
    spheres = make_spheres(pos, h)
    W = H = 128
    vext = 2.0
    img, ovf = render_ortho_splat(spheres, CAM, LOOK, UP, vext, 6.0, W, H,
                                  tile_w=32, band=32,
                                  interpret=True)
    assert not bool(ovf)
    pixel_area = (vext / H) * (vext / W)
    total = float(jnp.sum(img)) * pixel_area
    # pixel-center quadrature of smooth kernels: coarse-grid error dominates
    assert abs(total / n - 1.0) < 5e-3


def test_splat_depth_culling(rng):
    """Particles behind the camera plane or beyond ray length contribute
    nothing (reference along-ray acceptance, generic/intersect.h:26-54)."""
    pos = np.array([[0.5, 0.5, 0.5], [0.5, 0.5, -3.0], [0.5, 0.5, 9.0]], np.float32)
    h = np.array([0.1, 0.1, 0.1], np.float32)
    spheres = make_spheres(pos, h)
    img_all, _ = render_ortho_splat(spheres, CAM, LOOK, UP, 2.0, 6.0, 128, 128,
                                    tile_w=32, band=32,
                                    interpret=True)
    img_one, _ = render_ortho_splat(spheres[:1], CAM, LOOK, UP, 2.0, 6.0, 128, 128,
                                    tile_w=32, band=32,
                                    interpret=True)
    np.testing.assert_allclose(np.array(img_all), np.array(img_one),
                               rtol=0, atol=1e-6)


def test_splat_weights(rng):
    """Per-particle weights scale contributions linearly (the weighted-scan
    analog, ref: kernels/weights.cuh)."""
    ss, tree, _ = _scene(rng, n=400)
    w = jnp.asarray(2.5 * np.ones(400, np.float32))
    img1, _ = render_ortho_splat(ss, CAM, LOOK, UP, 2.0, 6.0, 128, 128,
                                 tile_w=32, band=32,
                                 interpret=True)
    img2, _ = render_ortho_splat(ss, CAM, LOOK, UP, 2.0, 6.0, 128, 128,
                                 weights=w, tile_w=32, band=32,
                                 interpret=True)
    a, b = np.array(img2), 2.5 * np.array(img1)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


def test_splat_overflow_flag(rng):
    """A footprint wider than a tile span must set the overflow flag."""
    pos = np.array([[0.5, 0.5, 0.5]], np.float32)
    h = np.array([1.5], np.float32)   # far bigger than any tile span
    spheres = make_spheres(pos, h)
    buckets = bucket_prims_ortho(spheres, CAM, LOOK, UP, 2.0, 6.0, 128, 128,
                                 tile_w=32, band=32)
    assert bool(buckets.overflow)


def test_splat_tile_shape_is_layout_only(rng):
    """The tile shape is a pure layout choice: images match across tile
    shapes to f32 rounding, and the engine oracle to the fit tolerance."""
    ss, tree, _ = _scene(rng)
    W = H = 128
    rays = orthographic_projection_rays(W, H, CAM, LOOK, UP, 2.0, 6.0)
    ref = np.array(trace_cumulative_sph(rays, ss, tree)).reshape(H, W)
    img0, ovf0 = render_ortho_splat(ss, CAM, LOOK, UP, 2.0, 6.0, W, H,
                                    tile_w=32, band=64, chunk=128,
                                    interpret=True)
    img, ovf = render_ortho_splat(ss, CAM, LOOK, UP, 2.0, 6.0, W, H,
                                  tile_w=16, band=32, chunk=64,
                                  interpret=True)
    assert not bool(ovf0) and not bool(ovf)
    img, img0 = np.array(img), np.array(img0)
    assert np.abs(img - img0).max() < 1e-6 * img0.max()
    assert np.abs(img - ref).max() < 4e-4 * ref.max()


def test_splat_banded_overflow_flag(rng):
    """A footprint wider than a tile's column span flags overflow."""
    spheres = make_spheres(np.array([[0.5, 0.5, 0.5]], np.float32),
                           np.array([0.9], np.float32))
    _, ovf = render_ortho_splat(spheres, CAM, LOOK, UP, 2.0, 6.0, 128, 128,
                                tile_w=64, band=32, interpret=True)
    assert bool(ovf)


@pytest.mark.parametrize("basis,tol", [("deg8", 6e-4), ("deg10", 2.5e-4)])
def test_splat_basis_vs_engine(rng, basis, tol):
    """The jointly-fit deg-8 basis (20% less factor work) and the
    per-eigenvector deg-10 basis stay within their documented bounds
    (~3.1e-4 and ~1e-4) vs the trace oracle and keep normalization."""
    ss, tree, _ = _scene(rng)
    W = H = 128
    rays = orthographic_projection_rays(W, H, CAM, LOOK, UP, 2.0, 6.0)
    ref = np.array(trace_cumulative_sph(rays, ss, tree)).reshape(H, W)
    b = bucket_prims_ortho(ss, CAM, LOOK, UP, 2.0, 6.0, W, H,
                           tile_w=16, band=32)
    img = np.array(splat_image(b, basis=basis, interpret=True))
    assert np.abs(img - ref).max() < tol * ref.max()
    assert abs(img.sum() / ref.sum() - 1.0) < 1e-4


MODEL_CAM = OrthoCamera(
    camera_position=(0.5, 0.5, -2.0),
    look_at=(0.5, 0.5, 0.5),
    view_up=(0.0, 1.0, 0.0),
    vertical_extent=1.4,
    length=6.0,
    resolution_x=128,
    resolution_y=64,
)


def _model_scene(rng, n=600):
    pos = (0.15 + 0.7 * rng.random((n, 3))).astype(np.float32)
    h = (0.03 + 0.05 * rng.random(n)).astype(np.float32)
    # A few dead particles: h = 0 and out-of-depth.
    h[:5] = 0.0
    pos[5:8, 2] = 50.0
    w = jnp.asarray((0.5 + rng.random(n)).astype(np.float32))
    return make_spheres(pos, h), w


def _model_buckets(spheres, w, tile_w=16, band=32, chunk=64):
    c = MODEL_CAM
    b = bucket_prims_ortho(spheres, c.camera_position, c.look_at, c.view_up,
                           c.vertical_extent, c.length, c.resolution_x,
                           c.resolution_y, tile_w=tile_w, band=band,
                           chunk=chunk, weights=w)
    assert not bool(b.overflow)
    return b


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("basis", ["deg8", "deg10"])
def test_triton_splat_matches_reference_model(rng, basis, weighted):
    """Same model, same coefficients: agreement to f32 rounding (the
    kernel's 3xTF32 product is exact f32 in the interpreter)."""
    spheres, w = _model_scene(rng)
    w = w if weighted else None
    img = splat_image(_model_buckets(spheres, w), basis=basis, interpret=True)
    ref = splat_reference_jnp(spheres, w, MODEL_CAM, basis=basis)
    scale = float(jnp.max(jnp.abs(ref)))
    np.testing.assert_allclose(np.array(img), np.array(ref), atol=2e-5 * scale)
    assert float(jnp.max(img)) > 0


@pytest.mark.parametrize("basis", ["deg8", "deg10"])
def test_xla_splat_matches_reference_model(rng, basis):
    spheres, w = _model_scene(rng)
    img = splat_image_xla(_model_buckets(spheres, w), basis=basis,
                          pair_block=64)
    ref = splat_reference_jnp(spheres, w, MODEL_CAM, basis=basis)
    scale = float(jnp.max(jnp.abs(ref)))
    np.testing.assert_allclose(np.array(img), np.array(ref), atol=2e-5 * scale)


@pytest.mark.parametrize("tile_w,band,chunk", [(16, 16, 32), (32, 64, 128)])
def test_triton_splat_matches_xla_splat(rng, tile_w, band, chunk):
    spheres, w = _model_scene(rng)
    b = _model_buckets(spheres, w, tile_w=tile_w, band=band, chunk=chunk)
    img = np.array(splat_image(b, interpret=True))
    img_x = np.array(splat_image_xla(b, pair_block=32))
    np.testing.assert_allclose(img, img_x, atol=1e-5 * np.abs(img_x).max())


def test_splat_empty_tiles(rng):
    """Particles in one image corner: every other tile has an empty
    instance range and renders exactly zero."""
    pos = np.array([[0.05, 0.95, 0.5], [0.08, 0.9, 0.4]], np.float32)
    spheres = make_spheres(pos, np.array([0.03, 0.02], np.float32))
    b = bucket_prims_ortho(spheres, CAM, LOOK, UP, 2.0, 6.0, 128, 128,
                           tile_w=32, band=32)
    empty = np.asarray(b.n_slabs) == 0
    assert empty.sum() >= 12
    img = np.array(splat_image(b, interpret=True))
    img_x = np.array(splat_image_xla(b, pair_block=32))
    assert img.max() > 0
    tiles = img.reshape(4, 32, 4, 32).transpose(0, 2, 1, 3)
    assert np.all(tiles[empty] == 0)
    np.testing.assert_allclose(img, img_x, atol=1e-6 * img.max())


def test_bucket_layout_covers_every_instance(rng):
    """Meta arrays are [tile rows, tile cols]; the per-tile instance ranges
    partition the live instances and each tile's slabs cover its range."""
    spheres, w = _model_scene(rng)
    b = _model_buckets(spheres, w, tile_w=16, band=32, chunk=64)
    assert b.first.shape == (64 // 16, 128 // 32)
    first, last = np.asarray(b.first).ravel(), np.asarray(b.last).ravel()
    assert first[0] == 0 and np.all(first[1:] == last[:-1])
    lo, n = np.asarray(b.slab_lo).ravel(), np.asarray(b.n_slabs).ravel()
    live = last > first
    assert np.all(lo[live] * 64 <= first[live])
    assert np.all((lo + n)[live] * 64 >= last[live])


def test_splat_kernel_without_interpret_raises_on_cpu(rng):
    spheres, w = _model_scene(rng, n=50)
    with pytest.raises(Exception, match="interpret"):
        splat_image(_model_buckets(spheres, w))


def test_sorted_first_counts(rng):
    """Two-level exact count over sorted keys == numpy searchsorted, incl.
    chunk-boundary, all-below, and empty-key edge cases."""
    from grace_jax.trace.splat import _sorted_first_counts

    for n, n_keys, chunk in ((100_000, 512, 1024), (7, 5, 4),
                             (4096, 64, 1024), (2048, 1, 8)):
        keys = np.sort(rng.integers(0, n_keys + 1, n)).astype(np.int32)
        got = np.asarray(_sorted_first_counts(jnp.asarray(keys), n_keys,
                                              chunk=chunk))
        want = np.searchsorted(keys, np.arange(n_keys + 1), side="left")
        assert (got == want).all()
    # every key strictly below every threshold (the n_full == m edge)
    got = np.asarray(_sorted_first_counts(jnp.zeros(2048, jnp.int32), 3,
                                          chunk=1024))
    assert (got == np.array([0, 2048, 2048, 2048])).all()
    # n == 0 (empty key array): all counts zero
    got = np.asarray(_sorted_first_counts(jnp.zeros(0, jnp.int32), 3))
    assert (got == np.zeros(4, np.int32)).all()
