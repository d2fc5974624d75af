"""Ray generation (analog of ref include/grace/cuda/gen_rays.cuh:26-399 and
include/grace/cuda/kernels/gen_rays.cuh).

All generators are pure jnp over the whole ray batch; randomness is
``jax.random`` (counter-based threefry — the stateless replacement for the
reference's cuRAND XORWOW state pools, ref: kernels/gen_rays.cuh:416-451; no
state initialization step is needed because threefry is stateless).

Conventions copied from the reference:
  * image ray index 0 is the top-left pixel and rays are row-major
    (ref: cuda/gen_rays.cuh:286-289);
  * pixel centers: x = (2 (i+.5)/res_x - 1) * aspect, y = 1 - 2 (j+.5)/res_y
    (ref: kernels/gen_rays.cuh:80-97 image_plane_coord);
  * isotropic directions: 3 standard normals, normalized
    (ref: kernels/gen_rays.cuh:119-161);
  * generated ray batches are sorted by a 30-bit Morton key of the direction
    ((d+1)/2 per axis, ref: kernels/gen_rays.cuh:38-43) — for the tile
    trace this sort is *load-bearing for tile coherence*, not just cache
    locality.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from grace_jax.core.types import Octants, Rays, RaySortType, octant_signs
from grace_jax.ops.morton import morton_key_30bit_from_unit, morton_keys_from_centroids
from grace_jax.ops.vecmath import cross, normalize3


def ray_dir_morton_keys(directions) -> jnp.ndarray:
    """30-bit Morton key of a normalized direction (ref: gen_rays.cuh:38-43)."""
    d01 = (directions + 1.0) * 0.5
    return morton_key_30bit_from_unit(d01[:, 0], d01[:, 1], d01[:, 2])


def _sort_rays_by_keys(rays: Rays, keys) -> Rays:
    order = jnp.argsort(keys)
    return rays[order]


def spatial_sort_rays(rays: Rays, aabb_min=None, aabb_max=None):
    """Sort rays by the 30-bit Morton key of their segment midpoint.

    Tile coherence is load-bearing for the Pallas trace path (small tile
    AABBs => selective broadphase), the analog of the reference's
    ray-coherence sorts (ref: kernels/gen_rays.cuh:483-485, 584-617). Returns
    (sorted_rays, order, inverse_order) so per-ray outputs can be scattered
    back: original_values = traced_values[inverse_order].
    """
    mid = rays.origins + 0.5 * rays.lengths[:, None] * rays.directions
    if aabb_min is None:
        aabb_min = jnp.min(mid, axis=0)
    if aabb_max is None:
        aabb_max = jnp.max(mid, axis=0)
    keys = morton_keys_from_centroids(mid, aabb_min, aabb_max, bits=30)
    order = jnp.argsort(keys)
    inv = jnp.argsort(order)
    return rays[order], order, inv


def uniform_random_rays(key, n_rays: int, origin, length, sort: bool = True) -> Rays:
    """Isotropic random rays from a common origin
    (ref: gen_rays.cuh:26-36, kernels/gen_rays.cuh:119-161, 454-485).

    Directions are normalized 3D standard normals (uniform on the sphere);
    the batch is direction-Morton sorted unless ``sort=False``.
    """
    d = jax.random.normal(key, (n_rays, 3), jnp.float32)
    d = normalize3(d)
    origins = jnp.broadcast_to(jnp.asarray(origin, jnp.float32), (n_rays, 3))
    lengths = jnp.full((n_rays,), length, jnp.float32)
    rays = Rays(origins, d, lengths)
    if sort:
        rays = _sort_rays_by_keys(rays, ray_dir_morton_keys(d))
    return rays


def uniform_random_rays_single_octant(
    key, n_rays: int, origin, length, octant: Octants, sort: bool = True
) -> Rays:
    """Isotropic rays restricted to one octant by sign-folding the normals
    (ref: kernels/gen_rays.cuh:164-205)."""
    d = jax.random.normal(key, (n_rays, 3), jnp.float32)
    signs = jnp.asarray(octant_signs(octant))
    d = normalize3(jnp.abs(d) * signs)
    origins = jnp.broadcast_to(jnp.asarray(origin, jnp.float32), (n_rays, 3))
    lengths = jnp.full((n_rays,), length, jnp.float32)
    rays = Rays(origins, d, lengths)
    if sort:
        rays = _sort_rays_by_keys(rays, ray_dir_morton_keys(d))
    return rays


def one_to_many_rays(
    origin,
    points,
    sort_type: RaySortType = RaySortType.NoSort,
    aabb_min=None,
    aabb_max=None,
) -> Rays:
    """Rays from one origin to each point, terminating at the point
    (ref: kernels/gen_rays.cuh:207-244 + wrappers :525-617; dispatch
    cuda/gen_rays.cuh:100-131).

    EndPointSort requires the points' AABB and sorts rays by the 30-bit
    Morton key of their endpoint (the reference reuses its particle
    morton_keys path for this, ref: gen_rays.cuh:603-612).
    """
    points = jnp.asarray(points, jnp.float32)[:, :3]
    origin = jnp.asarray(origin, jnp.float32)
    delta = points - origin
    lengths = jnp.sqrt(jnp.sum(delta * delta, axis=-1))
    d = delta / lengths[:, None]
    origins = jnp.broadcast_to(origin, points.shape)
    rays = Rays(origins, d, lengths)
    if sort_type == RaySortType.NoSort:
        return rays
    if sort_type == RaySortType.DirectionSort:
        return _sort_rays_by_keys(rays, ray_dir_morton_keys(d))
    if sort_type == RaySortType.EndPointSort:
        if aabb_min is None or aabb_max is None:
            aabb_min = jnp.min(points, axis=0)
            aabb_max = jnp.max(points, axis=0)
        keys = morton_keys_from_centroids(points, aabb_min, aabb_max, bits=30)
        return _sort_rays_by_keys(rays, keys)
    raise ValueError(f"unknown sort_type {sort_type}")


def plane_parallel_random_rays(key, width: int, height: int, base, w, h, length) -> Rays:
    """Parallel rays from jittered cells of a planar grid
    (ref: kernels/gen_rays.cuh:246-316, wrapper :619-664).

    The plane is spanned by vectors w (width direction) and h; each of the
    width x height cells emits one ray from a uniform-random point inside the
    cell, along normalize(cross(w, h)). Used by the integration tests: the
    per-ray area is |w| |h| / (width height).
    """
    base = jnp.asarray(base, jnp.float32)
    w = jnp.asarray(w, jnp.float32)
    h = jnp.asarray(h, jnp.float32)
    n = width * height
    i = jnp.arange(n, dtype=jnp.int32) % width
    j = jnp.arange(n, dtype=jnp.int32) // width
    rw, rh = jax.random.uniform(key, (2, n), jnp.float32)
    fw = (i.astype(jnp.float32) + rw) / width
    fh = (j.astype(jnp.float32) + rh) / height
    origins = base + fw[:, None] * w + fh[:, None] * h
    direction = normalize3(cross(w, h))
    directions = jnp.broadcast_to(direction, (n, 3))
    lengths = jnp.full((n,), length, jnp.float32)
    return Rays(origins, directions, lengths)


def _camera_basis(camera_position, look_at, view_up):
    view_dir = normalize3(jnp.asarray(look_at, jnp.float32) - jnp.asarray(camera_position, jnp.float32))
    v = normalize3(cross(view_dir, jnp.asarray(view_up, jnp.float32)))  # right
    u = normalize3(cross(v, view_dir))  # up
    return view_dir, v, u


def _pixel_coords(resolution_x: int, resolution_y: int, aspect: float):
    n = resolution_x * resolution_y
    i = jnp.arange(n, dtype=jnp.int32) % resolution_x
    j = jnp.arange(n, dtype=jnp.int32) // resolution_x
    x = (2.0 * ((i.astype(jnp.float32) + 0.5) / resolution_x) - 1.0) * aspect
    y = 1.0 - 2.0 * ((j.astype(jnp.float32) + 0.5) / resolution_y)
    return x, y


def orthographic_projection_rays(
    resolution_x: int,
    resolution_y: int,
    camera_position,
    look_at,
    view_up,
    vertical_extent,
    length,
) -> Rays:
    """Orthographic camera (ref: kernels/gen_rays.cuh:318-360, :666-725):
    pixel-center origins in the image plane through camera_position, common
    direction toward look_at."""
    view_dir, v, u = _camera_basis(camera_position, look_at, view_up)
    aspect = resolution_x / resolution_y
    horizontal_extent = vertical_extent * aspect
    x, y = _pixel_coords(resolution_x, resolution_y, 1.0)
    origins = (
        jnp.asarray(camera_position, jnp.float32)
        + x[:, None] * (v * (horizontal_extent / 2.0))
        + y[:, None] * (u * (vertical_extent / 2.0))
    )
    n = resolution_x * resolution_y
    directions = jnp.broadcast_to(view_dir, (n, 3))
    lengths = jnp.full((n,), length, jnp.float32)
    return Rays(origins, directions, lengths)


def pinhole_camera_rays(
    resolution_x: int,
    resolution_y: int,
    camera_position,
    look_at,
    view_up,
    fov_y,
    length,
) -> Rays:
    """Perspective pinhole camera (ref: kernels/gen_rays.cuh:362-395, :727-787):
    directions through pixel centers of an image plane at 1/tan(FOVy/2)."""
    view_dir, v, u = _camera_basis(camera_position, look_at, view_up)
    aspect = resolution_x / resolution_y
    n_pref = 1.0 / jnp.tan(jnp.asarray(fov_y, jnp.float32) / 2.0)
    x, y = _pixel_coords(resolution_x, resolution_y, aspect)
    dirs = x[:, None] * v + y[:, None] * u + n_pref * view_dir
    dirs = normalize3(dirs)
    n = resolution_x * resolution_y
    origins = jnp.broadcast_to(jnp.asarray(camera_position, jnp.float32), (n, 3))
    lengths = jnp.full((n,), length, jnp.float32)
    return Rays(origins, dirs, lengths)
