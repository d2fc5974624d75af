"""Triangle-mesh ray tracing — the generic-primitive capability proof.

Analog of the reference's render_triangle demo (ref: tests/render_triangle/):
Möller-Trumbore intersection with back-face culling (triangle.cuh:11-83),
closest-hit and any-hit (shadow) traversal via the generic engine with custom
functors (tris_trace.cuh:11-117), camera auto-framing (tris_render.cu:31-61)
and Lambert + shadow shading (tris_render.cu:63-163).

Triangles are stored as f32[T, 3, 3] vertex triplets; the LBVH build reuses
the generic build path (build_primitive_tree with the TRIANGLE kind and XOR
deltas, matching tris_tree.cuh:17-30).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from grace_jax.build.sph import build_primitive_tree
from grace_jax.core.types import Rays
from grace_jax.ops.primitives import TRIANGLE
from grace_jax.ops.vecmath import cross, dot3, normalize3
from grace_jax.rays.gen import pinhole_camera_rays
from grace_jax.trace.engine import TraceFunctors, trace

EPS = 1e-7


def intersect_triangle(ray_o, ray_d, ray_len, tris, ray_data=None):
    """Batched Möller-Trumbore with back-face culling
    (ref: render_triangle/triangle.cuh:intersect).

    tris: [..., 3, 3]; returns (hit, t) with t the ray parameter.
    """
    v0 = tris[..., 0, :]
    e1 = tris[..., 1, :] - v0
    e2 = tris[..., 2, :] - v0
    p = cross(ray_d, e2)
    det = dot3(e1, p)
    # Back-face culling: only dets > 0 count (ref triangle.cuh comment).
    inv_det = 1.0 / jnp.where(jnp.abs(det) > EPS, det, EPS)
    s = ray_o - v0
    u = dot3(s, p) * inv_det
    q = cross(s, e1)
    v = dot3(ray_d, q) * inv_det
    t = dot3(e2, q) * inv_det
    hit = (
        (det > EPS)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > EPS) & (t < ray_len)
    )
    return hit, t


def clip_rays_to_aabb(rays: Rays, bmin, bmax) -> Rays:
    """Clip ray lengths to the exit of an AABB (the mesh's bounds).

    Hits can only exist inside the mesh AABB, so shrinking every ray to
    its box-exit parameter (and to 0 for rays that miss the box) is
    semantically free, and it lets a traversal that stops once every ray
    has its closest hit stop early on rays that leave the mesh."""
    d = rays.directions
    inv = 1.0 / jnp.where(jnp.abs(d) < 1e-30, 1e-30, d)
    t0 = (bmin[None, :] - rays.origins) * inv
    t1 = (bmax[None, :] - rays.origins) * inv
    tn = jnp.max(jnp.minimum(t0, t1), axis=1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=1)
    hit_box = tf >= jnp.maximum(tn, 0.0)
    ln = jnp.where(hit_box, jnp.minimum(rays.lengths, tf), 0.0)
    return Rays(rays.origins, rays.directions, jnp.maximum(ln, 0.0))


def build_triangle_tree(tris, max_per_leaf: int = 8):
    """LBVH over triangles (ref: tris_tree.cuh:17-30)."""
    return build_primitive_tree(tris, TRIANGLE, max_per_leaf, delta_kind="xor")


class ClosestHit(NamedTuple):
    t: jax.Array      # f32[R] closest hit distance (inf if none)
    tri: jax.Array    # i32[R] triangle index (-1 if none)


def trace_closest_hit(rays: Rays, tris, tree, stack_size: int = 64) -> ClosestHit:
    """Closest-hit trace: per-ray min-t tracking
    (ref: tris_trace.cuh:28-58 RayData_tri + on-hit min update)."""

    def on_hit(carry, ray_ids, prim_ids, info, hit):
        (t_min, tri_min), g = carry
        t = jnp.where(hit, info, jnp.inf)
        best = jnp.argmin(t, axis=1)
        bt = jnp.take_along_axis(t, best[:, None], axis=1)[:, 0]
        btri = jnp.take_along_axis(prim_ids, best[:, None], axis=1)[:, 0]
        closer = bt < t_min
        return (jnp.where(closer, bt, t_min), jnp.where(closer, btri, tri_min)), g

    fx = TraceFunctors(intersect=intersect_triangle, on_hit=on_hit)
    init = (jnp.full((rays.n_rays,), jnp.inf, jnp.float32),
            jnp.full((rays.n_rays,), -1, jnp.int32))
    (t, tri), _ = trace(rays, tree, tris, fx, ray_data_init=init,
                        stack_size=stack_size)
    return ClosestHit(t=t, tri=tri)


def trace_any_hit(rays: Rays, tris, tree, stack_size: int = 64) -> jax.Array:
    """Occlusion (shadow) trace: boolean any-hit
    (ref: tris_trace.cuh shadow path)."""

    def on_hit(carry, ray_ids, prim_ids, info, hit):
        occluded, g = carry
        return occluded | jnp.any(hit, axis=1), g

    fx = TraceFunctors(intersect=intersect_triangle, on_hit=on_hit)
    occ, _ = trace(
        rays, tree, tris, fx,
        ray_data_init=jnp.zeros((rays.n_rays,), jnp.bool_),
        stack_size=stack_size,
    )
    return occ


def auto_camera(tris, resolution: int, fov_y: float = jnp.pi / 3):
    """Frame the mesh AABB like the reference's auto-framing
    (ref: tris_render.cu:31-61): camera backed off along +z by the distance
    that fits the bounds in the vertical FOV."""
    mins = jnp.min(tris.reshape(-1, 3), axis=0)
    maxs = jnp.max(tris.reshape(-1, 3), axis=0)
    center = 0.5 * (mins + maxs)
    size = maxs - mins
    dist = 0.6 * jnp.max(size) / jnp.tan(fov_y / 2.0) + 0.5 * size[2]
    cam = center + jnp.asarray([0.0, 0.0, dist])
    length = 4.0 * dist
    return cam, center, length


def render_triangles(
    tris,
    resolution: int = 256,
    light_dir=(0.3, 1.0, 0.6),
    ambient: float = 0.15,
    max_per_leaf: int = 8,
) -> jax.Array:
    """Lambert + hard-shadow render of a triangle mesh, returns f32[res, res].

    Mirrors the reference pipeline (ref: tris_render.cu:165-191): primary
    closest-hit pass, shadow any-hit pass toward the light, shaded combine.
    """
    tris = jnp.asarray(tris, jnp.float32)
    sorted_tris, tree, _ = build_triangle_tree(tris, max_per_leaf)
    cam, look_at, length = auto_camera(sorted_tris, resolution)
    rays = pinhole_camera_rays(
        resolution, resolution, cam, look_at, (0.0, 1.0, 0.0), jnp.pi / 3, length
    )

    hitrec = trace_closest_hit(rays, sorted_tris, tree)
    hit_mask = jnp.isfinite(hitrec.t)
    tri_idx = jnp.clip(hitrec.tri, 0, sorted_tris.shape[0] - 1)

    tri = sorted_tris[tri_idx]
    n = normalize3(cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]))
    # Normals face the camera (back-face culling makes det > 0 hits front).
    l = normalize3(jnp.asarray(light_dir, jnp.float32))
    lambert = jnp.abs(dot3(n, l))

    # Shadow rays from the hit points toward the light.
    hit_p = rays.origins + rays.directions * jnp.where(hit_mask, hitrec.t, 0.0)[:, None]
    shadow_o = hit_p + n * 1e-3
    shadow = Rays(
        shadow_o,
        jnp.broadcast_to(l, shadow_o.shape),
        jnp.full((rays.n_rays,), length, jnp.float32),
    )
    occluded = trace_any_hit(shadow, sorted_tris, tree)

    shade = ambient + jnp.where(occluded, 0.0, lambert) * (1.0 - ambient)
    img = jnp.where(hit_mask, shade, 0.0)
    return img.reshape(resolution, resolution)
