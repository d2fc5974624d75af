"""Ray-ordering strategy comparison (analog of ref
tests/profile_one_to_many_rays_gadget/profile_one_to_many_rays_gadget.cu:
23-226 — NoSort vs DirectionSort vs EndPointSort generation + trace timings;
the reference notes NoSort is often fastest on Hilbert-ordered Gadget data
because the input is already coherent).

For the fused trace kernel ray coherence determines tile-AABB tightness and
hence broadphase selectivity — the sort is load-bearing, not just
cache-friendly.

Usage: python benchmarks/profile_ray_sort.py [n_particles] [n_rays]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from grace_jax.build.sph import build_sph_tree
    from grace_jax.core.types import RaySortType
    from grace_jax.io.synthetic import make_clustered_particles
    from grace_jax.rays.gen import one_to_many_rays, spatial_sort_rays
    from grace_jax.trace.pallas_kernel import pallas_trace_sph

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 19
    n_rays = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 16

    rng = np.random.default_rng(0)
    spheres = jnp.asarray(make_clustered_particles(rng, n))
    sorted_spheres, tree, _ = jax.jit(lambda s: build_sph_tree(s, 32))(spheres)

    # one-to-many: a point source to a random subset of particle positions
    # (the reference shoots rays to Gadget particle positions).
    targets = np.array(sorted_spheres[:, :3])[rng.integers(0, n, n_rays)]
    origin = (0.5, 0.5, -1.0)

    strategies = {
        "NoSort": RaySortType.NoSort,
        "DirectionSort": RaySortType.DirectionSort,
        "EndPointSort": RaySortType.EndPointSort,
    }

    for name, st in strategies.items():
        def run():
            rays = one_to_many_rays(origin, jnp.asarray(targets), st)
            v, ovf = pallas_trace_sph(rays, sorted_spheres, max_chunks=4096)
            return float(jnp.sum(v)), bool(jnp.any(ovf))

        total, ovf = run()  # warm-up
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        dt = (time.perf_counter() - t0) / 3
        print(f"{name}_ms: {dt * 1e3:.2f}  rays_per_s: {n_rays / dt:.3e}  "
              f"overflow: {ovf}")

    # Spatial (segment-midpoint Morton) sort: the order the fused kernel's
    # tile broadphase wants.
    def run_spatial():
        rays = one_to_many_rays(origin, jnp.asarray(targets), RaySortType.NoSort)
        rays_s, _, _ = spatial_sort_rays(rays)
        v, ovf = pallas_trace_sph(rays_s, sorted_spheres, max_chunks=4096)
        return float(jnp.sum(v)), bool(jnp.any(ovf))

    run_spatial()
    t0 = time.perf_counter()
    for _ in range(3):
        run_spatial()
    dt = (time.perf_counter() - t0) / 3
    print(f"SpatialSort_ms: {dt * 1e3:.2f}  rays_per_s: {n_rays / dt:.3e}")


if __name__ == "__main__":
    main()
