"""Stage-split trace profiler (analog of ref tests/profile_trace_gadget/
profile_trace_gadget.cu:23-188: ray gen + sort, hitcount trace, cumulative
trace, full per-hit trace, sort-by-distance, plus memory report).

Usage: python benchmarks/profile_trace.py [n_particles] [n_rays] [iters]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import time

import numpy as np


def timeit(run, iters=5):
    run()  # warm-up / compile
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    return (time.perf_counter() - t0) / iters * 1e3


def main():
    import jax
    import jax.numpy as jnp

    from grace_jax.build.sph import build_sph_tree
    from grace_jax.io.synthetic import make_clustered_particles
    from grace_jax.ops.segops import sort_by_distance
    from grace_jax.rays.gen import plane_parallel_random_rays, spatial_sort_rays
    from grace_jax.trace.pallas_kernel import pallas_trace_sph
    from grace_jax.trace.sph import trace_sph

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 20
    n_rays = int(sys.argv[2]) if len(sys.argv) > 2 else 512 * 512
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    side = int(np.sqrt(n_rays))

    rng = np.random.default_rng(0)
    spheres = jnp.asarray(make_clustered_particles(rng, n))

    build = jax.jit(lambda s: build_sph_tree(s, 32))
    t_build = timeit(lambda: jax.block_until_ready(build(spheres)), iters)
    sorted_spheres, tree, _ = build(spheres)

    def gen():
        r = plane_parallel_random_rays(
            jax.random.key(0), side, side, (0, 0, -2.0), (1, 0, 0), (0, 1, 0), 6.0)
        rs, _, _ = jax.jit(spatial_sort_rays)(r)
        return jax.block_until_ready(rs.origins)

    t_gen = timeit(gen, iters)
    rays = plane_parallel_random_rays(
        jax.random.key(0), side, side, (0, 0, -2.0), (1, 0, 0), (0, 1, 0), 6.0)
    rays_s, _, _ = jax.jit(spatial_sort_rays)(rays)

    def hitcount():
        v, _ = pallas_trace_sph(rays_s, sorted_spheres, max_chunks=4096,
                                mode="hitcount")
        return np.array(v)

    def cumulative():
        v, _ = pallas_trace_sph(rays_s, sorted_spheres, max_chunks=4096,
                                mode="cumulative")
        return np.array(v)

    t_hc = timeit(hitcount, iters)
    t_cum = timeit(cumulative, iters)

    counts = hitcount()
    total = int(counts.sum())

    # Full per-hit trace (ref trace_sph two-pass, trace_sph.cuh:111-168)
    # through the XLA engine, then the segmented distance sort
    # (ref sort_by_distance, sort.cuh:100-131).
    full_trace = jax.jit(trace_sph, static_argnums=3)
    cap = total + 1

    def full():
        return int(full_trace(rays_s, sorted_spheres, tree, cap).total_hits)

    t_full = timeit(full, iters)
    res = full_trace(rays_s, sorted_spheres, tree, cap)
    dist_sort = jax.jit(sort_by_distance)

    def sort():
        out = dist_sort(res.distances, res.offsets, res.indices,
                        res.integrals, total_hits=res.total_hits)
        return jax.block_until_ready(out[0])

    t_ds = timeit(sort, iters)
    t_fs = t_full + t_ds

    print(f"n_particles: {n}")
    print(f"n_rays: {n_rays}")
    print(f"build_ms: {t_build:.2f}")
    print(f"ray_gen_sort_ms: {t_gen:.2f}")
    print(f"hitcount_trace_ms: {t_hc:.2f}")
    print(f"cumulative_trace_ms: {t_cum:.2f}")
    print(f"full_trace_ms: {t_full:.2f}")
    print(f"full_trace_sorted_ms: {t_fs:.2f}")
    print(f"full_sorted_over_cumulative: {t_fs / t_cum:.2f}")
    print(f"sort_by_distance_ms: {t_ds:.2f}")
    print(f"total_hits: {total}")
    print(f"rays_per_s_cumulative: {n_rays / (t_cum / 1e3):.3e}")
    print(f"rays_per_s_full_sorted: {n_rays / (t_fs / 1e3):.3e}")


if __name__ == "__main__":
    main()
