"""Stage-split tree-build profiler (analog of ref tests/profile_tree/
profile_tree.cu:23-167: morton / sort / deltas / build timings over a log2-N
sweep with warm-up excluded).

Usage: python benchmarks/profile_tree.py [log2_n_min] [log2_n_max] [iters]
Prints key: value lines (the reference's de-facto metrics interface,
parseable like tests/profile_leafbuilders.py does).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import time

import numpy as np


def timeit(fn, *args, iters=10):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)  # compile warm-up (i = -1 convention)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def main():
    import jax
    import jax.numpy as jnp

    from grace_jax.build.lbvh import build_lbvh
    from grace_jax.build.sph import (
        euclidean_deltas_sph,
        morton_keys_sph,
        sort_by_morton,
    )
    from grace_jax.ops.primitives import SPHERE

    lo = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    hi = int(sys.argv[2]) if len(sys.argv) > 2 else 23
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    mpl = 32

    rng = np.random.default_rng(0)
    for logn in range(lo, hi + 1):
        n = 1 << logn
        spheres = jnp.asarray(np.concatenate(
            [rng.random((n, 3)), 0.005 + 0.01 * rng.random((n, 1))], axis=1
        ).astype(np.float32))

        keys_fn = jax.jit(morton_keys_sph)
        sort_fn = jax.jit(sort_by_morton)
        deltas_fn = jax.jit(euclidean_deltas_sph)

        t_keys = timeit(keys_fn, spheres, iters=iters)
        t_sort = timeit(sort_fn, spheres, iters=iters)
        _, sorted_spheres, _ = sort_fn(spheres)
        t_deltas = timeit(deltas_fn, sorted_spheres, iters=iters)
        d = deltas_fn(sorted_spheres)
        mins, maxs = SPHERE.aabb(sorted_spheres)

        build_fn = jax.jit(lambda a, b, c: build_lbvh(a, b, c, mpl))
        t_build = timeit(build_fn, mins, maxs, d, iters=iters)

        print(f"N: {n}")
        print(f"morton_keys_ms: {t_keys:.3f}")
        print(f"sort_ms: {t_sort:.3f}")
        print(f"deltas_ms: {t_deltas:.3f}")
        print(f"build_lbvh_ms: {t_build:.3f}")
        print(f"total_ms: {t_keys + t_sort + t_deltas + t_build:.3f}")
        print()


if __name__ == "__main__":
    main()
