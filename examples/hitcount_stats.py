"""Hit-count statistics dump — the reference's `hitcounts` diagnostic binary
(ref: tests/hitcounts/hitcounts.cu:21-107) re-built on this pipeline:
random spheres in the unit box, uniform isotropic rays from the box centre,
BVH build + hit-count trace, then total/max/min statistics and an optional
text dump of spheres, rays, and per-ray counts.

Usage:
    python examples/hitcount_stats.py [N] [N_rays] [max_per_leaf] [save]
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import jax


def main(argv):
    n = int(argv[1]) if len(argv) > 1 else 100_000
    n_rays = 32 * (int(argv[2]) if len(argv) > 2 else 3125 // 8)
    max_per_leaf = int(argv[3]) if len(argv) > 3 else 32
    save = len(argv) > 4 and argv[4] == "save"

    print(f"Number of rays:         {n_rays}")
    print(f"Number of particles:    {n}")
    print(f"Max particles per leaf: {max_per_leaf}\n")

    from grace_jax.build.sph import build_sph_tree
    from grace_jax.core.types import make_spheres
    from grace_jax.rays.gen import uniform_random_rays
    from grace_jax.trace.sph import trace_hitcounts_sph

    # Random spheres in [0, 1), radii in [0, 0.1) — hitcounts.cu's scene.
    rng = np.random.default_rng(0)
    spheres = make_spheres(rng.random((n, 3)).astype(np.float32),
                           (0.1 * rng.random(n)).astype(np.float32))
    # Rays from the box centre, length 2 (ref: O = (.5, .5, .5, 2.)).
    rays = uniform_random_rays(jax.random.key(0), n_rays,
                               (0.5, 0.5, 0.5), 2.0)

    sorted_spheres, tree, _ = jax.jit(
        lambda s: build_sph_tree(s, max_per_leaf))(spheres)
    counts = np.asarray(trace_hitcounts_sph(rays, sorted_spheres, tree))

    print(f"Total hits: {counts.sum()}")
    print(f"Max hits:   {counts.max()}")
    print(f"Min hits:   {counts.min()}")

    if save:
        np.savetxt("outdata_spheres.txt", np.asarray(sorted_spheres),
                   fmt="%.8f")
        rays_np = np.concatenate(
            [np.asarray(rays.origins), np.asarray(rays.directions),
             np.asarray(rays.lengths)[:, None]], axis=1)
        np.savetxt("outdata_rays.txt", rays_np, fmt="%.8f")
        np.savetxt("outdata_hitcounts.txt", counts, fmt="%d")
        print("Saved outdata_{spheres,rays,hitcounts}.txt")


if __name__ == "__main__":
    main(sys.argv)
