"""Leaf-occupancy + culling-selectivity analysis (analog of ref
leaf_sizes.py:1-68: histogram of leaf sizes and surface-area fraction per
occupancy, computed directly from a built tree instead of a dumped text
file) — plus the metric that drives the dense broadphase's selectivity:
the 128-primitive SEGMENT AABB overlap factor (sum of segment-AABB
cross-section areas relative to the scene's; the expected number of
segments a random axis ray's unit tile must test scales with it).

Usage:
  python tools/leaf_sizes.py [n_particles] [max_per_leaf]   # histogram
  python tools/leaf_sizes.py --bench [--json]               # bench scene
  python tools/leaf_sizes.py 1000000 32 --json              # one JSON line
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def leaf_statistics(tree, spheres):
    import jax.numpy as jnp

    nl = int(tree.n_leaves)
    leaves = np.array(tree.leaves)[:nl]
    counts = leaves[:, 1]
    # Per-leaf AABB surface area from the sorted primitive ranges.
    s = np.array(spheres)
    areas = np.zeros(nl)
    for k, (first, cnt) in enumerate(leaves):
        seg = s[first:first + cnt]
        mins = (seg[:, :3] - seg[:, 3:4]).min(0)
        maxs = (seg[:, :3] + seg[:, 3:4]).max(0)
        e = maxs - mins
        areas[k] = 2 * (e[0] * e[1] + e[0] * e[2] + e[1] * e[2])
    return counts, areas


def segment_overlap_stats(sorted_spheres):
    """Selectivity of the 128-aligned segment culling (pallas_broadphase):
    per-axis mean segment extent as a fraction of the scene extent, and the
    expected number of segments overlapping a thin axis-aligned beam
    (sum over segments of the fractional cross-section area). Lower is more
    selective; a perfectly space-filling Morton order approaches
    n_segs^(1/3)-ish scaling."""
    from grace_jax.trace.pallas_broadphase import segment_aabbs

    seg_min, seg_max = map(np.asarray, segment_aabbs(sorted_spheres))
    scene_min, scene_max = seg_min.min(0), seg_max.max(0)
    scene_ext = scene_max - scene_min
    ext = (seg_max - seg_min) / scene_ext
    # Beam along z: fractional x*y cross-section summed over segments.
    exp_overlaps_z = float((ext[:, 0] * ext[:, 1]).sum())
    return {
        "n_segments": int(seg_min.shape[0]),
        "mean_segment_extent_frac": [float(x) for x in ext.mean(0)],
        "expected_segments_per_z_beam": exp_overlaps_z,
    }


def main():
    import json

    import jax
    import jax.numpy as jnp

    from grace_jax.build.sph import build_sph_tree
    from grace_jax.core.types import make_spheres

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    as_json = "--json" in sys.argv
    bench_scene = "--bench" in sys.argv
    n = int(args[0]) if args else 100_000
    mpl = int(args[1]) if len(args) > 1 else 32

    rng = np.random.default_rng(0)
    if bench_scene:
        from bench import MAX_PER_LEAF, N_PARTICLES
        from grace_jax.io.synthetic import make_clustered_particles

        n, mpl = N_PARTICLES, MAX_PER_LEAF
        rng = np.random.default_rng(2026)
        spheres = jnp.asarray(make_clustered_particles(rng, n))
    else:
        spheres = make_spheres(rng.random((n, 3)).astype(np.float32),
                               (0.005 + 0.01 * rng.random(n)).astype(np.float32))
    sorted_spheres, tree, _ = jax.jit(build_sph_tree, static_argnums=1)(spheres, mpl)
    counts, areas = leaf_statistics(tree, sorted_spheres)

    if as_json:
        stats = segment_overlap_stats(sorted_spheres)
        hist, _ = np.histogram(counts, bins=np.arange(1, mpl + 2))
        print(json.dumps({
            "scene": "bench" if bench_scene else "uniform",
            "n_particles": n,
            "max_per_leaf": mpl,
            "n_leaves": int(len(counts)),
            "mean_occupancy": float(counts.mean()),
            "occupancy_fraction": float(counts.mean() / mpl),
            "leaf_histogram": hist.tolist(),
            **stats,
        }))
        return

    print(f"n_particles: {n}  max_per_leaf: {mpl}  n_leaves: {len(counts)}")
    print(f"mean_occupancy: {counts.mean():.2f}  "
          f"occupancy_fraction: {counts.mean() / mpl:.2%}")
    hist, _ = np.histogram(counts, bins=np.arange(1, mpl + 2))
    area_frac = np.zeros(mpl)
    for occ in range(1, mpl + 1):
        area_frac[occ - 1] = areas[counts == occ].sum()
    area_frac /= areas.sum()
    print("occupancy  leaves  area_fraction")
    for occ in range(1, mpl + 1):
        if hist[occ - 1]:
            print(f"{occ:9d}  {hist[occ - 1]:6d}  {area_frac[occ - 1]:.4f}")


if __name__ == "__main__":
    main()
