"""Column-density projection of a Gadget-2 snapshot to a BMP image.

Analog of ref tests/project_gadget/project_gadget.cu:27-115: read the gas
particles, build the tree, trace an orthographic plane-parallel ray field
through the box, write the log-scaled column density as density.bmp.

Usage:
    python examples/project_gadget.py [snapshot] [resolution]

Without a snapshot argument a synthetic clustered snapshot is fabricated via
the native Gadget writer (the reference expects real data at
tests/data/gadget/0128/Data_025, which is not shipped; same here).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def synthetic_snapshot(path, n=200_000, seed=0):
    from grace_jax.io.gadget import write_gadget_gas

    rng = np.random.default_rng(seed)
    n_clumps = 64
    centers = rng.random((n_clumps, 3)).astype(np.float32)
    assign = rng.integers(0, n_clumps, n)
    scale = 0.02 + 0.05 * rng.random((n_clumps, 1)).astype(np.float32)
    pos = np.clip(
        centers[assign] + rng.standard_normal((n, 3)).astype(np.float32) * scale[assign],
        0.0, 1.0,
    )
    h = (0.004 + 0.01 * rng.random(n)).astype(np.float32)
    write_gadget_gas(path, np.concatenate([pos, h[:, None]], axis=1))
    return path


def main():
    import jax
    import jax.numpy as jnp

    from grace_jax.build.sph import build_sph_tree
    from grace_jax.io.gadget import read_gadget_gas
    from grace_jax.io.images import to_colormap, write_bmp
    from grace_jax.rays.gen import plane_parallel_random_rays
    from grace_jax.trace.sph import trace_cumulative_sph

    snapshot = sys.argv[1] if len(sys.argv) > 1 else synthetic_snapshot("/tmp/grace_synth.gdt")
    res = int(sys.argv[2]) if len(sys.argv) > 2 else 512

    spheres = jnp.asarray(read_gadget_gas(snapshot))
    print(f"{spheres.shape[0]} gas particles from {snapshot}")
    mins = np.array(jnp.min(spheres[:, :3], axis=0))
    maxs = np.array(jnp.max(spheres[:, :3], axis=0))
    side = float((maxs - mins).max())

    sorted_spheres, tree, _ = jax.jit(lambda s: build_sph_tree(s, 32))(spheres)
    rays = plane_parallel_random_rays(
        jax.random.key(0), res, res,
        base=(mins[0], mins[1], mins[2] - side),
        w=(side, 0, 0), h=(0, side, 0), length=3 * side,
    )
    img = np.array(trace_cumulative_sph(rays, sorted_spheres, tree)).reshape(res, res)
    write_bmp("density.bmp", to_colormap(img, log_scale=True))
    print(f"wrote density.bmp ({res}x{res}); column density range "
          f"[{img.min():.4g}, {img.max():.4g}]")


if __name__ == "__main__":
    main()
