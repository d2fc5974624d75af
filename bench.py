"""Headline benchmark: SPH column-density render throughput (rays/s).

Mirrors the reference's profile_trace_gadget workload shape
(ref: tests/profile_trace_gadget/profile_trace_gadget.cu): a clustered
particle snapshot, a 512x512 orthographic pixel grid, cumulative (column
density) render. Baseline for vs_baseline is the north-star target 1e8
rays/s (BASELINE.json) since the reference publishes no numbers
(BASELINE.md).

The default run measures the headline only: build + rays + bucket prep +
splat, a full-scale splat-vs-trace parity gate, then the splat frame time.
The JSON line prints (flushed) the moment it is known. Every stage logs a
timestamped line to stderr. GRACE_BENCH_FULL=1 additionally measures the
general fused trace and the bucket prep after the headline line and
prints them as a second JSON line.

Parity is gated on the device before timing: the splat image is compared
at full scale against the independent fused trace kernel.
"""

import json
import os
import sys
import time

import numpy as np

N_PARTICLES = int(os.environ.get("GRACE_BENCH_PARTICLES", 1 << 20))
N_RAYS = int(os.environ.get("GRACE_BENCH_RAYS", 512 * 512))
MAX_PER_LEAF = 32
NORTH_STAR_RAYS_PER_S = 1e8

CAM = (0.5, 0.5, -2.0)
LOOK = (0.5, 0.5, 0.5)
UP = (0.0, 1.0, 0.0)
VEXT = 1.2
LENGTH = 6.0
SPLAT_TILES = dict(tile_w=16, band=16, chunk=64)

_T0 = time.perf_counter()


def log(msg):
    """Stage marker on stderr: makes any hang attributable to a stage."""
    print(f"[bench +{time.perf_counter() - _T0:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


def device_frame_ms(body, k1=2, k2=18, reps=3):
    """Device time per frame, excluding host dispatch (the reference's
    profilers time kernels with cudaEvents, ref: helper/cuda_timer.cuh).

    ``body(i, acc) -> acc`` must make frame i+1 data-depend on frame i so
    XLA cannot CSE the chain. K frames run inside ONE jit; the per-frame
    time is the slope between two chain lengths, which cancels the fixed
    per-call cost.
    """
    import jax
    import jax.numpy as jnp

    # k is TRACED (fori_loop lowers to while) so both chain lengths share
    # one compilation.
    f = jax.jit(lambda k, x: jax.lax.fori_loop(0, k, body, x))
    float(f(jnp.int32(k1), jnp.float32(0.0)))  # compile + fault check

    def chain(k):
        best = None
        for _ in range(reps):
            t0 = time.perf_counter()
            v = float(f(jnp.int32(k), jnp.float32(0.0)))
            dt = time.perf_counter() - t0
            assert np.isfinite(v)
            best = dt if best is None else min(best, dt)
        return best

    return (chain(k2) - chain(k1)) / (k2 - k1) * 1e3


def setup_scene():
    """Build tree + sorted rays + splat buckets for the bench scene."""
    import jax
    import jax.numpy as jnp
    from grace_jax.build.sph import build_sph_tree
    from grace_jax.io.synthetic import make_clustered_particles
    from grace_jax.rays.gen import orthographic_projection_rays, spatial_sort_rays
    from grace_jax.trace.splat import bucket_prims_ortho

    rng = np.random.default_rng(2026)
    spheres = jnp.asarray(make_clustered_particles(rng, N_PARTICLES))
    side = int(np.sqrt(N_RAYS))

    log("tree build (compile + run)")
    build = jax.jit(lambda s: build_sph_tree(s, MAX_PER_LEAF))
    sorted_spheres, tree, _ = build(spheres)
    jax.block_until_ready(sorted_spheres)

    log("ray gen + spatial sort")
    rays = orthographic_projection_rays(side, side, CAM, LOOK, UP, VEXT, LENGTH)
    rays_s, _, inv = jax.jit(spatial_sort_rays)(rays)
    jax.block_until_ready(rays_s.origins)

    log("bucket prep (16x16 tiles, chunk 64)")
    buckets = bucket_prims_ortho(sorted_spheres, CAM, LOOK, UP, VEXT, LENGTH,
                                 side, side, **SPLAT_TILES)
    assert not bool(buckets.overflow), "splat tile overflow; enlarge tiles"
    return sorted_spheres, tree, rays_s, inv, buckets, side


def main(sharded: bool = False):
    from grace_jax.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    from grace_jax.trace.pallas_kernel import pallas_trace_sph
    from grace_jax.trace.splat import splat_image

    log(f"jax ready: {jax.devices()}")
    sorted_spheres, tree, rays_s, inv, buckets, side = setup_scene()

    # ---- on-device parity gate (before any timing) -------------------------
    # Splat image vs the independent fused trace kernel's cumulative values
    # at full scale (both approximate the same sums; gate inside the
    # combined basis-fit 3.1e-4 + Horner-integral 2e-5 tolerances).
    log("splat image (compile + run)")
    img = splat_image(buckets)
    jax.block_until_ready(img)

    log("fused trace full scale for parity (compile + run)")
    trace_v, ovf_t = pallas_trace_sph(rays_s, sorted_spheres)
    assert not bool(jnp.any(ovf_t)), "trace overflow flag set"
    img_trace = jnp.reshape(trace_v[inv], (side, side))
    rel_err = float(jnp.max(jnp.abs(img - img_trace)) / jnp.max(img_trace))
    assert np.isfinite(rel_err) and rel_err < 1e-3, f"splat/trace mismatch {rel_err}"
    log(f"parity OK: splat vs trace rel_err = {rel_err:.2e}")

    # ---- optional sharded mode (mesh over all available devices) ----------
    if sharded:
        from grace_jax.core.errors import check_overflow
        from grace_jax.parallel.sharding import (
            make_mesh, sharded_pallas_render, sharded_splat_render)

        n_dev = len(jax.devices())
        mesh = make_mesh(n_dev, 1)
        img_sh = sharded_splat_render(mesh, buckets)
        rel = float(jnp.max(jnp.abs(img_sh - img)) / jnp.max(img))
        assert rel < 1e-6, f"sharded splat != single-device splat ({rel})"
        tr_sh, ovf_sh = sharded_pallas_render(mesh, rays_s, sorted_spheres)
        check_overflow(ovf_sh, "sharded trace overflow")
        assert bool(jnp.all(tr_sh == trace_v)), "sharded trace != single"

        def splat_sh_body(i, acc):
            bb = buckets._replace(xcols=buckets.xcols + acc * 1e-38)
            im = sharded_splat_render(mesh, bb)
            return acc + im[0, 0] * 1e-38 + 1.0

        splat_sh_ms = device_frame_ms(splat_sh_body)
        rays_per_s = N_RAYS / (splat_sh_ms / 1e3)
        print(json.dumps({
            "metric": "sph_column_density_rays_per_s_sharded",
            "value": rays_per_s,
            "unit": "rays/s",
            "vs_baseline": rays_per_s / NORTH_STAR_RAYS_PER_S,
            "n_devices": n_dev,
            "sharded_equals_single": True,
            "splat_frame_ms": round(splat_sh_ms, 3),
        }), flush=True)
        return

    # ---- headline timing (device time via data-dependent chained frames;
    # see device_frame_ms) ---------------------------------------------------
    log("headline timing: device_frame_ms(splat)")

    def splat_body(i, acc):
        bb = buckets._replace(xcols=buckets.xcols + acc * 1e-38)
        im = splat_image(bb)
        return acc + im[0, 0] * 1e-38 + 1.0

    splat_ms = device_frame_ms(splat_body, reps=5)
    rays_per_s = N_RAYS / (splat_ms / 1e3)

    # THE headline line: printed the moment it is known, flushed, so a hang
    # in any later (optional) stage cannot lose it.
    print(
        json.dumps(
            {
                "metric": "sph_column_density_rays_per_s",
                "value": rays_per_s,
                "unit": "rays/s",
                "vs_baseline": rays_per_s / NORTH_STAR_RAYS_PER_S,
                "splat_frame_ms": round(splat_ms, 3),
                "device_parity_check": "ok",
                "splat_vs_trace_rel_err": rel_err,
                "device": {"platform": jax.devices()[0].platform,
                           "kind": jax.devices()[0].device_kind,
                           "count": len(jax.devices())},
            }
        ),
        flush=True,
    )
    log(f"HEADLINE DONE: {rays_per_s:.4g} rays/s ({splat_ms:.3f} ms/frame)")

    if os.environ.get("GRACE_BENCH_FULL", "0") != "1":
        return

    # ---- secondary metrics (manual runs only: GRACE_BENCH_FULL=1) ---------
    secondary = secondary_metrics(sorted_spheres, tree, rays_s)
    print(json.dumps({"metric": "secondary_metrics", **secondary}), flush=True)


def secondary_metrics(sorted_spheres, tree, rays_s):
    """The non-headline measurements (each logged; cheap first)."""
    import jax
    import jax.numpy as jnp
    from grace_jax.core.types import Rays
    from grace_jax.trace.pallas_kernel import pallas_trace_sph
    from grace_jax.trace.sph import trace_hitcounts_sph
    from grace_jax.trace.splat import bucket_prims_ortho

    side = int(np.sqrt(N_RAYS))
    out = {}

    # fused kernel hitcounts == XLA engine hitcounts, exactly, on a 16k-ray
    # slice.
    log("secondary: engine-vs-fused hitcount check (16k rays)")
    check_rays = jax.tree.map(lambda x: x[:16384], rays_s)
    hc_fast, ovf = pallas_trace_sph(check_rays, sorted_spheres, mode="hitcount")
    hc_ref = trace_hitcounts_sph(check_rays, sorted_spheres, tree)
    assert bool(jnp.all(hc_fast == hc_ref)) and not bool(jnp.any(ovf)), \
        "fused trace kernel hitcount parity FAILED on device"
    out["engine_parity_check"] = "ok"

    log("secondary: general fused trace timing")

    def trace_body(i, acc):
        rr = Rays(rays_s.origins, rays_s.directions,
                  rays_s.lengths + acc * 1e-38)
        v, _ = pallas_trace_sph(rr, sorted_spheres)
        return acc + v[0] * 1e-38 + 1.0

    trace_ms = device_frame_ms(trace_body, k1=2, k2=8)
    out["general_trace_rays_per_s"] = N_RAYS / (trace_ms / 1e3)
    out["general_trace_ms"] = round(trace_ms, 2)

    log("secondary: bucket prep timing")

    def bucket_body(i, acc):
        bb = bucket_prims_ortho(sorted_spheres + acc * 1e-38, CAM, LOOK, UP,
                                VEXT, LENGTH, side, side, **SPLAT_TILES)
        return acc + bb.slabs[0, 0, 0] * 1e-38 + 1.0

    out["bucket_prep_ms"] = round(device_frame_ms(bucket_body, k1=2, k2=8), 2)
    log("secondary metrics done")
    return out


if __name__ == "__main__":
    main(sharded="--sharded" in sys.argv)
