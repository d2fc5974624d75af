"""Smoke test of the SPH column-density path on one NVIDIA GPU.

    python chip_smoke.py            # one GPU: phases 1-4
    python chip_smoke.py --multi    # four GPUs: the sharded paths only

Drives the main path through the public entry points at the bench scene
(2^20 clustered particles, 512x512 orthographic rays): seeded scene ->
build_sph_tree -> ray generation and spatial_sort_rays ->
bucket_prims_ortho -> splat image, checked against the plain XLA splat and
the fused trace kernel, which is itself checked against the XLA engine.
Every Pallas kernel runs compiled for the GPU (Triton), never in the
interpreter.

Phases:
  1. compile each kernel at its real shapes, print its memory analysis,
     and compare it once with its reference on a small scene;
  2. the main path at 2^20 particles and 512^2 rays, with the
     kernel-vs-XLA times (host-clock medians around block_until_ready
     after warm-up);
  3. a 2^23-particle scene (134 MB of positions and h, past the 50 MB L2);
  4. the public facades: hit counts vs a numpy oracle, per-hit records plus
     the distance sort at 38,400 rays, jax.grad of the differentiable
     render vs finite differences, triangle closest-hit vs brute force.
With ``--multi``: every sharded path at 2^20 particles and 512^2 rays on
four GPUs, each against the single-GPU result on device 0.

Every phase prints its errors beside their tolerances. Any failure raises
and the process exits non-zero; the last line of a passing run is one
JSON object naming the device. Without a GPU the script exits non-zero
before doing anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_MAIN = 1 << 20
N_BIG = 1 << 23
SIDE = 512
SLICE = 16384
MAX_PER_LEAF = 32
CAM = (0.5, 0.5, -2.0)
LOOK = (0.5, 0.5, 0.5)
UP = (0.0, 1.0, 0.0)
VEXT = 1.2
LENGTH = 6.0
# Splat layout: 16x16-pixel tiles (1024 programs at 512^2), 64-instance
# slabs. Trace: 64-ray tiles on 8 warps (the kernel's default).
TILE_W, BAND, CHUNK = 16, 16, 64
TRACE_TILE = 64
MAX_CHUNKS = {N_MAIN: 2048, N_BIG: 8192}

# Tolerances, each with its reason.
TOL_SPLAT_VS_XLA = 1e-4     # same model; 3xTF32 kernel vs f32 XLA, f32 sums
TOL_SPLAT_VS_REF = 1e-4     # same model vs the dense reference
TOL_SPLAT_VS_TRACE = 1e-3   # basis fit (3.1e-4) + Horner integral (2e-5)
TOL_TRACE_VS_ENGINE = 1e-4  # Horner integral (~2e-5) vs 2048-entry table
TOL_GRAD_FD = 2e-2          # f32 central differences of an f32 loss
TOL_SHARDED = 1e-5          # identical kernels, other scatter/sum order
TOL_TRAIN = 1e-3            # atomic segment_sum order in the backward


def log(msg):
    print(msg, flush=True)


def check(name, err, tol):
    """Print an error beside its tolerance; fail the run if it is over."""
    ok = bool(np.isfinite(err)) and err <= tol
    log(f"  {name}: {err:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {err} exceeds {tol}")


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def median_ms(fn, *args, reps=7):
    """Host-clock median around block_until_ready, after one warm-up."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def scene(n, seed=2026):
    """Seeded clustered scene, Morton-sorted, with its tree."""
    import jax
    import jax.numpy as jnp
    from grace_jax.build.sph import build_sph_tree
    from grace_jax.io.synthetic import make_clustered_particles

    spheres = jnp.asarray(make_clustered_particles(np.random.default_rng(seed), n))
    ss, tree, _ = jax.jit(build_sph_tree, static_argnums=1)(spheres, MAX_PER_LEAF)
    return spheres, ss, tree


def camera_rays(side):
    """Orthographic rays, their spatially sorted order, and the inverse."""
    import jax
    from grace_jax.rays.gen import orthographic_projection_rays, spatial_sort_rays

    rays = orthographic_projection_rays(side, side, CAM, LOOK, UP, VEXT, LENGTH)
    rays_s, order, inv = jax.jit(spatial_sort_rays)(rays)
    return rays_s, order, inv


def buckets_for(ss, side):
    from grace_jax.trace.splat import bucket_prims_ortho

    b = bucket_prims_ortho(ss, CAM, LOOK, UP, VEXT, LENGTH, side, side,
                           tile_w=TILE_W, band=BAND, chunk=CHUNK)
    assert not bool(b.overflow), "splat tile overflow"
    return b


def phase_compile(n, side, interpret=False):
    """Compile each kernel at its real shapes; compare once on a small
    scene with its reference."""
    import jax
    import jax.numpy as jnp
    from grace_jax.trace.pallas_kernel import pallas_trace_sph
    from grace_jax.trace.sph import trace_cumulative_sph
    from grace_jax.trace.splat import OrthoCamera, splat_image, splat_reference_jnp

    log("phase 1: compile at real shapes")
    _, ss, _ = scene(n)
    rays_s, _, _ = camera_rays(side)
    b = buckets_for(ss, side)
    for name, fn, args in (
        ("splat_image", lambda bb: splat_image(bb, interpret=interpret), (b,)),
        ("trace_sph_cumulative",
         lambda r, s: pallas_trace_sph(r, s, tile=TRACE_TILE,
                                       max_chunks=MAX_CHUNKS.get(n, 2048),
                                       interpret=interpret),
         (rays_s, ss)),
    ):
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args).compile()
        log(f"  {name}: compiled in {time.perf_counter() - t0:.1f} s; "
            f"memory_analysis: {compiled.memory_analysis()}")

    log("phase 1: compare once on a small scene")
    small_side = 128
    _, ss_s, tree_s = scene(1 << 12, seed=7)
    cam = OrthoCamera(CAM, LOOK, UP, VEXT, LENGTH, small_side, small_side)
    img = splat_image(buckets_for(ss_s, small_side), interpret=interpret)
    with jax.default_matmul_precision("highest"):
        ref = splat_reference_jnp(ss_s, None, cam)
    check("splat_image vs splat_reference_jnp (rel to max)", rel_max(img, ref),
          TOL_SPLAT_VS_REF)
    rays, _, _ = camera_rays(small_side)
    v, ovf = pallas_trace_sph(rays, ss_s, tile=TRACE_TILE, interpret=interpret)
    assert not bool(jnp.any(ovf)), "trace list overflow"
    check("trace kernel vs trace_cumulative_sph (rel to max)",
          rel_max(v, trace_cumulative_sph(rays, ss_s, tree_s)),
          TOL_TRACE_VS_ENGINE)


def phase_main(n, side, max_chunks, full_trace=True, interpret=False,
               label="phase 2"):
    """The main path: splat vs XLA splat vs trace kernel vs XLA engine.
    ``full_trace=False`` traces only the first SLICE sorted rays."""
    import jax
    import jax.numpy as jnp
    from grace_jax.trace.pallas_kernel import pallas_trace_sph
    from grace_jax.trace.sph import trace_cumulative_sph, trace_hitcounts_sph
    from grace_jax.trace.splat import splat_image, splat_image_xla

    log(f"{label}: {n} particles, {side}x{side} rays")
    t0 = time.perf_counter()
    _, ss, tree = scene(n)
    jax.block_until_ready(ss)
    rays_s, order, inv = camera_rays(side)
    b = buckets_for(ss, side)
    jax.block_until_ready(b.slabs)
    log(f"  set-up (build, rays, bucket prep; compile included): "
        f"{time.perf_counter() - t0:.1f} s; {int(jnp.sum(b.last - b.first))} "
        f"splat instances in {b.slabs.shape[0]} slabs")

    splat = lambda bb: splat_image(bb, interpret=interpret)
    img = splat(b)
    img_x = splat_image_xla(b)
    check("splat kernel vs XLA splat (rel to max)", rel_max(img, img_x),
          TOL_SPLAT_VS_XLA)

    trace = jax.jit(lambda r, s: pallas_trace_sph(
        r, s, tile=TRACE_TILE, max_chunks=max_chunks, interpret=interpret))
    sl = jax.tree.map(lambda x: x[:SLICE], rays_s)
    traced = rays_s if full_trace else sl
    tv, ovf = trace(traced, ss)
    assert not bool(jnp.any(ovf)), "trace list overflow: raise max_chunks"
    if full_trace:
        check("splat vs trace kernel, full image (rel to max)",
              rel_max(img, jnp.reshape(tv[inv], (side, side))),
              TOL_SPLAT_VS_TRACE)
    else:
        check(f"splat vs trace kernel, {SLICE} rays (rel to max)",
              rel_max(img.reshape(-1)[order[:SLICE]], tv), TOL_SPLAT_VS_TRACE)
    eng = jax.jit(trace_cumulative_sph)
    check(f"trace kernel vs trace_cumulative_sph, {SLICE} rays (rel to max)",
          rel_max(tv[:SLICE], eng(sl, ss, tree)), TOL_TRACE_VS_ENGINE)
    hc, ovf_h = pallas_trace_sph(sl, ss, tile=TRACE_TILE, max_chunks=max_chunks,
                                 mode="hitcount", interpret=interpret)
    hc_eng = jax.jit(trace_hitcounts_sph)(sl, ss, tree)
    n_diff = int(jnp.sum(hc != hc_eng)) + int(jnp.any(ovf_h))
    log(f"  hitcounts kernel vs engine, {SLICE} rays: {n_diff} differ "
        f"({int(jnp.sum(hc_eng))} hits; must be exactly equal)")
    assert n_diff == 0, "hitcount mismatch"

    t_splat = median_ms(splat, b)
    t_splat_x = median_ms(splat_image_xla, b)
    log(f"  TIME splat: Triton kernel {t_splat:.3f} ms, XLA splat "
        f"{t_splat_x:.3f} ms ({side * side} rays)")
    t_trace = median_ms(trace, traced, ss)
    t_eng = median_ms(eng, traced, ss, tree, reps=3)
    log(f"  TIME trace: Triton kernel {t_trace:.3f} ms, XLA engine "
        f"trace_cumulative_sph {t_eng:.3f} ms ({traced.n_rays} rays)")
    from grace_jax.trace.splat import bucket_prims_ortho

    bucket = lambda s: bucket_prims_ortho(s, CAM, LOOK, UP, VEXT, LENGTH, side,
                                          side, tile_w=TILE_W, band=BAND,
                                          chunk=CHUNK)
    log(f"  TIME bucket prep {median_ms(bucket, ss, reps=3):.3f} ms")


def phase_facades(n, interpret=False):
    """The public facades on the device."""
    import jax
    import jax.numpy as jnp
    import grace_jax as gt
    from grace_jax.models.triangle import (build_triangle_tree,
                                           intersect_triangle,
                                           trace_closest_hit)
    from grace_jax.ops.segops import sort_by_distance
    from grace_jax.rays.gen import plane_parallel_random_rays, uniform_random_rays
    from grace_jax.trace.render import find_hits, integrate_hits

    log("phase 4: public facades")
    # hit counts vs the numpy oracle
    rng = np.random.default_rng(42)
    spheres = gt.make_spheres(rng.random((3000, 3), np.float32),
                              (0.01 + 0.06 * rng.random(3000)).astype(np.float32))
    ss, tree, _ = jax.jit(gt.build_sph_tree, static_argnums=1)(spheres, 16)
    o = (rng.random((400, 3)) * 0.1 - 0.3).astype(np.float32)
    d = rng.standard_normal((400, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = gt.Rays.from_arrays(o, d, np.full(400, 4.0, np.float32))
    counts = np.array(gt.trace_hitcounts_sph(rays, ss, tree))
    s = np.array(ss)
    p = s[None, :, :3] - o[:, None, :]
    t = (p * d[:, None, :]).sum(-1)
    b = p - t[..., None] * d[:, None, :]
    hit = ((b * b).sum(-1) < s[None, :, 3] ** 2) & (t >= 0) & (t < 4.0)
    n_diff = int(np.sum(counts != hit.sum(1)))
    log(f"  trace_hitcounts_sph vs numpy oracle: {n_diff} of 400 rays differ "
        f"(must be 0; {counts.sum()} hits)")
    assert n_diff == 0

    # per-hit records + distance sort at 38,400 isotropic rays
    _, ss_m, tree_m = scene(n)
    rays_i = uniform_random_rays(jax.random.key(3), 38400, (0.5, 0.5, 0.5), 0.5)
    hc = gt.trace_hitcounts_sph(rays_i, ss_m, tree_m)
    total = int(jnp.sum(hc))
    cap = 1 << int(np.ceil(np.log2(max(total, 1))))
    t0 = time.perf_counter()
    res = jax.jit(gt.trace_sph, static_argnums=3)(rays_i, ss_m, tree_m, cap)
    dist_s, idx_s, val_s = jax.jit(sort_by_distance)(
        res.distances, res.offsets, res.indices, res.integrals,
        total_hits=res.total_hits)
    jax.block_until_ready(dist_s)
    log(f"  trace_sph + sort_by_distance, 38400 rays: {total} hits "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")
    assert int(res.total_hits) == total
    seg = np.repeat(np.arange(38400), np.asarray(res.counts))
    ds = np.asarray(dist_s)[:total]
    bad = int(np.sum((np.diff(ds) < 0) & (seg[1:] == seg[:-1])))
    log(f"  per-ray distance order violations: {bad} (must be 0)")
    assert bad == 0
    per_ray = jax.ops.segment_sum(val_s[:total], jnp.asarray(seg),
                                  num_segments=38400)
    cum = gt.trace_cumulative_sph(rays_i, ss_m, tree_m)
    check("sum of sorted records vs trace_cumulative_sph (rel to max)",
          rel_max(per_ray, cum), 1e-5)

    # jax.grad of the differentiable render vs finite differences
    rng = np.random.default_rng(9)
    sp = gt.make_spheres((0.25 + 0.5 * rng.random((60, 3))).astype(np.float32),
                         (0.05 + 0.05 * rng.random(60)).astype(np.float32))
    ss_g, tree_g, _ = jax.jit(gt.build_sph_tree, static_argnums=1)(sp, 4)
    rays_g = plane_parallel_random_rays(jax.random.key(9), 48, 48, (0, 0, -3.0),
                                        (1, 0, 0), (0, 1, 0), length=10.0)
    rec = find_hits(rays_g, ss_g, tree_g, capacity=1 << 15)
    tgt = jax.random.normal(jax.random.key(0), (rays_g.n_rays,), jnp.float32)

    def loss(s):
        img = integrate_hits(rec, rays_g, s, rays_g.n_rays, use_closed_form=True)
        return jnp.mean(img * tgt)

    g = np.asarray(jax.grad(loss)(ss_g), np.float64)
    s0 = np.asarray(ss_g, np.float64)
    worst = 0.0
    for k in range(4):
        dvec = np.random.default_rng(k).standard_normal(s0.shape)
        dvec /= np.linalg.norm(dvec)
        eps = 1e-3
        fd = (float(loss(jnp.asarray(s0 + eps * dvec, jnp.float32)))
              - float(loss(jnp.asarray(s0 - eps * dvec, jnp.float32)))) / (2 * eps)
        worst = max(worst, abs(fd - float((g * dvec).sum()))
                    / max(abs(fd), 1e-3 * np.abs(g).max()))
    check("jax.grad(render) vs central differences, 4 directions (rel)",
          worst, TOL_GRAD_FD)

    # triangle closest hit vs brute force
    rng = np.random.default_rng(5)
    tris = (rng.random((300, 1, 3)) + 0.08 * rng.standard_normal((300, 3, 3))
            ).astype(np.float32)
    stris, ttree, _ = build_triangle_tree(jnp.asarray(tris), max_per_leaf=4)
    dr = rng.standard_normal((256, 3)).astype(np.float32)
    dr /= np.linalg.norm(dr, axis=1, keepdims=True)
    trays = gt.Rays.from_arrays((rng.random((256, 3)) * 0.2 - 0.5).astype(np.float32),
                                dr, np.full(256, 5.0, np.float32))
    ch = trace_closest_hit(trays, stris, ttree)
    hit_t, tt = intersect_triangle(trays.origins[:, None, :],
                                   trays.directions[:, None, :],
                                   trays.lengths[:, None], stris[None])
    tt = np.where(np.asarray(hit_t), np.asarray(tt), np.inf)
    tri_ref = np.where(np.isfinite(tt.min(1)), tt.argmin(1), -1)
    n_diff = int(np.sum(np.asarray(ch.tri) != tri_ref))
    log(f"  triangle closest-hit vs brute force: {n_diff} of 256 rays differ "
        f"(must be 0)")
    assert n_diff == 0


def phase_multi(n, side, max_chunks, n_dev=4, interpret=False):
    """Every sharded path against the single-device result on device 0."""
    import jax
    import jax.numpy as jnp
    from grace_jax.build.sph import build_sph_tree
    from grace_jax.parallel.sharding import (
        make_mesh, replicated_sharded_render, ring_pallas_render,
        sharded_pallas_render, sharded_splat_render, sharded_train_step)
    from grace_jax.trace.pallas_kernel import pallas_trace_sph
    from grace_jax.trace.render import render_column_density
    from grace_jax.trace.sph import trace_hitcounts_sph
    from grace_jax.trace.splat import splat_image

    log(f"phase multi: {n_dev} devices, {n} particles, {side}x{side} rays")
    rays_mesh = make_mesh(n_dev, 1)
    ring_mesh = make_mesh(1, n_dev)
    spheres, ss, tree = scene(n)
    rays_s, _, _ = camera_rays(side)
    b = buckets_for(ss, side)

    img_1 = splat_image(b, interpret=interpret)
    img_n = sharded_splat_render(rays_mesh, b, interpret=interpret)
    check("sharded_splat_render vs one device (rel to max)", rel_max(img_n, img_1),
          TOL_SHARDED)

    single, ovf = pallas_trace_sph(rays_s, ss, tile=TRACE_TILE,
                                   max_chunks=max_chunks, interpret=interpret)
    assert not bool(jnp.any(ovf))
    v1, o1 = sharded_pallas_render(rays_mesh, rays_s, ss, tile=TRACE_TILE,
                                   max_chunks=max_chunks, interpret=interpret)
    assert not bool(o1)
    check("sharded_pallas_render vs one device (rel to max)", rel_max(v1, single),
          TOL_SHARDED)
    v2, o2 = ring_pallas_render(ring_mesh, rays_s, ss, tile=TRACE_TILE,
                                max_chunks=max_chunks, interpret=interpret)
    assert not bool(o2)
    check("ring_pallas_render vs one device (rel to max)", rel_max(v2, single),
          TOL_SHARDED)

    total = int(jnp.sum(trace_hitcounts_sph(rays_s, ss, tree)))
    cap = int(total * 0.3) + 4096
    img_r, ovf_r = replicated_sharded_render(rays_mesh, rays_s, ss, tree, cap)
    assert not bool(ovf_r)
    ref = render_column_density(rays_s, ss, tree, total + 1)
    check("replicated_sharded_render vs one device (rel to max)",
          rel_max(img_r, ref), TOL_SHARDED)

    # Ring training step over particle shards vs one device: loss and the
    # gradient (lr = 1 makes spheres - new_spheres the gradient).
    target = jnp.zeros((rays_s.n_rays,), jnp.float32)
    cap_ring = total // n_dev + 4096
    new, loss_n, ovf_t = sharded_train_step(ring_mesh, rays_s, spheres, target,
                                            cap_ring, MAX_PER_LEAF, lr=1.0)
    assert not bool(ovf_t), "ring hit capacity overflow"
    g_n = spheres - new

    def loss_1(s):
        s_sorted, tr, _ = build_sph_tree(s, MAX_PER_LEAF)
        img = render_column_density(rays_s, s_sorted, tr, total + 1)
        return jnp.sum((img - target) ** 2)

    loss1, g1 = jax.jit(jax.value_and_grad(loss_1))(
        jax.device_put(spheres, jax.devices()[0]))
    check("sharded_train_step loss vs one device (rel)",
          abs(float(loss_n) - float(loss1)) / abs(float(loss1)), TOL_TRAIN)
    check("sharded_train_step gradient vs one device (rel to max)",
          rel_max(g_n, g1), TOL_TRAIN)


def main(argv):
    import jax

    multi = "--multi" in argv
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r}); "
              "this script measures nothing elsewhere", file=sys.stderr)
        return 2
    n_dev = 4 if multi else 1
    if len(devices) < n_dev:
        print(f"chip_smoke: needs {n_dev} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    from grace_jax.utils.compile_cache import enable_compilation_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)  # card name and power limit, one line per card
    log(f"jax {jax.__version__}; devices: {devices}; compile cache: "
        f"{enable_compilation_cache()}")

    t0 = time.perf_counter()
    if multi:
        phase_multi(N_MAIN, SIDE, MAX_CHUNKS[N_MAIN], n_dev=n_dev)
    else:
        phase_compile(N_MAIN, SIDE)
        phase_main(N_MAIN, SIDE, MAX_CHUNKS[N_MAIN])
        phase_main(N_BIG, SIDE, MAX_CHUNKS[N_BIG], full_trace=False,
                   label="phase 3 (past L2)")
        phase_facades(N_MAIN)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
