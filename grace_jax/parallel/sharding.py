"""Multi-chip distribution (capability the reference lacks: it is single-GPU,
ref SURVEY.md section 2.3 — no NCCL/MPI anywhere).

Scaling design (BASELINE.json north star):

  * axis "rays":  rays / image tiles are embarrassingly parallel — shard
    them; particles + tree replicated. Zero communication in the forward;
    per-particle gradients are psum-reduced over this axis (inserted
    automatically by shard_map's reverse-mode transpose).
  * axis "space": when particles exceed one card's memory, shard particles
    spatially; each shard builds its *local* BVH, and fixed-size ray blocks
    circulate around the ring via ppermute, accumulating column density from
    each particle shard in turn — structurally identical to ring attention:
    blocks move, per-ray accumulators ride along.

Meshes follow the algorithm: a rays-only mesh (n, 1) serves ray sharding,
a space-only mesh (1, n) serves the ring. Both axes compose in a 2D mesh;
``sharded_train_step`` demonstrates the
full differentiable pipeline (render -> loss -> particle gradients ->
SGD update) under jit over the mesh.
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from grace_jax.build.sph import build_sph_tree
from grace_jax.core.types import Rays
from grace_jax.trace.render import find_hits, integrate_hits


def make_mesh(n_rays_axis: int, n_space_axis: int = 1, devices=None) -> Mesh:
    devices = jax.devices() if devices is None else devices
    n = n_rays_axis * n_space_axis
    import numpy as np

    dev = np.asarray(devices[:n]).reshape(n_rays_axis, n_space_axis)
    return Mesh(dev, axis_names=("rays", "space"))


def replicated_sharded_render(
    mesh: Mesh, rays: Rays, spheres, tree, capacity_per_shard: int
):
    """v1 scaling: rays sharded over the whole mesh, particles replicated."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(("rays", "space")), P(), jax.tree_util.tree_map(lambda _: P(), tree)),
        out_specs=(P(("rays", "space")), P()),
    )
    def shard_render(local_rays, spheres, tree):
        recs = find_hits(local_rays, spheres, tree, capacity_per_shard)
        img = integrate_hits(recs, local_rays, spheres, local_rays.n_rays)
        # Overflowed shards silently drop hits — surface the flag, reduced
        # over the whole mesh so every host sees it (VERDICT r1: sharded
        # consumers must check total_hits > capacity).
        ovf = jax.lax.pmax(
            (recs.total_hits > capacity_per_shard).astype(jnp.int32),
            ("rays", "space"),
        )
        return img, ovf > 0

    return shard_render(rays, spheres, tree)


def sharded_pallas_render(
    mesh: Mesh,
    rays: Rays,
    spheres,
    tile: int = 64,
    mode: str = "cumulative",
    max_chunks: int = 2048,
    interpret: bool = False,
):
    """Rays sharded over the whole mesh, particles replicated, each shard
    running the fused trace kernel (trace/pallas_kernel.py) on its local
    ray block. The forward is communication-free; returns (values
    f32/i32[R], overflow bool[]) with the overflow flag pmax'd mesh-wide.
    """
    return _sharded_pallas_fn(mesh, tile, mode, max_chunks,
                              interpret)(rays, spheres)


@functools.lru_cache(maxsize=None)
def _sharded_pallas_fn(mesh: Mesh, tile: int, mode: str, max_chunks: int,
                       interpret: bool):
    # Cached jitted closure: rebuilding the shard_map per call would
    # re-trace it every time.
    from grace_jax.trace.pallas_kernel import pallas_trace_sph

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(("rays", "space")), P()),
        out_specs=(P(("rays", "space")), P()),
        check_vma=False,  # pallas_call out_shapes carry no vma annotations
    )
    def shard_render(local_rays, spheres):
        v, ovf = pallas_trace_sph(
            local_rays, spheres, tile=tile, mode=mode, max_chunks=max_chunks,
            interpret=interpret)
        flag = jax.lax.pmax(jnp.any(ovf).astype(jnp.int32), ("rays", "space"))
        return v, flag > 0

    return jax.jit(shard_render)


def ring_pallas_render(
    mesh: Mesh,
    rays: Rays,
    spheres,
    tile: int = 64,
    max_chunks: int = 2048,
    interpret: bool = False,
):
    """Particles spatially sharded over "space", ray blocks (with
    accumulators) circulating the ring via ppermute, the fused cumulative
    trace kernel running per step against the resident particle shard —
    ring_render_and_loss's structure with the fused kernel inside, so the
    fast renderer scales past one card's memory. Returns (values f32[R],
    overflow bool[]).
    """
    return _ring_pallas_fn(mesh, tile, max_chunks, interpret)(rays, spheres)


@functools.lru_cache(maxsize=None)
def _ring_pallas_fn(mesh: Mesh, tile: int, max_chunks: int,
                    interpret: bool):
    from grace_jax.trace.broadphase import tile_aabbs
    from grace_jax.trace.pallas_broadphase import (
        compact_mask_words, masks_for_tile_aabbs)
    from grace_jax.trace.pallas_kernel import pad_rays, pallas_trace_sph
    from grace_jax.utils.vma import promote_to_vma

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(("rays", "space")), P("space")),
        out_specs=(P(("rays", "space")), P()),
        check_vma=False,  # pallas_call out_shapes carry no vma annotations
    )
    def shard_render(local_rays, local_spheres):
        n_space = jax.lax.axis_size("space")
        idx = jax.lax.axis_index("space")
        perm = [(i, (i + 1) % n_space) for i in range(n_space)]
        n_local = local_rays.n_rays
        local_rays = pad_rays(local_rays, tile)

        # Broadphase hoisted OUT of the ring (one batched pass instead of a
        # serialized per-step cull): every block's per-tile AABBs are tiny,
        # so gather THEM over the ring and build this shard's segment lists
        # against all n_space blocks up front.
        tmin, tmax = tile_aabbs(local_rays, tile)
        tmin_all = jax.lax.all_gather(tmin, "space")   # (n_space, T, 3)
        tmax_all = jax.lax.all_gather(tmax, "space")
        lists_all = jax.vmap(
            lambda a, b: compact_mask_words(
                masks_for_tile_aabbs(a, b, local_spheres), max_chunks)
        )(tmin_all, tmax_all)                          # 3 x (n_space, T, ...)

        def step(carry, t):
            rays_blk, acc, ovf = carry
            # After t forward ppermutes, this shard holds the block that
            # STARTED at ring position idx - t.
            b = jax.lax.rem(idx - t + n_space, n_space)
            segments = jax.tree_util.tree_map(
                lambda a: jax.lax.dynamic_index_in_dim(a, b, keepdims=False),
                lists_all)
            v, o = pallas_trace_sph(
                rays_blk, local_spheres, tile=tile, mode="cumulative",
                segments=segments, interpret=interpret)
            acc = acc + v
            ovf = ovf | jnp.any(o)
            rays_nxt = jax.tree_util.tree_map(
                lambda x: jax.lax.ppermute(x, "space", perm), rays_blk)
            acc_nxt = jax.lax.ppermute(acc, "space", perm)
            return (rays_nxt, acc_nxt, ovf), None

        acc0 = jnp.zeros((local_rays.n_rays,), jnp.float32)
        init = promote_to_vma(
            (local_rays, acc0, jnp.zeros((), jnp.bool_)),
            frozenset(("rays", "space")))
        (_, img, ovf), _ = jax.lax.scan(
            step, init, jnp.arange(n_space, dtype=jnp.int32))
        flag = jax.lax.pmax(ovf.astype(jnp.int32), ("rays", "space"))
        return img[:n_local], flag > 0

    return jax.jit(shard_render)


def sharded_splat_render(mesh: Mesh, buckets, basis: str = "deg8",
                         interpret: bool = False):
    """Splat renderer over the mesh: image TILE ROWS sharded across all
    devices, instance slabs replicated. Communication-free forward; the
    per-(scene, camera) bucket prep stays replicated.

    Returns the full image f32[H, W] sharded over rows.
    """
    n_dev = mesh.devices.size
    nty = buckets.first.shape[0]
    if nty % n_dev:
        raise ValueError(f"tile rows {nty} must divide over {n_dev} devices")
    return _sharded_splat_fn(mesh, basis, interpret)(buckets)


@functools.lru_cache(maxsize=None)
def _sharded_splat_fn(mesh: Mesh, basis: str, interpret: bool):
    from grace_jax.trace.splat import SplatBuckets, splat_image

    # Leading-axis (tile row) sharding of the per-tile metadata and the
    # pixel-row coordinates.
    rows = P(("rays", "space"))
    specs = SplatBuckets(
        slabs=P(), slab_lo=rows, n_slabs=rows, first=rows, last=rows,
        xcols=P(), yrows=rows, overflow=P(),
    )

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(specs,), out_specs=rows,
        check_vma=False,  # pallas_call out_shapes carry no vma annotations
    )
    def shard_render(local):
        return splat_image(local, basis=basis, interpret=interpret)

    return jax.jit(shard_render)


def ring_render_and_loss(
    local_rays: Rays,
    local_spheres,
    target,
    capacity: int,
    max_per_leaf: int,
    space_axis: str = "space",
):
    """Inside-shard_map body: ring column-density render + local loss.

    Each space shard builds the BVH of its resident particles once, then the
    ray blocks (with their accumulators) make a full circuit of the ring; at
    every step the block accumulates the local shard's contribution before
    being ppermute'd to the next neighbor. After axis_size steps every block
    is home with the full integral.
    """
    n_space = jax.lax.axis_size(space_axis)
    idx = jax.lax.axis_index(space_axis)
    perm = [(i, (i + 1) % n_space) for i in range(n_space)]

    sorted_spheres, tree, _ = build_sph_tree(local_spheres, max_per_leaf)

    def step(carry, _):
        rays_blk, acc, ovf = carry
        recs = find_hits(rays_blk, jax.lax.stop_gradient(sorted_spheres), tree, capacity)
        acc = acc + integrate_hits(recs, rays_blk, sorted_spheres, rays_blk.n_rays)
        ovf = ovf | (recs.total_hits > capacity)
        rays_nxt = jax.tree_util.tree_map(
            lambda x: jax.lax.ppermute(x, space_axis, perm), rays_blk
        )
        acc_nxt = jax.lax.ppermute(acc, space_axis, perm)
        return (rays_nxt, acc_nxt, ovf), None

    # scan requires a consistent carry type under shard_map: ppermute makes
    # every carry leaf varying over the mesh axes, so promote any
    # still-invariant leaf (e.g. broadcast constants) before the scan.
    from grace_jax.utils.vma import promote_to_vma

    acc0 = jnp.zeros((local_rays.n_rays,), jnp.float32)
    ovf0 = jnp.zeros((), jnp.bool_)
    init = promote_to_vma((local_rays, acc0, ovf0),
                          frozenset(("rays", space_axis)))
    (rays_out, img, ovf), _ = jax.lax.scan(step, init, None, length=n_space)
    # After n_space ppermutes the block is back at its home shard. The
    # overflow flag traveled with the block; reduce so every shard agrees.
    overflow = jax.lax.pmax(ovf.astype(jnp.int32), ("rays", space_axis)) > 0
    local_loss = jnp.sum((img - target) ** 2)
    return img, local_loss, overflow


def sharded_train_step(
    mesh: Mesh,
    rays: Rays,
    spheres,
    targets,
    capacity: int,
    max_per_leaf: int,
    lr: float = 1e-3,
):
    """Full differentiable training step over a ("rays", "space") mesh.

    Rays and targets are sharded over both axes (each space lane starts with
    its own resident ray block); particles are sharded over "space" and
    replicated over "rays". The loss gradient w.r.t. the local particle shard
    is psum'd over "rays" by shard_map's transpose; the returned updated
    particles keep the P("space") sharding.

    Returns (new_spheres, loss, overflow). overflow=True means some shard's
    hit buffer overflowed ``capacity`` and the loss/gradient are silently
    truncated — callers MUST check it (errors.check_overflow raises).
    """

    def train(rays, spheres, targets):
        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(("rays", "space")), P("space"), P(("rays", "space"))),
            out_specs=(P("space"), P(), P()),
        )
        def grad_shard(local_rays, local_spheres, local_targets):
            def loss_fn(ls):
                _, local_loss, overflow = ring_render_and_loss(
                    local_rays, ls, local_targets, capacity, max_per_leaf
                )
                # Total loss over every ray shard: psum over both axes.
                return jax.lax.psum(local_loss, ("rays", "space")), overflow

            (loss, overflow), g = jax.value_and_grad(loss_fn, has_aux=True)(
                local_spheres)
            return g, loss, overflow

        g, loss, overflow = grad_shard(rays, spheres, targets)
        new_spheres = spheres - lr * g
        return new_spheres, loss, overflow

    return jax.jit(train)(rays, spheres, targets)
