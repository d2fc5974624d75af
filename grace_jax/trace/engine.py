"""Generic BVH traversal engine (vectorized XLA formulation).

Analog of the reference's generic warp-cooperative trace kernel
(ref: include/grace/cuda/kernels/bintree_trace.cuh:52-197). Design mapping:

  CUDA reference                          this engine
  ------------------------------------    ----------------------------------
  1 thread = 1 ray, 1 warp = 32-ray       all R rays advance in lockstep,
  packet sharing a shared-memory stack    each with its own stack row in a
                                          [R, S] array
  warp __any ballots push children        per-ray predicated pushes; rays
  (bintree_trace.cuh:148-160)             are pre-sorted for coherence so
                                          lockstep iterations stay short
  texture fetches of nodes/leaves         XLA gathers from device memory
  per-leaf shared-memory staging of       [R, mpl, ...] vectorized gather +
  <= mpl prims (bintree_trace.cuh:178-191) batched intersection test
  functor template parameters             Python callables closed over at
  (Init/Intersect/OnHit/Entry/Exit)       trace time and traced into the jit

The user-extension quintuple (ref: bintree_trace.cuh:63-67) becomes the
``TraceFunctors`` callables; see grace_jax.trace.functors for the stock
library mirroring cuda/functors/trace.cuh.

The fused trace kernel (grace_jax.trace.pallas_kernel) computes hit counts
and column density for any ray bundle much faster; this XLA engine is the
reference implementation and serves every other functor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from grace_jax.core.config import VECTOR_STACK_SIZE
from grace_jax.core.errors import debug_assert
from grace_jax.core.types import Rays
from grace_jax.core.tree import Tree
from grace_jax.ops.intersect import aabbs_hit, safe_inverse_direction


@dataclass(frozen=True)
class TraceFunctors:
    """User extension points (analog of ref bintree_trace.cuh:63-67 template
    parameters Init / Intersection / OnHit / OnRayEntry / OnRayExit).

    intersect(rays_o, rays_d, rays_len, prims, ray_data) -> (hit, info)
      rays_*: f32[R, ...] broadcast to [R, mpl, ...]; prims: [R, mpl, ...]
      gathered leaf primitives. Returns hit mask bool[R, mpl] plus an
      arbitrary pytree of per-candidate info (e.g. b2, dist).

    on_hit(carry, ray_ids, prim_ids, info, hit) -> carry
      carry = (ray_data, global_state); prim_ids: i32[R, mpl] indices into
      the sorted primitive array; must honor the hit mask.

    ray_entry(ray_data) / ray_exit(ray_data) are optional pre/post maps
    (ref: functors/trace.cuh RayEntry_*/RayExit_*).
    """

    intersect: Callable[..., Tuple[jax.Array, Any]]
    on_hit: Callable[..., Any]
    ray_entry: Optional[Callable[[Any], Any]] = None
    ray_exit: Optional[Callable[[Any], Any]] = None


def trace(
    rays: Rays,
    tree: Tree,
    prims: jax.Array,
    functors: TraceFunctors,
    ray_data_init: Any,
    global_init: Any = None,
    stack_size: int = VECTOR_STACK_SIZE,
) -> Tuple[Any, Any]:
    """Traverse the BVH for every ray, invoking the functors at leaves.

    Returns (ray_data, global_state) after every ray's traversal completes.
    """
    n_rays = rays.n_rays
    mpl = tree.max_per_leaf

    inv_d = safe_inverse_direction(rays.directions)
    ray_ids = jnp.arange(n_rays, dtype=jnp.int32)

    ray_data = ray_data_init
    if functors.ray_entry is not None:
        ray_data = functors.ray_entry(ray_data)

    # Stack rows hold child-entries: >= 0 internal node, < 0 leaf (~idx).
    stack = jnp.zeros((n_rays, stack_size), jnp.int32)
    stack = stack.at[:, 0].set(tree.root)
    sp = jnp.ones((n_rays,), jnp.int32)

    prim_count = prims.shape[0]
    leaf_offsets = jnp.arange(mpl, dtype=jnp.int32)

    def body(state):
        stack, sp, ray_data, global_state = state
        active = sp > 0
        top_col = jnp.maximum(sp - 1, 0)
        top = stack[ray_ids, top_col]
        at_leaf = active & (top < 0)
        at_node = active & (top >= 0)

        # ---- internal node step: test the two child AABBs ----------------
        node = jnp.clip(top, 0, tree.capacity - 1)
        kids = tree.children[node]              # [R, 2]
        boxes = tree.child_aabbs[node]          # [R, 2, 2, 3]
        hits = aabbs_hit(
            rays.origins[:, None, :],
            inv_d[:, None, :],
            rays.lengths[:, None],
            boxes[:, :, 0, :],
            boxes[:, :, 1, :],
        )                                        # bool [R, 2]
        hits = hits & at_node[:, None]
        hit_l = hits[:, 0]
        hit_r = hits[:, 1]
        n_push = hit_l.astype(jnp.int32) + hit_r.astype(jnp.int32)
        # Replace the popped entry; when both children hit, the right child
        # lands on top of the stack and pops first. Traversal order does not
        # affect any supported query (no early-out tracing).
        first = jnp.where(hit_l, kids[:, 0], kids[:, 1])
        second = kids[:, 1]
        col0 = jnp.where(at_node & (n_push >= 1), top_col, stack_size)
        new_stack = stack.at[ray_ids, col0].set(first, mode="drop")
        col1 = jnp.where(at_node & (n_push == 2), top_col + 1, stack_size)
        new_stack = new_stack.at[ray_ids, col1].set(second, mode="drop")
        sp_node = sp - 1 + n_push
        # Stack-bound invariant (ref GRACE_ASSERT, bintree_trace.cuh:164):
        # a push past stack_size silently drops the node — results would be
        # truncated. Active only under GRACE_JAX_DEBUG=1.
        debug_assert(
            jnp.logical_not(at_node) | (sp_node <= stack_size),
            "traversal stack overflow: raise stack_size",
        )

        # ---- leaf step: gather <= mpl primitives and intersect ------------
        leaf = jnp.clip(jnp.invert(top), 0, tree.leaf_capacity - 1)
        first_prim = tree.leaves[leaf, 0]
        count = tree.leaves[leaf, 1]
        prim_ids = first_prim[:, None] + leaf_offsets[None, :]      # [R, mpl]
        in_leaf = (leaf_offsets[None, :] < count[:, None]) & at_leaf[:, None]
        prim_ids_c = jnp.clip(prim_ids, 0, prim_count - 1)
        leaf_prims = prims[prim_ids_c]                               # [R, mpl, ...]
        hit, info = functors.intersect(
            rays.origins[:, None, :],
            rays.directions[:, None, :],
            rays.lengths[:, None],
            leaf_prims,
            ray_data,
        )
        hit = hit & in_leaf
        ray_data2, global_state2 = functors.on_hit(
            (ray_data, global_state), ray_ids, prim_ids_c, info, hit
        )
        sp_leaf = sp - 1

        new_sp = jnp.where(at_leaf, sp_leaf, jnp.where(at_node, sp_node, sp))
        return new_stack, new_sp, ray_data2, global_state2

    def cond(state):
        _, sp, _, _ = state
        return jnp.any(sp > 0)

    state = (stack, sp, ray_data, global_init)
    # Under shard_map the loop body mixes sharded inputs into the carry; the
    # carry must start with the matching varying-axes type.
    from grace_jax.utils.vma import promote_to_vma, union_vma

    state = promote_to_vma(state, union_vma(rays, tree, prims))
    stack, sp, ray_data, global_state = jax.lax.while_loop(cond, body, state)

    if functors.ray_exit is not None:
        ray_data = functors.ray_exit(ray_data)
    return ray_data, global_state


def trace_bruteforce(
    rays: Rays,
    prims: jax.Array,
    intersect_fn,
    reduce_fn,
    init,
    chunk: int = 256,
):
    """O(R * N) oracle: every ray against every primitive, no BVH.

    The analog of the reference's OpenMP CPU brute-force checks
    (ref: tests/tree_traversal/tree_traversal.cu:65-79). ``reduce_fn`` folds
    (init, hit, info, prim_ids) -> per-ray value; rays are processed in
    chunks of ``chunk`` to bound memory.
    """
    n = rays.n_rays
    n_prims = prims.shape[0]
    pad = (-n) % chunk
    o = jnp.pad(rays.origins, ((0, pad), (0, 0)))
    d = jnp.pad(rays.directions, ((0, pad), (0, 0)))
    ln = jnp.pad(rays.lengths, ((0, pad),))
    prim_ids = jnp.arange(n_prims, dtype=jnp.int32)

    def per_chunk(args):
        o_c, d_c, l_c = args
        hit, info = intersect_fn(
            o_c[:, None, :], d_c[:, None, :], l_c[:, None], prims[None, :, :], None
        )
        return reduce_fn(init, hit, info, prim_ids[None, :])

    o_c = o.reshape(-1, chunk, 3)
    d_c = d.reshape(-1, chunk, 3)
    l_c = ln.reshape(-1, chunk)
    out = jax.lax.map(per_chunk, (o_c, d_c, l_c))
    out = jax.tree_util.tree_map(lambda x: x.reshape((-1,) + x.shape[2:])[:n], out)
    return out
