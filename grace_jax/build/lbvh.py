"""Deterministic LBVH construction — the atomics-free replacement for the
reference's atomics-based ALBVH build (ref: include/grace/cuda/kernels/albvh.cuh).

Algorithm
=========
The reference builds an Apetrei-style agglomerative LBVH with two
atomicAdd-coordinated bottom-up climbing kernels (``build_leaves_kernel``
albvh.cuh:76-234 and ``build_nodes_slice_kernel`` albvh.cuh:303-670). Atomics
and data-dependent host loops are hostile to XLA, but the tree those climbs
produce is *deterministic*: it is exactly the Cartesian tree (max at root) of
the adjacent-pair delta sequence, with ties broken toward the leftmost
position. Proof sketch: a node covering leaves [l, r] chooses its parent by
``delta_comp(d[l-1], d[r])`` (albvh.cuh:124-144) — the boundary with the
*smaller* (delta, -index) priority becomes the parent, so every node's range
extends to the nearest strictly-higher-priority delta on each side.

Hence each internal node i (split position i, i.e. its children cover
[l_i, i] and [i+1, r_i] — the Apetrei numbering invariant) has

    l_i = 1 + max{ j < i : d[j] >= d[i] }        (or 0)
    r_i =     min{ j > i : d[j] >  d[i] }        (or n-1)

which we compute for all i at once with a sparse max-table + binary skip
search: O(n log n) vector work, no atomics, no host round-trips, one fused
XLA computation. Leaf coalescing reproduces ``write_leaves_kernel``
(albvh.cuh:236-295) exactly: a child range becomes a big leaf iff its size is
<= max_per_leaf while its parent's size is not (or its sibling is oversized).
Child AABBs are range reductions over the Morton-sorted primitive interval a
subtree covers — computed with a complete-binary reduction tree
(O(log n) gathers), replacing the reference's in-register climb unions
(albvh.cuh:384-429).

All shapes are static (padded to capacity); ``n_leaves``/``n_nodes`` are
traced scalars, so the whole build jits once per primitive count.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import jax
import jax.numpy as jnp

from grace_jax.core.tree import Tree, encode_leaf_child
from grace_jax.core.errors import debug_assert, require
from grace_jax.build.deltas import delta_max_sentinel


def _min_sentinel(dtype):
    dtype = jnp.dtype(dtype)
    if dtype == jnp.uint32:
        return jnp.uint32(0)
    return jnp.asarray(-jnp.inf, dtype)


def _build_max_table(d: jax.Array) -> List[jax.Array]:
    """Sparse table M[k][i] = max(d[i : i + 2**k]) (windows clipped at the end).

    Returns the per-level list; levels are full length for O(1) gathers.
    """
    n = d.shape[0]
    levels = [d]
    k = 1
    while (1 << k) <= n:
        prev = levels[-1]
        half = 1 << (k - 1)
        shifted = jnp.concatenate([prev[half:], prev[-half:]])
        # Clipped windows: max(d[i:i+2^k]) = max(M[k-1][i], M[k-1][min(i+h, n-h)])
        # using the saturating shift above (tail windows repeat the last valid
        # window, whose max equals the clipped-window max since it is a subset
        # containing the suffix).
        levels.append(jnp.maximum(prev, shifted))
        k += 1
    return levels


def _next_greater(levels: List[jax.Array], start: jax.Array, t: jax.Array) -> jax.Array:
    """First j >= start with d[j] > t, else n. Vectorized binary skip."""
    n = levels[0].shape[0]
    pos = start
    for k in reversed(range(len(levels))):
        w = 1 << k
        valid = pos + w <= n
        m = levels[k][jnp.clip(pos, 0, n - 1)]
        skip = valid & (m <= t)
        pos = jnp.where(skip, pos + w, pos)
    return pos


def _prev_greater_equal(levels: List[jax.Array], start: jax.Array, t: jax.Array) -> jax.Array:
    """Last j <= start with d[j] >= t, else -1. Vectorized binary skip."""
    n = levels[0].shape[0]
    pos = start
    for k in reversed(range(len(levels))):
        w = 1 << k
        lo = pos - w + 1
        valid = lo >= 0
        m = levels[k][jnp.clip(lo, 0, n - 1)]
        skip = valid & (m < t)
        pos = jnp.where(skip, pos - w, pos)
    return pos


def cartesian_tree_ranges(d: jax.Array, n_valid=None) -> Tuple[jax.Array, jax.Array]:
    """Ranges [l_i, r_i] (leaf-index space) of every split position i.

    Args:
      d: deltas, shape [n-1] for n leaves (may be padded; see ``n_valid``).
      n_valid: optional traced count of valid *leaf* positions n; padding
        entries of d at index >= n_valid - 1 must be the dtype's MAX sentinel.

    Returns:
      (l, r): i32 arrays of shape [n-1]; node i covers leaves [l[i], r[i]]
      and splits into [l[i], i] / [i+1, r[i]].
    """
    m = d.shape[0]
    levels = _build_max_table(d)
    i = jnp.arange(m, dtype=jnp.int32)
    t = d
    l = _prev_greater_equal(levels, i - 1, t) + 1
    r = _next_greater(levels, i + 1, t)
    if n_valid is not None:
        # Padded MAX entries at >= n_valid-1 stop the right search at the true
        # boundary already; clamp anyway for safety.
        r = jnp.minimum(r, n_valid - 1)
    return l.astype(jnp.int32), r.astype(jnp.int32)


def coalesce_leaves(
    l: jax.Array, r: jax.Array, max_per_leaf: int, n_prims: int
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Form big leaves from the primitive-level Cartesian tree.

    Reproduces write_leaves_kernel (ref: albvh.cuh:236-295): the big leaves
    are exactly the maximal subtrees of size <= max_per_leaf.

    Returns:
      leaf_first: i32[n_prims]  (compacted to the front, primitive order)
      leaf_count: i32[n_prims]  (0 beyond n_leaves)
      n_leaves:   i32[]
    """
    n = n_prims
    i = jnp.arange(n - 1, dtype=jnp.int32)
    s_left = i - l + 1
    s_right = r - i
    size = s_left + s_right
    left_small = s_left <= max_per_leaf
    right_small = s_right <= max_per_leaf
    # ref albvh.cuh:272-275: emit when exactly one child is small, or when
    # both are small but the node itself is oversized.
    write = jnp.where(left_small != right_small, True, size > max_per_leaf)
    emit_left = left_small & write
    emit_right = right_small & write

    first = jnp.zeros((n,), jnp.int32)
    count = jnp.zeros((n,), jnp.int32)
    # Emitted leaf ranges are disjoint, so the slots (left child keyed by its
    # first leaf, right child by its last) never collide.
    slot_l = jnp.where(emit_left, l, n)
    first = first.at[slot_l].set(l, mode="drop")
    count = count.at[slot_l].set(s_left, mode="drop")
    slot_r = jnp.where(emit_right, r, n)
    first = first.at[slot_r].set(i + 1, mode="drop")
    count = count.at[slot_r].set(s_right, mode="drop")

    valid = count > 0
    n_leaves = jnp.sum(valid.astype(jnp.int32))
    # Stable-compact valid slots to the front (slot order == primitive order).
    order = jnp.argsort(jnp.logical_not(valid), stable=True)
    leaf_first = jnp.where(jnp.arange(n) < n_leaves, first[order], 0)
    leaf_count = jnp.where(jnp.arange(n) < n_leaves, count[order], 0)
    return leaf_first, leaf_count, n_leaves


def _segment_reduce_tree(values: jax.Array, op) -> List[jax.Array]:
    """Per-level reduction arrays over axis 0 (complete binary tree)."""
    n = values.shape[0]
    m = 1 << max(1, math.ceil(math.log2(max(n, 2))))
    pad_val = jnp.full((m - n,) + values.shape[1:], _reduce_identity(op, values.dtype))
    levels = [jnp.concatenate([values, pad_val], axis=0)]
    while levels[-1].shape[0] > 1:
        prev = levels[-1]
        levels.append(op(prev[0::2], prev[1::2]))
    return levels


def _reduce_identity(op, dtype):
    if op is jnp.minimum:
        return jnp.asarray(jnp.inf, dtype)
    if op is jnp.maximum:
        return jnp.asarray(-jnp.inf, dtype)
    raise ValueError("unsupported op")


def _range_reduce(levels: List[jax.Array], a: jax.Array, b: jax.Array, op):
    """Reduce values[a..b] inclusive for batched (a, b) via tree decomposition."""
    ident = _reduce_identity(op, levels[0].dtype)
    acc = jnp.full((a.shape[0],) + levels[0].shape[1:], ident)
    lpos = a
    rpos = b + 1
    for level in levels[:-1]:
        sz = level.shape[0]
        take_l = ((lpos & 1) == 1) & (lpos < rpos)
        vl = level[jnp.clip(lpos, 0, sz - 1)]
        acc = jnp.where(take_l[:, None], op(acc, vl), acc)
        lpos = lpos + take_l.astype(lpos.dtype)
        take_r = ((rpos & 1) == 1) & (lpos < rpos)
        vr = level[jnp.clip(rpos - 1, 0, sz - 1)]
        acc = jnp.where(take_r[:, None], op(acc, vr), acc)
        rpos = rpos - take_r.astype(rpos.dtype)
        lpos = lpos >> 1
        rpos = rpos >> 1
    return acc


def build_lbvh(
    prim_aabb_mins: jax.Array,
    prim_aabb_maxs: jax.Array,
    deltas: jax.Array,
    max_per_leaf: int,
) -> Tree:
    """Build the BVH over Morton-sorted primitives.

    Equivalent of ``grace::build_ALBVH`` (ref: albvh.cuh:986-1021): takes
    sorted per-primitive AABBs and the interior delta array (length N-1) and
    produces the two-level tree (coalesced big leaves + internal hierarchy).

    Args:
      prim_aabb_mins/maxs: f32[N, 3] AABBs of Morton-sorted primitives.
      deltas: [N-1] adjacent-pair deltas (u32 or f32); see build.deltas.
      max_per_leaf: static leaf capacity, must satisfy 1 <= mpl < N.

    Returns:
      Tree with capacity N-1 internal nodes / N leaves.
    """
    n = prim_aabb_mins.shape[0]
    # ref build_ALBVH throws std::invalid_argument for misuse
    # (albvh.cuh:795-799); shape-static misuse is a Python-time GraceError.
    require(n >= 2, "build_lbvh requires at least 2 primitives")
    require(1 <= max_per_leaf < n,
            f"max_per_leaf {max_per_leaf} out of range for N={n}")

    # ---- Phase A: primitive-level Cartesian ranges + leaf coalescing ------
    l, r = cartesian_tree_ranges(deltas)
    leaf_first, leaf_count, n_leaves = coalesce_leaves(l, r, max_per_leaf, n)

    # Leaf boundary deltas: ld[k] = delta at the right edge of leaf k
    # (ref copy_leaf_deltas_kernel albvh.cuh:50-74); padded to MAX at
    # k >= n_leaves - 1 so the top-tree searches stop at the true boundary.
    sent = delta_max_sentinel(deltas.dtype)
    last = jnp.clip(leaf_first + leaf_count - 1, 0, n - 2)
    k_idx = jnp.arange(n, dtype=jnp.int32)
    ld_full = jnp.where(k_idx < n_leaves - 1, deltas[last], sent)
    ld = ld_full[: n - 1] if n > 1 else ld_full  # top tree has <= n-1 splits

    # ---- Phase B: top tree over big leaves --------------------------------
    cap = n - 1  # node capacity
    p = jnp.arange(cap, dtype=jnp.int32)
    node_valid = p < (n_leaves - 1)
    L, R = cartesian_tree_ranges(ld, n_valid=n_leaves)
    L = jnp.where(node_valid, L, 0)
    R = jnp.where(node_valid, R, 0)

    def ld_at(idx):
        # ld with virtual MAX at idx == -1 and idx >= n_leaves - 1.
        inside = (idx >= 0) & (idx < n_leaves - 1)
        return jnp.where(inside, ld[jnp.clip(idx, 0, cap - 1)], sent)

    # Parent rule (ref albvh.cuh:124-144 / 187-206): boundary with the
    # smaller delta becomes the parent; ties go right (left delta >= right
    # delta => parent is the right boundary).
    dL = ld_at(L - 1)
    dR = ld_at(R)
    is_right_child = dL < dR
    parent = jnp.where(is_right_child, L - 1, R)
    is_root = node_valid & (L == 0) & (R == n_leaves - 1)
    root = jnp.argmax(is_root).astype(jnp.int32)

    children = jnp.full((cap, 2), jnp.int32(0))
    # Internal-node children: node p is its parent's left child iff
    # parent == R (it covers [L, parent's split]), else right child.
    can_link = node_valid & jnp.logical_not(is_root)
    slot_left = jnp.where(can_link & jnp.logical_not(is_right_child), parent, cap)
    children = children.at[slot_left, 0].set(p, mode="drop")
    slot_right = jnp.where(can_link & is_right_child, parent, cap)
    children = children.at[slot_right, 1].set(p, mode="drop")

    # Leaf children: leaf k (range [k, k]) uses the same parent rule.
    kk = jnp.arange(n, dtype=jnp.int32)
    leaf_valid = kk < n_leaves
    dLk = ld_at(kk - 1)
    dRk = ld_at(kk)
    leaf_is_right = dLk < dRk
    leaf_parent = jnp.where(leaf_is_right, kk - 1, kk)
    enc = encode_leaf_child(kk)
    lslot = jnp.where(leaf_valid & jnp.logical_not(leaf_is_right), leaf_parent, cap)
    children = children.at[lslot, 0].set(enc, mode="drop")
    rslot = jnp.where(leaf_valid & leaf_is_right, leaf_parent, cap)
    children = children.at[rslot, 1].set(enc, mode="drop")

    # ---- Child AABBs: range reductions over sorted primitive intervals ----
    min_levels = _segment_reduce_tree(prim_aabb_mins, jnp.minimum)
    max_levels = _segment_reduce_tree(prim_aabb_maxs, jnp.maximum)

    def leaf_prim_span(leaf_idx):
        f = leaf_first[jnp.clip(leaf_idx, 0, n - 1)]
        c = leaf_count[jnp.clip(leaf_idx, 0, n - 1)]
        return f, f + c - 1

    # Left child covers leaves [L, p]; right child covers [p+1, R].
    la, _ = leaf_prim_span(L)
    _, lb = leaf_prim_span(p)
    ra, _ = leaf_prim_span(jnp.minimum(p + 1, n - 1))
    _, rb = leaf_prim_span(R)

    def child_aabb(a, b, valid):
        mins = _range_reduce(min_levels, a, b, jnp.minimum)
        maxs = _range_reduce(max_levels, a, b, jnp.maximum)
        empty_min = jnp.full_like(mins, jnp.inf)
        empty_max = jnp.full_like(maxs, -jnp.inf)
        return (
            jnp.where(valid[:, None], mins, empty_min),
            jnp.where(valid[:, None], maxs, empty_max),
        )

    lmin, lmax = child_aabb(la, lb, node_valid)
    rmin, rmax = child_aabb(ra, rb, node_valid)
    child_aabbs = jnp.stack(
        [jnp.stack([lmin, lmax], axis=1), jnp.stack([rmin, rmax], axis=1)], axis=1
    )  # [cap, 2(child), 2(min/max), 3]

    leaves = jnp.stack([leaf_first, leaf_count], axis=1)

    # GRACE_JAX_DEBUG invariants (ref GRACE_ASSERT in albvh.cuh:160,227,531,
    # 661 guards the build protocol; the deterministic formulation here has
    # no arrival races, so the surviving invariants are the OUTPUT contracts
    # the trace kernels rely on):
    #  * leaves tile [0, N): consecutive, starting at 0, ending at n.
    #  * every valid leaf holds 1..max_per_leaf primitives.
    #  * every valid node's child AABBs are non-empty (min <= max).
    debug_assert(
        (leaf_first[0] == 0)
        & jnp.all(jnp.where(leaf_valid, leaf_count >= 1, True))
        & jnp.all(jnp.where(leaf_valid, leaf_count <= max_per_leaf, True)),
        "leaf partition: counts out of [1, max_per_leaf] or nonzero start",
    )
    ends = leaf_first + leaf_count
    nxt = jnp.where(kk + 1 < n_leaves, leaf_first[jnp.minimum(kk + 1, n - 1)],
                    ends)
    debug_assert(
        jnp.all(jnp.where(leaf_valid, nxt == ends, True))
        & (ends[jnp.maximum(n_leaves - 1, 0)] == n),
        "leaf partition: gaps or wrong terminal primitive",
    )
    debug_assert(
        jnp.all(jnp.where(node_valid[:, None, None],
                          child_aabbs[:, :, 0, :] <= child_aabbs[:, :, 1, :],
                          True)),
        "node child AABBs empty/inverted",
    )
    return Tree(
        children=children,
        child_aabbs=child_aabbs,
        leaves=leaves,
        root=root,
        n_nodes=(n_leaves - 1).astype(jnp.int32),
        n_leaves=n_leaves.astype(jnp.int32),
        max_per_leaf=max_per_leaf,
    )
