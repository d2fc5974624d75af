"""LBVH builder tests: structural parity with a sequential simulation of the
reference climbing algorithms, plus tree invariants (leaf partition, AABB
containment). Analog of the implicit invariants GRACE_DEBUG asserts in
ref albvh.cuh plus the tree_traversal correctness idiom."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from grace_jax.build.lbvh import build_lbvh, cartesian_tree_ranges, coalesce_leaves
from grace_jax.build.sph import build_sph_tree
from grace_jax.core.types import make_spheres
from tests.helper.reference_builder import build_reference_tree, climb_ranges, emit_big_leaves


def random_deltas(rng, n, kind):
    if kind == "float":
        return rng.random(n - 1).astype(np.float32)
    if kind == "tied":
        return rng.integers(0, 4, n - 1).astype(np.float32)
    if kind == "uint":
        return rng.integers(0, 2**30, n - 1).astype(np.uint32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["float", "tied", "uint"])
@pytest.mark.parametrize("n", [2, 3, 17, 128, 1000])
def test_cartesian_ranges_match_reference_climb(rng, n, kind):
    d = random_deltas(rng, n, kind)
    l, r = jax.jit(cartesian_tree_ranges)(jnp.asarray(d))
    l, r = np.array(l), np.array(r)
    ranges = climb_ranges(d)
    assert len(ranges) == n - 1
    for i in range(n - 1):
        assert (l[i], r[i]) == ranges[i], f"node {i}: {(l[i], r[i])} vs {ranges[i]}"


@pytest.mark.parametrize("kind", ["float", "tied"])
@pytest.mark.parametrize("n,mpl", [(10, 3), (100, 8), (1000, 32), (257, 1)])
def test_leaf_coalescing_matches_reference(rng, n, mpl, kind):
    d = random_deltas(rng, n, kind)
    l, r = cartesian_tree_ranges(jnp.asarray(d))
    leaf_first, leaf_count, n_leaves = coalesce_leaves(l, r, mpl, n)
    got = list(zip(np.array(leaf_first)[: int(n_leaves)], np.array(leaf_count)[: int(n_leaves)]))
    expect = emit_big_leaves(d, mpl)
    assert got == expect


@pytest.mark.parametrize("n,mpl", [(50, 4), (333, 16)])
def test_full_tree_matches_reference(rng, n, mpl):
    d = rng.random(n - 1).astype(np.float32)
    mins = rng.random((n, 3)).astype(np.float32)
    maxs = mins + rng.random((n, 3)).astype(np.float32)
    tree = jax.jit(build_lbvh, static_argnums=3)(mins, maxs, jnp.asarray(d), mpl)

    leaves_ref, children_ref, root_ref = build_reference_tree(d, mpl)
    nl = int(tree.n_leaves)
    assert nl == len(leaves_ref)
    got_leaves = list(zip(np.array(tree.leaves)[:nl, 0], np.array(tree.leaves)[:nl, 1]))
    assert got_leaves == leaves_ref
    assert int(tree.root) == root_ref
    ch = np.array(tree.children)
    for p, (cl, cr) in children_ref.items():
        assert ch[p, 0] == cl and ch[p, 1] == cr, f"node {p}"


def test_tree_invariants_random_spheres(rng):
    n = 4096
    spheres = make_spheres(rng.random((n, 3)).astype(np.float32),
                           (0.01 + 0.02 * rng.random(n)).astype(np.float32))
    sorted_spheres, tree, perm = jax.jit(build_sph_tree, static_argnums=1)(spheres, 24)
    ss = np.array(sorted_spheres)
    nl = int(tree.n_leaves)
    leaves = np.array(tree.leaves)[:nl]
    # Leaves tile [0, n) in order.
    assert leaves[0, 0] == 0
    assert np.all(leaves[1:, 0] == leaves[:-1, 0] + leaves[:-1, 1])
    assert leaves[-1, 0] + leaves[-1, 1] == n
    assert leaves[:, 1].max() <= 24 and leaves[:, 1].min() >= 1
    # Permutation is a permutation.
    assert np.array_equal(np.sort(np.array(perm)), np.arange(n))

    # AABB containment: walk the tree, check each child box contains the
    # union of its subtree's primitive boxes.
    prim_min = ss[:, :3] - ss[:, 3:4]
    prim_max = ss[:, :3] + ss[:, 3:4]
    children = np.array(tree.children)
    boxes = np.array(tree.child_aabbs)

    def leaf_span(leaf_idx):
        f, c = leaves[leaf_idx]
        return f, f + c

    def subtree_span(entry):
        if entry < 0:
            return leaf_span(~entry)
        lo1 = subtree_span(children[entry][0])
        lo2 = subtree_span(children[entry][1])
        assert lo1[1] == lo2[0], "children must be contiguous"
        return lo1[0], lo2[1]

    import sys
    sys.setrecursionlimit(100000)
    visited = set()

    def walk(node):
        assert node not in visited
        visited.add(node)
        for c in range(2):
            a, b = subtree_span(children[node][c])
            np.testing.assert_allclose(boxes[node, c, 0], prim_min[a:b].min(0), rtol=1e-6)
            np.testing.assert_allclose(boxes[node, c, 1], prim_max[a:b].max(0), rtol=1e-6)
            if children[node][c] >= 0:
                walk(children[node][c])

    root = int(tree.root)
    a, b = subtree_span(root)
    assert (a, b) == (0, n), "root must cover all primitives"
    walk(root)
    assert len(visited) == nl - 1, "every internal node reachable exactly once"


def test_build_with_63bit_keys_and_xor_deltas(rng):
    """End-to-end 63-bit key path: lexicographic (hi, lo) sort + compressed
    XOR deltas must produce a valid tree with exact hitcounts."""
    from grace_jax.core.types import Rays
    from grace_jax.trace.sph import trace_hitcounts_sph

    n = 3000
    spheres = make_spheres(rng.random((n, 3)).astype(np.float32),
                           (0.01 + 0.03 * rng.random(n)).astype(np.float32))
    ss, tree, perm = jax.jit(
        build_sph_tree, static_argnums=(1, 2, 3)
    )(spheres, 16, "xor", 63)
    assert np.array_equal(np.sort(np.array(perm)), np.arange(n))

    r = 256
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (rng.random((r, 3)) * 0.2).astype(np.float32)
    ln = np.full(r, 3.0, np.float32)
    rays = Rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(ln))
    counts = np.array(trace_hitcounts_sph(rays, ss, tree))
    s = np.array(ss)
    p = s[None, :, :3] - o[:, None, :]
    t = (p * d[:, None, :]).sum(-1)
    b = p - t[..., None] * d[:, None, :]
    hit = ((b * b).sum(-1) < s[None, :, 3] ** 2) & (t >= 0) & (t < ln[:, None])
    assert np.array_equal(counts, hit.sum(1))
