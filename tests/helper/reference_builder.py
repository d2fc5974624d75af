"""Sequential, faithful simulation of the reference ALBVH algorithms.

Used as an independent oracle for the vectorized Cartesian-tree builder:
this module re-enacts, single-threaded in plain Python, exactly what the
reference's climbing kernels compute —

  * the bottom-up parent rule: a node covering [l, r] compares
    delta(l-1) vs delta(r); strictly smaller left delta => the left
    boundary node (l-1) is the parent and the node is its right child,
    otherwise the right boundary node (r) is the parent
    (ref: albvh.cuh:124-144, 187-206);
  * second-arrival climbing: a parent's range is complete only once both
    children have reported (ref: albvh.cuh:156-163);
  * big-leaf emission (ref: albvh.cuh:236-295 write_leaves_kernel).

No code is shared with grace_jax.build — that is the point.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def climb_ranges(d: np.ndarray) -> Dict[int, Tuple[int, int]]:
    """Full ranges [l, r] of every internal node (split position) for n = len(d)+1 leaves."""
    n = len(d) + 1
    INF = None  # sentinel: boundary deltas compare greater than everything

    def less(a, b):
        if a is None:
            return False
        if b is None:
            return True
        return a < b

    node_lr: Dict[int, List[int]] = {i: [None, None] for i in range(n - 1)}
    arrivals = {i: 0 for i in range(n - 1)}
    ranges: Dict[int, Tuple[int, int]] = {}

    for leaf in range(n):
        l = r = leaf
        while True:
            dL = d[l - 1] if l - 1 >= 0 else INF
            dR = d[r] if r <= n - 2 else INF
            if dL is INF and dR is INF:
                break  # root of a 1-leaf tree (n == 1)
            if less(dL, dR):
                parent = l - 1
                node_lr[parent][1] = r
            else:
                parent = r
                node_lr[parent][0] = l
            arrivals[parent] += 1
            if arrivals[parent] == 1:
                break
            l, r = node_lr[parent]
            ranges[parent] = (l, r)
            if l == 0 and r == n - 1:
                break
    return ranges


def emit_big_leaves(d: np.ndarray, max_per_leaf: int) -> List[Tuple[int, int]]:
    """(first, count) big leaves per write_leaves_kernel semantics, in order."""
    n = len(d) + 1
    ranges = climb_ranges(d)
    leaves = {}
    for i, (l, r) in ranges.items():
        s_left = i - l + 1
        s_right = r - i
        size = s_left + s_right
        left_leaf = s_left <= max_per_leaf
        right_leaf = s_right <= max_per_leaf
        write = True if (left_leaf != right_leaf) else (size > max_per_leaf)
        if left_leaf and write:
            leaves[l] = (l, s_left)
        if right_leaf and write:
            leaves[r] = (i + 1, s_right)
    return [leaves[k] for k in sorted(leaves)]


def build_reference_tree(d: np.ndarray, max_per_leaf: int):
    """Full two-phase reference build: big leaves + top-tree links.

    Returns (leaves, children, root) where children[p] = (left, right) with
    leaf children encoded as ~leaf_index, matching grace_jax.core.tree.
    """
    leaves = emit_big_leaves(d, max_per_leaf)
    nl = len(leaves)
    ld = np.array([d[first + cnt - 1] for (first, cnt) in leaves[:-1]])
    ranges = climb_ranges(ld)
    children = {}
    for p, (l, r) in ranges.items():
        children[p] = [None, None]
    # leaf children
    for k in range(nl):
        dL = ld[k - 1] if k - 1 >= 0 else None
        dR = ld[k] if k <= nl - 2 else None
        if (dR is None) or (dL is not None and dL < dR):
            children[k - 1][1] = ~k
        else:
            children[k][0] = ~k
    # internal children
    for p, (l, r) in ranges.items():
        if l == 0 and r == nl - 1:
            root = p
            continue
        dL = ld[l - 1] if l - 1 >= 0 else None
        dR = ld[r] if r <= nl - 2 else None
        if (dR is None) or (dL is not None and dL < dR):
            children[l - 1][1] = p
        else:
            children[r][0] = p
    return leaves, children, root
