"""Segmented sort/scan post-processing.

Analog of ref include/grace/cuda/sort.cuh (133 LoC), scan.cuh (60 LoC),
kernels/weights.cuh (61 LoC) and the ~9.6k-line vendored ModernGPU subset
they call into (include/grace/external/sgpu/). All of sgpu's
CTA-level machinery collapses into XLA primitives:

  sgpu::SegSortPairsFromIndices  ->  one lax.sort with the segment id as the
                                     leading lexicographic key
  sgpu::SegScan* (CSR)           ->  global cumsum minus segment-start base
  thrust::gather/scatter         ->  jnp indexing / .at[] scatters

giving the same dataflow with no vendored kernels at all.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def offsets_to_segments(offsets, n_elements: int) -> jnp.ndarray:
    """Per-element segment ids from CSR segment-start offsets
    (ref: sort.cuh:21-40 — scatter + inclusive scan).

    offsets: i32[S] sorted start indices (offsets[0] == 0). Returns i32[n].
    Empty segments are supported (repeated offsets).
    """
    offsets = jnp.asarray(offsets, jnp.int32)
    marks = jnp.zeros((n_elements,), jnp.int32)
    # Element at offsets[s] starts segment s: scatter-add 1 (repeated offsets
    # from empty segments accumulate, exactly reproducing the skip).
    marks = marks.at[offsets[1:]].add(1, mode="drop")
    return jnp.cumsum(marks)


def order_by_index(order, values) -> jnp.ndarray:
    """Gather values by an index map (ref: sort.cuh:43-51)."""
    return jnp.asarray(values)[jnp.asarray(order)]


def sort_and_map(keys) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Argsort returning (sorted_keys, map) (ref: sort.cuh:54-71)."""
    order = jnp.argsort(keys, stable=True)
    return keys[order], order.astype(jnp.int32)


def sort_by_key(keys, *values):
    """Sort one or two value arrays by a key array (ref: sort.cuh:74-97)."""
    order = jnp.argsort(keys, stable=True)
    out = tuple(jnp.asarray(v)[order] for v in values)
    return (keys[order],) + out


def segmented_sort(segment_ids, keys, *payloads):
    """Stable sort of keys within segments, carrying payload arrays.

    The sgpu::SegSortPairsFromIndices replacement (ref: sort.cuh:118-125):
    a single lexicographic ``lax.sort`` on (segment, key) — the segment id
    dominates so elements never cross segments.
    """
    seg = jnp.asarray(segment_ids, jnp.int32)
    operands = (seg, jnp.asarray(keys)) + tuple(jnp.asarray(p) for p in payloads)
    out = jax.lax.sort(operands, num_keys=2, is_stable=True)
    return out[1:] if payloads else out[1]


def sort_by_distance(distances, offsets, indices, *data, total_hits=None):
    """Per-ray segmented sort of hit distances, gathering hit indices/data
    along (ref: sort.cuh:100-131).

    Args:
      distances: f32[H] per-hit distances (keys); H may be a static capacity
                 larger than the true hit count.
      offsets:   i32[R] CSR segment starts per ray.
      indices:   i32[H] per-hit primitive indices.
      *data:     additional per-hit arrays to reorder.
      total_hits: true number of valid entries; capacity padding beyond it is
                 kept in a trailing pseudo-segment so it cannot pollute the
                 last ray's segment. Defaults to H.

    Returns (sorted_distances, sorted_indices, *sorted_data).
    """
    h = distances.shape[0]
    seg = offsets_to_segments(offsets, h)
    if total_hits is not None:
        n_seg = jnp.asarray(offsets).shape[0]
        seg = jnp.where(jnp.arange(h) < total_hits, seg, n_seg)
    out = segmented_sort(seg, distances, indices, *data)
    return out


def exclusive_segmented_scan(offsets, values) -> jnp.ndarray:
    """Per-segment exclusive prefix sum from CSR offsets
    (ref: scan.cuh:15-37, sgpu SegScanCsr).

    out[i] = sum of values[j] for j in [seg_start(i), i).

    Implemented as a flagged ``lax.associative_scan`` (the classic segmented
    scan operator), so sums accumulate *within* each segment only — no
    global-cumsum cancellation error.
    """
    values = jnp.asarray(values)
    n = values.shape[0]
    seg = offsets_to_segments(offsets, n)
    heads = jnp.concatenate([jnp.ones((1,), jnp.bool_), seg[1:] != seg[:-1]])

    def op(a, b):
        a_flag, a_val = a
        b_flag, b_val = b
        return a_flag | b_flag, b_val + jnp.where(b_flag, 0.0, a_val)

    _, incl = jax.lax.associative_scan(op, (heads, values))
    return incl - values


def weighted_exclusive_segmented_scan(offsets, values, weight_map, weights) -> jnp.ndarray:
    """Elementwise weight multiply then segmented exclusive scan
    (ref: kernels/weights.cuh:13-57 multiply_weights + scan.cuh:44-58):
    each element i is scaled by weights[weight_map[i]] before scanning."""
    w = jnp.asarray(weights)[jnp.asarray(weight_map)]
    return exclusive_segmented_scan(offsets, jnp.asarray(values) * w)


def segment_sums(segment_ids, values, num_segments: int) -> jnp.ndarray:
    """Per-segment totals (used by render reductions)."""
    return jax.ops.segment_sum(values, segment_ids, num_segments=num_segments)
