"""Dense segment culling: the broadphase of the fused trace kernel.

Instead of a per-tile tree walk, every 128-primitive segment's AABB is
tested against every ray-tile box as one dense (n_tiles x n_segments)
elementwise op:

  1. segment AABBs: range-reduce the Morton-sorted primitive AABBs per
     128-block (one reshape + min/max — Morton order makes segments
     spatially compact, which is what keeps the cull selective);
  2. dense overlap matrix [n_tiles, n_segments], packed to bitmask words
     block by block;
  3. vectorized set-bit compaction (compact_mask_words) into the per-tile
     segment lists the trace kernel consumes — ascending and unique by
     construction.

The BVH is still load-bearing for the generic traversal engine, per-hit
records, and closest-hit queries; for the tile broadphase the
Morton-ordered flat segmentation is the acceleration structure. The
lockstep tree-walk broadphase (grace_jax.trace.broadphase) is the other
implementation of the same cull.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from grace_jax.core.types import Rays
from grace_jax.ops.primitives import sphere_aabb
from grace_jax.trace.broadphase import tile_aabbs

SEG = 128


def segment_aabbs(spheres: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """AABBs of each SEG-primitive segment of the sorted particle array."""
    n = spheres.shape[0]
    n_pad = ((n + SEG - 1) // SEG) * SEG
    mins, maxs = sphere_aabb(spheres)
    big = jnp.finfo(jnp.float32).max
    mins = jnp.pad(mins, ((0, n_pad - n), (0, 0)), constant_values=big)
    maxs = jnp.pad(maxs, ((0, n_pad - n), (0, 0)), constant_values=-big)
    seg_min = jnp.min(mins.reshape(-1, SEG, 3), axis=1)
    seg_max = jnp.max(maxs.reshape(-1, SEG, 3), axis=1)
    return seg_min, seg_max


def pack_overlap_bits(overlap: jax.Array) -> jax.Array:
    """Pack a bool [n_tiles, n_segs] overlap matrix into i32 bitmask words
    [n_tiles, n_segs/32] (bit s of word w = segment w*32+s).

    Memory: n_tiles * n_segs / 8 bytes, so large scenes never hold the
    dense bool matrix (see masks_for_tile_aabbs).
    """
    n_tiles, n_segs = overlap.shape
    pad = (-n_segs) % 32
    if pad:
        overlap = jnp.pad(overlap, ((0, 0), (0, pad)))
    b = overlap.reshape(n_tiles, -1, 32).astype(jnp.uint32)
    words = jnp.sum(b << jnp.arange(32, dtype=jnp.uint32), axis=2, dtype=jnp.uint32)
    return jax.lax.bitcast_convert_type(words, jnp.int32)


def _popcount32(v: jax.Array) -> jax.Array:
    """Per-lane popcount of i32 words (SWAR; logical shifts — jnp's >> is
    arithmetic on int32 and would smear sign bits)."""
    lsr = jax.lax.shift_right_logical
    v = v - (lsr(v, 1) & jnp.int32(0x55555555))
    v = (v & jnp.int32(0x33333333)) + (lsr(v, 2) & jnp.int32(0x33333333))
    v = (v + lsr(v, 4)) & jnp.int32(0x0F0F0F0F)
    return lsr(v * jnp.int32(0x01010101), 24)


def compact_mask_words(words: jax.Array, max_q: int):
    """Vectorized set-bit compaction: bitmask words -> per-tile dense
    ascending id lists, entirely in XLA and without gathers: a two-level
    "which word holds output j" search done as broadcast counts + one-hot
    batched matmuls, then a 32-step bit-rank select —

      level A  sword (32-word group) exclusive bases; s(j) = last sword
               with base <= j via a [T, S, max_q] broadcast count;
      level B  in-sword word bases; the chosen sword's 32-word base row
               and bit rows are PICKED with one-hot f32 matmuls (exact:
               counts < 2^24, bits split 16/16) — no take_along_axis;
      level C  j's rank within its word selects the bit by a 32-step
               cumulative-count scan (vector ops over [T, max_q]).

    Returns (q_ids i32[T, max_q] ascending, zero-padded; n_q i32[T];
    overflow bool[T]).
    """
    lsr = jax.lax.shift_right_logical
    n_tiles, n_words = words.shape
    pad_w = (-n_words) % 32
    if pad_w:
        words = jnp.pad(words, ((0, 0), (0, pad_w)))
    n_swords = words.shape[1] // 32
    w3 = words.reshape(n_tiles, n_swords, 32)                  # [T, S, 32]
    pc = _popcount32(w3)                                       # [T, S, 32]
    csum = jnp.cumsum(pc, axis=2)
    wbase = csum - pc                                          # in-sword excl
    sc = csum[:, :, 31]                                        # [T, S]
    sbase = jnp.cumsum(sc, axis=1) - sc                        # [T, S] excl
    n_q = (sbase[:, -1] + sc[:, -1]).astype(jnp.int32)

    j = jnp.arange(max_q, dtype=jnp.int32)                     # [Q]
    # level A: containing sword = last s with sbase <= j (consecutive equal
    # bases are empty swords; "last" lands on the one that holds j).
    s_of_j = jnp.sum(
        (sbase[:, :, None] <= j[None, None, :]).astype(jnp.int32), axis=1
    ) - 1                                                      # [T, Q]
    s_of_j = jnp.maximum(s_of_j, 0)
    oh_s = (s_of_j[:, :, None] == jnp.arange(n_swords)[None, None, :]
            ).astype(jnp.float32)                              # [T, Q, S]

    # level B: pick the sword's base/word rows with batched one-hot matmuls
    # (f32 exact: bases < 2^24; words split into two 16-bit halves).
    # precision=HIGHEST is REQUIRED for exactness: a reduced-precision
    # product (TF32 keeps 10 mantissa bits) would corrupt the word bases
    # and the 16-bit word halves.
    def pick_rows(rows_f32):                                   # [T, S, 32]
        return jnp.einsum("tqs,tsk->tqk", oh_s, rows_f32,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)

    base_row = pick_rows(wbase.astype(jnp.float32))            # [T, Q, 32]
    lo_row = pick_rows((words.reshape(n_tiles, n_swords, 32)
                        & jnp.int32(0xFFFF)).astype(jnp.float32))
    hi_row = pick_rows(lsr(w3, 16).astype(jnp.float32))
    sbase_j = jnp.einsum("tqs,ts->tq", oh_s, sbase.astype(jnp.float32),
                         precision=jax.lax.Precision.HIGHEST)
    jloc = j[None, :].astype(jnp.float32) - sbase_j            # [T, Q]

    k_of_j = jnp.sum(
        (base_row <= jloc[:, :, None]).astype(jnp.int32), axis=2
    ) - 1                                                      # [T, Q]
    k_of_j = jnp.maximum(k_of_j, 0)
    oh_k = (k_of_j[:, :, None] == jnp.arange(32)[None, None, :])
    pickk = lambda r: jnp.sum(jnp.where(oh_k, r, 0.0), axis=2)
    word_j = (pickk(lo_row).astype(jnp.int32)
              + (pickk(hi_row).astype(jnp.int32) << 16))       # [T, Q]
    jj = (jloc - pickk(base_row)).astype(jnp.int32)            # rank in word

    # level C: the jj-th set bit of word_j.
    cnt = jnp.zeros_like(word_j)
    b_of_j = jnp.zeros_like(word_j)
    for b in range(32):
        bit = lsr(word_j, b) & 1
        b_of_j = jnp.where((bit == 1) & (cnt == jj), b, b_of_j)
        cnt = cnt + bit
    q_id = (s_of_j * 32 + k_of_j) * 32 + b_of_j
    valid = j[None, :] < n_q[:, None]
    return (jnp.where(valid, q_id, 0), jnp.minimum(n_q, max_q),
            n_q > max_q)


def masks_for_tile_aabbs(
    tmin: jax.Array,
    tmax: jax.Array,
    spheres: jax.Array,
    seg_block: int = 8192,
) -> jax.Array:
    """Overlap bitmask words i32[n_tiles, ceil(n_segs / 32)] of ray-tile
    AABBs against SEG-primitive segment AABBs (bit s of word w =
    segment w*32+s). Taking the tile boxes rather than the rays lets
    distributed callers build lists for REMOTE ray blocks (ship the tiny
    per-tile boxes through a collective, not the rays) and hoist the whole
    broadphase out of a ring circuit (parallel/sharding.ring_pallas_render).
    Segments are processed ``seg_block`` at a time and packed to bits
    immediately, bounding the dense intermediate at n_tiles x seg_block.
    """
    seg_min, seg_max = segment_aabbs(spheres)

    def block_words(args):
        s_min, s_max = args
        overlap = (
            (tmin[:, 0:1] <= s_max[:, 0]) & (s_min[:, 0] <= tmax[:, 0:1])
            & (tmin[:, 1:2] <= s_max[:, 1]) & (s_min[:, 1] <= tmax[:, 1:2])
            & (tmin[:, 2:3] <= s_max[:, 2]) & (s_min[:, 2] <= tmax[:, 2:3])
        )
        return pack_overlap_bits(overlap)

    n_segs = seg_min.shape[0]
    if n_segs <= seg_block:
        return block_words((seg_min, seg_max))
    blk = seg_block
    assert blk % 32 == 0
    pad = (-n_segs) % blk
    # Padded segments are empty (min=+inf > max=-inf): never overlap.
    big = jnp.finfo(jnp.float32).max
    s_min = jnp.concatenate([seg_min, jnp.full((pad, 3), big)], 0)
    s_max = jnp.concatenate([seg_max, jnp.full((pad, 3), -big)], 0)
    words = jax.lax.map(
        block_words,
        (s_min.reshape(-1, blk, 3), s_max.reshape(-1, blk, 3)),
    )  # [n_blocks, n_tiles, blk/32]
    words = jnp.transpose(words, (1, 0, 2)).reshape(tmin.shape[0], -1)
    return words[:, : (n_segs + 31) // 32]


@functools.partial(jax.jit, static_argnames=("tile", "max_chunks"))
def dense_tile_segments(
    rays: Rays,
    spheres: jax.Array,
    tile: int,
    max_chunks: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Per-tile ascending, unique 128-aligned segment ids by dense culling.

    Returns (seg_ids i32[n_tiles, max_chunks], n_segs i32[n_tiles],
    overflow bool[n_tiles]): the packed overlap bitmask
    (masks_for_tile_aabbs) compacted by compact_mask_words.
    """
    tmin, tmax = tile_aabbs(rays, tile)
    words = masks_for_tile_aabbs(tmin, tmax, spheres)
    return compact_mask_words(words, max_chunks)
