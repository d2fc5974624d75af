"""Morton key unit tests (parity with ref tests/morton_key/*.cu and
tests/morton_key_kernel/*.cu: hard-coded bit patterns + random cross-check
against an independent host implementation)."""

import numpy as np
import jax.numpy as jnp

from grace_jax.ops import morton


def spread_py(x: int, nbits: int) -> int:
    """Independent pure-Python bit spread: bit k -> bit 3k."""
    out = 0
    for k in range(nbits):
        if (x >> k) & 1:
            out |= 1 << (3 * k)
    return out


def key_py(x: int, y: int, z: int, nbits: int) -> int:
    return (spread_py(z, nbits) << 2) | (spread_py(y, nbits) << 1) | spread_py(x, nbits)


def test_space_by_two_10bit_patterns():
    # Hard-coded expectations (the analog of ref 30bit_key.cu:12-46).
    assert int(morton.space_by_two_10bit(0)) == 0
    assert int(morton.space_by_two_10bit(1)) == 1
    assert int(morton.space_by_two_10bit(0b11)) == 0b1001
    assert int(morton.space_by_two_10bit(0x3FF)) == 0b001001001001001001001001001001
    # Upper bits beyond 10 are masked away.
    assert int(morton.space_by_two_10bit(0x400)) == 0
    for x in [5, 123, 600, 1023]:
        assert int(morton.space_by_two_10bit(x)) == spread_py(x, 10)


def test_space_by_two_21bit_patterns():
    for x in [0, 1, 3, (1 << 21) - 1, 0x15555, 0x1F0F0F]:
        hi, lo = morton.space_by_two_21bit(x)
        got = (int(hi) << 32) | int(lo)
        assert got == spread_py(x, 21), hex(x)


def test_morton_key_30bit_random(rng):
    xs = rng.integers(0, 1 << 10, 200)
    ys = rng.integers(0, 1 << 10, 200)
    zs = rng.integers(0, 1 << 10, 200)
    keys = np.array(morton.morton_key_30bit(
        jnp.asarray(xs, jnp.uint32), jnp.asarray(ys, jnp.uint32), jnp.asarray(zs, jnp.uint32)))
    for x, y, z, k in zip(xs, ys, zs, keys):
        assert int(k) == key_py(int(x), int(y), int(z), 10)


def test_morton_key_63bit_random(rng):
    xs = rng.integers(0, 1 << 21, 100)
    ys = rng.integers(0, 1 << 21, 100)
    zs = rng.integers(0, 1 << 21, 100)
    hi, lo = morton.morton_key_63bit(
        jnp.asarray(xs, jnp.uint32), jnp.asarray(ys, jnp.uint32), jnp.asarray(zs, jnp.uint32))
    for x, y, z, h, l in zip(xs, ys, zs, np.array(hi), np.array(lo)):
        assert ((int(h) << 32) | int(l)) == key_py(int(x), int(y), int(z), 21)


def test_morton_key_from_unit_floats():
    # floats in (0,1) quantized with span 1023, truncating cast (ref morton.h:32-43)
    k = int(morton.morton_key_30bit_from_unit(
        jnp.float32(0.5), jnp.float32(0.25), jnp.float32(0.75)))
    expect = key_py(int(1023 * 0.5), int(1023 * 0.25), int(1023 * 0.75), 10)
    assert k == expect


def test_morton_keys_from_centroids_matches_manual(rng):
    pts = rng.random((64, 3)).astype(np.float32) * 4 - 2
    mins = pts.min(0)
    maxs = pts.max(0)
    keys = np.array(morton.morton_keys_from_centroids(pts, mins, maxs, bits=30))
    scale = 1023.0 / (maxs - mins)
    for p, k in zip(pts, keys):
        u = ((p - mins) * scale).astype(np.float32).astype(np.uint32)
        assert int(k) == key_py(int(u[0]), int(u[1]), int(u[2]), 10)
