"""GRACE_JAX_DEBUG invariant wiring (analog of ref GRACE_DEBUG asserts,
error.h:10-36): healthy inputs stay silent, violated invariants report.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from grace_jax.build.sph import build_sph_tree
from grace_jax.core.errors import GraceError, check_overflow, require
from grace_jax.core.types import Rays, make_spheres
from grace_jax.trace.sph import trace_hitcounts_sph


def _scene(rng, n=200):
    spheres = make_spheres(rng.random((n, 3)).astype(np.float32),
                           (0.05 + 0.1 * rng.random(n)).astype(np.float32))
    rays = Rays(
        jnp.asarray(np.tile([[0.5, 0.5, -2.0]], (8, 1)).astype(np.float32)),
        jnp.asarray(np.tile([[0.0, 0.0, 1.0]], (8, 1)).astype(np.float32)),
        jnp.full((8,), 6.0, jnp.float32),
    )
    return spheres, rays


def test_require_raises_grace_error():
    with pytest.raises(GraceError):
        require(False, "nope")
    assert issubclass(GraceError, ValueError)  # old except ValueError works


def test_check_overflow():
    check_overflow(jnp.zeros((), jnp.bool_))  # no-op
    with pytest.raises(GraceError):
        check_overflow(jnp.ones((3,), jnp.bool_), "boom")


def test_debug_asserts_silent_on_healthy_scene(rng, monkeypatch, capfd):
    monkeypatch.setenv("GRACE_JAX_DEBUG", "1")
    spheres, rays = _scene(rng)
    ss, tree, _ = build_sph_tree(spheres, 8)
    counts = trace_hitcounts_sph(rays, ss, tree, stack_size=64)
    jax.block_until_ready(counts)
    out = capfd.readouterr()
    assert "GRACE_JAX_ASSERT" not in out.out + out.err


def test_engine_stack_overflow_reports_under_debug(rng, monkeypatch, capfd):
    # Co-located primitives degenerate the tree; a tiny stack must overflow
    # and, under GRACE_JAX_DEBUG, say so (ref GRACE_ASSERT
    # bintree_trace.cuh:164) instead of only silently truncating.
    monkeypatch.setenv("GRACE_JAX_DEBUG", "1")
    spheres = make_spheres(np.full((256, 3), 0.5, np.float32),
                           np.full((256,), 0.4, np.float32))
    _, rays = _scene(rng)
    ss, tree, _ = build_sph_tree(spheres, 2)
    counts = trace_hitcounts_sph(rays, ss, tree, stack_size=4)
    jax.block_until_ready(counts)
    out = capfd.readouterr()
    assert "GRACE_JAX_ASSERT" in out.out + out.err
    assert "stack overflow" in out.out + out.err


def test_build_misuse_raises(rng):
    spheres, _ = _scene(rng, n=8)
    with pytest.raises(GraceError):
        build_sph_tree(spheres, 0)
    with pytest.raises(GraceError):
        build_sph_tree(spheres, 8)  # max_per_leaf must be < N


def test_device_frame_ms_harness_on_cpu():
    """The chained-frame timing harness (bench.device_frame_ms) must
    produce a finite per-frame time for a trivial data-dependent body —
    this is the measurement primitive every hardware number relies on."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import bench

    def body(i, acc):
        return acc * 1.0000001 + 1.0

    ms = bench.device_frame_ms(body, k1=2, k2=10, reps=2)
    assert isinstance(ms, float)
    # slope of a trivial body is tiny but must be finite and not absurd
    assert -1.0 < ms < 1000.0
