"""Gadget snapshot -> physics end-to-end (ref analog:
tests/integrate_gadget/integrate_gadget.cu:24-92, which reads a real
snapshot and checks the same plane-integral normalization).

No binary fixture is committed: a synthetic gas-only Gadget-2 format-1
snapshot is fabricated in-test (io.gadget.write_gadget_gas), read back
through BOTH reader paths (native C++ when the toolchain is present, and
the pure-numpy fallback), and the particles are pushed through the full
build + trace pipeline with the reference's 5e-4 normalization gate."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from grace_jax.build.sph import build_sph_tree
from grace_jax.core.types import make_spheres
from grace_jax.io import native
from grace_jax.io.gadget import _np_read, read_gadget_gas, write_gadget_gas
from grace_jax.rays.gen import plane_parallel_random_rays
from grace_jax.trace.sph import trace_cumulative_sph

TOL = 5e-4  # ref integrate_gadget.cu / integrate.cu gate


def _snapshot(tmp_path, rng, n=40):
    pos = (rng.random((n, 3)) * 1.2 - 0.6).astype(np.float32)
    h = (0.1 + 0.1 * rng.random(n)).astype(np.float32)
    xyzh = np.concatenate([pos, h[:, None]], axis=1).astype(np.float32)
    path = str(tmp_path / "snap_000")
    write_gadget_gas(path, xyzh)
    return path, xyzh


def test_gadget_roundtrip_both_readers(tmp_path, rng):
    path, xyzh = _snapshot(tmp_path, rng)
    got_np = _np_read(path)
    np.testing.assert_array_equal(got_np, xyzh)
    lib = native.load()
    if lib is None:
        pytest.skip("native toolchain unavailable; numpy path covered")
    got_native = read_gadget_gas(path)       # native path when lib loads
    np.testing.assert_array_equal(got_native, xyzh)


def test_gadget_to_integral_normalization(tmp_path, rng):
    """Read a fabricated snapshot and run the physics gate on its
    particles — the reference's integrate_gadget flow end-to-end."""
    path, _ = _snapshot(tmp_path, rng)
    readers = [("numpy", _np_read)]
    if native.load() is not None:
        readers.append(("native", read_gadget_gas))
    for name, reader in readers:
        xyzh = reader(path)
        spheres = make_spheres(xyzh[:, :3], xyzh[:, 3])
        ss, tree, _ = jax.jit(build_sph_tree, static_argnums=1)(spheres, 4)
        side = 2.0
        res = 1024
        rays = plane_parallel_random_rays(
            jax.random.key(11), res, res, (-1.0, -1.0, -5.0),
            (side, 0, 0), (0, side, 0), length=20.0)
        integrals = trace_cumulative_sph(rays, ss, tree)
        total = float(jnp.sum(integrals)) * (side / res) ** 2
        n = xyzh.shape[0]
        assert abs(total / n - 1.0) < TOL, (name, total)
