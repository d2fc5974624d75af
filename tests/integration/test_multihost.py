"""Two-process multi-host test (SURVEY.md section 4 "Multi-node testing").

Spawns 2 REAL processes, each with 4 virtual CPU devices, brings up
jax.distributed via grace_jax.parallel.multihost.initialize, builds an
8-device global ("rays", "space") mesh spanning both processes, runs the
space-sharded ring training step on globally assembled arrays, and compares
loss + image against a single-process oracle computed from the same seed.

This is the recipe a multi-host GPU run uses; only the device count and
platform differ.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
import numpy as np

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]

import jax
jax.config.update("jax_platforms", "cpu")
from grace_jax.parallel import multihost

multihost.initialize(f"localhost:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == nproc * 4, len(jax.devices())

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from grace_jax.core.types import Rays, make_spheres
from grace_jax.parallel.sharding import sharded_train_step

# Deterministic global problem, identical in every process.
rng = np.random.default_rng(99)
n, r = 128, 64
spheres_np = np.concatenate(
    [(rng.random((n, 3)) * 1.2 - 0.6), 0.15 + 0.1 * rng.random((n, 1))],
    axis=1).astype(np.float32)
d = rng.standard_normal((r, 3)).astype(np.float32)
d /= np.linalg.norm(d, axis=1, keepdims=True)
o = (rng.random((r, 3)) * 0.2 - 0.7).astype(np.float32)
targets_np = np.zeros((r,), np.float32)

mesh = multihost.global_mesh(4, 2)

# Each process contributes only ITS local slice of the global arrays
# (rays sharded over both axes -> this host owns half the rays; particles
# sharded over "space" -> each host's devices hold one space shard each).
def local_rows(a, spec_axes_size):
    per = a.shape[0] // nproc
    return a[pid * per:(pid + 1) * per]

rays_local = Rays(
    jnp.asarray(local_rows(o, nproc)),
    jnp.asarray(local_rows(d, nproc)),
    jnp.asarray(local_rows(np.full((r,), 4.0, np.float32), nproc)),
)
spec_rays = Rays(P(("rays", "space")), P(("rays", "space")), P(("rays", "space")))
rays_g = multihost.host_local_to_global(mesh, spec_rays, rays_local)
# P("space"): the "space" axis lies WITHIN each host's device rows, so the
# host-local view spans every space shard — pass the full array (in a real
# run each host concatenates the gadget shards its devices need).
spheres_g = multihost.host_local_to_global(
    mesh, P("space"), jnp.asarray(spheres_np))
targets_g = multihost.host_local_to_global(
    mesh, P(("rays", "space")), jnp.asarray(local_rows(targets_np, nproc)))

new_spheres, loss, ovf = sharded_train_step(
    mesh, rays_g, spheres_g, targets_g, capacity=4096, max_per_leaf=4,
    lr=1e-6)
# loss/ovf are replicated (out_specs P()); fetch this host's local copy.
loss_l, ovf_l = multihost.global_to_host_local(mesh, (P(), P()), (loss, ovf))
assert not bool(np.asarray(ovf_l)), "overflow flagged"
print(f"WORKER {pid} loss {float(np.asarray(loss_l)):.8e}", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_ring_train_step(tmp_path, rng):
    port = _free_port()
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORM_NAME"] = "cpu"
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"

    losses = []
    for out in outs:
        line = [l for l in out.splitlines() if l.startswith("WORKER")][0]
        losses.append(float(line.split()[-1]))
    assert losses[0] == losses[1], losses

    # Single-process oracle on the same deterministic problem.
    import jax
    import jax.numpy as jnp
    from grace_jax.core.types import Rays
    from grace_jax.parallel.sharding import make_mesh, sharded_train_step

    rng99 = np.random.default_rng(99)
    n, r = 128, 64
    spheres_np = np.concatenate(
        [(rng99.random((n, 3)) * 1.2 - 0.6), 0.15 + 0.1 * rng99.random((n, 1))],
        axis=1).astype(np.float32)
    d = rng99.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (rng99.random((r, 3)) * 0.2 - 0.7).astype(np.float32)
    rays = Rays(jnp.asarray(o), jnp.asarray(d), jnp.full((r,), 4.0, jnp.float32))
    mesh = make_mesh(4, 2)
    _, loss_ref, ovf = sharded_train_step(
        mesh, rays, jnp.asarray(spheres_np), jnp.zeros((r,), jnp.float32),
        capacity=4096, max_per_leaf=4, lr=1e-6)
    assert not bool(ovf)
    np.testing.assert_allclose(losses[0], float(loss_ref), rtol=1e-5)
