"""Multi-host (multi-process) scaling recipe.

The reference is strictly single-GPU/single-process (SURVEY.md section 2.3);
this module supplies the pieces a multi-host deployment needs:

  1. ``initialize`` — one-call ``jax.distributed`` bring-up. After it, every
     process sees the GLOBAL device list and a mesh built from it spans all
     hosts; collectives ride NVLink within a host and the network across
     hosts, chosen by XLA from the mesh layout.
  2. ``global_mesh`` — the same ("rays", "space") mesh the single-host
     sharding module uses, built over all processes' devices.
  3. ``host_local_to_global`` / ``global_to_host_local`` — wrap
     ``jax.experimental.multihost_utils`` so each host can contribute its
     locally loaded shard (rays it generated, particles it read via
     ``io.gadget.read_gadget_gas_shard``) to a global sharded array.
  4. ``load_gadget_shard_for_process`` — per-process Gadget reading: host k
     of N reads only its contiguous gas-particle range (the multi-host data
     loading path; ref reader: helper/read_gadget.cuh:15-167).

Testing recipe (no accelerator needed): run N processes with
``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=K``
and ``initialize(coordinator_address="localhost:<port>", num_processes=N,
process_id=i)``; the global mesh then has N*K virtual devices. See
tests/integration/test_multihost.py, which runs exactly this two-process
recipe and checks the sharded result against a single-process oracle.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids: Optional[list] = None,
) -> None:
    """Bring up the JAX distributed runtime (idempotent per process).

    Call BEFORE any other JAX API touches a backend. The three arguments
    are required: nothing in a plain GPU or CPU host tells JAX of a
    cluster.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_mesh(n_rays_axis: int, n_space_axis: int = 1) -> Mesh:
    """("rays", "space") mesh over the GLOBAL device list (all hosts).

    Lay the "space" axis within hosts where possible so the ring ppermute of
    ring_pallas_render/ring_render_and_loss rides intra-host NVLink and only
    the wrap-around link crosses the network.
    """
    devices = jax.devices()
    n = n_rays_axis * n_space_axis
    if n > len(devices):
        raise ValueError(
            f"mesh {n_rays_axis}x{n_space_axis} needs {n} devices, "
            f"have {len(devices)} global devices")
    dev = np.asarray(devices[:n]).reshape(n_rays_axis, n_space_axis)
    return Mesh(dev, axis_names=("rays", "space"))


def host_local_to_global(mesh: Mesh, spec: P, local_pytree):
    """Assemble per-process local shards into global sharded arrays.

    Each process passes the slice of the global array its devices own
    (concatenated along the sharded axes in process order); returns global
    jax.Arrays usable directly by the shard_map entry points."""
    from jax.experimental import multihost_utils

    return multihost_utils.host_local_array_to_global_array(
        local_pytree, mesh, spec)


def global_to_host_local(mesh: Mesh, spec: P, global_pytree):
    """Inverse of host_local_to_global: fetch this process's local shard."""
    from jax.experimental import multihost_utils

    return multihost_utils.global_array_to_host_local_array(
        global_pytree, mesh, spec)


def process_allgather(pytree):
    """All-hosts gather of (small) per-host values — the result-check path."""
    from jax.experimental import multihost_utils

    return multihost_utils.process_allgather(pytree)


def load_gadget_shard_for_process(
    path: str,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
) -> np.ndarray:
    """Read this process's contiguous gas-particle shard of a Gadget-2
    snapshot (ref reader: helper/read_gadget.cuh:15-167; shard reader:
    grace_jax.io.gadget.read_gadget_gas_shard).

    Returns spheres f32[n_local, 4]. Concatenating the shards in process
    order reproduces the full snapshot, so feeding them through
    ``host_local_to_global`` with spec P("space") yields the globally
    space-sharded particle array the ring renderer consumes.
    """
    from grace_jax.io.gadget import read_gadget_gas_shard

    pid = jax.process_index() if process_id is None else process_id
    np_ = jax.process_count() if num_processes is None else num_processes
    return read_gadget_gas_shard(path, pid, np_)
