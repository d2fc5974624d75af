"""Test configuration: the CPU backend with an 8-device virtual mesh.

The tests run on the host CPU (Pallas kernels in the interpreter);
multi-device sharding tests use the 8 virtual devices.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
