"""Error handling / debug assertions (analog of ref include/grace/error.h).

The reference's ``GRACE_CUDA_CHECK``/``GRACE_KERNEL_CHECK`` macros have no
direct analog — XLA raises on compile/runtime failure — so this module keeps
the two pieces that do transfer:

  * Host-side API validation (the reference throws std::invalid_argument for
    misuse, e.g. bintree_trace.cuh:231-238, albvh.cuh:795-799).
  * ``GRACE_DEBUG``-style optional invariant checks
    (ref: error.h:10-36, tests/Makefile.common:57-61): enabled by setting the
    environment variable ``GRACE_JAX_DEBUG=1``, they add ``checkify``-free
    host-side assertions on concrete values and ``jax.debug``-level checks in
    traced code via ``debug_assert``.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp


class GraceError(ValueError):
    """Raised on invalid API usage (analog of std::invalid_argument throws)."""


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise GraceError(msg)


def debug_enabled() -> bool:
    return os.environ.get("GRACE_JAX_DEBUG", "0") not in ("", "0", "false")


def check_overflow(flag, msg: str = "capacity overflow") -> None:
    """Host-side fetch-and-raise on an overflow flag (bool or count>cap).

    The analog of the reference's fatal ``cuda_error_check``
    (ref: error.h:40-55): capacity-bounded kernels RETURN overflow flags
    (device code cannot raise); every host consumer must funnel them here
    before trusting the results. Forces a blocking device fetch — call it
    outside hot loops.
    """
    import numpy as np

    if bool(np.any(np.asarray(flag))):
        raise GraceError(msg + " — re-run with a larger capacity")


def debug_assert(pred, msg: str = "grace_jax debug assertion failed"):
    """Device-side invariant check, active only when GRACE_JAX_DEBUG is set.

    Analog of the reference's GRACE_ASSERT device asserts that are compiled in
    under -DGRACE_DEBUG (ref: error.h:10-36). In traced code we cannot branch
    on data, so this emits a jax.debug.print when the predicate fails.
    """
    if not debug_enabled():
        return
    bad = jnp.logical_not(jnp.all(pred))

    def _report(b):
        jax.lax.cond(
            b,
            lambda: jax.debug.print("GRACE_JAX_ASSERT FAILED: " + msg),
            lambda: None,
        )

    _report(bad)
