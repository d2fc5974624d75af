"""Profiling helpers (SURVEY section 5: the reference's nvprof/cudaEvent
idioms map to jax.profiler traces)."""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/grace_jax_trace"):
    """Capture a jax.profiler trace viewable with xprof/tensorboard:

        with grace_jax.utils.profiling.trace("/tmp/tr"):
            img = pallas_trace_sph(...)
            jax.block_until_ready(img)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region inside a trace (TraceAnnotation context)."""
    return jax.profiler.TraceAnnotation(name)
