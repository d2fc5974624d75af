"""Wall-clock stage timer (analog of ref tests/helper/cuda_timer.cuh:5-59:
cudaEvent start/split/elapsed).

Device work is async, so ``split``/``elapsed`` first block until the given
arrays are ready."""

from __future__ import annotations

import time
from typing import Optional

import jax


def _sync(x=None):
    if x is not None:
        jax.tree_util.tree_map(
            lambda a: a.block_until_ready() if hasattr(a, "block_until_ready") else a,
            x,
        )


class Timer:
    """start() ... split(x) ... elapsed(x): millisecond stage timings."""

    def __init__(self):
        self._t0: Optional[float] = None
        self._last: Optional[float] = None

    def start(self) -> "Timer":
        self._t0 = self._last = time.perf_counter()
        return self

    def split(self, sync_on=None) -> float:
        """ms since the last split (synchronizing on ``sync_on`` first)."""
        _sync(sync_on)
        now = time.perf_counter()
        dt = (now - self._last) * 1e3
        self._last = now
        return dt

    def elapsed(self, sync_on=None) -> float:
        """ms since start()."""
        _sync(sync_on)
        return (time.perf_counter() - self._t0) * 1e3
