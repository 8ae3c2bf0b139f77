"""Wall-clock timing (the reference's ``benchmark.h`` analogue).

The reference wraps main in CLOCK_MONOTONIC macros and prints
``msg : seconds`` (``benchmark.h:7-23``). Here a context-manager timer
with explicit device synchronization — on an async dispatch runtime a
timer without ``block_until_ready`` measures nothing.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False

    def line(self, msg: str = "time") -> str:
        """Reference-style 'time : <seconds>' line (benchmark.h:14-23)."""
        return f"{msg} : {self.seconds:.6f}"


# ---------------------------------------------------------------------
# Phase timing: per-stage walls (prep / upload / train / top1).  The
# reference times only the whole main (benchmark.h) — but its
# per-iteration cost IS its wall/iters because nothing else happens;
# here upload/compile/top-1 are one-shot costs that can dominate a
# 10-iteration extreme-shape wall, so the train phase is isolated.
#
# Collection is opt-in: when no collector is active, ``phase`` yields a
# no-op sync and adds zero overhead to the hot path.  Inside a
# collector, the yielded callable blocks until the device work
# producing its argument is done (``jax.block_until_ready``).
# ---------------------------------------------------------------------

import contextlib

_COLLECTOR: dict | None = None


def _noop_sync(x=None):
    return x


@contextlib.contextmanager
def collect_phases(out: dict):
    """Collect named phase walls into ``out`` for the duration."""
    global _COLLECTOR
    prev = _COLLECTOR
    _COLLECTOR = out
    try:
        yield out
    finally:
        _COLLECTOR = prev


@contextlib.contextmanager
def phase(name: str):
    """Time one named stage.  Yields a sync callable the caller applies
    to the stage's result (no-op when collection is off)."""
    if _COLLECTOR is None:
        yield _noop_sync
        return
    collector = _COLLECTOR

    def psync(x=None):
        import jax

        return jax.block_until_ready(x)

    t0 = time.perf_counter()
    try:
        yield psync
    finally:
        collector[name] = collector.get(name, 0.0) + time.perf_counter() - t0
