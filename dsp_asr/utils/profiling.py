"""Profiling helpers: XLA traces, named stages, wall-clock stage timing.

The reference has no tracing story (SURVEY.md §5); here:

* ``trace(logdir)`` wraps ``jax.profiler.trace`` — open the result in
  TensorBoard / Perfetto to see per-op device timelines;
* ``stage(name)`` adds a ``jax.named_scope`` so pipeline stages (vad,
  mfcc, dtw, argmin) are attributed in those profiles;
* ``StageTimer`` gives cheap host-side wall-clock accounting; a stage
  that times device work ends in ``jax.block_until_ready``.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture an XLA device trace into ``logdir``."""
    with jax.profiler.trace(logdir):
        yield


def stage(name: str):
    """Named scope for profile attribution: `with stage('dtw'): ...`."""
    return jax.named_scope(name)


class StageTimer:
    """Accumulates host wall-clock per named stage."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def report(self) -> dict[str, float]:
        return {k: round(v, 4) for k, v in sorted(self.totals.items())}
