"""Timing and tracing utilities.

The reference's only instrumentation is a single ``clock()`` wall-time print
at exit (``fluid.cc:18-20,1511-1513``); this module provides per-phase
timers, throughput counters (the BASELINE metrics), and an optional
``jax.profiler`` trace context.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class PhaseTimer:
    """Accumulating per-phase wall-clock timer with throughput helpers."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        t0 = time.time()
        yield
        self.totals[name] += time.time() - t0
        self.counts[name] += 1

    def report(self, particles: int | None = None):
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            line = f"{name:24s} {t:8.3f}s total  {t / max(c, 1) * 1000:8.1f} ms/call ({c})"
            if particles and c:
                line += f"  {particles * c / t / 1e6:8.1f}M particle-steps/s"
            lines.append(line)
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``jax.profiler`` trace context (no-op when log_dir is None)."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def check_finite(metrics: dict, frame: int):
    """Failure detection (SURVEY §5): raise on NaN/Inf energy or dt collapse
    so the frame loop can checkpoint-and-stop instead of silently diverging."""
    ke = float(metrics.get("kinetic_energy", 0.0))
    dt = float(metrics.get("dt", 1.0))
    import math
    if not math.isfinite(ke):
        raise FloatingPointError(
            f"non-finite kinetic energy at frame {frame}: {ke}")
    if dt <= 0 or not math.isfinite(dt):
        raise FloatingPointError(f"invalid dt at frame {frame}: {dt}")
