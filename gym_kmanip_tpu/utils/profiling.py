"""Tracing / profiling utilities.

The reference's only instrumentation is print-based timers ("IK took Xms"
at ik_mujoco.py:153-154, per-step logger ms at env_base.py:252-258). This
module provides the structured equivalents (SURVEY.md §5):
wall-clock timers with solves/sec counters that feed the BASELINE metrics,
and a `jax.profiler` trace context for per-kernel analysis.
"""

import contextlib
import time
from typing import Dict, Optional

import jax


class Timer:
    """Accumulating wall-clock timer with rate reporting.

    >>> t = Timer("mpc_solve")
    >>> with t:  # doctest: +SKIP
    ...     solver(...)
    >>> t.rate_hz  # doctest: +SKIP
    """

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1
        return False

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.total / max(self.count, 1)

    @property
    def rate_hz(self) -> float:
        return self.count / self.total if self.total > 0 else 0.0

    def __repr__(self):
        return f"Timer({self.name}: {self.mean_ms:.2f} ms/call, {self.rate_hz:.1f} Hz)"


class Timers:
    """Named timer registry (the framework's metrics sink)."""

    def __init__(self):
        self._timers: Dict[str, Timer] = {}

    def __call__(self, name: str) -> Timer:
        if name not in self._timers:
            self._timers[name] = Timer(name)
        return self._timers[name]

    def report(self) -> Dict[str, float]:
        return {n: t.mean_ms for n, t in self._timers.items()}


TIMERS = Timers()


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/kmanip_trace"):
    """jax.profiler trace context: open the result with TensorBoard/XProf."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def timed_block_until_ready(fn, *args, n: int = 10, warmup: int = 1):
    """Benchmark helper: mean wall seconds per call of a jitted fn."""
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n
