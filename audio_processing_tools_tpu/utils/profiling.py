"""Profiling / tracing (SURVEY §5 aux-subsystem parity).

The reference instruments wall-clock per processor (``latency_s``) and run
totals in ``DataFrame.attrs``; the JAX equivalent keeps that API (framework
layer) and adds device-level tracing via ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Tuple


@contextlib.contextmanager
def device_trace(log_dir: str, *, host_tracer_level: int = 2):
    """Capture a ``jax.profiler`` trace (TensorBoard/Perfetto-readable).

    Usage::

        with device_trace("/tmp/trace"):
            engine.process_batch(xb)
    """
    import jax

    jax.profiler.start_trace(log_dir, create_perfetto_link=False)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Named wall-clock section accumulator.

    The host-side twin of the per-processor ``latency_s`` instrumentation:
    collects named sections and reports totals/means.
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }


def timed(func: Callable[..., Any], *args, **kwargs) -> Tuple[Any, float]:
    """(result, seconds) — the ``BaseProcessor._with_timing`` pattern."""
    t0 = time.perf_counter()
    result = func(*args, **kwargs)
    return result, time.perf_counter() - t0
