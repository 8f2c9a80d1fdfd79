"""Profiling & metering.

The reference's only observability is a wall-clock print per run
(omp_get_wtime around the loop, sample/algorithms.cpp:647-648) plus the
Results.txt ledger.  Here: per-phase timers, a throughput meter in the
benchmark's unit (edge force-updates/s), and an optional jax.profiler
trace capture for Tensorboard/Perfetto.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional


class Meter:
    """Accumulates per-phase wall time and work counters.

    >>> m = Meter()
    >>> with m.phase("train"):
    ...     out = step(x); m.sync(out)
    >>> m.count("edge_updates", nnz + n * ns)
    >>> m.report()
    """

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0

    def sync(self, x) -> None:
        """Wait for the device work that produces ``x``."""
        import jax

        jax.block_until_ready(x)

    def count(self, name: str, value: float) -> None:
        self.counts[name] = self.counts.get(name, 0.0) + value

    def rate(self, count_name: str, phase_name: str) -> float:
        s = self.seconds.get(phase_name, 0.0)
        return self.counts.get(count_name, 0.0) / s if s > 0 else 0.0

    def report(self) -> str:
        lines = [f"{k}: {v:.4f}s" for k, v in self.seconds.items()]
        lines += [f"{k}: {v:,.0f}" for k, v in self.counts.items()]
        return "\n".join(lines)


@contextlib.contextmanager
def phase_timer(name: str, verbose: bool = True):
    """Standalone one-shot phase timer."""
    t0 = time.perf_counter()
    yield
    if verbose:
        print(f"[{name}] {time.perf_counter() - t0:.4f}s")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a jax.profiler device trace (viewable in TensorBoard /
    Perfetto) around the enclosed block; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
