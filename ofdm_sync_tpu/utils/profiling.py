"""Profiling and observability: the subsystem the reference lacks entirely
(SURVEY section 5: "Tracing / profiling: none").

Provides
  * `trace(dir)` -- context manager around `jax.profiler` emitting a
    TensorBoard-loadable trace of every XLA/Pallas kernel launch;
  * `Throughput` -- steady-state samples/sec meter with compile-time
    exclusion; every call ends in `block_until_ready`;
  * `kernel_stats` -- one-line throughput/latency summary used by bench.py
    and the pipelines' report blocks.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/ofdm_sync_trace", *, create_perfetto: bool = False):
    """Profile the enclosed device work: `with profiling.trace(dir): fn(x)`.

    View with TensorBoard's profile plugin or Perfetto.
    """
    jax.profiler.start_trace(log_dir, create_perfetto_trace=create_perfetto)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@dataclass
class Throughput:
    """Steady-state throughput meter.

    >>> meter = Throughput(samples_per_call=batch * stream_len)
    >>> stats = meter.measure(fn, x, iters=10)
    """

    samples_per_call: int
    warmup: int = 2
    latencies_s: list = field(default_factory=list)

    def measure(self, fn, *args, iters: int = 10) -> dict:
        for _ in range(self.warmup):
            jax.block_until_ready(fn(*args))
        lats = []
        t_all0 = time.perf_counter()
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            lats.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t_all0
        self.latencies_s = lats
        sps = self.samples_per_call * iters / wall
        return {
            "samples_per_sec": sps,
            "wall_s": wall,
            "iters": iters,
            "samples_per_call": self.samples_per_call,
        }


def kernel_stats(fn, *args, samples_per_call: int, iters: int = 10,
                 label: str = "kernel") -> dict:
    """Measure and pretty-print one kernel's steady-state throughput."""
    stats = Throughput(samples_per_call=samples_per_call).measure(
        fn, *args, iters=iters
    )
    sps = stats["samples_per_sec"]
    print(f"{label}: {sps / 1e6:.1f} M IQ samples/s "
          f"({stats['wall_s'] * 1e3 / iters:.2f} ms/call)")
    return stats
