"""Profiling and metrics: honest device timers, FPS counter, trace capture.

The reference's only instrumentation is an FPS HUD with a 500 ms window
(reference: index.html:2181-2204). Here profiling is a first-class module:
a measurement harness (timings are only honest after a device->host
sync) and a jax.profiler trace context for kernel-level analysis.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp

__all__ = ["device_timer", "FpsCounter", "trace", "benchmark_fn"]


def _sync(x) -> float:
    """Force completion of a device value and return a scalar from it."""
    return float(jnp.sum(jnp.asarray(x)))


def device_timer(fn, *args, warmup: int = 1, iters: int = 10, **kwargs):
    """Time a device function honestly.

    Runs `warmup` untimed calls (compile + switch the runtime into
    synchronous accounting via a D2H), then `iters` timed calls chained on
    device with ONE final sync. Returns seconds per call.
    """
    out = fn(*args, **kwargs)
    for _ in range(max(warmup - 1, 0)):
        out = fn(*args, **kwargs)
    _sync(out)

    t0 = time.perf_counter()
    outs = [fn(*args, **kwargs) for _ in range(iters)]
    _sync(jnp.stack([jnp.sum(jnp.asarray(o)) for o in outs]))
    return (time.perf_counter() - t0) / iters


@dataclass
class FpsCounter:
    """Windowed frames/sec counter (the HUD metric, 500 ms window).
    reference: index.html:2182-2186."""

    window_seconds: float = 0.5
    _stamps: list = field(default_factory=list)

    def tick(self, now: float | None = None) -> float:
        now = time.perf_counter() if now is None else now
        self._stamps.append(now)
        cutoff = now - self.window_seconds
        self._stamps = [t for t in self._stamps if t >= cutoff]
        if len(self._stamps) < 2:
            return 0.0
        span = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / span if span > 0 else 0.0


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context: kernel-level timeline into `log_dir`
    (view with tensorboard or xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def benchmark_fn(fn, *args, label: str = "", iters: int = 10, **kwargs) -> dict:
    """device_timer + a result dict {label, seconds_per_call, calls_per_sec}."""
    sec = device_timer(fn, *args, iters=iters, **kwargs)
    return {
        "label": label or getattr(fn, "__name__", "fn"),
        "seconds_per_call": sec,
        "calls_per_sec": 1.0 / sec if sec > 0 else float("inf"),
    }
