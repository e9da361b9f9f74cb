"""Profiling / tracing hooks.

The reference's only performance signal is the FPS window title
(timerEvent, main.cpp:230-237). Here: structured per-frame stats live in
utils.timing (FrameStats: fps, Mrays/s), and this module adds device trace
capture around a frame run — open the dump with TensorBoard's profiler or
Perfetto (SURVEY.md §5 'tracing/profiling').
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(out_dir: str):
    """jax.profiler trace capture around a block of frame work.

    Produces a TensorBoard/Perfetto-loadable dump under out_dir. A backend
    that cannot trace raises: a run asked to trace must not silently go
    untraced.
    """
    import jax

    os.makedirs(out_dir, exist_ok=True)
    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class FrameProbe:
    """Rolling per-frame wall-clock stats: last/mean/p99 frame ms.

    A host-side probe for interactive loops; pairs with utils.timing's
    FrameTimer (which measures sustained throughput with device sync).
    """

    def __init__(self, window: int = 240):
        import collections

        self.window = window
        self.samples: "collections.deque" = collections.deque(maxlen=window)
        self._last = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.samples.append(dt)     # deque(maxlen) evicts in O(1)
        self._last = now
        return dt

    def stats(self) -> dict:
        if not self.samples:
            return {"frames": 0}
        s = sorted(self.samples)
        n = len(s)
        return {
            "frames": n,
            "mean_ms": round(sum(s) / n * 1e3, 2),
            "p50_ms": round(s[n // 2] * 1e3, 2),
            "p99_ms": round(s[min(n - 1, int(n * 0.99))] * 1e3, 2),
            "fps": round(n / sum(s), 1),
        }
