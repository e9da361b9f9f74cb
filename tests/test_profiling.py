"""Profiling utility tests (SURVEY.md §5 tracing/metrics)."""

import time

from raytracing_cuda_tpu.utils.profiling import FrameProbe, trace
from raytracing_cuda_tpu.utils.timing import FrameStats


def test_frame_probe_stats():
    p = FrameProbe(window=16)
    assert p.stats() == {"frames": 0}
    for _ in range(5):
        p.tick()
        time.sleep(0.002)
    s = p.stats()
    assert s["frames"] == 4 and s["mean_ms"] >= 1.0
    assert s["p99_ms"] >= s["p50_ms"] > 0


def test_frame_probe_window_bound():
    p = FrameProbe(window=3)
    for _ in range(10):
        p.tick()
    assert p.stats()["frames"] == 3


def test_trace_degrades_gracefully(tmp_path):
    """trace() writes a profile for the work inside it; a backend that
    cannot trace makes it raise rather than silently skip the trace."""
    import glob

    import jax
    import jax.numpy as jnp
    import pytest

    out = tmp_path / "prof"
    with trace(str(out)):
        jax.block_until_ready(jnp.arange(8) * 2)
    assert glob.glob(str(out / "**" / "*.xplane.pb"), recursive=True)

    def refuse(_):
        raise RuntimeError("no profiler on this backend")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.profiler, "start_trace", refuse)
        with pytest.raises(RuntimeError, match="no profiler"):
            with trace(str(tmp_path / "never")):
                pass


def test_frame_stats_metrics():
    s = FrameStats(frames=60, seconds=1.0, width=1280, height=720)
    assert s.fps == 60.0
    assert abs(s.mrays_per_s - 55.296) < 1e-3   # 1280*720*60 rays per second
    d = s.as_dict()
    assert d["frames"] == 60 and d["fps"] == 60.0
