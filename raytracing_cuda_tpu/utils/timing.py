"""Frame timing + throughput metrics.

Replaces the reference's FPS window title (timerEvent/updateDelta,
main.cpp:230-259) with structured per-frame stats: wall-clock FPS and
Mrays/s (width*height primary rays per frame), measured with
block_until_ready so device work is fully accounted.
"""

from __future__ import annotations

import dataclasses
import time

import jax


@dataclasses.dataclass
class FrameStats:
    frames: int
    seconds: float
    width: int
    height: int

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds > 0 else float("inf")

    @property
    def mrays_per_s(self) -> float:
        return self.fps * self.width * self.height / 1e6

    def as_dict(self) -> dict:
        return {
            "frames": self.frames,
            "seconds": round(self.seconds, 4),
            "fps": round(self.fps, 2),
            "mrays_per_s": round(self.mrays_per_s, 2),
        }


class FrameTimer:
    """Wall-clock timer over a run of frames."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.frames = 0
        self._t0 = None
        self._elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def tick(self, device_value=None):
        """Count one frame; pass the frame array to block on device completion."""
        if device_value is not None:
            jax.block_until_ready(device_value)
        self.frames += 1

    def stop(self) -> FrameStats:
        self._elapsed = time.perf_counter() - self._t0
        return FrameStats(self.frames, self._elapsed, self.width, self.height)
