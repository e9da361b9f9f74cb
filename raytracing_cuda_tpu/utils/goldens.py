"""Golden frames: the states the oracle rendered and where the PNGs live.

tests/golden/*.png are 160x96 oracle renders (procedural 64x128 sky) that
gate every path in the tests; tests/golden/full/ holds 1280x720 renders and
tests/golden/full/{W}x{H}/ other sizes (procedural 2048x4096 sky), which
bench.py and chip_smoke.py gate the compiled GPU path against
(utils.images.parity). Regenerate with tests/gen_golden.py and
tests/gen_full_golden.py, only when render semantics change on purpose.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests", "golden")
FULL_SIZE = (1280, 720)
FULL_SKY_SHAPE = (2048, 4096)

CASES = {
    "island_morning": dict(day=6.0),
    "mountains_day": dict(day=14.0, cp=1),
    "island_night": dict(day=1.0),
    "evening_flood_noaa": dict(day=18.0, sea=2.0, aa=False),
}

# reference-sky states (day=9.0 is mid morning→day crossfade)
CASES_REF = {
    "ref_island_fade": dict(day=9.0),
    "ref_mountains_day": dict(day=14.0, cp=1),
}


def make_state(day, cp=None, sea=None, aa=True):
    from raytracing_cuda_tpu.sim import state as sim
    from raytracing_cuda_tpu.sim.actions import Action

    s = sim.init_state()._replace(day_time=jnp.float32(day))
    if cp is not None:
        s = sim.apply_controls(
            s, Action.idle()._replace(cam_preset=np.int32(cp)), 0.0)
    if sea is not None:
        s = s._replace(sea_y=jnp.float32(sea))
    return sim.settle(s._replace(aa=jnp.bool_(aa)))


def full_golden_dir(w: int, h: int) -> str:
    """Directory of the full-resolution goldens for a (w, h) frame."""
    root = os.path.join(GOLDEN_DIR, "full")
    return root if (w, h) == FULL_SIZE else os.path.join(root, f"{w}x{h}")
