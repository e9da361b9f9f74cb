"""RenderConfig / checkpoint input validation (SURVEY.md §2 #20 — the
reference's only guard rails are checkCudaErrors aborts, helper_cuda.h:579;
here bad inputs fail at construction with a message)."""

import pytest

from raytracing_cuda_tpu.utils.checkpoint import state_from_dict, state_to_dict
from raytracing_cuda_tpu.utils.config import RenderConfig


@pytest.mark.parametrize("kw", [
    {"width": 0}, {"height": 1}, {"width": -640},
    {"chunk": 0},
    {"path": "cuda"}, {"path": ""},
    {"scene": "moon"},
    {"shard_interleave": 0}, {"preview": 0},
    {"sky_source": "png"},
    {"sky_downsample": 0},
    {"procedural_sky_shape": (4, 4)}, {"procedural_sky_shape": (64,)},
    {"aspect": 0.0}, {"aspect": -1.7},
])
def test_bad_config_raises(kw):
    with pytest.raises(ValueError):
        RenderConfig(**kw)


def test_good_configs_construct():
    RenderConfig()
    RenderConfig(width=2, height=2, path="pallas_interpret", aspect=1.7777)


def test_checkpoint_rejects_malformed_fields():
    from raytracing_cuda_tpu.sim.state import init_state

    d = state_to_dict(init_state())
    state_from_dict(d)  # round-trips

    bad = dict(d, sky_vars=[0.0, 1.0, 0.0])
    with pytest.raises(ValueError, match="sky_vars"):
        state_from_dict(bad)
    bad = dict(d, recolor_vars=[1.0] * 5)
    with pytest.raises(ValueError, match="recolor_vars"):
        state_from_dict(bad)
    bad = dict(d, camera=dict(d["camera"], pos=[0.0, 1.0]))
    with pytest.raises(ValueError, match="pos"):
        state_from_dict(bad)
    with pytest.raises(ValueError, match="format"):
        state_from_dict(dict(d, format="something-else"))
