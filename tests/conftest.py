"""Test harness setup: the CPU backend with 8 virtual devices.

Must run before jax initializes — tests exercise multi-device sharding on a
virtual CPU mesh (SURVEY.md §4) and golden-frame parity on the CPU backend.
An explicit JAX_PLATFORMS wins, so the tests marked `gpu` can run on a card
(JAX_PLATFORMS=cuda python -m pytest -m gpu tests); elsewhere they skip.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from raytracing_cuda_tpu.scene.builders import build_scene
from raytracing_cuda_tpu.scene.textures import procedural_skies


@pytest.fixture(scope="session")
def scene():
    return build_scene()

