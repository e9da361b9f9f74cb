"""Golden-frame regression tests.

Frozen oracle renders (tests/golden/*.png, 160x96, procedural 64x128 sky;
utils.goldens) gate every render path against semantic drift — the replacement for the
reference's purely visual verification (SURVEY.md §4). Tolerances allow
float reassociation across paths/backends but catch any real change.

Regenerate (only when semantics intentionally change):
  JAX_PLATFORMS=cpu python tests/gen_golden.py
"""

import os

import glob

import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_cuda_tpu.render.pipeline import render_frame
from raytracing_cuda_tpu.scene.builders import build_scene
from raytracing_cuda_tpu.scene.textures import procedural_skies
from raytracing_cuda_tpu.sim import state as sim
from raytracing_cuda_tpu.utils.goldens import CASES, GOLDEN_DIR, make_state
from raytracing_cuda_tpu.utils.images import load_png, parity

H, W = 96, 160


def classic_env():
    """The classic demo scene (oldStaticScene analogue) + its camera pose.

    The island CASES can't reach this scene family, so it gets its own
    golden: without one, a semantic regression hitting every path equally
    would slip past the path-agreement test."""
    from raytracing_cuda_tpu.core.types import Camera
    from raytracing_cuda_tpu.scene.builders import (CLASSIC_CAMERA,
                                                    build_classic_scene)

    cc = CLASSIC_CAMERA
    st = sim.settle(sim.init_state()._replace(
        day_time=jnp.float32(14.0),
        cam=Camera(pos=jnp.asarray(cc["pos"], jnp.float32),
                   hor_angle=jnp.float32(cc["hor_angle"]),
                   ver_angle=jnp.float32(cc["ver_angle"]),
                   fov=jnp.float32(cc["fov"]))))
    return build_classic_scene(), st


@pytest.fixture(scope="module")
def env():
    return build_scene(), jnp.asarray(procedural_skies(64, 128))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("path", ["oracle", "fast", "pallas_interpret"])
def test_matches_golden(env, name, path):
    scene, sky = env
    golden = load_png(os.path.join(GOLDEN_DIR, f"{name}.png")).astype(
        np.float32)
    img = np.asarray(
        render_frame(scene, make_state(**CASES[name]), sky, H, W,
                     chunk=4096, path=path), np.float32)
    diff = np.abs(img - golden)
    rmse = np.sqrt(np.mean((diff / 255.0) ** 2))
    mismatched = np.mean(np.any(diff > 2.0, axis=-1))
    assert rmse < 2e-3, f"{name}/{path}: rmse {rmse}"
    assert mismatched < 0.003, f"{name}/{path}: {mismatched:.4%} pixels off"


@pytest.mark.parametrize("path", ["oracle", "fast", "pallas_interpret"])
def test_classic_matches_golden(env, path):
    """classic_demo.png pins the classic scene family (see classic_env)."""
    _, sky = env
    scene, st = classic_env()
    golden = load_png(os.path.join(GOLDEN_DIR, "classic_demo.png")).astype(
        np.float32)
    img = np.asarray(render_frame(scene, st, sky, H, W, chunk=4096,
                                  path=path), np.float32)
    diff = np.abs(img - golden)
    rmse = np.sqrt(np.mean((diff / 255.0) ** 2))
    assert rmse < 2e-3, f"classic/{path}: rmse {rmse}"
    assert np.mean(np.any(diff > 2.0, axis=-1)) < 0.003


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_golden_clustered(env, name):
    """The fully-clustered kernel (4 mountain groups + sphere clusters with
    the emissive cluster statically excluded from shadows) must be
    pixel-identical in result space to the unclustered kernel — culling and
    cluster partitions are pure skip optimizations."""
    from raytracing_cuda_tpu.scene.builders import (ISLAND_SPH_CLUSTERS,
                                                    ISLAND_TRI_CLUSTERS)

    scene, sky = env
    golden = load_png(os.path.join(GOLDEN_DIR, f"{name}.png")).astype(
        np.float32)
    img = np.asarray(
        render_frame(scene, make_state(**CASES[name]), sky, H, W,
                     chunk=4096, path="pallas_interpret",
                     tri_clusters=ISLAND_TRI_CLUSTERS,
                     sph_clusters=ISLAND_SPH_CLUSTERS), np.float32)
    plain = np.asarray(
        render_frame(scene, make_state(**CASES[name]), sky, H, W,
                     chunk=4096, path="pallas_interpret"), np.float32)
    assert np.array_equal(img, plain), "clustering changed pixels"
    diff = np.abs(img - golden)
    rmse = np.sqrt(np.mean((diff / 255.0) ** 2))
    assert rmse < 2e-3, f"{name}/clustered: rmse {rmse}"
    assert np.mean(np.any(diff > 2.0, axis=-1)) < 0.003


GOLDEN_PNGS = sorted(os.path.relpath(p, GOLDEN_DIR) for p in glob.glob(
    os.path.join(GOLDEN_DIR, "**", "*.png"), recursive=True))


@pytest.mark.parametrize("rel", GOLDEN_PNGS)
def test_png_reader_matches_pil(rel):
    """utils.images.load_png (numpy + zlib) decodes every committed golden
    exactly as an independent decoder does, and re-encoding round-trips."""
    from PIL import Image

    from raytracing_cuda_tpu.utils.images import decode_png, encode_png

    path = os.path.join(GOLDEN_DIR, rel)
    img = load_png(path)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
    assert np.array_equal(img, np.asarray(Image.open(path).convert("RGB")))
    assert np.array_equal(decode_png(encode_png(img, level=1)), img)


def test_parity_gate_thresholds():
    """utils.images.parity: RMSE < 2e-3 and < 0.3% of pixels off by more
    than 2 levels; both bounds bite on their own."""
    ref = np.full((100, 100, 3), 100, np.uint8)
    assert parity(ref, ref) == {"rmse": 0.0, "off_fraction": 0.0, "ok": True}
    near = ref.copy()
    near[:2, :1] += 3                          # 0.02% of pixels off by 3
    assert parity(near, ref)["ok"]
    many = ref.copy()
    many[:1, :40] += 3                         # 0.4% of pixels off by 3
    r = parity(many, ref)
    assert r["rmse"] < 2e-3 and not r["ok"]
    shift = ref + 1                            # every pixel off by 1 level
    r = parity(shift, ref)
    assert r["off_fraction"] == 0.0 and not r["ok"]
    with pytest.raises(ValueError, match="shape"):
        parity(ref[:10], ref)
