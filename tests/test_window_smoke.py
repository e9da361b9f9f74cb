"""Window event-loop smoke tests under the SDL dummy video driver.

Executes the real run_window loop (blit, title refresh, checkpoint keys,
resize) headlessly — the reference's GLUT shell was only ever verified by
eye (SURVEY.md §4); here the loop itself runs in CI.
"""

import os

import numpy as np
import pytest

pygame = pytest.importorskip("pygame")

from raytracing_cuda_tpu.utils.config import RenderConfig

CFG = RenderConfig(width=64, height=48, path="fast", sky_source="procedural",
                   procedural_sky_shape=(16, 32), chunk=4096)


@pytest.fixture(autouse=True)
def dummy_video(monkeypatch):
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")


def test_run_window_renders_frames(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # checkpoint writes land in tmp
    from raytracing_cuda_tpu.app.window import run_window

    assert run_window(CFG, max_frames=2) == 2


def test_run_window_checkpoint_and_resize_events(tmp_path, monkeypatch):
    """Post F5 (save), a VIDEORESIZE, then F9 (load) through the real loop."""
    monkeypatch.chdir(tmp_path)
    from raytracing_cuda_tpu.app import window as win

    events = [
        pygame.event.Event(pygame.KEYDOWN, key=pygame.K_F5),
        pygame.event.Event(pygame.VIDEORESIZE, w=96, h=64),
        pygame.event.Event(pygame.KEYDOWN, key=pygame.K_F9),
    ]
    orig_init = pygame.init

    def init_and_queue():
        out = orig_init()
        for ev in events:
            pygame.event.post(ev)
        return out

    monkeypatch.setattr(pygame, "init", init_and_queue)
    # resize_settle_s=0: apply the (debounced) resize on the next frame so
    # the in-loop rebuild path executes within the 3-frame smoke run
    assert win.run_window(CFG, max_frames=3, resize_settle_s=0.0) == 3
    assert os.path.exists("raytracer_state.json")


def test_run_window_screenshot_key(tmp_path, monkeypatch):
    """F12 saves a full-res PNG of the current state (beyond-reference)."""
    import glob

    monkeypatch.chdir(tmp_path)
    from raytracing_cuda_tpu.app import window as win

    orig_init = pygame.init

    def init_and_queue():
        out = orig_init()
        pygame.event.post(pygame.event.Event(pygame.KEYDOWN,
                                             key=pygame.K_F12))
        return out

    monkeypatch.setattr(pygame, "init", init_and_queue)
    assert win.run_window(CFG, max_frames=2) == 2
    shots = glob.glob("screenshot_*.png")
    assert len(shots) == 1
    from raytracing_cuda_tpu.utils.images import load_png

    img = load_png(shots[0])
    assert img.shape == (CFG.height, CFG.width, 3) and img.any()


def test_run_window_preview_mode(tmp_path, monkeypatch):
    """--preview N: the loop renders full-res, reads back the 1/N device
    downsample and upscales in the blit — must run end-to-end."""
    import dataclasses

    monkeypatch.chdir(tmp_path)
    from raytracing_cuda_tpu.app.window import run_window

    cfg = dataclasses.replace(CFG, preview=2)
    assert run_window(cfg, max_frames=2) == 2


def test_engine_preview_downsample_shape():
    from raytracing_cuda_tpu.app.loop import Engine
    import dataclasses

    eng = Engine(dataclasses.replace(CFG, preview=2))
    small = np.asarray(eng.step_and_frame_preview(None, 1 / 60))
    assert small.shape == (24, 32, 3) and small.dtype == np.uint8
    # the preview is a box mean of the full-res frame rendered by the same
    # fused step — check against the full frame of the NEXT identical step
    # is not exact (state advanced), so just sanity-check the range
    assert small.mean() > 0


def test_box_downsample_matches_numpy():
    import jax.numpy as jnp

    from raytracing_cuda_tpu.app.loop import _box_downsample

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (8, 12, 3)).astype(np.uint8)
    got = np.asarray(_box_downsample(jnp.asarray(img), 4))
    want = (img.astype(np.float32).reshape(2, 4, 3, 4, 3).mean((1, 3))
            + 0.5).astype(np.uint8)
    assert np.array_equal(got, want)
    assert np.array_equal(np.asarray(_box_downsample(jnp.asarray(img), 1)),
                          img)   # n=1 is a passthrough


def test_host_and_device_downsample_agree():
    """The SSAA resolve (utils.images.box_downsample, host numpy) and the
    preview resolve (app.loop._box_downsample, device jnp) are twins —
    same box mean, same +0.5 truncate rounding."""
    import jax.numpy as jnp

    from raytracing_cuda_tpu.app.loop import _box_downsample
    from raytracing_cuda_tpu.utils.images import box_downsample

    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
    img[:4, :4] = 255    # saturated box: mean+0.5 = 255.5 must stay 255
    for n in (1, 2, 4):
        host = box_downsample(img, n)
        dev = np.asarray(_box_downsample(jnp.asarray(img), n))
        assert np.array_equal(host, dev), n


def test_preview_must_divide_framebuffer():
    import dataclasses

    with pytest.raises(ValueError, match="preview"):
        dataclasses.replace(CFG, preview=7)   # 64 % 7 != 0


def test_engine_resized_shares_assets_and_state():
    from raytracing_cuda_tpu.app.loop import Engine

    eng = Engine(CFG)
    eng.step()  # advance the clock so carried state is non-trivial
    big = eng.resized(96, 64)
    assert big.config.width == 96 and big.config.height == 64
    assert big.sky_texels is eng.sky_texels and big.scene is eng.scene
    assert float(big.state.day_time) == float(eng.state.day_time)
    img = np.asarray(big.frame())
    assert img.shape == (64, 96, 3) and img.dtype == np.uint8


def test_cli_preview_is_window_only():
    """--preview must only reach RenderConfig for the window command: it
    is a window-loop knob, and forwarding it for render/record/bench made
    the config's divisibility validation reject runs that never read it."""
    import argparse

    from raytracing_cuda_tpu.__main__ import _config

    base = dict(size="1280x720", sky="procedural", path="auto",
                scene="island", preview=3)   # 720 % 3 == 0 but 1280 % 3 != 0
    cfg = _config(argparse.Namespace(command="record", **base))
    assert cfg.preview == 1
    with pytest.raises(ValueError, match="preview"):
        _config(argparse.Namespace(command="window", **base))
