"""CLI-level tests for `python -m raytracing_cuda_tpu record --dp`.

The reference exposes only `raytracing.exe [-device=N]` (main.cpp:338-384);
record is this build's headless output mode. Frame-for-frame bit-parity of
the frame-DP path against sequential stepping is pinned at the Engine
level (test_parallel.py); what the CLI adds on top is host batching logic
— full dp-divisible batches, then a sequential tail — so that is what
these tests pin, mostly with the render calls stubbed to index-tagged
images (running the interpret-mode kernel over a dozen frames re-proves
nothing the Engine test doesn't).
"""

import os

import numpy as np
import pytest

from raytracing_cuda_tpu.__main__ import main
from raytracing_cuda_tpu.utils.images import load_png, save_png


def _tag_img(i):
    img = np.zeros((64, 128, 3), np.uint8)
    img[0, 0, 0] = i
    return img


def test_record_dp_batches_and_tail(tmp_path, monkeypatch):
    """10 frames at --dp 4: the loop must issue dp-divisible DP batches
    (8 frames) then fall through to single-frame steps for the remainder
    (2), with every output frame landing at its own script index."""
    from raytracing_cuda_tpu.app import loop as loop_mod

    calls = []

    def fake_dp(self, vecs, n, n_rows=1):
        assert len(vecs) % n == 0 and n_rows == 1
        calls.append(("dp", len(vecs), n))
        start = sum(c[1] for c in calls[:-1])
        return np.stack([_tag_img(start + j) for j in range(len(vecs))])

    def fake_step(self, action, dt):
        calls.append(("seq", 1, 1))
        return _tag_img(sum(c[1] for c in calls[:-1]))

    monkeypatch.setattr(loop_mod.Engine, "render_script_dp", fake_dp)
    monkeypatch.setattr(loop_mod.Engine, "step_and_frame", fake_step)

    out = str(tmp_path / "frames")
    assert main(["record", out, "--frames", "10", "--dp", "4",
                 "--size", "128x64", "--sky", "procedural",
                 "--sky-shape", "64x32", "--path", "pallas_interpret"]) == 0

    # one 8-frame DP dispatch (dp*4 batch cap, clipped to the divisible 8),
    # then two sequential tail frames
    assert calls == [("dp", 8, 4), ("seq", 1, 1), ("seq", 1, 1)]
    for i in range(10):
        img = load_png(os.path.join(out, f"{i:04d}.png"))
        assert img[0, 0, 0] == i, i


def test_record_resume_skips_prefix_and_fast_forwards(tmp_path, monkeypatch):
    """--resume: the contiguous on-disk prefix is skipped, the state
    machine is fast-forwarded past exactly those frames (one scanned
    dispatch), and only the missing tail is rendered."""
    from raytracing_cuda_tpu.app import loop as loop_mod

    out = tmp_path / "frames"
    out.mkdir()
    for i in range(4):
        save_png(_tag_img(i), str(out / f"{i:04d}.png"))
    # a gap later must NOT extend the skip (only the contiguous prefix is
    # trusted — frame 6 exists but 4-5 don't, so rendering restarts at 4)
    save_png(_tag_img(6), str(out / "0006.png"))

    ff, rendered = [], []

    def fake_ff(self, actions, dt=1 / 30):
        ff.append(len(actions))
        return self.state

    def fake_step(self, action, dt):
        rendered.append(len(rendered))
        return _tag_img(100 + rendered[-1])

    monkeypatch.setattr(loop_mod.Engine, "fast_forward", fake_ff)
    monkeypatch.setattr(loop_mod.Engine, "step_and_frame", fake_step)

    assert main(["record", str(out), "--frames", "8", "--resume",
                 "--size", "128x64", "--sky", "procedural",
                 "--sky-shape", "64x32", "--path", "pallas_interpret"]) == 0

    # the last prefix frame (0003) is re-rendered — it may be truncated by
    # the very crash --resume recovers from — so the skip is 3, not 4
    assert ff == [3] and len(rendered) == 5
    for i, tag in [(0, 0), (2, 2), (3, 100), (4, 101), (7, 104)]:
        img = load_png(str(out / f"{i:04d}.png"))
        assert img[0, 0, 0] == tag, i


def test_record_dp_requires_pallas_static_sky(tmp_path):
    """record --dp on the GPU kernel path (interpret mode over the 8-device
    CPU mesh) writes the same frames as sequential recording; the fast
    path, which has no static sky stack, is refused."""
    common = ["--frames", "4", "--size", "32x16", "--sky", "procedural",
              "--sky-shape", "64x32", "--path", "pallas_interpret"]
    seq, dp = tmp_path / "seq", tmp_path / "dp"
    assert main(["record", str(seq)] + common) == 0
    assert main(["record", str(dp), "--dp", "4"] + common) == 0
    for i in range(4):
        a = load_png(str(seq / f"{i:04d}.png"))
        assert a.shape == (16, 32, 3)
        assert np.array_equal(a, load_png(str(dp / f"{i:04d}.png"))), i
    with pytest.raises(ValueError, match="static-sky"):
        main(["record", str(tmp_path / "x"), "--frames", "4", "--dp", "4",
              "--size", "128x64", "--sky", "procedural",
              "--sky-shape", "64x32", "--path", "fast"])


def test_fast_forward_matches_stepping():
    """Engine.fast_forward (fixed-chunk scans + single-step remainder)
    must land on exactly the state that stepping frame by frame reaches —
    the resume contract."""
    from raytracing_cuda_tpu.app.loop import Engine
    from raytracing_cuda_tpu.sim.actions import Action
    from raytracing_cuda_tpu.utils.config import RenderConfig

    cfg = RenderConfig(width=128, height=64, sky_source="procedural",
                       procedural_sky_shape=(32, 64), path="fast")
    acts = [Action.idle()._replace(
        mouse_dx=np.float32(2.0 * i), time_control=np.int32(1))
        for i in range(6)]

    a, b = Engine(cfg), Engine(cfg)
    for act in acts:
        a.step(act, 1 / 30)
    b.FF_CHUNK = 4          # cover the fixed-chunk scan AND the
    b.fast_forward(acts, 1 / 30)     # single-step remainder (6 = 4 + 2)
    import jax

    la = jax.tree_util.tree_leaves(a.state)
    lb = jax.tree_util.tree_leaves(b.state)
    assert len(la) == len(lb)
    for leaf_a, leaf_b in zip(la, lb):
        assert np.array_equal(np.asarray(leaf_a), np.asarray(leaf_b))


def test_malformed_size_is_a_usage_error(tmp_path):
    for flag, val in (("--size", "1280"), ("--sky-shape", "x64")):
        with pytest.raises(SystemExit, match="WxH"):
            main(["render", str(tmp_path / "x.png"), flag, val,
                  "--sky", "procedural", "--path", "fast"])


def test_box_downsample_semantics():
    """SSAA resolve: n×n box mean, round-half-up, uint8 in/out."""
    from raytracing_cuda_tpu.utils.images import box_downsample

    img = np.zeros((4, 4, 3), np.uint8)
    img[:2, :2] = 100                       # one uniform 2x2 box
    img[:2, 2:4, 0] = [[10, 11], [10, 12]]  # mean 10.75 -> 11
    out = box_downsample(img, 2)
    assert out.shape == (2, 2, 3) and out.dtype == np.uint8
    assert (out[0, 0] == 100).all()
    assert out[0, 1, 0] == 11 and out[0, 1, 1] == 0
    assert (out[1] == 0).all()
    src = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    assert np.array_equal(box_downsample(src, 1), src)   # n=1 passthrough


def test_record_ssaa_resolves_at_write_time(tmp_path, monkeypatch):
    """--ssaa 2: the engine is built at 2x --size and written frames are
    box-resolved back to --size (stubbed renders, the dp-test pattern)."""
    from raytracing_cuda_tpu.app import loop as loop_mod

    seen_cfg = []
    orig_init = loop_mod.Engine.__init__

    def spy_init(self, cfg, **kw):
        seen_cfg.append((cfg.width, cfg.height))
        return orig_init(self, cfg, **kw)

    def fake_step(self, action, dt):
        img = np.zeros((128, 256, 3), np.uint8)   # 2x the requested 128x64
        img[0, 0] = 255      # lone bright texel -> 64 after the 2x2 mean
        return img

    monkeypatch.setattr(loop_mod.Engine, "__init__", spy_init)
    monkeypatch.setattr(loop_mod.Engine, "step_and_frame", fake_step)

    out = str(tmp_path / "frames")
    assert main(["record", out, "--frames", "2", "--ssaa", "2",
                 "--size", "128x64", "--sky", "procedural",
                 "--sky-shape", "64x32", "--path", "pallas_interpret"]) == 0
    assert seen_cfg == [(256, 128)]
    img = load_png(os.path.join(out, "0000.png"))
    assert img.shape == (64, 128, 3)
    assert img[0, 0, 0] == 64 and (img[0, 1] == 0).all()  # 255/4=63.75 -> 64


def test_frames_mesh_rejects_oversubscription():
    from raytracing_cuda_tpu.parallel.frames import make_frames_mesh

    with pytest.raises(ValueError, match="available"):
        make_frames_mesh(1000)


def test_ssaa_rejected_for_window_and_bench():
    """--ssaa is render/record-only: window/bench must refuse it up front
    (it used to be silently ignored for window), and bad values must fail
    BEFORE any engine is built (advisor r4)."""
    import pytest

    for cmd in ("window", "bench"):
        with pytest.raises(SystemExit):
            main([cmd, "--ssaa", "2"])
    with pytest.raises(SystemExit):
        main(["render", "--ssaa", "0"])
