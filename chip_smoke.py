#!/usr/bin/env python
"""Prove on one NVIDIA GPU that the engine's main path runs and is right.

  python chip_smoke.py          # one card: device, loop, parity, kernel, record
  python chip_smoke.py --four   # four cards: frame-DP and row-sharded frames
                                #   against the same frames on one card

Phases (one line each, in order):
  (a) device  — JAX must report a GPU; prints nvidia-smi's name and limit;
  (b) loop    — Engine at 1280x720 through the animated camera script of
                bench.py: fps, p50/p99 frame ms, compile seconds;
  (c) parity  — the four golden states through the Engine's compiled path at
                1280x720 and 1920x1080 against tests/golden/full/ (oracle
                renders), each under utils.images.parity;
  (d) kernel  — the raytracing kernel's pre-FXAA frame against
                render/reference.py at 1280x720, three poses;
  (e) record  — a few frames through `record` with the native frame writer
                (built from native/ on first use), read back and checked.
The last line is one JSON object: {"ok": true, "device": {...}}. Any failure
raises, and the process exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import jax
import numpy as np

import bench
from raytracing_cuda_tpu.app.loop import Engine
from raytracing_cuda_tpu.utils.config import RenderConfig
from raytracing_cuda_tpu.utils.images import load_png, parity

REPO = os.path.dirname(os.path.abspath(__file__))

W, H = 1280, 720
LOOP_FRAMES = 240
POSES = {"day14": dict(day=14.0), "worst": dict(day=17.6, yaw=315.0),
         "fade": dict(day=8.05)}


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def check(phase, ok, what):
    if not ok:
        raise SystemExit(f"[{phase}] FAILED: {what}")


def phase_device(n_cards):
    devs = jax.devices()
    check("device", devs[0].platform == "gpu",
          f"JAX found no GPU (platform {devs[0].platform!r})")
    check("device", len(devs) >= n_cards, f"{n_cards} cards needed, "
          f"{len(devs)} found")
    print(bench.nvidia_smi(), flush=True)
    say("device", platform=devs[0].platform, kind=repr(devs[0].device_kind),
        count=len(devs))


def phase_loop():
    t0 = time.perf_counter()
    eng = Engine(RenderConfig(width=W, height=H))
    jax.block_until_ready(eng.step_and_frame(bench.camera_path(0)))
    compile_s = time.perf_counter() - t0
    check("loop", eng.path == "pallas", f"auto path resolved to {eng.path}")
    fps, ms = bench.timed_loop(eng, LOOP_FRAMES)
    img = np.asarray(eng.frame())
    check("loop", img.shape == (H, W, 3) and img.std() > 1.0,
          f"frame {img.shape}, std {img.std()}")
    say("loop", path=eng.path, frames=LOOP_FRAMES, fps=fps,
        p50_ms=bench.percentile(ms, 50), p99_ms=bench.percentile(ms, 99),
        compile_s=compile_s)


def phase_parity():
    from raytracing_cuda_tpu.utils.goldens import (CASES, full_golden_dir,
                                                   make_state)

    for w, h in ((1280, 720), (1920, 1080)):
        eng = Engine(RenderConfig(width=w, height=h))
        for name, kw in CASES.items():
            eng.set_state(make_state(**kw))
            golden = load_png(os.path.join(full_golden_dir(w, h),
                                           f"{name}.png"))
            r = parity(np.asarray(eng.frame()), golden)
            say("parity", size=f"{w}x{h}", state=name, rmse=r["rmse"],
                off_fraction=r["off_fraction"], ok=r["ok"])
            check("parity", r["ok"], f"{name} at {w}x{h}: {r}")


def phase_kernel():
    """The kernel's frame (static sky stack) vs the oracle's, both through
    the same FXAA and gated like the goldens. Before FXAA a few isolated
    silhouette pixels flip between two objects under GPU rounding (the
    fused-XLA path shows the same), so that difference is printed only."""
    from raytracing_cuda_tpu.render.fxaa import fxaa
    from raytracing_cuda_tpu.render.pipeline import _pallas_base
    from raytracing_cuda_tpu.render.reference import render_base_image
    from raytracing_cuda_tpu.scene.builders import (ISLAND_SPH_CLUSTERS,
                                                    ISLAND_TRI_CLUSTERS,
                                                    ISLAND_TRI_SUBS,
                                                    build_scene)
    from raytracing_cuda_tpu.scene.textures import (blend_sky,
                                                    procedural_skies,
                                                    sky_static_init)
    from raytracing_cuda_tpu.sim.state import camera_rays, derive_frame

    scene = jax.device_put(build_scene())
    texels = jax.device_put(procedural_skies(2048, 4096))
    stack = jax.jit(sky_static_init)(texels)
    sh, sw = texels.shape[1], texels.shape[2]

    @jax.jit
    def kernel(st):
        scene_f, lights, ambient = derive_frame(scene, st)
        return _pallas_base(
            scene_f, lights, ambient, camera_rays(st.cam, W / H), stack,
            sh, sw, st.day_time / 24.0, H, W,
            tri_clusters=ISLAND_TRI_CLUSTERS,
            sph_clusters=ISLAND_SPH_CLUSTERS, sky_vars=st.sky_vars,
            t_subs=ISLAND_TRI_SUBS)

    @jax.jit
    def oracle(st):
        scene_f, lights, ambient = derive_frame(scene, st)
        return render_base_image(
            scene_f, lights, ambient, blend_sky(texels, st.sky_vars),
            st.day_time / 24.0, camera_rays(st.cam, W / H), H, W)

    aa = jax.jit(fxaa)
    with jax.default_matmul_precision("highest"):
        for name, kw in POSES.items():
            st = bench.preset_state(**kw)
            got, want = kernel(st), oracle(st)
            base = parity(np.asarray(got), np.asarray(want))
            r = parity(np.asarray(aa(got)), np.asarray(aa(want)))
            say("kernel", kernel="raytrace", size=f"{W}x{H}", pose=name,
                rmse=r["rmse"], off_fraction=r["off_fraction"], ok=r["ok"],
                pre_fxaa_rmse=base["rmse"],
                pre_fxaa_off_fraction=base["off_fraction"])
            check("kernel", r["ok"], f"raytrace at {name}: {r}")


def phase_record():
    from raytracing_cuda_tpu.__main__ import main as cli
    from raytracing_cuda_tpu.utils import frameio

    if not frameio.available():
        check("record", frameio.build(), "native/frameio did not build")
    n = 4
    with tempfile.TemporaryDirectory(dir=REPO) as out:
        rc = cli(["record", out, "--frames", str(n), "--size", f"{W}x{H}",
                  "--sky", "procedural", "--png-level", "1"])
        check("record", rc == 0, f"record exited {rc}")
        frames = [load_png(os.path.join(out, f"{i:04d}.png"))
                  for i in range(n)]
    check("record", all(f.shape == (H, W, 3) and f.std() > 1.0
                        for f in frames), "bad frames")
    check("record", not np.array_equal(frames[0], frames[-1]),
          "the scripted camera did not move")
    say("record", frames=n, native=frameio.available(), size=f"{W}x{H}")


def phase_four():
    """Frame-DP and row-sharded frames on four cards vs one card."""
    cfg = RenderConfig(width=W, height=H)
    script = [bench.camera_path(i) for i in range(8)]
    one = Engine(cfg)
    state0 = one.state
    ref = [np.asarray(one.step_and_frame(a, 1 / 60)) for a in script]
    dp = Engine(cfg, share_assets_from=one)
    dp.set_state(state0)
    imgs = np.asarray(dp.render_script_dp(
        np.stack([a.pack(1 / 60) for a in script]), n_devices=4))
    for k in range(len(script)):
        r = parity(imgs[k], ref[k])
        say("four", layout="frame-dp", cards=4, frame=k, rmse=r["rmse"],
            off_fraction=r["off_fraction"], ok=r["ok"])
        check("four", r["ok"], f"frame-dp frame {k}: {r}")
    rows = Engine(cfg, sharded=True, share_assets_from=one)
    check("four", rows.mesh.size == 4, f"row mesh over {rows.mesh.size}")
    st = bench.preset_state(day=17.6, yaw=315.0)
    rows.set_state(st)
    one.set_state(st)
    r = parity(np.asarray(rows.frame()), np.asarray(one.frame()))
    say("four", layout="row-sharded", cards=4, rmse=r["rmse"],
        off_fraction=r["off_fraction"], ok=r["ok"])
    check("four", r["ok"], f"row-sharded frame: {r}")


def main_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths and their one-card "
                         "comparison")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four else 1
    phase_device(n_cards)
    if args.four:
        phase_four()
    else:
        phase_loop()
        phase_parity()
        phase_kernel()
        phase_record()
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))


if __name__ == "__main__":
    main_args(sys.argv[1:])
