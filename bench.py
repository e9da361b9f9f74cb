#!/usr/bin/env python
"""Benchmark driver: the interactive loop and fixed poses on one device.

Prints ONE JSON line on stdout: the sustained fps of the animated
1280x720 loop (state step → render → FXAA, one frame at a time, each
waited for like a viewer waits to present it) with its p50/p99 frame
times, the crossfade and worst-pose numbers, the compiled-path parity
against the oracle goldens (tests/golden/full/, utils.images.parity) and
the device it ran on. Per-config details go to stderr.

Usage:
  python bench.py                 # full run (1280x720)
  python bench.py --quick         # small smoke run
  python bench.py --frames 120 --size 1280x720 --sky procedural
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_info() -> dict:
    """The device as JAX reports it, plus nvidia-smi's name and power limit
    on a GPU (a card set below its maximum runs slower under load)."""
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if info["platform"] == "gpu":
        info["name_power_limit"] = nvidia_smi()
    return info


def nvidia_smi() -> str:
    """First card's `name, power.limit` line from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def camera_path(i):
    """The animated loop's deterministic camera script (smooth pan + slow
    forward drift)."""
    from raytracing_cuda_tpu.sim.actions import Action

    return Action.idle()._replace(
        mouse_dx=np.float32(2.0 * np.sin(i * 0.02)),
        move_forward=np.int32(1 if (i // 60) % 2 == 0 else 0),
    )


def preset_state(day=None, cam_preset=None, sea=None, aa=True, yaw=None):
    from raytracing_cuda_tpu.sim import state as sim
    from raytracing_cuda_tpu.sim.actions import Action

    st = sim.init_state()
    if day is not None:
        st = st._replace(day_time=jnp.float32(day))
    if sea is not None:
        st = st._replace(sea_y=jnp.float32(sea))
    if cam_preset is not None:
        st = sim.apply_controls(
            st, Action.idle()._replace(cam_preset=np.int32(cam_preset)), 0.0)
    if yaw is not None:
        st = st._replace(cam=st.cam._replace(hor_angle=jnp.float32(yaw)))
    st = st._replace(aa=jnp.bool_(aa), play=jnp.bool_(False))
    return sim.settle(st)


def timed_loop(eng, n, action_fn=camera_path, dt=1 / 60, warmup=3):
    """Step + render n frames, waiting for each → (fps, per-frame ms)."""
    state0 = eng.state
    for i in range(warmup):
        jax.block_until_ready(eng.step_and_frame(action_fn(i), dt))
    eng.set_state(state0)
    ms = []
    t0 = time.perf_counter()
    for i in range(n):
        t = time.perf_counter()
        jax.block_until_ready(eng.step_and_frame(action_fn(i), dt))
        ms.append((time.perf_counter() - t) * 1e3)
    return n / (time.perf_counter() - t0), ms


def percentile(ms, q):
    return float(np.percentile(np.asarray(ms), q))


def time_frames(eng, state, n=10, warmup=3):
    """Pipelined per-frame seconds of one frozen state: n frames enqueued,
    one wait at the end."""
    eng.set_state(state)
    for _ in range(warmup):
        jax.block_until_ready(eng.frame())
    t0 = time.perf_counter()
    img = None
    for _ in range(n):
        img = eng.frame()
    jax.block_until_ready(img)
    return (time.perf_counter() - t0) / n


def ab_frames(eng, state_a, state_b, n=10, reps=5):
    """Interleaved A/B of eng.frame() under two states → (ms_a, ms_b)."""
    time_frames(eng, state_a, n=2, warmup=2)
    time_frames(eng, state_b, n=2, warmup=2)
    a, b = [], []
    for _ in range(reps):
        a.append(time_frames(eng, state_a, n=n, warmup=0))
        b.append(time_frames(eng, state_b, n=n, warmup=0))
    return statistics.median(a) * 1e3, statistics.median(b) * 1e3


def _ensure_goldens(w, h):
    """Goldens for (w, h) on disk (oracle renders, CPU backend). The 720p
    and 1080p sets are checked in; other sizes are generated once by
    tests/gen_full_golden.py in a child process on the CPU backend."""
    from raytracing_cuda_tpu.scene.textures import REFERENCE_BACKGROUNDS
    from raytracing_cuda_tpu.utils.goldens import (CASES, CASES_REF,
                                                   full_golden_dir)

    d = full_golden_dir(w, h)
    want = list(CASES)
    if os.path.exists(REFERENCE_BACKGROUNDS):
        want += list(CASES_REF)
    missing = [n for n in want
               if not os.path.exists(os.path.join(d, f"{n}.png"))]
    if missing:
        log(f"parity: generating {len(missing)} oracle goldens at {w}x{h} "
            f"on the CPU backend (one-time, minutes): {missing}")
        subprocess.run(
            [sys.executable, os.path.join(REPO, "tests", "gen_full_golden.py"),
             "--size", f"{w}x{h}"],
            check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"),
            timeout=float(os.environ.get("GOLDEN_GEN_TIMEOUT", 1800)))
    return d


def parity_check(w, h, sky_shape, chunk):
    """Render the golden states through the engine's compiled path and gate
    them against oracle goldens at the SAME size → (ok, {name: result}).

    Two golden families: the four procedural-sky states, plus (when the
    reference panoramas are in assets/backgrounds) two reference-sky states,
    one mid-crossfade (day = 9.0)."""
    from raytracing_cuda_tpu.app.loop import Engine
    from raytracing_cuda_tpu.scene.textures import REFERENCE_BACKGROUNDS
    from raytracing_cuda_tpu.utils.config import RenderConfig
    from raytracing_cuda_tpu.utils.images import load_png, parity

    # make_state is the SAME function the goldens were rendered with
    from raytracing_cuda_tpu.utils.goldens import CASES, CASES_REF, make_state

    golden_d = _ensure_goldens(w, h)
    suites = [("procedural", CASES)]
    if os.path.exists(REFERENCE_BACKGROUNDS):
        suites.append(("reference", CASES_REF))
    results = {}
    for sky_source, cases in suites:
        eng = Engine(RenderConfig(width=w, height=h, chunk=chunk,
                                  sky_source=sky_source,
                                  procedural_sky_shape=sky_shape))
        for name, kw in cases.items():
            eng.set_state(make_state(**kw))
            r = parity(np.asarray(eng.frame()),
                       load_png(os.path.join(golden_d, f"{name}.png")))
            results[name] = r
            log(f"parity {name}: rmse={r['rmse']:.6f} "
                f"off={r['off_fraction']:.6f} "
                f"{'OK' if r['ok'] else '*** FAIL ***'}")
        del eng
    return all(r["ok"] for r in results.values()), results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="small resolution smoke run")
    ap.add_argument("--frames", type=int, default=None, help="frames for the sustained loop")
    ap.add_argument("--size", default=None, help="WxH, e.g. 1280x720")
    ap.add_argument("--sky", default="auto", choices=["auto", "reference", "procedural"])
    ap.add_argument("--sky-downsample", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=32768)
    ap.add_argument("--skip-configs", action="store_true",
                    help="only run the headline sustained loop")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--no-sky-cache", action="store_true")
    args = ap.parse_args()

    from raytracing_cuda_tpu.app.loop import Engine
    from raytracing_cuda_tpu.sim import state as sim
    from raytracing_cuda_tpu.utils.config import RenderConfig

    if args.size:
        w, h = (int(v) for v in args.size.lower().split("x"))
    elif args.quick:
        w, h = 480, 272
    else:
        w, h = 1280, 720
    frames = args.frames or (30 if args.quick else 200)
    sky_shape = (256, 512) if args.quick else (2048, 4096)

    cfg = RenderConfig(width=w, height=h, chunk=args.chunk, sky_source=args.sky,
                       sky_downsample=args.sky_downsample,
                       procedural_sky_shape=sky_shape,
                       sky_cache=not args.no_sky_cache)
    device = device_info()
    log(f"device={device} size={w}x{h} frames={frames}")

    t0 = time.perf_counter()
    eng = Engine(cfg)
    jax.block_until_ready(eng.step_and_frame(camera_path(0)))
    compile_s = time.perf_counter() - t0
    details = {"path": eng.path, "compile_s": compile_s}

    if not args.skip_configs:
        # 1. Mountains, fixed camera, 640x480, no FXAA
        eng_small = Engine(RenderConfig(width=640, height=480, chunk=args.chunk,
                                        sky_source=args.sky,
                                        sky_downsample=args.sky_downsample,
                                        procedural_sky_shape=sky_shape))
        ms = time_frames(eng_small, preset_state(day=14.0, cam_preset=1, aa=False),
                         n=10, warmup=3) * 1e3
        details["mountains_640x480_noaa_ms"] = ms
        del eng_small

        # 2. Frozen island sea-level sweep (same compiled program; sea_y is
        # a traced scalar), interleaved reps with a per-level median
        levels = (-4.5, -2.0, 0.0, 2.0)
        states = [preset_state(cam_preset=0, sea=s) for s in levels]
        for st in states:
            time_frames(eng, st, n=2, warmup=2)
        sweep = [[] for _ in levels]
        for _ in range(3):
            for i, st in enumerate(states):
                sweep[i].append(time_frames(eng, st, n=10, warmup=0) * 1e3)
        details["island_sea_sweep_ms"] = [statistics.median(v) for v in sweep]

        # 3. FXAA on/off at full size — interleaved A/B of one program
        ms_on, ms_off = ab_frames(eng, preset_state(cam_preset=0, aa=True),
                                  preset_state(cam_preset=0, aa=False))
        details["fxaa_on_ms"] = ms_on
        details["fxaa_off_ms"] = ms_off

        # 4. Time-of-day sweep (morning/day/evening/night presets)
        details["time_of_day_ms"] = [
            time_frames(eng, preset_state(day=d, cam_preset=1), n=10) * 1e3
            for d in (6.0, 14.0, 18.0, 1.0)]

        # 4b. Crossfade: the playing clock crosses the 8-10 h morning→day
        # fade, so every frame blends two panoramas
        eng.set_state(sim.settle(sim.init_state()._replace(
            day_time=jnp.float32(8.05))))
        fps_fade, _ = timed_loop(eng, min(frames, 200))
        details["crossfade_fps"] = fps_fade

        # 4c. Worst pose: day 17.6, yaw 315 — the island pose where the most
        # geometry and sea reflections fill the frame and near-horizontal
        # shadow rays sweep the mountain ring
        details["worst_pose_ms"] = time_frames(
            eng, preset_state(day=17.6, yaw=315.0), n=10, warmup=3) * 1e3

    # 5. Sustained real-time loop: animated camera + automatic time (headline)
    eng.set_state(sim.settle(sim.init_state()))
    fps, ms = timed_loop(eng, frames)
    details["sustained_fps"] = fps

    # 6. compiled-path parity against oracle goldens at the invoked size
    parity_ok, results = True, {}
    if not args.skip_parity and not args.quick:
        parity_ok, results = parity_check(w, h, sky_shape, args.chunk)

    log(json.dumps(details, indent=2))
    out = {
        "metric": f"sustained_fps_{w}x{h}_animated",
        "value": fps,
        "unit": "fps",
        "p50_ms": percentile(ms, 50),
        "p99_ms": percentile(ms, 99),
        "compile_s": compile_s,
        "path": eng.path,
        "device": device,
    }
    for key in ("crossfade_fps", "worst_pose_ms"):
        if key in details:
            out[key] = details[key]
    if results:
        out["parity_rmse_max"] = max(r["rmse"] for r in results.values())
        out["parity_ok"] = parity_ok
    print(json.dumps(out))
    if not parity_ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
