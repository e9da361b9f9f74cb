"""Command-line entry points.

  python -m raytracing_cuda_tpu window              interactive viewer
  python -m raytracing_cuda_tpu render out.png      one frame to PNG
  python -m raytracing_cuda_tpu record out_dir/     scripted animation frames
  python -m raytracing_cuda_tpu bench               sustained-FPS loop

The reference exposes only `raytracing.exe [-device=N]` (main.cpp:338-384);
these subcommands cover the same interactive use plus the headless drivers a
display-less GPU host needs.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _parse_wh(value: str, flag: str) -> "tuple[int, int]":
    try:
        w, h = (int(v) for v in value.lower().split("x"))
    except ValueError:
        raise SystemExit(f"{flag} must be WxH (e.g. 1280x720), "
                         f"got {value!r}")
    return w, h


def _config(args) -> "RenderConfig":
    from raytracing_cuda_tpu.utils.config import RenderConfig

    w, h = _parse_wh(args.size, "--size")
    # SSAA (render/record only): the engine renders at N x the requested
    # size; frames are box-resolved back down at write time
    ssaa = getattr(args, "ssaa", 1)
    if args.command in ("render", "record") and ssaa > 1:
        w, h = w * ssaa, h * ssaa
    # preview is a window-only knob (the help text scopes it); forwarding
    # it for render/record/bench would make RenderConfig's divisibility
    # validation reject runs that never read it
    preview = getattr(args, "preview", 1) if args.command == "window" else 1
    ssw, ssh = _parse_wh(getattr(args, "sky_shape", "2048x1024"),
                         "--sky-shape")
    return RenderConfig(width=w, height=h, sky_source=args.sky, path=args.path,
                        scene=args.scene, procedural_sky_shape=(ssh, ssw),
                        preview=preview)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="raytracing_cuda_tpu")
    ap.add_argument("command", choices=["window", "render", "record", "bench"])
    ap.add_argument("target", nargs="?", default=None,
                    help="output png (render) / output dir (record)")
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--sky", default="auto",
                    choices=["auto", "reference", "procedural"])
    ap.add_argument("--sky-shape", default="2048x1024",
                    help="procedural panorama size WxH, same axis order as "
                         "--size (sky=procedural; smaller is faster to "
                         "build and resolve)")
    ap.add_argument("--path", default="auto",
                    choices=["auto", "pallas", "pallas_interpret", "fast",
                             "oracle"],
                    help="render path (auto: the GPU kernel 'pallas' on a "
                         "GPU, 'fast' on the CPU); pallas_interpret runs the "
                         "kernel in interpret mode on the CPU (slow — "
                         "debugging and GPU-free exercise of the kernel-only "
                         "features, e.g. record --dp)")
    ap.add_argument("--scene", default="island", choices=["island", "classic"])
    ap.add_argument("--state", default=None,
                    help="load a FrameState checkpoint (utils.checkpoint JSON)")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--day", type=float, default=None, help="clock hour 0-24")
    ap.add_argument("--cam", type=int, default=None, help="camera preset 0/1")
    ap.add_argument("--no-aa", action="store_true")
    ap.add_argument("--gif", default=None,
                    help="record: also assemble frames into an animated GIF")
    ap.add_argument("--dp", type=int, default=1,
                    help="record: shard frame batches across N devices "
                         "(frame data parallelism, parallel/frames.py; "
                         "matches sequential output within the parity "
                         "gate; needs the kernel static-sky path)")
    ap.add_argument("--resume", action="store_true",
                    help="record: skip frames already on disk (contiguous "
                         "prefix) and fast-forward the state machine past "
                         "them in a few scanned dispatches — restartable "
                         "long renders")
    ap.add_argument("--dp-rows", type=int, default=1,
                    help="record: with --dp N, also row-shard each frame "
                         "across R devices (2-D N x R hybrid mesh, N frame "
                         "groups of R row-sharded devices)")
    ap.add_argument("--png-level", type=int, default=0,
                    help="record PNG compression 0-9 (0 = stored-deflate, "
                         "memcpy-speed, default; >0 = Sub-filtered zlib, "
                         "~4-6x smaller frames, encoded on background "
                         "writer threads)")
    ap.add_argument("--ssaa", type=int, default=1,
                    help="supersample factor for render/record (beyond-"
                         "reference): renders at N x --size and box-"
                         "resolves down — offline quality knob, composes "
                         "with FXAA (which runs at the super resolution)")
    ap.add_argument("--preview", type=int, default=1,
                    help="window: render full-res but read back a 1/N-size "
                         "on-device downsample and upscale in the blit "
                         "(readback-bound displays; render/record keep full "
                         "resolution)")
    ap.add_argument("--device", type=int, default=None,
                    help="device index (the reference's -device=N flag, "
                         "main.cpp:391)")
    args = ap.parse_args(argv)

    # validate BEFORE building any engine: _config consumes --ssaa (it
    # scales the render size), so a bad value must fail here, not after a
    # minutes-long Engine construction; and window/bench never resolve
    # SSAA frames, so accepting the flag there would silently change what
    # the user sees
    if args.ssaa < 1:
        raise SystemExit(f"--ssaa must be >= 1, got {args.ssaa}")
    if args.ssaa > 1 and args.command in ("window", "bench"):
        raise SystemExit(f"--ssaa applies to render/record only; "
                         f"{args.command} always runs at --size")

    if args.device is not None:
        import jax

        jax.config.update("jax_default_device", jax.devices()[args.device])

    def build_state(default_state):
        """Apply --state/--day/--cam/--no-aa. A loaded checkpoint is used
        VERBATIM (settle would overwrite its recolor_vars, breaking the
        exact round-trip contract); settle only runs when --day/--cam
        changed the clock or pose, or no checkpoint was given."""
        from raytracing_cuda_tpu.sim import state as sim
        from raytracing_cuda_tpu.sim.actions import Action

        st = default_state
        if args.state:
            from raytracing_cuda_tpu.utils.checkpoint import load_state

            st = load_state(args.state)
        needs_settle = not args.state
        if args.day is not None:
            import jax.numpy as jnp

            st = st._replace(day_time=jnp.float32(args.day))
            needs_settle = True
        if args.cam is not None:
            st = sim.apply_controls(
                st, Action.idle()._replace(cam_preset=np.int32(args.cam)), 0.0)
            needs_settle = True
        if args.no_aa:
            import jax.numpy as jnp

            st = st._replace(aa=jnp.bool_(False))
        return sim.settle(st) if needs_settle else st

    if args.command == "window":
        from raytracing_cuda_tpu.app.window import run_window
        from raytracing_cuda_tpu.sim import state as sim

        run_window(_config(args),
                   initial_state=build_state(sim.settle(sim.init_state())))
        return 0

    from raytracing_cuda_tpu.app.loop import Engine
    from raytracing_cuda_tpu.sim import state as sim
    from raytracing_cuda_tpu.sim.actions import Action

    eng = Engine(_config(args))
    eng.set_state(build_state(eng.state))

    if args.command == "render":
        from raytracing_cuda_tpu.utils.images import box_downsample, save_png

        out = args.target or "frame.png"
        save_png(box_downsample(eng.frame_np(), args.ssaa), out)
        print(f"wrote {out}")
        return 0

    if args.command == "record":
        from raytracing_cuda_tpu.utils import frameio

        out_dir = args.target or "frames"
        os.makedirs(out_dir, exist_ok=True)
        if not frameio.available():
            frameio.build()   # compiles native/frameio once; numpy fallback below

        def scripted(i):
            return Action.idle()._replace(
                mouse_dx=np.float32(3.0 * np.sin(i * 0.05)),
                time_control=np.int32(1))

        start = 0
        if args.resume:
            while (start < args.frames and os.path.exists(
                    os.path.join(out_dir, f"{start:04d}.png"))):
                start += 1
            # the LAST prefix frame may be truncated by the very crash
            # --resume recovers from (frameio writes are not atomic) —
            # always re-render it rather than trust it
            start = max(start - 1, 0)
            if start:
                # replay the skipped script through the state machine only
                # (fixed-chunk scanned dispatches, no rendering) so frame
                # `start` sees exactly the state a fresh run would give it
                eng.fast_forward([scripted(i) for i in range(start)], 1 / 30)
                print(f"resume: {start} frames already in {out_dir}, "
                      f"state fast-forwarded", file=sys.stderr)

        def emit_all(write):
            i = start
            if args.dp > 1 or args.dp_rows > 1:
                # --dp-rows alone still goes through the batched path (a
                # 1 x R hybrid mesh row-shards each frame) — it must not
                # silently degrade to single-chip sequential rendering
                # frame-DP batches: a few frames per device per dispatch
                # amortizes host costs. The batch size is fixed ONCE so
                # every DP dispatch shares one compiled shape (a smaller
                # dp-divisible tail would trace a second program to save a
                # handful of cheap single-frame steps); the sub-batch
                # remainder falls
                # through to the sequential loop below
                k = min(args.dp * 4,
                        (args.frames - start) // args.dp * args.dp)
                while k and args.frames - i >= k:
                    vecs = np.stack([scripted(i + j).pack(1 / 30)
                                     for j in range(k)])
                    imgs = np.asarray(eng.render_script_dp(
                        vecs, args.dp, n_rows=args.dp_rows))
                    for j in range(k):
                        write(imgs[j],
                              os.path.join(out_dir, f"{i + j:04d}.png"))
                    i += k
            for i in range(i, args.frames):
                img = eng.step_and_frame(scripted(i), 1 / 30)
                write(np.asarray(img), os.path.join(out_dir, f"{i:04d}.png"))

        if args.ssaa > 1:                        # SSAA resolve at write time
            from raytracing_cuda_tpu.utils.images import box_downsample

            def _resolved(write):
                return lambda img, path: write(
                    box_downsample(img, args.ssaa), path)
        else:
            def _resolved(write):
                return write

        level = frameio.set_png_level(args.png_level)
        if level != args.png_level:
            if level == 0 and args.png_level > 0:
                # capability clamp: the loaded frameio build has no zlib
                print("note: PNG compression unavailable (zlib-less "
                      "frameio build) — writing uncompressed (level 0)",
                      file=sys.stderr)
            else:
                # range clamp: request outside 0-9
                print(f"note: PNG level clamped to {level} (valid range "
                      "0-9)", file=sys.stderr)
        if frameio.available():
            # compressed encodes are ~ms-scale per frame: spread them over
            # a few workers so the writer keeps up with the render loop
            threads = 4 if level > 0 else 1
            with frameio.AsyncFrameWriter(ring=4, threads=threads) as w:
                emit_all(_resolved(w.submit))
                w.drain()
                written = w.written
            if written != args.frames - start:
                print(f"ERROR: only {written}/{args.frames - start} frames "
                      f"written (disk full or {out_dir} unwritable?)",
                      file=sys.stderr)
                return 1
        else:
            emit_all(_resolved(frameio.write_png))
        print(f"wrote {args.frames} frames to {out_dir}")
        if args.gif and args.frames > 0:
            from PIL import Image

            def load(i):
                return Image.open(
                    os.path.join(out_dir, f"{i:04d}.png")).convert("P")

            # generator keeps one frame resident at a time (a 720p run of
            # thousands of frames would otherwise hold gigabytes of PIL
            # images while encoding)
            rest = (load(i) for i in range(1, args.frames))
            load(0).save(args.gif, save_all=True, append_images=rest,
                         duration=33, loop=0)
            print(f"wrote {args.gif}")
        return 0

    if args.command == "bench":
        stats = eng.run(args.frames)
        print(stats.as_dict())
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
