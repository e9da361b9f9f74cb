"""Interactive window: pygame display + input → Action mapping.

Replacement for the reference's GLUT/Win32 shell (main.cpp:338-443,
scene.cpp:689-756): instead of a CUDA-GL interop PBO the frame is rendered by
the jitted pipeline and blitted from a host array; instead of per-frame Win32
GetAsyncKeyState polling, pygame's key state snapshot feeds the pure
sim.animate step. Controls follow the reference README:

  mouse        look (pointer captured; ESC quits)      scene.cpp:128-140
  W/A/S/D      move, Q/E up/down, SHIFT run            scene.cpp:142-163
  LEFT/RIGHT   scrub time of day (x4 speed)            scene.cpp:691-698
  O / P        pause / play the day cycle              scene.cpp:700-706
  UP/DOWN      raise / lower sea level                 scene.cpp:708-712
  1/2/3/4      time presets (morning/day/evening/night) scene.cpp:713-728
  5 / 6        camera presets (island / mountains)     scene.cpp:736-747
  B / V        FXAA on / off                           scene.cpp:750-755
  F            toggle fullscreen                       main.cpp:277-284
  F5 / F9      save / load state checkpoint (new capability — the reference
               rebuilds all state at startup, scene.cpp:654)
  ESC          quit                                    main.cpp:286-289

The window title shows FPS and the HH:MM clock like the reference's
`timerEvent` (main.cpp:230-237) and `getTime` (scene.cpp:731-733).
"""

from __future__ import annotations

import time

import numpy as np

from raytracing_cuda_tpu.app.loop import Engine
from raytracing_cuda_tpu.sim.actions import Action
from raytracing_cuda_tpu.utils.config import RenderConfig


def poll_action(pygame, grab: bool) -> Action:
    """Build this frame's Action from pygame's key/mouse state."""
    k = pygame.key.get_pressed()
    K = pygame.K_d, pygame.K_a, pygame.K_w, pygame.K_s, pygame.K_q, pygame.K_e
    d, a, w, s, q, e = (np.int32(1) if k[x] else np.int32(0) for x in K)
    mdx, mdy = pygame.mouse.get_rel() if grab else (0, 0)

    def preset(keys):
        for i, key in enumerate(keys):
            if k[key]:
                return np.int32(i)
        return np.int32(-1)

    return Action(
        move_side=d - a, move_forward=w - s, move_up=q - e,
        run=np.bool_(k[pygame.K_LSHIFT] or k[pygame.K_RSHIFT]),
        mouse_dx=np.float32(mdx), mouse_dy=np.float32(mdy),
        time_control=(np.int32(1) if k[pygame.K_RIGHT] else np.int32(0))
        - (np.int32(1) if k[pygame.K_LEFT] else np.int32(0)),
        set_play=np.bool_(k[pygame.K_p]), set_pause=np.bool_(k[pygame.K_o]),
        sea_control=(np.int32(1) if k[pygame.K_UP] else np.int32(0))
        - (np.int32(1) if k[pygame.K_DOWN] else np.int32(0)),
        time_preset=preset((pygame.K_1, pygame.K_2, pygame.K_3, pygame.K_4)),
        cam_preset=preset((pygame.K_5, pygame.K_6)),
        set_aa_on=np.bool_(k[pygame.K_b]), set_aa_off=np.bool_(k[pygame.K_v]),
    )


def run_window(config: RenderConfig | None = None, max_frames: int | None = None,
               resize_settle_s: float = 0.35, initial_state=None):
    """Open the interactive viewer. Blocks until ESC / window close.

    max_frames bounds the loop for smoke tests on headless CI (with the
    SDL_VIDEODRIVER=dummy driver). resize_settle_s debounces live window
    resizes: a drag emits a stream of VIDEORESIZE events, and rebuilding
    the jitted programs costs a compile per distinct size (tens of
    seconds) — the engine is rebuilt only once the size has
    been stable for this long.
    """
    import pygame

    config = config or RenderConfig()
    engine = Engine(config)
    if initial_state is not None:      # CLI --state/--day/--cam/--no-aa
        engine.set_state(initial_state)

    pygame.init()
    screen = pygame.display.set_mode((config.width, config.height),
                                     pygame.RESIZABLE)
    pygame.display.set_caption("raytracing_cuda_tpu")
    grab = pygame.display.get_driver() != "dummy"
    if grab:
        pygame.mouse.set_visible(False)        # main.cpp:430 hides the cursor
        pygame.event.set_grab(True)
        pygame.mouse.get_rel()                 # swallow the initial jump

    fullscreen = False
    pending = None          # device frame enqueued last iteration
    resize_target = None    # debounced live-resize request
    resize_t = 0.0
    last = time.perf_counter()
    fps_acc, fps_n, fps_t0 = 0.0, 0, last
    frames = 0
    running = True
    while running and (max_frames is None or frames < max_frames):
        for ev in pygame.event.get():
            if ev.type == pygame.QUIT:
                running = False
            elif ev.type == pygame.KEYDOWN:
                if ev.key == pygame.K_ESCAPE:
                    running = False
                elif ev.key == pygame.K_f:     # fullscreen toggle
                    fullscreen = not fullscreen
                    flags = pygame.FULLSCREEN if fullscreen else pygame.RESIZABLE
                    screen = pygame.display.set_mode(
                        (config.width, config.height), flags)
                    resize_target = None   # mode switches emit VIDEORESIZE;
                    #                        don't treat them as live resizes
                elif ev.key == pygame.K_F5:
                    from raytracing_cuda_tpu.utils.checkpoint import save_state

                    save_state(engine.state, "raytracer_state.json")
                elif ev.key == pygame.K_F9:
                    from raytracing_cuda_tpu.utils.checkpoint import load_state

                    try:
                        engine.set_state(load_state("raytracer_state.json"))
                    except (FileNotFoundError, ValueError) as e:
                        # a missing or corrupt checkpoint must not kill the
                        # interactive session; keep the current state
                        print(f"checkpoint load skipped: {e}")
                elif ev.key == pygame.K_F12:
                    # screenshot (beyond-reference): full-res render of the
                    # CURRENT state, regardless of --preview downsampling
                    import os

                    from raytracing_cuda_tpu.utils.images import save_png

                    # strftime is 1-second resolution: suffix a counter so
                    # two shots in the same second can't overwrite
                    stem = time.strftime("screenshot_%Y%m%d_%H%M%S")
                    shot, n = f"{stem}.png", 1
                    while os.path.exists(shot):
                        shot, n = f"{stem}_{n}.png", n + 1
                    save_png(engine.frame_np(), shot)
                    print(f"saved {shot}")
            elif ev.type == pygame.VIDEORESIZE and not fullscreen:
                # live resolution change (reshape, main.cpp:293-306):
                # record the target; the rebuild happens below once the
                # size stops changing (debounced — each distinct size costs
                # a recompile). Fullscreen mode switches also emit
                # VIDEORESIZE at the display size — ignored above. Snap to
                # preview-factor multiples so the downsample stays exact.
                p = engine.config.preview
                resize_target = (max(ev.w, 2 * p) // p * p,
                                 max(ev.h, 2 * p) // p * p)
                resize_t = time.perf_counter()

        if (resize_target is not None
                and time.perf_counter() - resize_t >= resize_settle_s):
            w, h = resize_target
            resize_target = None
            if (w, h) != (engine.config.width, engine.config.height):
                engine = engine.resized(w, h)
                config = engine.config
                pending = None
                screen = pygame.display.set_mode((w, h), pygame.RESIZABLE)

        now = time.perf_counter()
        dt, last = now - last, now             # updateDelta, main.cpp:255-258
        # clamp: a multi-minute jit compile (first frame, live resize) must
        # not become one giant sim step (clock leaps hours, camera teleports)
        dt = min(dt, 0.1)
        # double-buffered present: enqueue this frame's render, then read
        # back and blit the PREVIOUS frame while the device works — the
        # one-frame display lag overlaps readback with render
        p = engine.config.preview
        step = (engine.step_and_frame_preview if p > 1
                else engine.step_and_frame)
        dev_img = step(poll_action(pygame, grab), dt)
        try:
            # start the device→host copy without blocking: by the time the
            # NEXT iteration blits this frame, the transfer is underway or
            # done — hides the device→host round trip
            dev_img.copy_to_host_async()
        except AttributeError:
            pass
        if pending is not None:
            img = np.asarray(pending)
            surf = pygame.surfarray.make_surface(img.transpose(1, 0, 2))
            full = (surf.get_width() * p, surf.get_height() * p)
            if full == screen.get_size():
                if p > 1:   # preview: upscale the small readback in the blit
                    surf = pygame.transform.scale(surf, full)
                screen.blit(surf, (0, 0))
                pygame.display.flip()
        pending = dev_img
        frames += 1

        # FPS + clock in the title every 0.5 s (REFRESH_DELAY, main.cpp:32).
        # Throughput = frames / window, NOT the mean of instantaneous 1/dt
        # rates (which overstates fps whenever frame times vary)
        fps_n += 1
        if now - fps_t0 >= 0.5:
            pygame.display.set_caption(
                f"raytracing_cuda_tpu   {fps_n / (now - fps_t0):5.1f} fps   "
                f"{engine.time_string()}")
            fps_n, fps_t0 = 0, now

    pygame.quit()
    return frames


if __name__ == "__main__":
    run_window()
