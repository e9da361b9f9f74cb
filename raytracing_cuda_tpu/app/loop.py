"""Frame loop / engine facade (replaces main.cpp's GLUT shell).

The reference couples its loop to GLUT callbacks and Win32 polling
(main.cpp:220-268, scene.cpp:689-756). Here the Engine owns (scene, sky,
state) and exposes step(action, dt) + frame(); drivers — headless benchmark
runs, scripted camera paths, an interactive window — feed Actions in and
take framebuffers out.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_cuda_tpu.parallel.mesh import make_mesh, render_frame_sharded
from raytracing_cuda_tpu.render.pipeline import render_frame
from raytracing_cuda_tpu.scene.builders import (CLASSIC_CAMERA, SPH_CLUSTERS,
                                                 TRI_CLUSTERS, TRI_SUBS,
                                                 build_named_scene)
from raytracing_cuda_tpu.scene.textures import load_skies
from raytracing_cuda_tpu.sim import state as sim
from raytracing_cuda_tpu.sim.actions import Action
from raytracing_cuda_tpu.utils.config import RenderConfig
from raytracing_cuda_tpu.utils.timing import FrameStats, FrameTimer


def _box_downsample(img, n: int):
    """(H, W, 3) uint8 → (H/n, W/n, 3) uint8 box mean (preview readback).

    DEVICE twin of utils.images.box_downsample (the host-side SSAA
    resolve) — jnp because it is traced inside the preview jit; pinned
    equal by test_host_and_device_downsample_agree."""
    if n == 1:
        return img
    H, W = img.shape[0], img.shape[1]
    f = img.astype(jnp.float32).reshape(H // n, n, W // n, n, 3)
    return (f.mean(axis=(1, 3)) + 0.5).astype(jnp.uint8)


class Engine:
    """Scene + sky + frame state with a jitted render step."""

    def __init__(self, config: RenderConfig | None = None, sharded: bool = False,
                 share_assets_from: "Engine | None" = None):
        from raytracing_cuda_tpu.utils.config import enable_compilation_cache

        enable_compilation_cache()
        self.config = config or RenderConfig()
        if share_assets_from is not None:
            # live-resize path (the reference's reshape, main.cpp:293-306):
            # reuse the loaded scene/sky and carry the sim state over; only
            # the jitted programs are rebuilt (recompile per new size)
            self.scene = share_assets_from.scene
            self.sky = share_assets_from.sky
            self.sky_texels = share_assets_from.sky_texels
            self.state = share_assets_from.state
        else:
            self.scene = jax.device_put(build_named_scene(self.config.scene))
            self.sky = load_skies(self.config.sky_source,
                                  downsample=self.config.sky_downsample,
                                  procedural_shape=self.config.procedural_sky_shape)
            self.sky_texels = jax.device_put(self.sky.texels)
            self.state = sim.settle(sim.init_state()._replace(
                aa=jnp.bool_(self.config.antialiasing)))
            if self.config.scene == "classic":
                from raytracing_cuda_tpu.core.types import Camera

                cc = CLASSIC_CAMERA
                self.state = self.state._replace(cam=Camera(
                    pos=jnp.asarray(cc["pos"], jnp.float32),
                    hor_angle=jnp.float32(cc["hor_angle"]),
                    ver_angle=jnp.float32(cc["ver_angle"]),
                    fov=jnp.float32(cc["fov"])))
        self.mesh = make_mesh() if sharded else None
        if self.mesh is not None and self.mesh.size > 1:
            if self.config.height % (self.mesh.size
                                     * self.config.shard_interleave):
                # fail fast: render_frame_sharded would raise the same
                # error, but only on the first frame — after a minutes-long
                # compile
                raise ValueError(
                    f"height {self.config.height} not divisible by mesh "
                    f"size {self.mesh.size} x shard_interleave "
                    f"{self.config.shard_interleave}")
        elif sharded and self.config.shard_interleave > 1:
            # one device: the render path below degrades to single-chip
            # (mesh=None), where striding does not exist — say so instead
            # of silently ignoring the requested interleave (or, worse,
            # rejecting a height over a mesh that will never be used)
            import warnings

            warnings.warn(
                f"sharded=True on a single-device backend: "
                f"shard_interleave={self.config.shard_interleave} has no "
                f"effect (rendering single-chip)", stacklevel=2)
        self.path = self.config.resolved_path()
        self.tri_clusters = TRI_CLUSTERS.get(self.config.scene)
        self.sph_clusters = SPH_CLUSTERS.get(self.config.scene)
        self.tri_subs = TRI_SUBS.get(self.config.scene)
        self._animate = jax.jit(sim.animate)

        def _ff_scan(st, avs):
            def body(st, av):
                return sim.animate(st, Action.unpack(av),
                                   Action.unpack_dt(av)), None

            return jax.lax.scan(body, st, avs)[0]

        self._fast_forward = jax.jit(_ff_scan)
        c = self.config
        path = self.path
        mesh = self.mesh if (self.mesh is not None and self.mesh.size > 1) else None
        is_pallas = path.startswith("pallas")
        clusters = self.tri_clusters if is_pallas else None
        s_clusters = self.sph_clusters if is_pallas else None
        t_subs = self.tri_subs if is_pallas else None

        # --- unified render fn: (scene, state, sky) → img; covers
        # single-device / sharded. Kernel paths look the sky up in a STATIC
        # all-panorama stack built once here (sky_static_init): the ≤2
        # active panoramas blend at lookup time, so no per-frame blend+pack
        # exists and frame cost is flat across the 24 h clock. The sharded
        # kernel path always uses the static stack; single-device keeps
        # sky_cache=False as the one-shot debug knob.
        use_static = is_pallas and (c.sky_cache or mesh is not None)
        sh, sw = self.sky_texels.shape[1], self.sky_texels.shape[2]
        if use_static:
            shared = getattr(share_assets_from, "_sky_pack", None)
            if shared is not None and shared.size:
                self._sky_pack = shared     # resize path: same sky
            else:
                from raytracing_cuda_tpu.scene.textures import sky_static_init

                self._sky_pack = jax.jit(sky_static_init)(self.sky_texels)
        else:
            # placeholder so the jitted signatures stay uniform (the static
            # pack rides as a runtime ARGUMENT, never a captured constant,
            # which would be baked into every compiled program)
            self._sky_pack = jnp.zeros((0,), jnp.int32)
        interpret = path == "pallas_interpret"

        if mesh is not None:
            def _render(scene, state, sky_texels, sky_pack):
                return render_frame_sharded(
                    scene, state, sky_texels, mesh=mesh, height=c.height,
                    width=c.width, chunk=c.chunk, aspect=c.aspect, path=path,
                    tri_clusters=clusters, sph_clusters=s_clusters,
                    sky_pack=sky_pack if use_static else None,
                    interleave=c.shard_interleave, t_subs=t_subs)
        elif use_static:
            from raytracing_cuda_tpu.render.pipeline import (
                render_frame_static_sky)

            def _render(scene, state, sky_texels, sky_pack):
                return render_frame_static_sky(
                    scene, state, sky_pack, sh, sw, c.height, c.width,
                    aspect=c.aspect, tri_clusters=clusters,
                    sph_clusters=s_clusters, interpret=interpret,
                    t_subs=t_subs)
        else:
            def _render(scene, state, sky_texels, sky_pack):
                return render_frame(scene, state, sky_texels, c.height,
                                    c.width, chunk=c.chunk, aspect=c.aspect,
                                    path=path, tri_clusters=clusters,
                                    sph_clusters=s_clusters, t_subs=t_subs)

        self._render_only = jax.jit(_render)

        def _step_render(scene, state, sky_texels, sky_pack, action_vec):
            state = sim.animate(state, Action.unpack(action_vec),
                                Action.unpack_dt(action_vec))
            return state, _render(scene, state, sky_texels, sky_pack)

        # one device dispatch per frame: state step + render fused
        self._step_render = jax.jit(_step_render)

        def _step_render_batch(scene, state, sky_texels, sky_pack,
                               action_vecs):
            """lax.scan over a whole batch of frames in ONE dispatch,
            amortizing per-dispatch host costs."""
            def body(state, av):
                return _step_render(scene, state, sky_texels, sky_pack, av)

            state, imgs = jax.lax.scan(body, state, action_vecs)
            return state, imgs

        self._step_render_batch = jax.jit(_step_render_batch)

        def _step_render_preview(scene, state, sky_texels, sky_pack,
                                 action_vec):
            """Fused step + render + on-device box-downsample: the small
            buffer is all that crosses device→host, cutting the windowed
            loop's readback by preview² (the reference presents through
            zero-copy GL interop instead, main.cpp:141-165)."""
            state, img = _step_render(scene, state, sky_texels, sky_pack,
                                      action_vec)
            return state, _box_downsample(img, c.preview)

        self._step_render_preview = jax.jit(_step_render_preview)

    # --- state ---

    def step(self, action: Action | None = None, dt: float = 1 / 60):
        """Advance the host state machine one frame (idle/animate)."""
        self.state = self._animate(self.state, action or Action.idle(),
                                   jnp.float32(dt))
        return self.state

    FF_CHUNK = 256

    def fast_forward(self, action_vecs, dt: float = 1 / 30):
        """Advance the state machine past a batch of actions WITHOUT
        rendering — scanned dispatches, so replaying thousands of
        scripted frames (record --resume) costs milliseconds, not a
        render each. Dispatched in fixed FF_CHUNK-sized scans plus
        single-step remainders (Engine.run's remainder discipline): a
        data-dependent scan length would compile a fresh program per
        distinct prefix length, while the two fixed shapes here stay warm
        in the compile cache. The vectors stay NUMPY on the host so the
        remainder's unpack is host-side slicing — each remainder frame is
        exactly one jitted _animate dispatch (unpacking a device row
        eagerly would issue ~27 tiny device ops per frame).
        action_vecs: (K, 16) packed vectors or a list of Actions (packed
        with dt)."""
        if isinstance(action_vecs, (list, tuple)):
            action_vecs = np.stack([a.pack(dt) for a in action_vecs])
        action_vecs = np.asarray(action_vecs)
        k, i = self.FF_CHUNK, 0
        while action_vecs.shape[0] - i >= k:
            self.state = self._fast_forward(self.state,
                                            action_vecs[i:i + k])
            i += k
        for j in range(i, action_vecs.shape[0]):
            av = action_vecs[j]
            self.state = self._animate(self.state, Action.unpack(av),
                                       Action.unpack_dt(av))
        return self.state

    def step_and_frame(self, action: Action | None = None, dt: float = 1 / 60):
        """Fused step+render: a single jitted dispatch per frame."""
        self.state, img = self._step_render(
            self.scene, self.state, self.sky_texels, self._sky_pack,
            (action or Action.idle()).pack(dt))
        return img

    def step_and_frame_preview(self, action: Action | None = None,
                               dt: float = 1 / 60):
        """Fused step+render+downsample → (H/p, W/p, 3) uint8 device array
        (p = config.preview). Full-res rendering, small readback."""
        self.state, img = self._step_render_preview(
            self.scene, self.state, self.sky_texels, self._sky_pack,
            (action or Action.idle()).pack(dt))
        return img

    def step_and_frame_batch(self, actions, dts=None):
        """Render a batch of frames in one dispatch → (B, H, W, 3) uint8.

        actions: list[Action] (or a pre-packed (B, 16) f32 array)."""
        if isinstance(actions, (list, tuple)):
            if dts is None:
                dts = [1 / 60] * len(actions)
            if len(dts) != len(actions):
                raise ValueError(f"{len(actions)} actions but {len(dts)} dts")
            vecs = np.stack([a.pack(dt) for a, dt in zip(actions, dts)])
        else:
            vecs = actions
        self.state, imgs = self._step_render_batch(
            self.scene, self.state, self.sky_texels, self._sky_pack, vecs)
        return imgs

    def render_script_dp(self, action_vecs, n_devices: int | None = None,
                         dt: float = 1 / 60, n_rows: int = 1):
        """Offline frame-data-parallel batch → (K, H, W, 3) uint8.

        Shards the K frames of a scripted animation across the devices
        (parallel/frames.py) — the throughput complement of the
        row-sharded latency path; matches K step_and_frame calls
        (bit-identical on CPU, within the parity gate on a GPU) and
        advances self.state past all K frames. Requires the kernel
        static-sky single-device configuration (the per-frame program frame
        DP fans out) and K divisible by the frame-axis device count.

        n_rows > 1 selects the 2-D (frames, rows) hybrid mesh: n_devices
        frame groups x n_rows row-sharded devices each (n_devices then
        counts frame GROUPS, not total devices), with the config's
        shard_interleave striding the bands. dt applies only when
        action_vecs is a list of Actions (pre-packed (K, 16) vectors
        carry their own dt, like step_and_frame_batch).
        """
        from raytracing_cuda_tpu.parallel import frames as F

        if self.mesh is not None:
            raise ValueError("frame DP and row sharding are alternative "
                             "layouts; build the Engine with sharded=False "
                             "(n_rows>1 composes them on a 2-D mesh)")
        if not (self.path.startswith("pallas") and self._sky_pack.size):
            raise ValueError("render_script_dp needs the kernel static-sky "
                             "path (config path='pallas' or "
                             "'pallas_interpret', sky_cache=True)")
        if isinstance(action_vecs, (list, tuple)):
            action_vecs = np.stack([a.pack(dt) for a in action_vecs])
        sh, sw = self.sky_texels.shape[1], self.sky_texels.shape[2]
        common = dict(
            sky_h=sh, sky_w=sw, height=self.config.height,
            width=self.config.width, aspect=self.config.aspect,
            tri_clusters=self.tri_clusters, sph_clusters=self.sph_clusters,
            interpret=self.path == "pallas_interpret", t_subs=self.tri_subs)
        if n_rows > 1:
            if n_devices is None:
                n_devices = max(len(jax.devices()) // n_rows, 1)
            imgs, self.state = F.render_script_hybrid(
                self.scene, self.state, self._sky_pack,
                jnp.asarray(action_vecs),
                mesh=F.make_hybrid_mesh(n_devices, n_rows),
                interleave=self.config.shard_interleave, **common)
        else:
            imgs, self.state = F.render_script_dp(
                self.scene, self.state, self._sky_pack,
                jnp.asarray(action_vecs),
                mesh=F.make_frames_mesh(n_devices), **common)
        return imgs

    def resized(self, width: int, height: int) -> "Engine":
        """New Engine at a different framebuffer size, sharing loaded assets
        and carrying the sim state over — the reference's reshape
        (main.cpp:293-306) minus its resource leak. The jitted programs
        recompile for the new shapes (cached per size thereafter)."""
        import dataclasses

        cfg = dataclasses.replace(self.config, width=width, height=height)
        return Engine(cfg, sharded=self.mesh is not None,
                      share_assets_from=self)

    def set_state(self, state: sim.FrameState):
        self.state = state

    def time_string(self) -> str:
        return sim.format_time(float(self.state.day_time))

    # --- rendering ---

    def frame(self):
        """Render the current state → (H, W, 3) uint8 device array."""
        return self._render_only(self.scene, self.state, self.sky_texels,
                                 self._sky_pack)

    def frame_np(self) -> np.ndarray:
        return np.asarray(self.frame())

    # --- drivers ---

    def run(self, n_frames: int, action_fn: Callable[[int], Action] | None = None,
            dt: float = 1 / 60, warmup: int = 2,
            on_frame: Callable[[int, object], None] | None = None,
            batch: int = 1) -> FrameStats:
        """Headless loop: step + render n_frames, return FPS/Mrays stats.

        action_fn(i) supplies scripted input per frame (default: idle —
        automatic time advance only, like the reference left running).
        batch > 1 scans that many frames per device dispatch (use when no
        per-frame host consumption is needed, e.g. sustained benchmarks).
        """
        c = self.config
        state0 = self.state
        for _ in range(warmup):
            if batch > 1:
                jax.block_until_ready(self.step_and_frame_batch(
                    np.stack([Action.idle().pack(dt)] * batch)))
            if batch == 1 or n_frames % batch:
                # the single-frame program only runs for batch=1 loops or a
                # remainder; don't force its compile otherwise
                jax.block_until_ready(self.step_and_frame(None, dt))
        self.state = state0

        timer = FrameTimer(c.width, c.height).start()
        img = None
        if batch > 1:
            assert on_frame is None, "batch mode yields frames per batch"
            done = 0
            # full batches through the scan program; the remainder runs as
            # single-frame steps — a differently-shaped final batch would
            # recompile inside the timed region
            while done + batch <= n_frames:
                vecs = np.stack([
                    (action_fn(done + j) if action_fn else Action.idle()).pack(dt)
                    for j in range(batch)])
                img = self.step_and_frame_batch(vecs)
                timer.frames += batch
                done += batch
            while done < n_frames:
                img = self.step_and_frame(
                    action_fn(done) if action_fn else None, dt)
                timer.frames += 1
                done += 1
            jax.block_until_ready(img)
            return timer.stop()
        for i in range(n_frames):
            img = self.step_and_frame(action_fn(i) if action_fn else None, dt)
            if on_frame is not None:
                on_frame(i, img)
            timer.tick()
        timer.tick(img)  # block once at the end; frames pipeline in between
        timer.frames -= 1
        return timer.stop()
