"""Frame-data-parallel offline rendering over a jax.sharding.Mesh.

The row-sharded path (parallel/mesh.py) cuts LATENCY: one frame's rows
spread over the mesh so an interactive viewer sees it sooner. Offline
scripted rendering (record / GIF assembly / soaks, SURVEY.md §2 #3's
headless analogue) wants THROUGHPUT instead — and frames of a scripted
animation are embarrassingly parallel once their states are known. This
path shards the FRAME axis: the host state machine (the scene.cpp:806-816
analogue — a few hundred scalar ops per frame) pre-scans all K states
sequentially (replicated, trivially cheap), then each device renders its
contiguous block of frames with the SAME single-frame program the
engine's hot path runs (render_frame_static_sky), so output matches
stepping the single-chip engine frame by frame — pinned bit-identical on
CPU meshes by tests/test_parallel.py. (On a GPU the scan/map wrapping
gives XLA a different fusion context than the fused per-frame program, so
quantize-boundary pixels may move by a level, inside the parity gate.)
There are no collectives in the render loop at all; the only cross-device
traffic is the output gather at readback.

The per-frame render has no cross-frame dependency and the ~5 KB scene and
static sky stack are replicated, so throughput should scale with devices —
the right trade for offline batches, where the row-sharded path's
per-frame halo exchange and skewed-band work balance buy nothing. Like
everywhere else, the static sky pack rides as a runtime ARGUMENT (a
closed-over pack would be baked into the executable as a constant).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from raytracing_cuda_tpu.core.types import Scene
from raytracing_cuda_tpu.sim.state import FrameState

AXIS = "frames"


def make_frames_mesh(n_devices: int | None = None) -> Mesh:
    """1-D device mesh over the scripted-animation frame axis.

    Fails fast when fewer devices exist than requested — a silent clamp
    would desynchronize callers that size their frame batches by the
    REQUESTED count (the CLI's --dp loop) from the mesh that actually
    renders them, surfacing later as a confusing divisibility error.
    """
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"frame DP over {n_devices} devices requested "
                             f"but only {len(devices)} available")
        devices = devices[:n_devices]
    return Mesh(devices, (AXIS,))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "sky_h", "sky_w", "height", "width", "aspect",
                     "fxaa_static", "tri_clusters", "sph_clusters",
                     "interpret", "t_subs"),
)
def render_script_dp(scene: Scene, state: FrameState, sky_pack,
                     action_vecs, *, mesh: Mesh, sky_h: int, sky_w: int,
                     height: int, width: int, aspect: float | None = None,
                     fxaa_static: bool | None = None,
                     tri_clusters: tuple | None = None,
                     sph_clusters: tuple | None = None,
                     interpret: bool = False,
                     t_subs: tuple | None = None):
    """Render a scripted animation with frames sharded over the mesh.

    action_vecs: (K, 16) packed Action(+dt) wire vectors (Action.pack),
    exactly like Engine.step_and_frame_batch. K must divide evenly over
    the mesh (render any remainder with single-frame steps, as Engine.run
    does for its batches). sky_pack is the static all-panorama stack from
    textures.sky_static_init, replicated on every device.

    Returns (imgs (K, H, W, 3) uint8 sharded on the frame axis,
    last_state). Frame k's image matches the k-th Engine.step_and_frame
    from the same initial state (bit-identical on CPU meshes; within the
    parity gate on a GPU — see the module docstring).
    """
    from raytracing_cuda_tpu.render.pipeline import render_frame_static_sky
    from raytracing_cuda_tpu.sim.actions import Action
    from raytracing_cuda_tpu.sim.state import animate as sim_animate

    n = mesh.shape[AXIS]
    K = action_vecs.shape[0]
    if K % n:
        raise ValueError(f"{K} frames not divisible over {n} devices; "
                         f"render the remainder with single-frame steps")

    # 1. the sequential (and cheap) part: the host state machine
    def pre(carry, av):
        st = sim_animate(carry, Action.unpack(av), Action.unpack_dt(av))
        return st, st

    last_state, states = jax.lax.scan(pre, state, action_vecs)

    # 2. the heavy, embarrassingly-parallel part: device d renders frames
    # [d*K/n, (d+1)*K/n) with the engine's single-frame program
    def shard_fn(scene, states, sky_pack):
        def one(st):
            return render_frame_static_sky(
                scene, st, sky_pack, sky_h, sky_w, height, width,
                aspect=aspect, fxaa_static=fxaa_static,
                tri_clusters=tri_clusters, sph_clusters=sph_clusters,
                interpret=interpret, t_subs=t_subs)

        return jax.lax.map(one, states)

    imgs = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(AXIS), P()),
        out_specs=P(AXIS),
        # the lax.map carry starts replicated and becomes device-varying
        # (same situation as the row-sharded path's scan carries)
        check_vma=False,
    )(scene, states, sky_pack)
    return imgs, last_state


def make_hybrid_mesh(n_frames: int, n_rows: int) -> Mesh:
    """2-D (frames, rows) device mesh: n_frames frame-DP groups of n_rows
    row-sharded devices each. Only the rows axis communicates (the FXAA
    halo ppermutes); the frames axis needs no communication at all."""
    import numpy as np

    devices = jax.devices()
    need = n_frames * n_rows
    if n_frames < 1 or n_rows < 1:
        raise ValueError(f"hybrid mesh axes must be >= 1, got "
                         f"{n_frames}x{n_rows}")
    if len(devices) < need:
        raise ValueError(f"hybrid mesh {n_frames}x{n_rows} needs {need} "
                         f"devices, have {len(devices)}")
    from raytracing_cuda_tpu.parallel.mesh import AXIS as ROWS
    grid = np.asarray(devices[:need]).reshape(n_frames, n_rows)
    return Mesh(grid, (AXIS, ROWS))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "sky_h", "sky_w", "height", "width", "aspect",
                     "fxaa_static", "tri_clusters", "sph_clusters",
                     "interpret", "t_subs", "interleave"),
)
def render_script_hybrid(scene: Scene, state: FrameState, sky_pack,
                         action_vecs, *, mesh: Mesh, sky_h: int, sky_w: int,
                         height: int, width: int,
                         aspect: float | None = None,
                         fxaa_static: bool | None = None,
                         tri_clusters: tuple | None = None,
                         sph_clusters: tuple | None = None,
                         interpret: bool = False,
                         t_subs: tuple | None = None,
                         interleave: int = 1):
    """Scripted animation over a 2-D (frames, rows) mesh — frame data
    parallelism composed with row sharding in ONE program.

    This is the layout an offline render farm wants: frame groups scale
    throughput with zero communication, and the rows axis
    inside each group shards the per-frame work so a frame's latency (and
    its per-device memory) stays bounded as frames grow heavier. The row
    axis reuses the exact band renderer of the 1-D row mesh
    (parallel/mesh.band_shard_fn) — its FXAA halo ppermutes name only the
    rows axis, so mapping it over each device's local frames composes
    freely with the frames axis. Output frame k matches the k-th
    single-device Engine.step_and_frame (bit-identical on CPU meshes,
    pinned by tests/test_parallel.py; within the parity gate on a GPU).

    K must divide over the frames axis and height over rows*interleave;
    sky_pack is the static stack from sky_static_init, replicated.
    """
    from raytracing_cuda_tpu.parallel.mesh import (AXIS as ROWS,
                                                   band_shard_fn,
                                                   uninterleave_rows)
    from raytracing_cuda_tpu.sim.actions import Action
    from raytracing_cuda_tpu.sim.state import (animate as sim_animate,
                                               camera_rays, derive_frame)

    nf, nr = mesh.shape[AXIS], mesh.shape[ROWS]
    K = action_vecs.shape[0]
    if K % nf:
        raise ValueError(f"{K} frames not divisible over the {nf}-device "
                         f"frame axis; render the remainder with "
                         f"single-frame steps")
    if height % (nr * interleave):
        raise ValueError(f"height {height} not divisible by rows axis {nr} "
                         f"x interleave {interleave}")
    sub = height // nr // interleave
    if aspect is None:
        aspect = width / height
    path = "pallas_interpret" if interpret else "pallas"

    # sequential host state machine (identical to render_script_dp)
    def pre(carry, av):
        st = sim_animate(carry, Action.unpack(av), Action.unpack_dt(av))
        return st, st

    last_state, states = jax.lax.scan(pre, state, action_vecs)

    # per-frame derived arrays, stacked on the frame axis (the same
    # prologue render_frame_sharded runs for its single frame)
    def prep(st):
        scene_f, lights, ambient = derive_frame(scene, st)
        rays = camera_rays(st.cam, aspect)
        aa = st.aa if fxaa_static is None else jnp.bool_(fxaa_static)
        return (scene_f, lights, ambient, rays, st.day_time / 24.0, aa,
                st.sky_vars)

    per_frame = jax.vmap(prep)(states)

    band = band_shard_fn(
        path=path, sub=sub, width=width, n=nr, interleave=interleave,
        height=height, sh=sky_h, sw=sky_w,
        tri_clusters=tri_clusters, sph_clusters=sph_clusters,
        t_subs=t_subs, chunk=0)

    def shard_fn(per_frame, packed):
        def one(args):
            scene_f, lights, ambient, rays, day_frac, aa, sky_vars = args
            return band(scene_f, lights, ambient, packed, rays, day_frac,
                        aa, sky_vars)

        return jax.lax.map(one, per_frame)

    imgs = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(AXIS), P()),
        out_specs=P(AXIS, ROWS),
        check_vma=False,
    )(per_frame, sky_pack)
    if interleave > 1:
        imgs = jax.vmap(
            lambda im: uninterleave_rows(im, nr, interleave, sub, width)
        )(imgs)
    return imgs, last_state
