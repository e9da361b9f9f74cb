"""Multi-device framebuffer sharding over a jax.sharding.Mesh.

The reference is strictly single-GPU (SURVEY.md §2 parallelism audit: no
NCCL/MPI anywhere); its only parallelism is the per-pixel CUDA grid. The
scale-out here shards the framebuffer by row bands over a 1-D device mesh
with shard_map: the ~5 KB scene and the sky are replicated, each device
raytraces its band (ray generation is positioned by a global row offset
carried in the kernel's params vector, so every band runs the SAME compiled
kernel and the sharded frame matches the single-device render), and the
FXAA stencil exchanges 1-row halos with neighbour devices via
lax.ppermute — the only collective in the frame.

Like the single-device engine, the sharded kernel path looks the sky up in
the STATIC all-panorama stack (textures.sky_static_init, replicated): the
≤2 active panoramas are blended per fetched texel, so no per-frame
blend+pack exists and frame cost is flat across the 24 h clock including
the 2 h crossfades (scene.cpp:778-804).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from raytracing_cuda_tpu.core.types import Scene
from raytracing_cuda_tpu.render.fxaa import fxaa_ext
from raytracing_cuda_tpu.render.fast import render_base_image_fast
from raytracing_cuda_tpu.scene.textures import blend_sky
from raytracing_cuda_tpu.sim.state import FrameState, camera_rays, derive_frame

AXIS = "rows"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D device mesh over the framebuffer's row axis."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (AXIS,))


def band_shard_fn(*, path, sub, width, n, interleave, height,
                  sh, sw, tri_clusters, sph_clusters, t_subs, chunk):
    """The per-device row-band render body, as a function of one frame's
    arrays: (scene_f, lights, ambient, packed, rays, day_frac, aa,
    sky_vars) → (interleave*sub, width, 3) uint8 local rows.

    Must run inside a shard_map whose mesh has a '{AXIS}' axis of size n —
    either the 1-D row mesh (render_frame_sharded) or the 2-D
    (frames, rows) hybrid mesh (parallel/frames.py), where it is mapped
    over each device's local frames; its only collectives (the FXAA halo
    ppermutes) name the row axis, so the frame axis composes freely
    around it.
    """

    def shard_fn(scene_f, lights, ambient, packed, rays, day_frac, aa,
                 sky_vars):
        idx = jax.lax.axis_index(AXIS)

        def render_chunk(chunk_id):
            """One (sub, width) row chunk starting at global row
            chunk_id*sub. chunk_id is traced — on the kernel path the row
            offset rides the params vector, so every chunk of every device
            runs the SAME compiled kernel."""
            if path.startswith("pallas"):
                from raytracing_cuda_tpu.render.pallas_rt import (
                    render_base_planes_pallas)
                from raytracing_cuda_tpu.render.reference import quantize
                from raytracing_cuda_tpu.scene.textures import (
                    sample_sky_packed_pair)

                planes = render_base_planes_pallas(
                    scene_f, lights, ambient, rays, sub, width,
                    interpret=(path == "pallas_interpret"),
                    tri_clusters=tri_clusters, sph_clusters=sph_clusters,
                    row0=(chunk_id * sub).astype(jnp.float32),
                    total_height=height, t_subs=t_subs)
                r, g, b, mw, mdx, mdy, mdz = planes
                mdir = jnp.stack([mdx, mdy, mdz], axis=-1)
                sky = sample_sky_packed_pair(packed, sh, sw, mdir, day_frac,
                                             sky_vars)
                return quantize(jnp.stack([r, g, b], axis=-1)
                                + mw[..., None] * sky)
            return render_base_image_fast(scene_f, lights, ambient, packed,
                                          day_frac, rays, sub, width,
                                          row0=chunk_id * sub,
                                          total_height=height, chunk=chunk)

        # device d renders global chunks d, d+n, …, d+(k-1)n (k=interleave;
        # k=1 is the contiguous-band layout)
        bases = [render_chunk(idx + j * n) for j in range(interleave)]

        # halo exchange: chunk c needs the last row of chunk c-1 and the
        # first row of chunk c+1. c-1 lives on device d-1 at the same slot j
        # (ring step), EXCEPT device 0, whose upper neighbors are device
        # n-1's chunks at slot j-1 (the wrap ppermute carries the slot-
        # shifted stack; non-receivers get zeros, and zeros are exactly
        # right at the global frame borders, which FXAA passes through).
        L = jnp.concatenate([b[-1:] for b in bases], axis=0)   # (k, W, 3)
        F = jnp.concatenate([b[:1] for b in bases], axis=0)
        down = [(i, i + 1) for i in range(n - 1)]
        up = [(i + 1, i) for i in range(n - 1)]
        halo_top = jax.lax.ppermute(L, AXIS, down)
        halo_bot = jax.lax.ppermute(F, AXIS, up)
        if interleave > 1:      # wrap legs carry the slot-shifted stacks
            zrow = jnp.zeros_like(L[:1])
            halo_top = halo_top + jax.lax.ppermute(
                jnp.concatenate([zrow, L[:-1]], axis=0), AXIS, [(n - 1, 0)])
            halo_bot = halo_bot + jax.lax.ppermute(
                jnp.concatenate([F[1:], zrow], axis=0), AXIS, [(0, n - 1)])

        def aa_chunks(args):
            bases, halo_top, halo_bot = args
            outs = []
            for j, b in enumerate(bases):
                ext = jnp.concatenate([halo_top[j:j + 1], b,
                                       halo_bot[j:j + 1]], axis=0)
                outs.append(fxaa_ext(ext, row0=(idx + j * n) * sub,
                                      total_height=height))
            return jnp.concatenate(outs, axis=0)

        def no_aa(args):
            return jnp.concatenate(args[0], axis=0)

        return jax.lax.cond(aa, aa_chunks, no_aa,
                            (bases, halo_top, halo_bot))

    return shard_fn


def uninterleave_rows(img, n: int, interleave: int, sub: int, width: int):
    """Undo the strided-band shard order: shard output row-major order is
    (device d, slot j) = global chunk d + j*n; the global image wants
    chunks in order c = 0, 1, …"""
    if interleave == 1:
        return img
    return (img.reshape(n, interleave, sub, width, 3)
            .swapaxes(0, 1).reshape(n * interleave * sub, width, 3))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "height", "width", "chunk", "aspect",
                     "fxaa_static", "path", "tri_clusters", "sph_clusters",
                     "interleave", "t_subs"),
)
def render_frame_sharded(scene: Scene, state: FrameState, sky_texels, *,
                         mesh: Mesh, height: int, width: int,
                         chunk: int = 32768, aspect: float | None = None,
                         fxaa_static: bool | None = None,
                         path: str = "fast",
                         tri_clusters: tuple | None = None,
                         sph_clusters: tuple | None = None,
                         sky_pack=None, interleave: int = 1,
                         t_subs: tuple | None = None):
    """Row-sharded render of one frame → (height, width, 3) uint8.

    Output matches render_frame exactly: rays are generated from global row
    coordinates and FXAA sees true neighbour rows through a halo exchange
    instead of band-local padding.

    Kernel paths require sky_pack (the static stack from
    textures.sky_static_init, replicated on every device); the other paths
    blend the panoramas per frame from sky_texels like render_frame.

    interleave = k > 1 assigns each device k STRIDED sub-bands (device d
    renders row chunks d, d+n, d+2n, …) instead of one contiguous band.
    Contiguous bands have skewed work — top rows are sky-cheap, bottom rows
    hit water reflections — so striding balances the per-device load; the
    cost is k kernel launches per device (inside one program) and 2k halo
    rows instead of 2. Bit-identical output by construction (pinned by
    tests/test_parallel.py). The expected win is the gap between the
    heaviest and the mean band; it is not measured yet.
    """
    n = mesh.shape[AXIS]
    if interleave < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    if height % (n * interleave):
        raise ValueError(f"height {height} not divisible by mesh size {n} "
                         f"x interleave {interleave}")
    band = height // n
    sub = band // interleave        # rows per strided chunk
    if aspect is None:
        aspect = width / height

    scene_f, lights, ambient = derive_frame(scene, state)
    rays = camera_rays(state.cam, aspect)
    day_frac = state.day_time / 24.0
    aa = state.aa if fxaa_static is None else jnp.bool_(fxaa_static)

    sh, sw = sky_texels.shape[1], sky_texels.shape[2]
    if path.startswith("pallas"):
        if sky_pack is None:
            raise ValueError("kernel paths need sky_pack "
                             "(textures.sky_static_init)")
        packed = sky_pack
    else:
        packed = blend_sky(sky_texels, state.sky_vars)

    shard_fn = band_shard_fn(
        path=path, sub=sub, width=width, n=n, interleave=interleave,
        height=height, sh=sh, sw=sw,
        tri_clusters=tri_clusters, sph_clusters=sph_clusters,
        t_subs=t_subs, chunk=chunk)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(), P()),
        out_specs=P(AXIS),
        # scan carries inside the trace loop start replicated and become
        # device-varying; skip the varying-manual-axes check rather than
        # pcast every carry leaf
        check_vma=False,
    )
    img = fn(scene_f, lights, ambient, packed, rays, day_frac, aa,
             state.sky_vars)
    return uninterleave_rows(img, n, interleave, sub, width)
