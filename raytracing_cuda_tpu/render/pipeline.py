"""Per-frame render pipeline: derive scene → raytrace → sky → FXAA.

The equivalent of the reference's launchKernel (kernel.cu:406-462): where
CUDA re-uploads constants and launches two kernels per frame, here the whole
frame — per-frame scene derivation (recolor, sea level, light orbit),
raytrace, sky lookup, FXAA — is one jitted function of (scene, state, sky),
so no host work sits between its stages.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from raytracing_cuda_tpu.core.types import Scene, SkyTextures
from raytracing_cuda_tpu.render.fast import render_base_image_fast
from raytracing_cuda_tpu.render.fxaa import apply_fxaa, fxaa
from raytracing_cuda_tpu.render.reference import render_base_image
from raytracing_cuda_tpu.scene.textures import blend_sky
from raytracing_cuda_tpu.sim.state import FrameState, camera_rays, derive_frame


@functools.partial(
    jax.jit,
    static_argnames=("height", "width", "chunk", "aspect", "fxaa_static",
                     "path", "tri_clusters", "sph_clusters", "t_subs"))
def render_frame(scene: Scene, state: FrameState, sky_texels,
                 height: int, width: int, chunk: int = 32768,
                 aspect: float | None = None,
                 fxaa_static: bool | None = None,
                 path: str = "fast",
                 tri_clusters: tuple | None = None,
                 sph_clusters: tuple | None = None,
                 t_subs: tuple | None = None):
    """Render one frame → (height, width, 3) uint8.

    aspect defaults to width/height (see RenderConfig.aspect for the
    reference's stale-aspect quirk). fxaa_static pins the FXAA branch at
    compile time (None → runtime lax.cond on state.aa, like the reference's
    per-frame `alias` flag kernel.cu:263). path selects the raytracer:
    "fast" (default, render.fast), "oracle" (render.reference — the
    straight-line parity implementation), "pallas" (the GPU kernel,
    render.pallas_rt) or "pallas_interpret" (that kernel on the CPU).
    """
    if aspect is None:
        aspect = width / height
    scene_f, lights, ambient = derive_frame(scene, state)
    rays = camera_rays(state.cam, aspect)
    blended = blend_sky(sky_texels, state.sky_vars)
    day_frac = state.day_time / 24.0
    if path in ("pallas", "pallas_interpret"):
        from raytracing_cuda_tpu.scene.textures import pack_sky

        sh, sw = blended.shape[0], blended.shape[1]
        base = _pallas_base(scene_f, lights, ambient, rays, pack_sky(blended),
                            sh, sw, day_frac, height, width,
                            interpret=(path == "pallas_interpret"),
                            tri_clusters=tri_clusters,
                            sph_clusters=sph_clusters, t_subs=t_subs)
    else:
        render = {"fast": render_base_image_fast, "oracle": render_base_image}[path]
        base = render(scene_f, lights, ambient, blended, day_frac,
                      rays, height, width, chunk=chunk)
    return _apply_aa(base, state.aa, fxaa_static)


def _apply_aa(base, aa_flag, fxaa_static):
    """FXAA on the runtime flag (like the reference's per-frame `alias`
    flag, kernel.cu:263), or pinned at compile time by fxaa_static."""
    if fxaa_static is None:
        return apply_fxaa(base, aa_flag)
    return fxaa(base) if fxaa_static else base


def _pallas_base(scene_f, lights, ambient, rays, packed_sky, sky_h, sky_w,
                 day_frac, height, width, interpret=False,
                 tri_clusters=None, sph_clusters=None,
                 sky_vars=None, t_subs=None):
    """Raytracing kernel + deferred sky lookup from a packed sky.

    With sky_vars=None, packed_sky is a per-frame pre-blended plane
    (pack_sky of blend_sky's output). With sky_vars given, packed_sky is the
    STATIC all-panorama stack (sky_static_init) and the lookup blends the ≤2
    active panoramas per fetched texel — bit-identical output, no per-frame
    blend+pack."""
    from raytracing_cuda_tpu.render.pallas_rt import render_base_planes_pallas
    from raytracing_cuda_tpu.render.reference import quantize
    from raytracing_cuda_tpu.scene.textures import (sample_sky_packed,
                                                    sample_sky_packed_pair)

    r, g, b, mw, mdx, mdy, mdz = render_base_planes_pallas(
        scene_f, lights, ambient, rays, height, width, interpret=interpret,
        tri_clusters=tri_clusters, sph_clusters=sph_clusters, t_subs=t_subs)
    mdir = jnp.stack([mdx, mdy, mdz], axis=-1)
    if sky_vars is not None:
        sky = sample_sky_packed_pair(packed_sky, sky_h, sky_w, mdir,
                                     day_frac, sky_vars)
    else:
        sky = sample_sky_packed(packed_sky, sky_h, sky_w, mdir, day_frac)
    return quantize(jnp.stack([r, g, b], axis=-1) + mw[..., None] * sky)


def render_frame_static_sky(scene: Scene, state: FrameState, sky_pack,
                            sky_h: int, sky_w: int,
                            height: int, width: int,
                            aspect: float | None = None,
                            fxaa_static: bool | None = None,
                            tri_clusters: tuple | None = None,
                            sph_clusters: tuple | None = None,
                            interpret: bool = False,
                            t_subs: tuple | None = None):
    """Kernel-path render from the STATIC all-panorama sky stack.

    sky_pack comes from textures.sky_static_init (packed once per sky, at
    engine construction). The lookup blends the ≤2 active panoramas per
    fetched texel with the reference's truncated arithmetic, so frame cost
    is flat across the whole 24 h clock: no per-frame blend+pack exists
    (the reference pays the 4-way per-ray blend unconditionally,
    kernel.cu:156-163).
    """
    if aspect is None:
        aspect = width / height
    scene_f, lights, ambient = derive_frame(scene, state)
    rays = camera_rays(state.cam, aspect)
    day_frac = state.day_time / 24.0
    base = _pallas_base(scene_f, lights, ambient, rays, sky_pack, sky_h,
                        sky_w, day_frac, height, width,
                        tri_clusters=tri_clusters, sph_clusters=sph_clusters,
                        sky_vars=state.sky_vars, interpret=interpret,
                        t_subs=t_subs)
    return _apply_aa(base, state.aa, fxaa_static)


def render_frame_np(scene, state, sky: SkyTextures, height, width, **kw):
    """Convenience wrapper returning a host numpy array."""
    import numpy as np

    return np.asarray(render_frame(scene, state, sky.texels, height, width, **kw))
