"""Pure-jnp raytracer — the parity oracle and the default XLA render path.

Functional re-expression of the reference's raytracing kernel
(kernel.cu:131-259): the template-recursive trace<depth> becomes an iterative
bounce loop carrying (origin, direction, throughput, color, live-mask) over
masked vector lanes; the sequential 133-object nearest-hit and shadow loops
become batched intersections + reductions (ops.intersect); the per-ray
4-texture sky blend becomes one gather into the per-frame pre-blended
panorama (scene.textures.blend_sky — exact, see its docstring).

Runs identically on the CPU (golden frames) and the GPU. Pixels are
processed in fixed-size chunks via lax.map so peak memory stays bounded at
any resolution — the analogue of the reference's unbounded CUDA pixel grid
(kernel.cu:455-456).

Semantics preserved exactly (for RMSE parity with the CUDA reference):
  - emissive short-circuit for sun/moon proxies (kernel.cu:169)
  - Phong: ambient tint, 2 lights, hard shadows over non-light objects,
    shadow/reflection ray epsilon 0.001 (kernel.cu:172-206)
  - mirror weighting refColor*kR + phong*(1-kR), depth 4, black beyond
    (kernel.cu:209-225)
  - final packing clamp(c*255, 0, 255) truncated to integer (kernel.cu:26-32)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracing_cuda_tpu.core.types import SPHERE, CameraRays, Lights, Scene
from raytracing_cuda_tpu.ops.intersect import nearest_hit, occluded
from raytracing_cuda_tpu.scene.textures import sample_sky

from raytracing_cuda_tpu.core.math3d import normalize as _normalize

f32 = jnp.float32

MAX_DEPTH = 4  # kernel.cu:11 — bounces run depths 0..MAX_DEPTH inclusive


def primary_rays(cam: CameraRays, height: int, width: int,
                 row0: int = 0, total_height: int | None = None):
    """Per-pixel ray directions by bilinear frustum-corner interpolation
    (kernel.cu:244-253). Returns (height, width, 3) normalized directions.

    row0/total_height address a horizontal band of a larger framebuffer so
    multi-chip shards reproduce the exact single-chip rays.
    """
    th = total_height if total_height is not None else height
    px = (jnp.arange(width, dtype=f32) / f32(width - 1))[None, :, None]
    py = ((row0 + jnp.arange(height, dtype=f32)) / f32(th - 1))[:, None, None]
    vd = cam.LD + (cam.RD - cam.LD) * px          # (1, W, 3)
    vu = cam.LU + (cam.RU - cam.LU) * px
    target = vu - (vu - vd) * py                  # (H, W, 3)
    return _normalize(target)


def trace_image(scene: Scene, lights: Lights, ambient, sky_blended, day_frac, o, d):
    """Iterative trace (kernel.cu:131-225) over a batch of rays.

    o, d: (..., 3). Returns linear color (..., 3) f32 (pre-quantization).
    """
    ambient = jnp.asarray(ambient, f32)
    shape = d.shape[:-1]
    color_acc = jnp.zeros(shape + (3,), f32)
    throughput = jnp.ones(shape, f32)
    live = jnp.ones(shape, bool)

    def bounce(carry, _):
        o, d, throughput, color_acc, live = carry

        hit_any, t, gidx = nearest_hit(scene, o, d)
        gidx_safe = jnp.maximum(gidx, 0)

        # --- miss → sky (kernel.cu:154-163) ---
        sky_rgb = sample_sky(sky_blended, d, day_frac)
        miss = live & jnp.logical_not(hit_any)
        color_acc = color_acc + jnp.where(
            miss[..., None], throughput[..., None] * sky_rgb, 0.0)

        # --- gather winner attributes ---
        col = scene.color[gidx_safe]
        shine = scene.shine[gidx_safe]
        spec_exp = scene.specular[gidx_safe]
        kr = scene.mirror[gidx_safe]
        emissive = scene.is_light[gidx_safe]
        typ = scene.obj_type[gidx_safe]

        hit_pos = o + d * t[..., None]
        normal = jnp.where(
            (typ == SPHERE)[..., None],
            _normalize(hit_pos - scene.center[gidx_safe]),
            scene.static_normal[gidx_safe],
        )

        # --- emissive sun/moon proxies (kernel.cu:169) ---
        lit = live & hit_any & emissive
        color_acc = color_acc + jnp.where(lit[..., None], throughput[..., None] * col, 0.0)

        # --- Phong with hard shadows (kernel.cu:172-206) ---
        phong = col * ambient
        for i in range(2):
            lvec = lights.pos[i] - hit_pos
            sdist = jnp.sqrt(jnp.sum(lvec * lvec, axis=-1))
            sdir = lvec / sdist[..., None]
            angle = jnp.maximum(0.0, jnp.sum(normal * sdir, axis=-1))
            shadow_o = hit_pos + sdir * 0.001
            occ = occluded(scene, shadow_o, sdir, sdist)
            angle = jnp.where(occ, 0.0, angle)
            phong = phong + (col * lights.color[i]) * (angle * lights.intensity[i])[..., None]

            light_dir = -sdir
            spec_dir = _normalize(
                light_dir - 2.0 * jnp.sum(normal * light_dir, axis=-1, keepdims=True) * normal)
            spec = (jnp.power(jnp.maximum(0.0, -jnp.sum(spec_dir * d, axis=-1)), spec_exp)
                    * shine * angle)
            phong = phong + jnp.where(shine > 0, spec, 0.0)[..., None]

        shaded = live & hit_any & jnp.logical_not(emissive)
        color_acc = color_acc + jnp.where(
            shaded[..., None], (throughput * (1.0 - kr))[..., None] * phong, 0.0)

        # --- mirror bounce (kernel.cu:209-218) ---
        refl = _normalize(d - 2.0 * jnp.sum(normal * d, axis=-1, keepdims=True) * normal)
        new_o = hit_pos + refl * 0.001
        bounce_on = shaded & (kr > 0)
        o = jnp.where(bounce_on[..., None], new_o, o)
        d = jnp.where(bounce_on[..., None], refl, d)
        throughput = jnp.where(bounce_on, throughput * kr, throughput)
        live = bounce_on

        return (o, d, throughput, color_acc, live), None

    (o, d, throughput, color_acc, live), _ = jax.lax.scan(
        bounce, (o, d, throughput, color_acc, live), None, length=MAX_DEPTH + 1)
    return color_acc


def quantize(color):
    """rgbToInt packing (kernel.cu:26-32): clamp(c*255, 0, 255), truncate."""
    c = jnp.clip(color * 255.0, 0.0, 255.0)
    return c.astype(jnp.uint8)


def render_base_image(scene: Scene, lights: Lights, ambient, sky_blended, day_frac,
                      cam: CameraRays, height: int, width: int,
                      row0: int = 0, total_height: int | None = None,
                      chunk: int = 32768):
    """Render the pre-FXAA framebuffer: (height, width, 3) uint8.

    Pixels are traced in `chunk`-sized batches with lax.map so the (..., N)
    intersection intermediates stay within on-chip/HBM budgets at any
    resolution.
    """
    dirs = primary_rays(cam, height, width, row0, total_height)
    n_px = height * width
    flat = dirs.reshape(n_px, 3)

    chunk = min(chunk, n_px)
    n_chunks = -(-n_px // chunk)
    pad = n_chunks * chunk - n_px
    if pad:
        flat = jnp.concatenate([flat, jnp.broadcast_to(jnp.array([0, 1, 0], f32), (pad, 3))])

    def render_chunk(d):
        o = jnp.broadcast_to(cam.pos, d.shape)
        color = trace_image(scene, lights, ambient, sky_blended, day_frac, o, d)
        return quantize(color)

    out = jax.lax.map(render_chunk, flat.reshape(n_chunks, chunk, 3))
    return out.reshape(-1, 3)[:n_px].reshape(height, width, 3)
