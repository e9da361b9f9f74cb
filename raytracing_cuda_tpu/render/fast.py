"""Fused-XLA raytracer — same semantics as render.reference, restructured
for vector hardware (the CPU path; the GPU runs render.pallas_rt).

Three structural differences from the parity oracle (render/reference.py),
none observable in the output:

1. **Linear-form intersections** (ops.linear_forms): the per-(ray, object)
   3-vector math of checkHit (kernel.cu:41-129) is hoisted into per-object
   constants × a 12-dim per-ray feature vector, so one pass over all 133
   objects is a fused elementwise sweep over (chunk, n_objects) f32 planes —
   no (pixels, objects, 3) intermediates, which made the naive vectorization
   HBM-bound.

2. **Deferred sky gather**: a ray misses at most once (a miss kills it), so
   instead of an equirect texture gather per bounce (kernel.cu:156-163 runs
   inside the recursion) the loop records (miss_throughput, miss_direction)
   and a single gather per pixel resolves the sky after the loop.

3. **Per-chunk early exit**: pixels render in chunks (lax.map); inside each
   chunk the unrolled bounce iterations and the per-light occlusion sweeps
   are wrapped in lax.cond on "any lane still needs this", recovering the
   sequential reference's early-outs (kernel.cu:192, 222) at tile
   granularity. Sky-only chunks pay one bounce; most chunks skip the deep
   reflection levels entirely.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracing_cuda_tpu.core.types import SPHERE, CameraRays, Lights, Scene
from raytracing_cuda_tpu.ops import linear_forms as lf
from raytracing_cuda_tpu.render.reference import MAX_DEPTH, primary_rays, quantize
from raytracing_cuda_tpu.scene.textures import sample_sky

from raytracing_cuda_tpu.core.math3d import normalize as _normalize

f32 = jnp.float32


def trace_chunk(scene: Scene, tp: lf.TriPack, sp: lf.SpherePack, sph_blocks,
                lights: Lights, ambient, o, d):
    """Trace one chunk of rays through the full bounce loop.

    Returns (color_acc, miss_w, miss_dir): linear hit-path color plus the
    deferred sky term — final color = color_acc + miss_w * sky(miss_dir).
    """
    ambient = jnp.asarray(ambient, f32)
    shape = d.shape[:-1]
    carry = (
        o, d,
        jnp.ones(shape, f32),           # throughput
        jnp.zeros(shape + (3,), f32),   # color_acc
        jnp.ones(shape, bool),          # live
        jnp.zeros(shape, f32),          # miss_w
        d,                              # miss_dir (weight 0 ⇒ value unused)
    )

    def bounce(carry):
        o, d, throughput, color_acc, live, miss_w, miss_dir = carry
        F = lf.ray_features(o, d)
        hit_any, t, gidx = lf.nearest_hit_fast(scene, tp, sp, F)
        gidx_safe = jnp.maximum(gidx, 0)

        # --- miss → record deferred sky term (kernel.cu:154-163) ---
        miss = live & jnp.logical_not(hit_any)
        miss_w = jnp.where(miss, throughput, miss_w)
        miss_dir = jnp.where(miss[..., None], d, miss_dir)

        # --- winner attributes ---
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
        color_acc = color_acc + jnp.where(
            lit[..., None], throughput[..., None] * col, 0.0)

        # --- Phong with hard shadows (kernel.cu:172-206) ---
        shaded = live & hit_any & jnp.logical_not(emissive)
        phong = col * ambient
        for i in range(2):
            lvec = lights.pos[i] - hit_pos
            sdist = jnp.sqrt(jnp.sum(lvec * lvec, axis=-1))
            sdir = lvec / sdist[..., None]
            angle = jnp.maximum(0.0, jnp.sum(normal * sdir, axis=-1))

            need = shaded & (angle > 0)

            def shadow_sweep(args):
                hit_pos, sdir, sdist = args
                Fs = lf.ray_features(hit_pos + sdir * 0.001, sdir)
                return lf.occluded_fast(scene, tp, sp, sph_blocks, Fs, sdist)

            occ = jax.lax.cond(
                jnp.any(need), shadow_sweep,
                lambda args: jnp.zeros(shape, bool), (hit_pos, sdir, sdist))
            angle = jnp.where(occ, 0.0, angle)
            phong = phong + (col * lights.color[i]) * (
                angle * lights.intensity[i])[..., None]

            light_dir = -sdir
            spec_dir = _normalize(
                light_dir
                - 2.0 * jnp.sum(normal * light_dir, axis=-1, keepdims=True) * normal)
            spec = (jnp.power(jnp.maximum(0.0, -jnp.sum(spec_dir * d, axis=-1)),
                              spec_exp) * shine * angle)
            phong = phong + jnp.where(shine > 0, spec, 0.0)[..., None]

        color_acc = color_acc + jnp.where(
            shaded[..., None], (throughput * (1.0 - kr))[..., None] * phong, 0.0)

        # --- mirror bounce (kernel.cu:209-218) ---
        refl = _normalize(
            d - 2.0 * jnp.sum(normal * d, axis=-1, keepdims=True) * normal)
        new_o = hit_pos + refl * 0.001
        bounce_on = shaded & (kr > 0)
        o = jnp.where(bounce_on[..., None], new_o, o)
        d = jnp.where(bounce_on[..., None], refl, d)
        throughput = jnp.where(bounce_on, throughput * kr, throughput)
        return (o, d, throughput, color_acc, bounce_on, miss_w, miss_dir)

    for _ in range(MAX_DEPTH + 1):
        live = carry[4]
        carry = jax.lax.cond(jnp.any(live), bounce, lambda c: c, carry)

    _, _, _, color_acc, _, miss_w, miss_dir = carry
    return color_acc, miss_w, miss_dir


def render_base_image_fast(scene: Scene, lights: Lights, ambient, sky_blended,
                           day_frac, cam: CameraRays, height: int, width: int,
                           row0: int = 0, total_height: int | None = None,
                           chunk: int = 65536):
    """Render the pre-FXAA framebuffer: (height, width, 3) uint8.

    Drop-in replacement for render.reference.render_base_image with identical
    semantics (tests assert sub-quantum agreement).
    """
    dirs = primary_rays(cam, height, width, row0, total_height)
    n_px = height * width
    flat = dirs.reshape(n_px, 3)

    chunk = min(chunk, n_px)
    n_chunks = -(-n_px // chunk)
    pad = n_chunks * chunk - n_px
    if pad:
        flat = jnp.concatenate(
            [flat, jnp.broadcast_to(jnp.array([0, 1, 0], f32), (pad, 3))])

    tp = lf.tri_pack(scene)
    sp = lf.sphere_pack(scene)
    sph_blocks = jnp.logical_not(scene.is_light[scene.sph_gidx])

    def render_chunk(d):
        o = jnp.broadcast_to(cam.pos, d.shape)
        color, miss_w, miss_dir = trace_chunk(
            scene, tp, sp, sph_blocks, lights, ambient, o, d)
        sky = sample_sky(sky_blended, miss_dir, day_frac)
        return quantize(color + miss_w[..., None] * sky)

    out = jax.lax.map(render_chunk, flat.reshape(n_chunks, chunk, 3))
    return out.reshape(-1, 3)[:n_px].reshape(height, width, 3)
