"""Sky panorama textures: loading, procedural generation, blending, sampling.

The reference binds four 8192x4096 RGBA equirectangular panoramas
(morning/day/evening/night, scene.cpp:626-632) as CUDA point-sampled
normalized textures (kernel.cu:414-442) and blends all four per sky ray with
the skyVars weights using truncating uchar4 arithmetic (kernel.cu:156-163,
structs.h:86-91).

Because calc_sky_vars gives at most two nonzero weights, the lookup fetches
at most two texels per sky ray from a static stack of all four panoramas
and blends them with the reference's truncated arithmetic — bit-exact with
its per-texel blend (sky_static_init, sample_sky_packed_pair). Assets load
from assets/backgrounds/ when present (the reference's backgrounds/
directory copied into the checkout; optional point-sampled downsampling +
an .npz cache) and fall back to a deterministic procedural sky so the
engine is fully standalone.
"""

from __future__ import annotations

import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from raytracing_cuda_tpu.core.math3d import PI
from raytracing_cuda_tpu.core.types import SkyTextures

SKY_NAMES = ("morning", "day", "evening", "night")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REFERENCE_BACKGROUNDS = os.path.join(_REPO_ROOT, "assets", "backgrounds")
CACHE_DIR = os.path.join(_REPO_ROOT, "assets", "cache")


def procedural_skies(height: int = 256, width: int = 512) -> np.ndarray:
    """Deterministic synthetic panoramas, (4, H, W, 3) uint8.

    Stand-ins with the same role as backgrounds/{morning,day,evening,night}.png:
    a vertical sky→horizon gradient per time of day, a sun/moon glow band, and
    hash-noise stars at night. Used by tests and by standalone installs.
    """
    ys = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None, None]  # 0 = zenith
    xs = np.linspace(0.0, 1.0, width, endpoint=False, dtype=np.float32)[None, :, None]

    # per-time (zenith_rgb, horizon_rgb, glow_rgb, glow_x)
    params = [
        ((70, 110, 190), (255, 170, 110), (255, 210, 120), 0.25),   # morning
        ((90, 150, 235), (200, 225, 255), (255, 255, 230), 0.50),   # day
        ((60, 50, 120), (250, 120, 80), (255, 150, 90), 0.75),      # evening
        ((8, 10, 30), (25, 30, 60), (200, 200, 230), 0.50),         # night
    ]
    out = np.zeros((4, height, width, 3), np.float32)
    for i, (zen, hor, glow, gx) in enumerate(params):
        zen = np.array(zen, np.float32)
        hor = np.array(hor, np.float32)
        glow = np.array(glow, np.float32)
        grad = zen + (hor - zen) * np.clip(ys * 2.0, 0.0, 1.0)  # horizon at y=0.5
        dx = np.minimum(np.abs(xs - gx), 1.0 - np.abs(xs - gx)) * 2.0
        dy = np.abs(ys - 0.45) * 2.0
        halo = np.exp(-(dx**2 + dy**2) * 14.0)
        img = grad + glow * halo * 0.8
        if i == 3:  # stars
            rng = np.random.default_rng(1234)
            stars = (rng.random((height, width, 1)) > 0.9985).astype(np.float32)
            img = img + stars * 200.0 * (ys < 0.55)
        out[i] = img
    return np.clip(out, 0, 255).astype(np.uint8)


def load_reference_skies(path: str = REFERENCE_BACKGROUNDS, downsample: int = 1,
                         cache: bool = True) -> np.ndarray:
    """Load the four reference panoramas, (4, H, W, 3) uint8.

    downsample=k point-samples every k-th texel (preserving nearest-sampling
    character). Decoded arrays are cached under assets/cache/.
    """
    import hashlib

    path_tag = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:8]
    cache_file = os.path.join(CACHE_DIR, f"skies_{path_tag}_ds{downsample}.npz")
    if cache and os.path.exists(cache_file):
        return np.load(cache_file)["texels"]

    from PIL import Image

    planes = []
    for name in SKY_NAMES:
        img = np.asarray(Image.open(os.path.join(path, f"{name}.png")).convert("RGBA"))
        planes.append(img[::downsample, ::downsample, :3])
    texels = np.stack(planes)
    if cache:
        os.makedirs(CACHE_DIR, exist_ok=True)
        np.savez_compressed(cache_file, texels=texels)
    return texels


def load_skies(source: str = "auto", downsample: int = 1,
               procedural_shape: Tuple[int, int] = (2048, 4096)) -> SkyTextures:
    """Resolve sky textures: 'reference', 'procedural', or 'auto' (prefer
    reference assets when present)."""
    if source == "auto":
        source = "reference" if os.path.exists(REFERENCE_BACKGROUNDS) else "procedural"
    if source == "reference":
        texels = load_reference_skies(downsample=downsample)
    elif source == "procedural":
        texels = procedural_skies(*procedural_shape)
    else:
        raise ValueError(f"unknown sky source {source!r}")
    return SkyTextures(texels=texels)


def blend_sky(texels, sky_vars):
    """Pre-blend the four panoramas with the frame's skyVars → (H, W, 3) uint8.

    Reproduces the reference's per-ray blend (kernel.cu:158-162) exactly:
    each texel scaled in float32 and truncated to uchar (structs.h:86-88),
    then summed (weights sum to 1, so no uchar overflow). Because weights are
    uniform across the frame, pre-blending per texel is bit-identical to
    blending per ray.
    """
    texels = jnp.asarray(texels)
    sky_vars = jnp.asarray(sky_vars, jnp.float32)
    acc = jnp.zeros(texels.shape[1:], jnp.uint8)
    for i in range(4):
        term = (texels[i].astype(jnp.float32) * sky_vars[i]).astype(jnp.uint8)
        acc = acc + term
    return acc


def sample_sky(blended, d, day_frac):
    """Equirectangular sky lookup (kernel.cu:156-163) → (..., 3) f32 in [0,1].

    y from asin(dir.y); x from atan2(dir.x, dir.z) shifted by the day
    fraction so the sky rotates with the clock; point sampling with clamp
    addressing like the reference's CUDA texture setup (kernel.cu:429-436).
    """
    h, w = blended.shape[0], blended.shape[1]
    iy, ix = _equirect_indices(h, w, d, day_frac)
    texel = blended.reshape(-1, 3)[iy * w + ix]
    return texel.astype(jnp.float32) * jnp.float32(1.0 / 255.0)


def pack_sky(blended):
    """Pack the blended (H, W, 3) uint8 sky into a flat int32 plane: one
    4-byte load per sky ray instead of three 1-byte loads."""
    b32 = blended.astype(jnp.int32)
    return (b32[..., 0] | (b32[..., 1] << 8) | (b32[..., 2] << 16)).reshape(-1)


def sample_sky_packed(packed, h, w, d, day_frac):
    """Equirect lookup (kernel.cu:156-163) on a pack_sky plane → (..., 3) f32."""
    iy, ix = _equirect_indices(h, w, d, day_frac)
    texel = packed[iy * w + ix]
    rgb = jnp.stack([texel & 0xFF, (texel >> 8) & 0xFF, (texel >> 16) & 0xFF],
                    axis=-1)
    return rgb.astype(jnp.float32) * jnp.float32(1.0 / 255.0)


def _equirect_indices(h, w, d, day_frac):
    """Shared equirect index math (kernel.cu:156-163): direction → (iy, ix)."""
    y = 1.0 - (jnp.arcsin(jnp.clip(d[..., 1], -1.0, 1.0)) + PI / 2.0) / PI
    x = jnp.mod((jnp.arctan2(d[..., 0], d[..., 2]) + PI) / (2.0 * PI) + day_frac, 1.0)
    ix = jnp.clip((x * w).astype(jnp.int32), 0, w - 1)
    iy = jnp.clip((y * h).astype(jnp.int32), 0, h - 1)
    return iy, ix


def pack_sky_all(texels):
    """Flat-pack all four raw panoramas → (4, H*W) int32 (pack_sky per
    panorama)."""
    return jnp.stack([pack_sky(texels[i]) for i in range(4)])


def sky_blend_bands(sky_vars):
    """→ (ia, ib, wa, wb): the ≤2 active panoramas and their weights.

    calc_sky_vars (scene.cpp:778-804) yields at most two nonzero adjacent
    weights summing to 1, so the 4-way truncated blend collapses to two
    terms: trunc(tex_a·wa) + trunc(tex_b·wb) is bit-identical to
    blend_sky's Σ trunc(tex_i·w_i) (zero-weight terms truncate to 0; a
    pure band has wa = 1 and trunc(tex·1) = tex exactly).
    """
    sky_vars = jnp.asarray(sky_vars, jnp.float32)
    ia = jnp.argmax(sky_vars).astype(jnp.int32)
    masked = jnp.where(jnp.arange(4) == ia, -1.0, sky_vars)
    ib = jnp.argmax(masked).astype(jnp.int32)
    return ia, ib, sky_vars[ia], jnp.maximum(masked[ib], 0.0)


def sky_static_init(sky_texels):
    """Build the static sky stack for the kernel paths → (4, H·W) int32.

    Packed ONCE per sky (startup); frames blend the ≤2 active panoramas at
    lookup time (sky_blend_bands, sample_sky_packed_pair), so no per-frame
    blend+pack exists anywhere.
    """
    return pack_sky_all(jnp.asarray(sky_texels))


def sample_sky_packed_pair(packed_all, h, w, d, day_frac, sky_vars):
    """Flat equirect lookup on a pack_sky_all stack → (..., 3) f32 in [0,1].

    Bit-identical to sample_sky_packed on a pack_sky(blend_sky(...)) plane:
    the truncated two-term blend of sky_blend_bands, applied per pixel.
    """
    iy, ix = _equirect_indices(h, w, d, day_frac)
    idx = iy * w + ix
    ia, ib, wa, wb = sky_blend_bands(sky_vars)
    flat = packed_all.reshape(-1)
    hw = h * w

    def one(_):
        t = flat[ia * hw + idx]
        return jnp.stack([t & 0xFF, (t >> 8) & 0xFF, (t >> 16) & 0xFF],
                         axis=-1).astype(jnp.float32)

    def two(_):
        ta = flat[ia * hw + idx]
        tb = flat[ib * hw + idx]
        chans = [jnp.floor(((ta >> s) & 0xFF).astype(jnp.float32) * wa)
                 + jnp.floor(((tb >> s) & 0xFF).astype(jnp.float32) * wb)
                 for s in (0, 8, 16)]
        return jnp.stack(chans, axis=-1)

    rgb = jax.lax.cond(wb > 0, two, one, None)
    return rgb * jnp.float32(1.0 / 255.0)
