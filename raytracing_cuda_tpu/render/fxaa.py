"""FXAA anti-aliasing post-pass (antialiasing kernel, kernel.cu:262-403).

The reference implements FXAA as a CUDA block with a 34x34 shared-memory
luminance tile + halo. Here it is a pure 3x3 stencil over the framebuffer
built from shifted views, which XLA fuses into a few loop kernels — no
shared memory, no halo hazards. (A one-pass GPU kernel of the same math was
measured against it on the H100 and did not beat it end to end; PERF.md.)
For row-sharded framebuffers, fxaa_ext consumes 1-row halos exchanged
between devices (parallel.mesh) and masks borders by *global* row, so the
sharded result is identical to the single-device one.

Behavioral parity notes:
  - Luminance, thresholds, 12-tap blend filter, smoothstep, and the
    horizontal/vertical edge pick match kernel.cu:289-396 exactly.
  - Border pixels (x or y on the image edge) pass through (kernel.cu:330,399).
  - The reference has an operator-precedence bug in its halo loads
    (kernel.cu:318-319) causing out-of-bounds reads at image borders; the
    garbage values are only ever consumed by border pixels, which pass
    through — so this clean implementation is output-identical. Not
    replicated (SURVEY.md §2 #18: "do NOT replicate").
  - FXAA operates on the already uint8-quantized base image, and its output
    is re-quantized with the same clamp+truncate packing (kernel.cu:26-32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

f32 = jnp.float32

CONTRAST_THRESHOLD = 0.0312   # kernel.cu:289
RELATIVE_THRESHOLD = 0.063    # kernel.cu:290
LUMA_WEIGHTS = (0.2126729, 0.7151522, 0.0721750)  # Rec.709, kernel.cu:293


def luminance(img_f32):
    """min(255, r*c1 + g*c2 + b*c3) / 255 (kernel.cu:293-298)."""
    c1, c2, c3 = LUMA_WEIGHTS
    lum = img_f32[..., 0] * c1 + img_f32[..., 1] * c2 + img_f32[..., 2] * c3
    return jnp.minimum(255.0, lum) / 255.0


def fxaa_ext(image_ext, row0: int, total_height: int):
    """FXAA over a vertically-extended band.

    image_ext: (h + 2, w, 3) uint8 — the band plus one halo row above and
    below (contents of the halo rows are irrelevant where they correspond to
    out-of-image rows: those pixels pass through as global borders).
    row0/total_height locate the band in the full framebuffer.
    Returns the filtered band, (h, w, 3) uint8.
    """
    h = image_ext.shape[0] - 2
    w = image_ext.shape[1]
    image = image_ext[1:-1]
    img = image.astype(f32)

    # luminance on the extended band, then horizontal edge-pad
    lum_ext = luminance(image_ext.astype(f32))
    lp = jnp.pad(lum_ext, ((0, 0), (1, 1)), mode="edge")  # (h+2, w+2)
    ln = lp[0:h, 1:w + 1]      # y-1
    ls = lp[2:h + 2, 1:w + 1]  # y+1
    le = lp[1:h + 1, 2:w + 2]  # x+1
    lw = lp[1:h + 1, 0:w]      # x-1
    lne = lp[0:h, 2:w + 2]
    lnw = lp[0:h, 0:w]
    lse = lp[2:h + 2, 2:w + 2]
    lsw = lp[2:h + 2, 0:w]
    lm = lp[1:h + 1, 1:w + 1]

    # contrast + skip threshold (kernel.cu:337-354)
    high = jnp.maximum(jnp.maximum(jnp.maximum(jnp.maximum(le, lw), ln), ls), lm)
    low = jnp.minimum(jnp.minimum(jnp.minimum(jnp.minimum(le, lw), ln), ls), lm)
    contrast = high - low
    threshold = jnp.maximum(CONTRAST_THRESHOLD, RELATIVE_THRESHOLD * high)
    skip = contrast < threshold

    # blend factor: 12-tap neighborhood filter + smoothstep (kernel.cu:364-375)
    filt = (2.0 * (le + lw + ls + ln) + lne + lnw + lse + lsw) / 12.0
    filt = jnp.minimum(1.0, jnp.abs(filt - lm) / contrast)
    blend = filt * filt * (3.0 - 2.0 * filt)

    # edge direction from second-derivative taps (kernel.cu:377-392)
    hor = (jnp.abs(ln + ls - 2.0 * lm) * 2.0
           + jnp.abs(lne + lse - 2.0 * le) + jnp.abs(lnw + lsw - 2.0 * lw))
    ver = (jnp.abs(le + lw - 2.0 * lm) * 2.0
           + jnp.abs(lne + lnw - 2.0 * ln) + jnp.abs(lse + lsw - 2.0 * ls))
    is_hor = hor >= ver
    pick_n = jnp.abs(ln - lm) >= jnp.abs(ls - lm)
    pick_e = jnp.abs(le - lm) >= jnp.abs(lw - lm)

    ip = jnp.pad(image_ext.astype(f32), ((0, 0), (1, 1), (0, 0)), mode="edge")
    img_n = ip[0:h, 1:w + 1]
    img_s = ip[2:h + 2, 1:w + 1]
    img_e = ip[1:h + 1, 2:w + 2]
    img_w = ip[1:h + 1, 0:w]
    neighbor = jnp.where(
        is_hor[..., None],
        jnp.where(pick_n[..., None], img_n, img_s),
        jnp.where(pick_e[..., None], img_e, img_w),
    )

    blended = neighbor * blend[..., None] + img * (1.0 - blend[..., None])
    out = jnp.clip(blended, 0.0, 255.0).astype(jnp.uint8)  # rgbToInt semantics

    ys = row0 + jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    interior = (ys > 0) & (ys < total_height - 1) & (xs > 0) & (xs < w - 1)
    use_aa = interior & jnp.logical_not(skip)
    return jnp.where(use_aa[..., None], out, image)


def fxaa(image):
    """Apply FXAA to a full (H, W, 3) uint8 frame → (H, W, 3) uint8."""
    ext = jnp.pad(image, ((1, 1), (0, 0), (0, 0)), mode="edge")
    return fxaa_ext(ext, row0=0, total_height=image.shape[0])


def apply_fxaa(image, enabled):
    """FXAA with the runtime on/off toggle (kernel.cu:275-278 passthrough)."""
    return jax.lax.cond(enabled, fxaa, lambda x: x, image)
