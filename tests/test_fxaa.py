"""FXAA unit tests on synthetic tiles (kernel.cu:262-403 semantics).

The reference was verified only visually (SURVEY.md §4); these tests pin the
behavioral contract instead: luminance weights, contrast skip thresholds,
border passthrough, edge-direction blending, and off-toggle exactness.
"""

import jax.numpy as jnp
import numpy as np

from raytracing_cuda_tpu.render.fxaa import (
    CONTRAST_THRESHOLD, LUMA_WEIGHTS, RELATIVE_THRESHOLD, apply_fxaa, fxaa,
    luminance)


def test_luma_weights_are_rec709():
    # kernel.cu:293 uses Rec.709 coefficients
    assert abs(sum(LUMA_WEIGHTS) - 1.0) < 2e-6
    r, g, b = LUMA_WEIGHTS
    assert g > r > b


def test_luminance_clamps_at_255():
    img = jnp.full((2, 2, 3), 255.0)
    assert float(luminance(img).max()) <= 1.0


def test_flat_image_passthrough():
    """Zero contrast < threshold → every pixel skipped (kernel.cu:343-354)."""
    img = jnp.full((16, 24, 3), 128, jnp.uint8)
    assert np.array_equal(np.asarray(fxaa(img)), np.asarray(img))


def test_low_contrast_below_absolute_threshold_skipped():
    # luminance step of 3/255 ≈ 0.0118 < CONTRAST_THRESHOLD 0.0312
    img = np.full((16, 24, 3), 100, np.uint8)
    img[:, 12:] = 103
    out = np.asarray(fxaa(jnp.asarray(img)))
    assert np.array_equal(out, img)
    assert CONTRAST_THRESHOLD == 0.0312 and RELATIVE_THRESHOLD == 0.063


def test_hard_edge_blended():
    """A hard vertical luminance edge must change interior edge pixels."""
    img = np.zeros((16, 24, 3), np.uint8)
    img[:, 12:] = 255
    out = np.asarray(fxaa(jnp.asarray(img)))
    interior = out[1:-1, 1:-1]
    src = img[1:-1, 1:-1]
    assert (interior != src).any()
    # blended values must lie between the two source levels
    assert out.min() >= 0 and out.max() <= 255


def test_border_rows_pass_through():
    """Image-border pixels are never modified (kernel.cu:330,399-402)."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (20, 32, 3)).astype(np.uint8)
    out = np.asarray(fxaa(jnp.asarray(img)))
    assert np.array_equal(out[0], img[0]) and np.array_equal(out[-1], img[-1])
    assert np.array_equal(out[:, 0], img[:, 0])
    assert np.array_equal(out[:, -1], img[:, -1])


def test_apply_fxaa_off_is_exact_passthrough():
    """alias=false → untouched copy (kernel.cu:275-278)."""
    rng = np.random.default_rng(3)
    img = jnp.asarray(rng.integers(0, 256, (16, 16, 3)).astype(np.uint8))
    out = np.asarray(apply_fxaa(img, jnp.bool_(False)))
    assert np.array_equal(out, np.asarray(img))


def test_horizontal_vs_vertical_edge_pick():
    """A horizontal edge blends from the vertical neighbors and vice versa."""
    imgh = np.zeros((16, 16, 3), np.uint8)
    imgh[8:] = 200
    outh = np.asarray(fxaa(jnp.asarray(imgh))).astype(int)
    # row 7 (above edge) should move toward the row below
    assert (outh[7, 1:-1] > imgh[7, 1:-1]).all()

    imgv = np.zeros((16, 16, 3), np.uint8)
    imgv[:, 8:] = 200
    outv = np.asarray(fxaa(jnp.asarray(imgv))).astype(int)
    assert (outv[1:-1, 7] > imgv[1:-1, 7]).all()

