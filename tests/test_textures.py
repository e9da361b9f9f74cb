"""Sky texture pipeline tests: blend weights, packing, sampling.

Pins the per-frame pre-blend (scene/textures.py blend_sky) to the reference's
per-ray truncating uchar blend (kernel.cu:158-162, structs.h:86-88) and the
packed-int32 gather path to the reference's point-sampled equirect lookup
(kernel.cu:156-163).
"""

import jax.numpy as jnp
import numpy as np

from raytracing_cuda_tpu.scene.textures import (
    blend_sky, pack_sky, procedural_skies, sample_sky, sample_sky_packed)


def test_blend_matches_truncating_uchar_reference():
    rng = np.random.default_rng(11)
    tex = rng.integers(0, 256, (4, 8, 16, 3)).astype(np.uint8)
    w = np.array([0.25, 0.25, 0.3, 0.2], np.float32)
    got = np.asarray(blend_sky(jnp.asarray(tex), jnp.asarray(w)))
    want = sum((tex[i].astype(np.float32) * w[i]).astype(np.uint8)
               for i in range(4)).astype(np.uint8)
    assert np.array_equal(got, want)


def test_blend_pure_band_is_identity():
    tex = procedural_skies(16, 32)
    got = np.asarray(blend_sky(jnp.asarray(tex), jnp.asarray([0, 1, 0, 0], np.float32)))
    assert np.array_equal(got, tex[1])


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(5)
    blended = jnp.asarray(rng.integers(0, 256, (8, 16, 3)).astype(np.uint8))
    packed = pack_sky(blended)
    d = jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    a = np.asarray(sample_sky(blended, d, 0.3))
    b = np.asarray(sample_sky_packed(packed, 8, 16, d, 0.3))
    assert np.array_equal(a, b)


def test_sample_sky_day_rotation():
    """The sky rotates with the clock: x shifted by day fraction (kernel.cu:157)."""
    blended = jnp.asarray(
        (np.arange(32)[None, :, None] * np.ones((4, 1, 3)) * 8).astype(np.uint8))
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)   # atan2(0,1)=0 → x=0.5
    s0 = np.asarray(sample_sky(blended, d, 0.0))
    s_half = np.asarray(sample_sky(blended, d, 0.5))
    # half-day shift moves the lookup halfway around the panorama
    assert not np.array_equal(s0, s_half)


def test_sample_sky_poles_clamp():
    blended = jnp.asarray(np.zeros((8, 16, 3), np.uint8))
    for dy in (1.0, -1.0):
        d = jnp.asarray([[0.0, dy, 0.0]], jnp.float32)
        out = np.asarray(sample_sky(blended, d, 0.25))
        assert out.shape == (1, 3)  # no index error at the poles


def test_procedural_skies_deterministic():
    a = procedural_skies(16, 32)
    b = procedural_skies(16, 32)
    assert np.array_equal(a, b)
    assert a.shape == (4, 16, 32, 3) and a.dtype == np.uint8


def _smooth_dirs(h_img, w_img, outlier_frac=0.0, seed=3):
    """A primary-ray-like smooth direction field with optional incoherent
    outliers (stand-ins for divergent reflection misses at silhouettes)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-0.4, 0.5, h_img),
                         np.linspace(-0.9, 0.9, w_img), indexing="ij")
    d = np.stack([np.sin(xx), yy, np.cos(xx)], axis=-1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if outlier_frac:
        m = rng.random((h_img, w_img)) < outlier_frac
        r = rng.normal(size=(h_img, w_img, 3)).astype(np.float32)
        r /= np.linalg.norm(r, axis=-1, keepdims=True)
        d = np.where(m[..., None], r, d)
    return jnp.asarray(d)


def test_sky_static_init_shapes():
    from raytracing_cuda_tpu.scene.textures import pack_sky, sky_static_init

    tex = procedural_skies(64, 128)
    sp = np.asarray(sky_static_init(jnp.asarray(tex)))
    assert sp.shape == (4, 64 * 128) and sp.dtype == np.int32
    for i in range(4):
        assert np.array_equal(sp[i], np.asarray(pack_sky(jnp.asarray(tex[i]))))


def test_sky_blend_bands_picks_active_panoramas():
    """sky_blend_bands must recover the ≤2 nonzero weights of calc_sky_vars
    across the whole clock (pure bands, fades, the fade midpoint tie)."""
    from raytracing_cuda_tpu.scene.textures import sky_blend_bands
    from raytracing_cuda_tpu.sim.state import calc_sky_vars

    for day in (6.0, 7.9, 8.5, 9.0, 9.99, 14.0, 16.5, 17.0, 19.0, 21.3,
                23.0, 1.0, 4.4, 5.0, 5.9):
        sv = np.asarray(calc_sky_vars(day))
        ia, ib, wa, wb = (np.asarray(v) for v in sky_blend_bands(sv))
        w = np.zeros(4, np.float32)
        w[ia] += wa
        w[int(ib)] += wb
        assert np.allclose(w, sv, atol=0), f"day {day}: {w} vs {sv}"
        assert wa >= wb >= 0


def test_pair_resolve_bit_identical_to_preblended():
    """The static-stack pair lookup must be bit-identical to looking up a
    pre-blended pack — in pure bands (one-fetch branch) AND mid-fade
    (two-fetch truncated blend)."""
    from raytracing_cuda_tpu.scene.textures import (
        pack_sky, sample_sky_packed_pair, sky_static_init)

    rng = np.random.default_rng(21)
    H, W = 64, 128
    tex = rng.integers(0, 256, (4, H, W, 3)).astype(np.uint8)
    texj = jnp.asarray(tex)
    sp_flat = sky_static_init(texj)
    d = _smooth_dirs(32, 64, outlier_frac=0.02)
    for sv in ([0, 1, 0, 0], [0.25, 0.75, 0, 0], [0, 0, 0.95, 0.05],
               [0.5, 0, 0, 0.5]):
        svj = jnp.asarray(sv, jnp.float32)
        blended = blend_sky(texj, svj)
        ref_flat = np.asarray(sample_sky_packed(pack_sky(blended), H, W,
                                                d, 0.37))
        got_flat = np.asarray(sample_sky_packed_pair(sp_flat, H, W, d, 0.37,
                                                     svj))
        assert np.array_equal(got_flat, ref_flat), f"flat {sv}"
