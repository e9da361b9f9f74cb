"""Multi-chip sharding tests on the virtual 8-device CPU mesh (SURVEY.md §4).

The row-sharded renderer must be bit-identical to the single-chip one: ray
generation is positioned by global row and FXAA's halo rows arrive over the
mesh (lax.ppermute) instead of local padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_cuda_tpu.parallel.mesh import make_mesh, render_frame_sharded
from raytracing_cuda_tpu.render.pipeline import render_frame
from raytracing_cuda_tpu.scene.builders import build_scene
from raytracing_cuda_tpu.scene.textures import procedural_skies
from raytracing_cuda_tpu.sim import state as sim

H, W = 64, 128


@pytest.fixture(scope="module")
def setup():
    scene = build_scene()
    sky = jnp.asarray(procedural_skies(32, 64))
    st = sim.settle(sim.init_state())
    return scene, sky, st


def test_eight_device_mesh_available():
    assert jax.device_count() >= 8, "conftest must force 8 virtual CPU devices"


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_matches_single_chip(setup, n):
    scene, sky, st = setup
    mesh = make_mesh(n)
    single = np.asarray(render_frame(scene, st, sky, H, W, chunk=4096, path="fast"))
    sharded = np.asarray(render_frame_sharded(
        scene, st, sky, mesh=mesh, height=H, width=W, chunk=2048))
    assert np.array_equal(single, sharded), (
        f"{(single != sharded).any(-1).mean():.4%} pixels differ on {n} devices")


def test_sharded_fxaa_off(setup):
    scene, sky, st = setup
    st = st._replace(aa=jnp.bool_(False))
    mesh = make_mesh(4)
    single = np.asarray(render_frame(scene, st, sky, H, W, chunk=4096, path="fast"))
    sharded = np.asarray(render_frame_sharded(
        scene, st, sky, mesh=mesh, height=H, width=W, chunk=2048))
    assert np.array_equal(single, sharded)


def test_indivisible_height_raises(setup):
    scene, sky, st = setup
    mesh = make_mesh(8)
    with pytest.raises(ValueError):
        render_frame_sharded(scene, st, sky, mesh=mesh, height=60, width=W)


def test_sharded_pallas_matches_single_chip(setup):
    """The kernel inside shard_map: band-offset ray generation must make the
    sharded render bit-identical to the single-device render of the SAME
    pipeline (static sky stack + pair lookup)."""
    scene, sky, st = setup
    from raytracing_cuda_tpu.render.pipeline import render_frame_static_sky
    from raytracing_cuda_tpu.scene.builders import ISLAND_TRI_CLUSTERS
    from raytracing_cuda_tpu.scene.textures import sky_static_init

    mesh = make_mesh(4)
    sp = sky_static_init(sky)
    single = render_frame_static_sky(
        scene, st, sp, sky.shape[1], sky.shape[2], H, W,
        tri_clusters=ISLAND_TRI_CLUSTERS, interpret=True)
    sharded = np.asarray(render_frame_sharded(
        scene, st, sky, mesh=mesh, height=H, width=W,
        path="pallas_interpret", tri_clusters=ISLAND_TRI_CLUSTERS,
        sky_pack=sp))
    assert np.array_equal(np.asarray(single), sharded)

    # and the per-frame-blend single-device render agrees within the gate
    flat = np.asarray(render_frame(
        scene, st, sky, H, W, path="pallas_interpret",
        tri_clusters=ISLAND_TRI_CLUSTERS), np.float32)
    diff = np.abs(flat - sharded.astype(np.float32))
    assert np.sqrt(np.mean((diff / 255.0) ** 2)) < 2e-3


def test_sharded_pallas_requires_sky_pack(setup):
    scene, sky, st = setup
    with pytest.raises(ValueError, match="sky_pack"):
        render_frame_sharded(scene, st, sky, mesh=make_mesh(2), height=H,
                             width=W, path="pallas_interpret")


def test_sharded_wide_frame_16_group_parity(setup):
    """A wide, short frame (16x512, several kernel blocks per row band):
    the sharded render stays bit-identical to the single-device one, and
    both match the oracle."""
    scene, sky, st = setup
    from raytracing_cuda_tpu.render.pipeline import render_frame_static_sky
    from raytracing_cuda_tpu.scene.builders import ISLAND_TRI_CLUSTERS
    from raytracing_cuda_tpu.scene.textures import sky_static_init

    WH, WW = 16, 512
    mesh = make_mesh(2)
    sp = sky_static_init(sky)
    single = render_frame_static_sky(
        scene, st, sp, sky.shape[1], sky.shape[2], WH, WW,
        tri_clusters=ISLAND_TRI_CLUSTERS, interpret=True)
    sharded = np.asarray(render_frame_sharded(
        scene, st, sky, mesh=mesh, height=WH, width=WW,
        path="pallas_interpret", tri_clusters=ISLAND_TRI_CLUSTERS,
        sky_pack=sp))
    assert np.array_equal(np.asarray(single), sharded)

    oracle = np.asarray(render_frame(scene, st, sky, WH, WW, chunk=4096,
                                     path="oracle"), np.float32)
    diff = np.abs(np.asarray(single, np.float32) - oracle)
    assert np.sqrt(np.mean((diff / 255.0) ** 2)) < 2e-3


def test_sharded_static_sky_repeatable_and_traces_one_kernel(setup):
    """Static-sky sharded render: deterministic across calls (the static
    pack is read-only state) and the whole sharded program contains exactly
    ONE pallas_call (row0 rides the params vector — no per-band kernel
    variants)."""
    scene, sky, st = setup
    from raytracing_cuda_tpu.scene.builders import ISLAND_TRI_CLUSTERS
    from raytracing_cuda_tpu.scene.textures import sky_static_init

    mesh = make_mesh(4)
    sp = sky_static_init(sky)
    kw = dict(mesh=mesh, height=H, width=W, path="pallas_interpret",
              tri_clusters=ISLAND_TRI_CLUSTERS, sky_pack=sp)
    img1 = np.asarray(render_frame_sharded(scene, st, sky, **kw))
    img2 = np.asarray(render_frame_sharded(scene, st, sky, **kw))
    assert np.array_equal(img1, img2)

    jaxpr = jax.make_jaxpr(
        lambda sc, s, sk, p: render_frame_sharded(
            sc, s, sk, mesh=mesh, height=H, width=W,
            path="pallas_interpret", tri_clusters=ISLAND_TRI_CLUSTERS,
            sky_pack=p))(scene, st, sky, sp)
    assert str(jaxpr).count("pallas_call") == 1


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_interleaved_bit_parity_fast(setup, k):
    """Strided sub-band assignment (device d renders chunks d, d+n, …) must
    be bit-identical to the contiguous-band and single-chip renders — the
    un-interleave reshape, per-chunk ray offsets and the slot-shifted wrap
    halos all have to line up exactly."""
    scene, sky, st = setup
    mesh = make_mesh(4)
    single = np.asarray(render_frame(scene, st, sky, H, W, chunk=4096,
                                     path="fast"))
    strided = np.asarray(render_frame_sharded(
        scene, st, sky, mesh=mesh, height=H, width=W, chunk=2048,
        interleave=k))
    assert np.array_equal(single, strided), (
        f"{(single != strided).any(-1).mean():.4%} pixels differ "
        f"(interleave={k})")


def test_sharded_interleaved_bit_parity_pallas(setup):
    scene, sky, st = setup
    from raytracing_cuda_tpu.render.pipeline import render_frame_static_sky
    from raytracing_cuda_tpu.scene.builders import ISLAND_TRI_CLUSTERS
    from raytracing_cuda_tpu.scene.textures import sky_static_init

    mesh = make_mesh(4)
    sp = sky_static_init(sky)
    single = render_frame_static_sky(
        scene, st, sp, sky.shape[1], sky.shape[2], H, W,
        tri_clusters=ISLAND_TRI_CLUSTERS, interpret=True)
    strided = np.asarray(render_frame_sharded(
        scene, st, sky, mesh=mesh, height=H, width=W,
        path="pallas_interpret", tri_clusters=ISLAND_TRI_CLUSTERS,
        sky_pack=sp, interleave=2))
    assert np.array_equal(np.asarray(single), strided)


def test_sharded_interleave_indivisible_raises(setup):
    scene, sky, st = setup
    with pytest.raises(ValueError, match="interleave"):
        render_frame_sharded(scene, st, sky, mesh=make_mesh(4), height=H,
                             width=W, interleave=3)   # 64 % 12 != 0


def test_engine_sharded_multiframe_matches_single_chip():
    """Engine(sharded=True) stepping several frames — including across the
    9-10 h sky crossfade — must produce bit-identical frames to the
    single-chip engine fed the same actions (VERDICT r2 #5a)."""
    import jax.numpy as jnp

    from raytracing_cuda_tpu.app.loop import Engine
    from raytracing_cuda_tpu.sim.actions import Action
    from raytracing_cuda_tpu.utils.config import RenderConfig

    cfg = RenderConfig(width=128, height=64, sky_source="procedural",
                       procedural_sky_shape=(32, 64),
                       path="pallas_interpret", chunk=2048)
    eng_m = Engine(cfg, sharded=True)
    eng_s = Engine(cfg)
    st0 = sim.settle(sim.init_state()._replace(day_time=jnp.float32(8.95)))
    eng_m.set_state(st0)
    eng_s.set_state(st0)
    act = Action.idle()._replace(mouse_dx=np.float32(3.0))
    for i in range(3):
        a = np.asarray(eng_m.step_and_frame(act, 0.25))  # dt crosses the fade
        b = np.asarray(eng_s.step_and_frame(act, 0.25))
        assert np.array_equal(a, b), f"frame {i} diverged"


def test_engine_sharded_interleave_matches_contiguous():
    """RenderConfig.shard_interleave plumbs through the Engine and matches
    the contiguous-band engine bit-for-bit."""
    import dataclasses

    from raytracing_cuda_tpu.app.loop import Engine
    from raytracing_cuda_tpu.utils.config import RenderConfig

    cfg = RenderConfig(width=128, height=64, sky_source="procedural",
                       procedural_sky_shape=(32, 64),
                       path="pallas_interpret", chunk=2048)
    a = Engine(cfg, sharded=True).frame_np()
    b = Engine(dataclasses.replace(cfg, shard_interleave=2),
               sharded=True).frame_np()
    assert np.array_equal(a, b)


def test_engine_sharded_static_fused_step():
    """Engine(sharded=True) on the pallas path: frame() and the fused
    step_and_frame/batch run through the mesh with the static sky stack."""
    from raytracing_cuda_tpu.app.loop import Engine
    from raytracing_cuda_tpu.sim.actions import Action
    from raytracing_cuda_tpu.utils.config import RenderConfig

    eng = Engine(RenderConfig(width=128, height=64, sky_source="procedural",
                              procedural_sky_shape=(32, 64),
                              path="pallas_interpret", chunk=2048),
                 sharded=True)
    img = eng.frame_np()
    assert img.shape == (64, 128, 3) and img.dtype == np.uint8
    img2 = np.asarray(eng.step_and_frame(Action.idle(), 1 / 60))
    assert img2.shape == (64, 128, 3)
    imgs = np.asarray(eng.step_and_frame_batch([Action.idle()] * 2))
    assert imgs.shape == (2, 64, 128, 3)


def test_engine_sharded_smoke():
    """Engine(sharded=True) renders through the mesh path end-to-end."""
    from raytracing_cuda_tpu.app.loop import Engine
    from raytracing_cuda_tpu.utils.config import RenderConfig

    eng = Engine(RenderConfig(width=128, height=64, sky_source="procedural",
                              procedural_sky_shape=(32, 64), path="fast",
                              chunk=2048), sharded=True)
    img = eng.frame_np()
    assert img.shape == (64, 128, 3) and img.dtype == np.uint8


def test_engine_sharded_single_device_degrades_with_warning(monkeypatch):
    """sharded=True on a 1-device backend must degrade to single-chip:
    shard_interleave is unused there, so a non-dividing interleave gets a
    warning, NOT the mesh-divisibility ValueError (which once fired against
    a mesh the render path never uses)."""
    import warnings

    from raytracing_cuda_tpu.app import loop as L
    from raytracing_cuda_tpu.parallel.mesh import make_mesh
    from raytracing_cuda_tpu.utils.config import RenderConfig

    monkeypatch.setattr(L, "make_mesh", lambda: make_mesh(1))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        eng = L.Engine(RenderConfig(width=128, height=64,
                                    sky_source="procedural",
                                    procedural_sky_shape=(32, 64),
                                    path="fast", chunk=2048,
                                    shard_interleave=7), sharded=True)
    assert any("shard_interleave" in str(w.message) for w in rec)
    img = eng.frame_np()
    assert img.shape == (64, 128, 3)


def test_render_script_dp_matches_engine_frames():
    """Frame-data-parallel offline rendering (parallel/frames.py): frames
    sharded over the mesh must be bit-identical to stepping the single-chip
    engine frame by frame — same state machine, same per-frame program.
    Initial state sits mid-fade (day 8.5) so the pair resolve's two-gather
    branch is exercised, and the clock plays so every frame differs."""
    import jax.numpy as jnp

    from raytracing_cuda_tpu.app.loop import Engine
    from raytracing_cuda_tpu.parallel.frames import (make_frames_mesh,
                                                     render_script_dp)
    from raytracing_cuda_tpu.sim import state as sim
    from raytracing_cuda_tpu.sim.actions import Action
    from raytracing_cuda_tpu.utils.config import RenderConfig

    eng = Engine(RenderConfig(width=128, height=64, sky_source="procedural",
                              procedural_sky_shape=(32, 64),
                              path="pallas_interpret", chunk=2048))
    eng.state = sim.settle(sim.init_state()._replace(
        day_time=jnp.float32(8.5)))
    st0 = eng.state
    K = 8
    avs = jnp.stack([Action.idle().pack(1 / 30)] * K)

    seq = np.stack([np.asarray(eng.step_and_frame(Action.idle(), 1 / 30))
                    for _ in range(K)])

    sh, sw = eng.sky_texels.shape[1], eng.sky_texels.shape[2]
    for n_dev in (4, 8):
        imgs, last = render_script_dp(
            eng.scene, st0, eng._sky_pack, avs,
            mesh=make_frames_mesh(n_dev), sky_h=sh, sky_w=sw,
            height=64, width=128, tri_clusters=eng.tri_clusters,
            sph_clusters=eng.sph_clusters, interpret=True,
            t_subs=eng.tri_subs)
        assert np.array_equal(np.asarray(imgs), seq), n_dev
    assert np.allclose(float(last.day_time), float(eng.state.day_time))

    with pytest.raises(ValueError, match="divisible"):
        render_script_dp(eng.scene, st0, eng._sky_pack, avs[:6],
                         mesh=make_frames_mesh(4), sky_h=sh, sky_w=sw,
                         height=64, width=128, interpret=True)

    # hybrid 2-D (frames, rows) composition: frame DP around the row-
    # sharded band renderer in one program — still bit-identical. (2, 4)
    # covers contiguous bands; (4, 2) with interleave=2 covers strided
    # sub-bands (the slot-shifted wrap halos) under the frame axis.
    from raytracing_cuda_tpu.parallel.frames import (make_hybrid_mesh,
                                                     render_script_hybrid)

    for nf, nr, il in ((2, 4, 1), (4, 2, 2)):
        imgs, last = render_script_hybrid(
            eng.scene, st0, eng._sky_pack, avs,
            mesh=make_hybrid_mesh(nf, nr), sky_h=sh, sky_w=sw,
            height=64, width=128, tri_clusters=eng.tri_clusters,
            sph_clusters=eng.sph_clusters, interpret=True,
            t_subs=eng.tri_subs, interleave=il)
        assert np.array_equal(np.asarray(imgs), seq), (nf, nr, il)
        assert np.allclose(float(last.day_time), float(eng.state.day_time))

    with pytest.raises(ValueError, match="devices"):
        make_hybrid_mesh(8, 2)

    # Engine-level hybrid plumbing (render_script_dp n_rows>1): device-count
    # default and interleave forwarding. Fresh engine so its state starts
    # at st0.
    from raytracing_cuda_tpu.utils.config import RenderConfig as RC

    e2 = Engine(RC(width=128, height=64, sky_source="procedural",
                   procedural_sky_shape=(32, 64), path="pallas_interpret",
                   chunk=2048, shard_interleave=2))
    e2.set_state(st0)
    imgs = np.asarray(e2.render_script_dp(avs[:4], 2, n_rows=2))
    assert np.array_equal(imgs, seq[:4])
