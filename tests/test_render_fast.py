"""Fast path vs parity oracle: render.fast must reproduce render.reference.

The fast renderer restructures the math (linear-form intersections, deferred
sky gather, chunk early-exit) but computes the same function; frames must
agree except for borderline-epsilon pixels at geometric edges, where float
reassociation can flip a compare. We assert sub-quantum RMSE and a tiny
mismatched-pixel fraction across representative states.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_cuda_tpu.render.pipeline import render_frame
from raytracing_cuda_tpu.scene.builders import build_scene
from raytracing_cuda_tpu.scene.textures import procedural_skies
from raytracing_cuda_tpu.sim import state as sim
from raytracing_cuda_tpu.sim.actions import Action

H, W = 96, 160


@pytest.fixture(scope="module")
def scene():
    return build_scene()


@pytest.fixture(scope="module")
def sky():
    return jnp.asarray(procedural_skies(64, 128))


def _state(day=6.0, cam_preset=None, sea=None, aa=True):
    st = sim.init_state()._replace(day_time=jnp.float32(day))
    if sea is not None:
        st = st._replace(sea_y=jnp.float32(sea))
    if cam_preset is not None:
        st = sim.apply_controls(
            st, Action.idle()._replace(cam_preset=np.int32(cam_preset)), 0.0)
    return sim.settle(st._replace(aa=jnp.bool_(aa)))


CASES = [
    dict(day=6.0),                      # island, morning (init view)
    dict(day=14.0, cam_preset=1),       # mountains, day
    dict(day=1.0),                      # night: moon lit, sun under horizon
    dict(day=18.0, sea=2.0),            # evening, island submerged
    dict(day=9.0, aa=False),            # crossfade weights, FXAA off
]


@pytest.mark.parametrize("case", CASES)
def test_fast_matches_oracle(scene, sky, case):
    st = _state(**case)
    fast = np.asarray(
        render_frame(scene, st, sky, H, W, chunk=4096, path="fast"), np.float32)
    oracle = np.asarray(
        render_frame(scene, st, sky, H, W, chunk=4096, path="oracle"), np.float32)

    diff = np.abs(fast - oracle)
    rmse = np.sqrt(np.mean((diff / 255.0) ** 2))
    mismatched = np.mean(np.any(diff > 1.0, axis=-1))
    assert rmse < 2e-3, f"rmse {rmse}"
    assert mismatched < 0.003, f"{mismatched:.4%} pixels differ by >1 level"


def test_fast_chunk_invariance(scene, sky):
    """Chunk size (and thus early-exit grouping) must not change output."""
    st = _state(day=14.0)
    a = np.asarray(render_frame(scene, st, sky, H, W, chunk=1024, path="fast"))
    b = np.asarray(render_frame(scene, st, sky, H, W, chunk=H * W, path="fast"))
    assert np.array_equal(a, b)


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[3]])
def test_pallas_matches_oracle(scene, sky, case):
    """The GPU kernel (interpret mode on CPU) vs the parity oracle."""
    st = _state(**case)
    pall = np.asarray(
        render_frame(scene, st, sky, H, W, path="pallas_interpret"), np.float32)
    oracle = np.asarray(
        render_frame(scene, st, sky, H, W, chunk=4096, path="oracle"), np.float32)
    diff = np.abs(pall - oracle)
    rmse = np.sqrt(np.mean((diff / 255.0) ** 2))
    mismatched = np.mean(np.any(diff > 1.0, axis=-1))
    assert rmse < 2e-3, f"rmse {rmse}"
    assert mismatched < 0.003, f"{mismatched:.4%} pixels differ by >1 level"


def test_classic_scene_paths_agree(sky):
    """The classic demo scene renders identically across all paths."""
    from raytracing_cuda_tpu.core.types import Camera
    from raytracing_cuda_tpu.scene.builders import CLASSIC_CAMERA, build_classic_scene

    scene = build_classic_scene()
    cc = CLASSIC_CAMERA
    st = sim.settle(sim.init_state()._replace(
        day_time=jnp.float32(14.0),
        cam=Camera(pos=jnp.asarray(cc["pos"], jnp.float32),
                   hor_angle=jnp.float32(cc["hor_angle"]),
                   ver_angle=jnp.float32(cc["ver_angle"]),
                   fov=jnp.float32(cc["fov"]))))
    ref = np.asarray(render_frame(scene, st, sky, H, W, chunk=4096,
                                  path="oracle"), np.float32)
    for path in ("fast", "pallas_interpret"):
        img = np.asarray(render_frame(scene, st, sky, H, W, chunk=4096,
                                      path=path), np.float32)
        diff = np.abs(img - ref)
        assert np.sqrt(np.mean((diff / 255.0) ** 2)) < 2e-3, path


def test_pallas_clustered_matches_oracle(scene, sky):
    """Cluster-culled kernel (island partition) must match the oracle: the
    per-block bounding-sphere interval test is conservative, never
    changing which objects a ray can hit."""
    from raytracing_cuda_tpu.scene.builders import ISLAND_TRI_CLUSTERS

    for case in (CASES[0], CASES[1], CASES[3]):
        st = _state(**case)
        a = np.asarray(render_frame(scene, st, sky, H, W,
                                    path="pallas_interpret",
                                    tri_clusters=ISLAND_TRI_CLUSTERS), np.float32)
        b = np.asarray(render_frame(scene, st, sky, H, W, chunk=4096,
                                    path="oracle"), np.float32)
        diff = np.abs(a - b)
        assert np.sqrt(np.mean((diff / 255.0) ** 2)) < 2e-3


def test_pallas_random_states_match_oracle(scene, sky):
    """Seeded random camera poses / clock / sea levels: the kernel
    (interpret mode, full cluster culling) must track the oracle everywhere
    in state space, not just at the curated CASES."""
    from raytracing_cuda_tpu.core.types import Camera
    from raytracing_cuda_tpu.scene.builders import (ISLAND_SPH_CLUSTERS,
                                                    ISLAND_TRI_CLUSTERS)

    rng = np.random.default_rng(20260817)
    for _ in range(4):
        st = sim.init_state()._replace(
            cam=Camera(
                pos=jnp.asarray(rng.uniform((-60, 4, -60), (60, 40, 60)),
                                jnp.float32),
                # angles are DEGREES (scene.cpp:14-20): full yaw circle,
                # pitch across the reference's +/-44 deg clamp range
                hor_angle=jnp.float32(rng.uniform(0.0, 360.0)),
                ver_angle=jnp.float32(rng.uniform(-44.0, 44.0)),
                fov=jnp.float32(40.0)),
            day_time=jnp.float32(rng.uniform(0, 24)),
            sea_y=jnp.float32(rng.uniform(-6, 3)))
        st = sim.settle(st)
        pall = np.asarray(render_frame(
            scene, st, sky, H, W, path="pallas_interpret",
            tri_clusters=ISLAND_TRI_CLUSTERS,
            sph_clusters=ISLAND_SPH_CLUSTERS), np.float32)
        oracle = np.asarray(render_frame(scene, st, sky, H, W, chunk=4096,
                                         path="oracle"), np.float32)
        diff = np.abs(pall - oracle)
        rmse = np.sqrt(np.mean((diff / 255.0) ** 2))
        s = (float(st.cam.pos[0]), float(st.cam.pos[1]), float(st.cam.pos[2]),
             float(st.day_time), float(st.sea_y))
        assert rmse < 2e-3, f"state {s}: rmse {rmse}"


def test_fractional_specular_exponent_parity(scene, sky):
    """Specular exponents below 1 exercise power(0, e): any formulation
    that is not an exact power (e.g. exp2(e·log2(max(s, tiny)))) leaves a
    uniform glow for fractional e where the oracle's jnp.power(0, e) gives
    0. Pin it by rendering a scene with every specular exponent at 0.05
    and shine at 1.0 (such a glow is then ~8 levels — well above the
    gate; the island scene's own max shine of 0.05 would keep it
    sub-level)."""
    st = _state(day=14.0)
    frac = scene._replace(
        specular=jnp.full_like(scene.specular, 0.05),
        shine=jnp.full_like(scene.shine, 1.0))
    pall = np.asarray(render_frame(frac, st, sky, H, W,
                                   path="pallas_interpret"), np.float32)
    oracle = np.asarray(render_frame(frac, st, sky, H, W, chunk=4096,
                                     path="oracle"), np.float32)
    diff = np.abs(pall - oracle)
    rmse = np.sqrt(np.mean((diff / 255.0) ** 2))
    assert rmse < 2e-3, f"rmse {rmse}"


def _planes(scene, case, **kw):
    from raytracing_cuda_tpu.render.pallas_rt import render_base_planes_pallas

    st = _state(**case)
    scene_f, lights, ambient = sim.derive_frame(scene, st)
    rays = sim.camera_rays(st.cam, W / H)
    return [np.asarray(p) for p in render_base_planes_pallas(
        scene_f, lights, ambient, rays, H, W, interpret=True, **kw)]


def _assert_same(a, b, what):
    for pa, pb in zip(a, b):
        assert np.array_equal(pa, pb), what


def test_pallas_t_bound_identical(scene, sky):
    """The block culls (bounding-sphere interval test bounded by the
    farthest t the block still needs) are conservative, and the launch
    block only re-partitions per-pixel work: outputs must be bit-identical
    with culling on or off, for refined sub-bounds, and for another block
    shape, across hit-heavy and night states."""
    from raytracing_cuda_tpu.scene.builders import (ISLAND_SPH_CLUSTERS,
                                                    ISLAND_TRI_CLUSTERS,
                                                    ISLAND_TRI_SUBS)

    kw = dict(tri_clusters=ISLAND_TRI_CLUSTERS,
              sph_clusters=ISLAND_SPH_CLUSTERS)
    for case in (CASES[0], CASES[2]):
        a = _planes(scene, case, **kw)
        _assert_same(a, _planes(scene, case, cull=False, **kw), "cull")
        _assert_same(a, _planes(scene, case, t_subs=ISLAND_TRI_SUBS, **kw),
                     "t_subs")
        _assert_same(a, _planes(scene, case, block=(8, 32, 4), **kw),
                     "block")


def test_ablation_arms_semantics(scene, sky):
    """cull=False (every object of every cluster visited) is BIT-IDENTICAL
    to the shipped culled kernel — this gates every cull at once — for the
    island's cluster tables and for the unclustered whole-class default."""
    from raytracing_cuda_tpu.scene.builders import (ISLAND_SPH_CLUSTERS,
                                                    ISLAND_TRI_CLUSTERS)

    kw = dict(tri_clusters=ISLAND_TRI_CLUSTERS,
              sph_clusters=ISLAND_SPH_CLUSTERS)
    for case in (CASES[1], CASES[3]):
        _assert_same(_planes(scene, case, **kw),
                     _planes(scene, case, cull=False, **kw), case)
    _assert_same(_planes(scene, CASES[0]),
                 _planes(scene, CASES[0], cull=False), "unclustered")


def test_hcull_bit_identical(scene, sky):
    """Shadow sweeps stop once every lane that needs a light is occluded —
    which, with the sea plane tested first, skips every sweep for a light
    below the horizon. A pure skip: bit-identical to the cull-free kernel
    wherever it engages. Poses cover the sun below the horizon (day 6),
    the moon below (day 14), deep night, a raised sea with the island
    submerged (lanes AT the waterline), and a grazing light barely below
    the horizon (shadow rays too shallow for the plane test)."""
    from raytracing_cuda_tpu.scene.builders import (ISLAND_SPH_CLUSTERS,
                                                    ISLAND_TRI_CLUSTERS)

    kw = dict(tri_clusters=ISLAND_TRI_CLUSTERS,
              sph_clusters=ISLAND_SPH_CLUSTERS)
    for case in (CASES[0], CASES[1], CASES[2], CASES[3], dict(day=20.0115)):
        _assert_same(_planes(scene, case, **kw),
                     _planes(scene, case, cull=False, **kw), case)


def test_t_subs_requires_tri_clusters(scene):
    """t_subs without tri_clusters (or with the wrong arity) would misalign
    the sphere-cluster bound slots in the params vector — must raise, not
    silently unsound-cull."""
    from raytracing_cuda_tpu.render.pallas_rt import render_base_planes_pallas
    from raytracing_cuda_tpu.scene.builders import ISLAND_TRI_CLUSTERS

    st = sim.settle(sim.init_state())
    scene_f, lights, ambient = sim.derive_frame(scene, st)
    rays = sim.camera_rays(st.cam, W / H)
    with pytest.raises(ValueError, match="t_subs"):
        render_base_planes_pallas(scene_f, lights, ambient, rays, H, W,
                                  interpret=True, t_subs=(2,))
    with pytest.raises(ValueError, match="t_subs"):
        render_base_planes_pallas(scene_f, lights, ambient, rays, H, W,
                                  interpret=True,
                                  tri_clusters=ISLAND_TRI_CLUSTERS,
                                  t_subs=(2, 2))


def test_static_sky_grouped_matches_oracle(scene, sky):
    """The Engine's hot path (render_frame_static_sky: the static sky stack
    and its pair lookup) must match the oracle frame-for-frame, including
    across a sky crossfade (the two-fetch blend branch) and camera motion."""
    from raytracing_cuda_tpu.render.pipeline import render_frame_static_sky
    from raytracing_cuda_tpu.scene.builders import ISLAND_TRI_CLUSTERS
    from raytracing_cuda_tpu.scene.textures import sky_static_init

    sp = sky_static_init(sky)
    st = sim.settle(sim.init_state()._replace(day_time=jnp.float32(8.9)))
    for i in range(3):
        st = sim.animate(
            st, Action.idle()._replace(mouse_dx=np.float32(4.0 * i)),
            jnp.float32(0.25))  # big dt: crosses the 9-10h crossfade
        img = render_frame_static_sky(
            scene, st, sp, sky.shape[1], sky.shape[2], H, W,
            tri_clusters=ISLAND_TRI_CLUSTERS, interpret=True)
        ref = np.asarray(render_frame(scene, st, sky, H, W, chunk=4096,
                                      path="oracle"), np.float32)
        diff = np.abs(np.asarray(img, np.float32) - ref)
        rmse = np.sqrt(np.mean((diff / 255.0) ** 2))
        assert rmse < 2e-3, f"frame {i}: rmse {rmse}"


def test_engine_static_frame_wiring(scene, sky):
    """Engine.frame()/step_and_frame() on the static-sky kernel path
    (interpret mode on CPU): the render-only and fused-step entries must use
    the startup-packed sky stack and agree with the oracle."""
    from raytracing_cuda_tpu.app.loop import Engine
    from raytracing_cuda_tpu.utils.config import RenderConfig

    eng = Engine(RenderConfig(width=W, height=H, path="pallas_interpret",
                              sky_source="procedural",
                              procedural_sky_shape=(64, 128), chunk=4096))
    assert eng._sky_pack.shape == (4, 64 * 128)    # static sky stack

    img1 = np.asarray(eng.frame(), np.float32)       # render-only entry
    img2 = np.asarray(eng.frame(), np.float32)       # cache now warm
    assert np.array_equal(img1, img2)
    ref = np.asarray(render_frame(eng.scene, eng.state, eng.sky_texels,
                                  H, W, chunk=4096, path="oracle"), np.float32)
    diff = np.abs(img1 - ref)
    assert np.sqrt(np.mean((diff / 255.0) ** 2)) < 2e-3

    img3 = np.asarray(eng.step_and_frame(None, 1 / 60), np.float32)  # fused
    ref3 = np.asarray(render_frame(eng.scene, eng.state, eng.sky_texels,
                                   H, W, chunk=4096, path="oracle"), np.float32)
    diff = np.abs(img3 - ref3)
    assert np.sqrt(np.mean((diff / 255.0) ** 2)) < 2e-3
