"""Scene construction parity with initObjects (scene.cpp:444-488)."""

import numpy as np

from raytracing_cuda_tpu.core.types import N_OBJECTS, PLANE, SPHERE, TRIANGLE
from raytracing_cuda_tpu.scene.builders import build_scene, init_lights


def test_object_count(scene):
    assert scene.obj_type.shape == (N_OBJECTS,)


def test_type_census(scene):
    # 1 plane + 106 triangles (10 island + 48 tree + 48 mountain)
    # + 26 spheres (22 snowman + 2 igloo + 2 light proxies)
    assert int(np.sum(scene.obj_type == PLANE)) == 1
    assert int(np.sum(scene.obj_type == TRIANGLE)) == 106
    assert int(np.sum(scene.obj_type == SPHERE)) == 26


def test_global_order(scene):
    # reference construction order: plane 0, island 1-10, snowmen 11-32,
    # trees 33-80, mountains 81-128, igloo 129-130, sun 131, moon 132
    assert scene.obj_type[0] == PLANE
    assert np.all(scene.obj_type[1:11] == TRIANGLE)
    assert np.all(scene.obj_type[11:33] == SPHERE)
    assert np.all(scene.obj_type[33:81] == TRIANGLE)
    assert np.all(scene.obj_type[81:129] == TRIANGLE)
    assert np.all(scene.obj_type[129:133] == SPHERE)


def test_recolor_masks(scene):
    # vecTree = 10 island + 6 trees x 4 top tris = 34; vecMount = 12 x 4 = 48
    assert int(np.sum(scene.tree_mask)) == 34
    assert int(np.sum(scene.mount_mask)) == 48
    assert not scene.tree_mask[0] and not scene.mount_mask[0]
    assert np.all(scene.tree_mask[1:11])          # island
    assert np.all(scene.mount_mask[81:129])       # mountains


def test_lights_and_emissives(scene):
    assert int(np.sum(scene.is_light)) == 2
    assert scene.is_light[131] and scene.is_light[132]
    np.testing.assert_allclose(scene.color[131], [1, 0.8, 0.05], rtol=1e-6)
    np.testing.assert_allclose(scene.color[132], [0.9, 0.9, 1.0], rtol=1e-6)
    np.testing.assert_allclose(scene.sph_r[-2:], [50, 50])


def test_ground_plane(scene):
    # createGround (scene.cpp:326-336)
    np.testing.assert_allclose(scene.plane_pos, [0, -4.5, 0])
    np.testing.assert_allclose(scene.plane_normal, [0, 1, 0])
    assert scene.mirror[0] == np.float32(0.6)
    assert scene.specular[0] == 256
    assert scene.shine[0] == 0
    np.testing.assert_allclose(scene.color[0], np.float32([0, 0, 30]) / 255, rtol=1e-6)


def test_island_geometry(scene):
    # island top face at y = -4, bottom at y = -6 (offset (0,-4,0), depth d=2),
    # spanning ±25 in x/z (size 50 centered)
    island_v0 = scene.tri_v0[:10]
    ys = np.concatenate([island_v0[:, 1],
                         (island_v0 + scene.tri_e1[:10])[:, 1],
                         (island_v0 + scene.tri_e2[:10])[:, 1]])
    assert set(np.unique(ys)) == {-6.0, -4.0}
    xs = np.concatenate([island_v0[:, 0], (island_v0 + scene.tri_e1[:10])[:, 0]])
    assert xs.min() == -25.0 and xs.max() == 25.0


def test_snowman_head(scene):
    # second snowman sphere is the head: radius 1.3 at offset + (0,3,0)
    assert scene.sph_r[1] == np.float32(1.3)
    np.testing.assert_allclose(scene.sph_pos[1], [-4, 1, 17], atol=1e-5)


def test_mountain_positions(scene):
    # first mountain pyramid: offset (170,-4.5,0)*4 = (680,-18,0), size 400,
    # apex height t=0.5 of height=1.5*size=600 → apex y = -18 + 300.
    # triangle-compact layout: island 0-9, trees 10-57, mountains 58-105
    m = slice(58, 62)
    v0 = scene.tri_v0[m]
    apex_y = max((v0 + scene.tri_e1[m])[:, 1].max(),
                 (v0 + scene.tri_e2[m])[:, 1].max())
    assert np.isclose(apex_y, -18.0 + 300.0, atol=0.5)
    # base vertices sit at the offset height
    assert np.isclose(v0[:, 1].min(), -18.0, atol=1e-4)


def test_initial_lights():
    lights = init_lights()
    np.testing.assert_allclose(lights.pos, [[-1000, 1000, 1000]] * 2)
    np.testing.assert_allclose(lights.intensity, [1, 1])


def test_triangle_normals_unit(scene):
    n = scene.static_normal[scene.tri_gidx]
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)


def test_compact_consistency(scene):
    # compact sphere/tri arrays must mirror the global attribute arrays
    np.testing.assert_array_equal(scene.obj_type[scene.sph_gidx], SPHERE)
    np.testing.assert_array_equal(scene.obj_type[scene.tri_gidx], TRIANGLE)
    np.testing.assert_allclose(scene.center[scene.sph_gidx], scene.sph_pos)


def test_cluster_partitions_cover_scene_with_zero_padding(scene):
    """The static cluster tuples must tile the compact arrays exactly, and
    the kernel's cluster table must cover the coefficient table's object
    rows contiguously, with nothing left over and no padding rows."""
    from raytracing_cuda_tpu.render.pallas_rt import (K_END, K_OCCL, K_START,
                                                      cluster_table,
                                                      pack_scene)
    from raytracing_cuda_tpu.scene.builders import (ISLAND_SPH_CLUSTERS,
                                                    ISLAND_TRI_CLUSTERS,
                                                    ISLAND_TRI_SUBS)

    assert sum(ISLAND_TRI_CLUSTERS) == scene.tri_gidx.shape[0]
    assert sum(c for c, _ in ISLAND_SPH_CLUSTERS) == scene.sph_gidx.shape[0]
    # emissive sun/moon proxy cluster must stay shadow-inert and last
    assert ISLAND_SPH_CLUSTERS[-1] == (2, False)
    table, n_tri = cluster_table(scene, ISLAND_TRI_CLUSTERS,
                                 ISLAND_SPH_CLUSTERS, ISLAND_TRI_SUBS)
    table = np.asarray(table)
    assert n_tri == sum(ISLAND_TRI_SUBS)
    assert len(table) == n_tri + len(ISLAND_SPH_CLUSTERS)
    assert table[0, K_START] == 1                     # row 0 is the plane
    assert np.array_equal(table[1:, K_START], table[:-1, K_END])
    assert table[-1, K_END] == pack_scene(scene).shape[0]
    assert list(table[:, K_OCCL]) == [1.0] * (len(table) - 1) + [0.0]
