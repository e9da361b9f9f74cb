"""Pytree data types for the renderer.

Struct-of-arrays re-design of the reference's AoS POD types (structs.h:8-51):
the unified `Object` (one struct per object, type-tagged union of
sphere/plane/triangle payloads in pos/size/third) becomes type-partitioned
compact arrays for vectorized intersection, plus global per-object attribute
arrays (indexed by the reference's 0..132 object order) for shading and
nearest-hit tie-breaking parity.

Object type codes follow the reference Primitive enum (structs.h:21-25):
0 = SPHERE, 1 = PLANE, 2 = TRIANGLE.
"""

from __future__ import annotations

from typing import NamedTuple

import jax

SPHERE, PLANE, TRIANGLE = 0, 1, 2

N_OBJECTS = 133  # OBJECTS_NUMBER, scene.h:11
N_LIGHTS = 2     # LIGHTS_NUMBER, scene.h:12


class Camera(NamedTuple):
    """Camera state (structs.h:8-19 minus derived fields).

    Angles are in degrees, like the reference (scene.cpp:165-173).
    """

    pos: jax.Array        # (3,)
    hor_angle: jax.Array  # scalar, degrees
    ver_angle: jax.Array  # scalar, degrees
    fov: jax.Array        # scalar, degrees (40)


class CameraRays(NamedTuple):
    """Derived frustum corner directions (cameraHelperAngles, scene.cpp:100-126)."""

    pos: jax.Array  # (3,)
    LD: jax.Array   # (3,) left-down corner ray
    RD: jax.Array   # (3,)
    LU: jax.Array   # (3,)
    RU: jax.Array   # (3,)


class Lights(NamedTuple):
    """Point lights (structs.h:46-51): sun at row 0, moon at row 1."""

    pos: jax.Array        # (2, 3)
    color: jax.Array      # (2, 3)
    intensity: jax.Array  # (2,)


class Scene(NamedTuple):
    """The full 133-object scene as struct-of-arrays.

    Global arrays are in the reference's construction order
    (initObjects, scene.cpp:444-488): 0 sea plane, 1-10 island triangles,
    11-32 snowman spheres, 33-80 tree triangles, 81-128 mountain triangles,
    129-130 igloo spheres, 131 sun sphere, 132 moon sphere.
    """

    # --- global per-object attributes, shape (N,) / (N,3) ---
    obj_type: jax.Array       # (N,) int32: SPHERE/PLANE/TRIANGLE
    color: jax.Array          # (N,3) f32 — rewritten per frame by recolor
    shine: jax.Array          # (N,) f32
    specular: jax.Array       # (N,) f32
    mirror: jax.Array         # (N,) f32
    is_light: jax.Array       # (N,) bool — emissive sun/moon proxies
    center: jax.Array         # (N,3) f32 sphere centers (zeros elsewhere)
    static_normal: jax.Array  # (N,3) f32 unit normals for tris/plane (zeros for spheres)

    # --- spheres, compact (S,) ---
    sph_gidx: jax.Array  # (S,) int32 global index of each sphere
    sph_pos: jax.Array   # (S,3)
    sph_r: jax.Array     # (S,)

    # --- triangles, compact (T,) ---
    tri_gidx: jax.Array  # (T,) int32
    tri_v0: jax.Array    # (T,3)
    tri_e1: jax.Array    # (T,3) v1 - v0
    tri_e2: jax.Array    # (T,3) v2 - v0

    # --- the single sea plane (global index 0) ---
    plane_pos: jax.Array     # (3,) — y component is the live sea level
    plane_normal: jax.Array  # (3,) = (0,1,0)

    # --- recolor masks (scene.cpp:40-42 vecTree/vecMount as boolean masks) ---
    tree_mask: jax.Array   # (N,) bool — island + tree-top triangles
    mount_mask: jax.Array  # (N,) bool — mountain triangles

    @property
    def n_spheres(self) -> int:
        return self.sph_pos.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.tri_v0.shape[0]


class SkyTextures(NamedTuple):
    """Equirectangular sky panoramas: morning/day/evening/night.

    texels is (4, H, W, 3) uint8 (alpha dropped — the reference's alpha channel
    is never displayed: rgbToInt packs alpha 0, kernel.cu:26-32).
    """

    texels: jax.Array  # (4, H, W, 3) uint8


# FrameState (the host state machine pytree) lives in sim.state alongside
# its step functions.
