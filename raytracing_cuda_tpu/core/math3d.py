"""3x3 rotation math and small vector helpers.

Equivalents of the reference's transforms.h:7-40 (trans, rotX/Y/Z)
and structs.h:54-101 float3 operators. Rotations are expressed as 3x3
matrices applied with matmul/einsum so batched camera/scene transforms map
onto XLA-fused vector ops. Works with both numpy (host-side scene building)
and jax.numpy (traced sim/render code): all functions dispatch on the array
namespace of their input.

The reference uses float32 storage with C double-precision libm cos/sin
rounded back to float; host-side (numpy) paths reproduce that by computing
trig in float64 and casting, while traced paths use float32 throughout.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# The reference's PI macro (scene.h:5, kernel.cu:12) — deliberately truncated.
PI = np.float32(3.141592)


def _xp(x):
    """Pick numpy for concrete ndarrays, jnp for traced values."""
    return np if isinstance(x, (np.ndarray, np.generic, float, int)) else jnp


def to_rad(angle):
    """Degrees → radians with the reference's truncated PI (scene.cpp:89-91)."""
    return (PI / np.float32(180.0)) * angle


def rot_y_matrix(a):
    """Rotation about +Y (transforms.h:15-22). Row-major 3x3, applied as M @ v."""
    xp = _xp(a)
    c, s = xp.cos(a), xp.sin(a)
    zero, one = xp.zeros_like(c), xp.ones_like(c)
    return xp.stack(
        [
            xp.stack([c, zero, s], -1),
            xp.stack([zero, one, zero], -1),
            xp.stack([-s, zero, c], -1),
        ],
        -2,
    )


def rot_x_matrix(a):
    """Rotation about +X (transforms.h:24-31)."""
    xp = _xp(a)
    c, s = xp.cos(a), xp.sin(a)
    zero, one = xp.zeros_like(c), xp.ones_like(c)
    return xp.stack(
        [
            xp.stack([one, zero, zero], -1),
            xp.stack([zero, c, -s], -1),
            xp.stack([zero, s, c], -1),
        ],
        -2,
    )


def rot_z_matrix(a):
    """Rotation about +Z (transforms.h:33-40)."""
    xp = _xp(a)
    c, s = xp.cos(a), xp.sin(a)
    zero, one = xp.zeros_like(c), xp.ones_like(c)
    return xp.stack(
        [
            xp.stack([c, -s, zero], -1),
            xp.stack([s, c, zero], -1),
            xp.stack([zero, zero, one], -1),
        ],
        -2,
    )


def rot_y(v, a):
    """rotY(vec, a) (transforms.h:15-22), componentwise.

    Written without matmul/einsum on purpose: matmuls may run at reduced
    default precision on an accelerator (TF32 on a GPU), and these
    3-vectors need exact float32.
    """
    xp = _xp(v)
    c, s = xp.cos(a), xp.sin(a)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return xp.stack([c * x + s * z, y + 0 * c, -s * x + c * z], -1)


def rot_x(v, a):
    """rotX (transforms.h:24-31), componentwise."""
    xp = _xp(v)
    c, s = xp.cos(a), xp.sin(a)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return xp.stack([x + 0 * c, c * y - s * z, s * y + c * z], -1)


def rot_z(v, a):
    """rotZ (transforms.h:33-40), componentwise."""
    xp = _xp(v)
    c, s = xp.cos(a), xp.sin(a)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return xp.stack([c * x - s * y, s * x + c * y, z + 0 * c], -1)


def dot(a, b, axis=-1):
    """float3 dot (structs.h:60-62), batched along the last axis."""
    xp = _xp(a)
    return xp.sum(a * b, axis=axis)


def cross(a, b):
    """float3 cross `^` (structs.h:69-71), batched along the last axis."""
    xp = _xp(a)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return xp.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def norm(v, axis=-1, keepdims=False):
    """float3 norm (structs.h:75-81)."""
    xp = _xp(v)
    return xp.sqrt(xp.sum(v * v, axis=axis, keepdims=keepdims))


def normalize(v):
    """float3 normalize (structs.h:82-84): v * (1/norm)."""
    return v * (1.0 / norm(v, keepdims=True))


def normalize_np64(v):
    """Host-side normalize matching C++ `v * (1.0/norm(v))` double math."""
    v = np.asarray(v, np.float64)
    n = np.sqrt(np.sum(np.float32(v) * np.float32(v)))
    return np.float32(v * (1.0 / n))
