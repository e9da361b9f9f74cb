"""Raytracing kernel for NVIDIA GPUs (Pallas, Triton route).

The counterpart of the reference's `raytracing` CUDA kernel
(kernel.cu:228-259, launched on a 32x32 grid at kernel.cu:455-458). Like
the original, every program keeps its rays in registers and walks the
object list with block-uniform scalar loads: the reference reads the scene
from `__constant__ objectsGPU[133]`, where a warp's threads all read one
object at a time and the constant cache broadcasts it; here the scene is one
(N_OBJ, N_CHANNELS) coefficient table in device memory whose rows are read
as scalars inside a `fori_loop` (the L1 cache broadcasts them the same way).

One program renders one (TH, TW) pixel block through the whole bounce loop:

  - primary rays come from frustum-corner interpolation (kernel.cu:244-253)
    at global row `row0 + i*TH + r`, so row-sharded bands reproduce the
    single-device rays exactly;
  - the nearest hit is a running lexicographic (t, object index) min kept in
    registers, matching the reference's strict-'<' scan (kernel.cu:144-151);
    the winner's attributes are then loaded by index;
  - objects are visited cluster by cluster; a cluster whose bounding sphere
    no live ray of the block can reach (interval arithmetic over the block's
    ray box, bounded by the farthest t the block still needs) is skipped
    with one block-uniform branch. The same culls bound the shadow sweeps,
    which also stop as soon as every lane that needs a light is occluded;
  - the bounce loop is a `while_loop` that exits when no lane of the block
    is still live (only mirror chains reach the deep levels);
  - misses record (throughput, direction); the equirect sky lookup
    (kernel.cu:156-163) runs once per pixel after the kernel, in XLA.

Outputs 7 (H, W) f32 planes: hit-path RGB, miss weight, miss direction xyz.
Intersection tests use the linear forms of ops.linear_forms (same
accept/reject logic as the reference); `interpret=True` runs the same kernel
on the CPU, which is how the tests check it against render.reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from raytracing_cuda_tpu.core.types import Lights, Scene

f32 = jnp.float32
i32 = jnp.int32

MAX_DEPTH = 4        # kernel.cu:11
BIG = 1e30           # finite stand-in for +inf (avoids inf-inf NaN traps)

# --- coefficient table channels (one row per object) ---
C_COL = 0            # 0-2 color rgb
C_SHINE = 3
C_SPEC = 4           # specular exponent
C_KR = 5             # mirror coefficient
C_EMIT = 6           # 1 for the emissive sun/moon proxies
C_SPH = 7            # 1 for spheres (shading normal from the center)
C_NORMAL = 8         # 8-10 static normal (plane/tris) or center (spheres)
C_GIDX = 11          # reference object index (f32-exact; tie-break key)
C_BLOCKS = 12        # occludes shadow rays (non-emissive), kernel.cu:188-193
C_POS2 = 13          # sphere |pos|^2
C_R2 = 14            # sphere r^2
C_CDET = 15          # 15-17 tri e2×e1
C_AU = 18            # 18-20 tri v0×e2
C_BU = 21            # 21-23 tri e2
C_AV = 24            # 24-26 tri e1×v0
C_BV = 27            # 27-29 tri e1
C_N = 30             # 30-32 tri e1×e2
C_V0N = 33           # tri v0·n
N_CHANNELS = 34

# --- params vector ---
P_CAMPOS = 0         # 0-2
P_LD = 3             # 3-5 frustum corners
P_RD = 6
P_LU = 9
P_RU = 12
P_LPOS0 = 15         # 15-17 light 0 position
P_LPOS1 = 18
P_LCOL0 = 21         # 21-23
P_LCOL1 = 24
P_LINT = 27          # 27-28 intensities
P_AMBIENT = 29       # 29-31
P_SEAY = 32          # sea plane height
P_ROW0 = 33          # global row offset of this band (f32-exact int)
N_PARAMS = 34

# --- cluster table columns: slot range, bounding sphere, shadow flag ---
K_START, K_END, K_CX, K_CY, K_CZ, K_R, K_OCCL = range(7)

# Launch block: (rows, cols, warps). Chosen by timing on the H100 at
# 1280x720 (PERF.md); every caller pads to multiples of BLOCK[:2].
BLOCK = (16, 16, 4)


def _round_up(x, m):
    return (x + m - 1) // m * m


def tri_sub_partition(tri_clusters, t_subs):
    """Refined triangle partition: t_subs[k] splits cluster k into that many
    equal consecutive parts, each culled on its own tighter bound."""
    if not t_subs:
        return tuple(tri_clusters)
    if len(t_subs) != len(tri_clusters):
        raise ValueError(f"t_subs {t_subs} must have one entry per tri "
                         f"cluster {tri_clusters}")
    out = []
    for cnt, m in zip(tri_clusters, t_subs):
        if cnt % m:
            raise ValueError(f"t_subs {m} must divide cluster count {cnt}")
        out.extend([cnt // m] * m)
    return tuple(out)


def _cluster_counts(scene: Scene, tri_clusters, sph_clusters, t_subs):
    """→ (tri counts, ((sphere count, occludes), ...)) covering the scene."""
    if t_subs and not tri_clusters:
        raise ValueError("t_subs requires tri_clusters")
    T, S = scene.n_triangles, scene.n_spheres
    tri = tri_sub_partition(tri_clusters, t_subs) if tri_clusters else (T,)
    sph = tuple((c, bool(o)) for c, o in sph_clusters) if sph_clusters \
        else ((S, True),)
    if sum(tri) != T or sum(c for c, _ in sph) != S:
        raise ValueError(f"clusters {tri}, {sph} do not cover {T} triangles "
                         f"and {S} spheres")
    return tri, sph


def pack_scene(scene: Scene):
    """Build the (1 + T + S, N_CHANNELS) coefficient table.

    Row 0 is the sea plane, then the triangles, then the spheres, each in
    the scene's order (clusters are contiguous row ranges). Runs inside jit
    each frame: colors, the sea level and the sun/moon proxies move.
    """
    T, S = scene.n_triangles, scene.n_spheres

    def col(v):
        v = jnp.asarray(v, f32)
        return v[:, None] if v.ndim == 1 else v

    def zeros(n, c):
        return jnp.zeros((n, c), f32)

    v0, e1, e2 = scene.tri_v0, scene.tri_e1, scene.tri_e2
    n = jnp.cross(e1, e2)
    tg = scene.tri_gidx
    tri_rows = jnp.concatenate([
        col(scene.color[tg]), col(scene.shine[tg]), col(scene.specular[tg]),
        col(scene.mirror[tg]), zeros(T, 2),                # emit, sph
        col(scene.static_normal[tg]), col(tg.astype(f32)),
        jnp.ones((T, 1), f32), zeros(T, 2),                # blocks, pos2, r2
        col(jnp.cross(e2, e1)), col(jnp.cross(v0, e2)), col(e2),
        col(jnp.cross(e1, v0)), col(e1), col(n),
        col(jnp.sum(v0 * n, axis=-1)),
    ], axis=1)

    sg = scene.sph_gidx
    pos = scene.sph_pos
    is_light = col(scene.is_light[sg].astype(f32))
    sph_rows = jnp.concatenate([
        col(scene.color[sg]), col(scene.shine[sg]), col(scene.specular[sg]),
        col(scene.mirror[sg]), is_light, jnp.ones((S, 1), f32),
        col(pos), col(sg.astype(f32)), 1.0 - is_light,
        col(jnp.sum(pos * pos, axis=-1)), col(scene.sph_r * scene.sph_r),
        zeros(S, N_CHANNELS - C_CDET),
    ], axis=1)

    pl_row = jnp.concatenate([
        col(scene.color[0:1]), col(scene.shine[0:1]), col(scene.specular[0:1]),
        col(scene.mirror[0:1]), zeros(1, 2),
        col(scene.plane_normal[None, :]), zeros(1, 1),     # gidx 0
        jnp.ones((1, 1), f32), zeros(1, N_CHANNELS - C_POS2),
    ], axis=1)
    return jnp.concatenate([pl_row, tri_rows, sph_rows], axis=0)


def cluster_table(scene: Scene, tri_clusters=None, sph_clusters=None,
                  t_subs=None):
    """→ ((K, 7) f32 table, number of triangle clusters).

    Row k: the cluster's slot range in pack_scene's table, a conservative
    bounding sphere (AABB center, radius to the farthest vertex or sphere
    surface plus float slack), and whether it casts shadows. Triangle
    clusters come first. Runs per frame: the sun/moon proxies move.
    """
    tri, sph = _cluster_counts(scene, tri_clusters, sph_clusters, t_subs)
    v0 = scene.tri_v0
    verts = (v0, v0 + scene.tri_e1, v0 + scene.tri_e2)
    rows = []
    off = 0
    for cnt in tri:
        vs = jnp.concatenate([v[off:off + cnt] for v in verts], axis=0)
        c = (jnp.min(vs, axis=0) + jnp.max(vs, axis=0)) * 0.5
        r = jnp.sqrt(jnp.max(jnp.sum((vs - c) ** 2, axis=-1))) * 1.001 + 0.01
        rows.append((1 + off, 1 + off + cnt, c, r, 1.0))
        off += cnt
    base = 1 + scene.n_triangles
    off = 0
    for cnt, occludes in sph:
        p = scene.sph_pos[off:off + cnt]
        c = (jnp.min(p, axis=0) + jnp.max(p, axis=0)) * 0.5
        r = (jnp.max(jnp.sqrt(jnp.sum((p - c) ** 2, axis=-1))
                     + scene.sph_r[off:off + cnt]) * 1.001 + 0.01)
        rows.append((base + off, base + off + cnt, c, r, float(occludes)))
        off += cnt
    table = jnp.stack([
        jnp.concatenate([jnp.asarray([lo, hi], f32), c, r[None],
                         jnp.asarray([occ], f32)])
        for lo, hi, c, r, occ in rows])
    return table, len(tri)


def pack_params(cam_rays, lights: Lights, ambient, sea_y, row0=0):
    segs = [cam_rays.pos, cam_rays.LD, cam_rays.RD, cam_rays.LU, cam_rays.RU,
            lights.pos[0], lights.pos[1], lights.color[0], lights.color[1],
            lights.intensity, ambient, sea_y, row0]
    return jnp.concatenate([jnp.asarray(v, f32).reshape(-1) for v in segs])


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------

def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize3(x, y, z):
    # v * (1/|v|) like core.math3d.normalize; the floor keeps lanes whose
    # vector is zero (dead lanes) finite
    inv = 1.0 / jnp.sqrt(jnp.maximum(x * x + y * y + z * z, 1e-30))
    return x * inv, y * inv, z * inv


def _any(mask):
    # Triton has no boolean reduction; reduce the mask as integers
    return jnp.max(mask.astype(i32)) > 0


def _ival_prod(alo, ahi, blo, bhi):
    """Interval product [alo,ahi]x[blo,bhi] → (lo, hi) (scalars)."""
    p1, p2, p3, p4 = alo * blo, alo * bhi, ahi * blo, ahi * bhi
    return (jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4)),
            jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4)))


def _cluster_possible(cx, cy, cz, r, obox, dbox, t_hi):
    """Sound block cull: can any ray with origin in obox and direction in
    dbox meet the bounding sphere (c, r) at t ≤ t_hi?

    Interval arithmetic over the geometric sphere test: possible iff the
    origin box may touch the sphere, or the sphere may lie ahead (tca_hi > 0)
    with squared miss distance possibly below r² and its near side before
    t_hi. Ignoring the correlation between |L|² and tca only widens the
    answer. Directions are unit vectors, so t is Euclidean distance.
    """
    (oxlo, oxhi, oylo, oyhi, ozlo, ozhi) = obox
    (dxlo, dxhi, dylo, dyhi, dzlo, dzhi) = dbox
    tlo = thi = ll_lo = None
    for llo, lhi, dlo, dhi in ((cx - oxhi, cx - oxlo, dxlo, dxhi),
                               (cy - oyhi, cy - oylo, dylo, dyhi),
                               (cz - ozhi, cz - ozlo, dzlo, dzhi)):
        plo, phi = _ival_prod(llo, lhi, dlo, dhi)
        comp = jnp.where((llo < 0) & (lhi > 0), 0.0,
                         jnp.minimum(llo * llo, lhi * lhi))
        if tlo is None:
            tlo, thi, ll_lo = plo, phi, comp
        else:
            tlo, thi, ll_lo = tlo + plo, thi + phi, ll_lo + comp
    r2 = r * r
    d2_lo = ll_lo - jnp.maximum(tlo * tlo, thi * thi)
    inside = ll_lo <= r2
    ahead = (thi > 0) & (d2_lo <= r2) & (tlo - r <= t_hi)
    return inside | ahead


def _box(mask, xs):
    """(lo, hi) of each plane over the lanes in mask."""
    out = ()
    for x in xs:
        out += (jnp.min(jnp.where(mask, x, BIG)),
                jnp.max(jnp.where(mask, x, -BIG)))
    return out


def _make_kernel(TH, TW, total_h, total_w, n_tri_cl, n_cl, cull):

    def kernel(p_ref, coef_ref, clu_ref,
               r_ref, g_ref, b_ref, mw_ref, mdx_ref, mdy_ref, mdz_ref):
        P = lambda k: p_ref[k]                               # noqa: E731
        C = lambda s, c: coef_ref[s, c]                      # noqa: E731
        sea_y = P(P_SEAY)

        def tri_t(s, o, d, m):
            """Triangle row s → (hit, t): det-scaled Möller-Trumbore
            (ops.linear_forms; epsilons per kernel.cu:95-126)."""
            ox, oy, oz = o
            dx, dy, dz = d
            mx, my, mz = m
            v = lambda c: (C(s, c), C(s, c + 1), C(s, c + 2))  # noqa: E731
            det = _dot3(dx, dy, dz, *v(C_CDET))
            u_det = _dot3(dx, dy, dz, *v(C_AU)) + _dot3(mx, my, mz, *v(C_BU))
            v_det = _dot3(dx, dy, dz, *v(C_AV)) - _dot3(mx, my, mz, *v(C_BV))
            t_det = _dot3(ox, oy, oz, *v(C_N)) - C(s, C_V0N)
            hit = ((det >= 0.001) & (u_det >= 0) & (v_det >= 0)
                   & (u_det + v_det <= det) & (t_det >= 0))
            return hit, t_det / jnp.where(hit, det, 1.0)

        def sph_t(s, o, d, od, oo):
            """Sphere row s → (hit, t), geometric test (kernel.cu:47-69)."""
            ox, oy, oz = o
            dx, dy, dz = d
            px, py, pz = C(s, C_NORMAL), C(s, C_NORMAL + 1), C(s, C_NORMAL + 2)
            tca = _dot3(dx, dy, dz, px, py, pz) - od
            d2 = C(s, C_POS2) - 2.0 * _dot3(ox, oy, oz, px, py, pz) + oo \
                - tca * tca
            r2 = C(s, C_R2)
            hit = (tca > 0) & (d2 < r2) & (d2 > -0.01)
            return hit, tca - jnp.sqrt(jnp.maximum(r2 - d2, 0.0))

        def plane_t(oy, dy):
            """Sea-plane t, BIG where missed (kernel.cu:71-94)."""
            t = (sea_y - oy) / dy
            return jnp.where((dy * dy > 0.00001) & (t >= 0), t, BIG)

        def sweep(k0, k1, obj_fn, possible, carry):
            """Visit clusters k0..k1-1; each cluster's objects run only when
            possible(k, carry) holds for the block."""
            def cluster(k, carry):
                lo = clu_ref[k, K_START].astype(i32)
                hi = clu_ref[k, K_END].astype(i32)
                if cull:
                    hi = jnp.where(possible(k, carry), hi, lo)
                return jax.lax.fori_loop(lo, hi, obj_fn, carry)
            return jax.lax.fori_loop(k0, k1, cluster, carry)

        def bound(k):
            return (clu_ref[k, K_CX], clu_ref[k, K_CY], clu_ref[k, K_CZ],
                    clu_ref[k, K_R])

        # --- primary rays (kernel.cu:244-253) ---
        row = P(P_ROW0) + (pl.program_id(0) * TH + jax.lax.broadcasted_iota(
            i32, (TH, TW), 0)).astype(f32)
        colm = (pl.program_id(1) * TW
                + jax.lax.broadcasted_iota(i32, (TH, TW), 1)).astype(f32)
        px = colm / f32(total_w - 1)
        py = row / f32(total_h - 1)
        vd = [P(P_LD + a) + (P(P_RD + a) - P(P_LD + a)) * px for a in range(3)]
        vu = [P(P_LU + a) + (P(P_RU + a) - P(P_LU + a)) * px for a in range(3)]
        dx, dy, dz = _normalize3(*[u - (u - w) * py for u, w in zip(vu, vd)])
        zeros = jnp.zeros((TH, TW), f32)
        ox, oy, oz = (zeros + P(P_CAMPOS + a) for a in range(3))

        def level(state):
            (k, ox, oy, oz, dx, dy, dz, thr, ra, ga, ba, live,
             mw, mdx, mdy, mdz) = state
            o, d = (ox, oy, oz), (dx, dy, dz)
            m = (oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx)
            od = _dot3(ox, oy, oz, dx, dy, dz)
            oo = _dot3(ox, oy, oz, ox, oy, oz)

            # --- nearest hit: the plane first, then the clusters ---
            t_pl = plane_t(oy, dy)
            best = (t_pl, jnp.where(t_pl < BIG, 0.0, BIG),
                    jnp.zeros((TH, TW), i32))
            obox = _box(live, o)
            dbox = _box(live, d)

            def possible(k, best):
                t_hi = jnp.max(jnp.where(live, best[0], 0.0))
                return _cluster_possible(*bound(k), obox, dbox, t_hi)

            def take(s, hit, t, best):
                bt, bg, bs = best
                g = C(s, C_GIDX)
                better = hit & ((t < bt) | ((t == bt) & (g < bg)))
                return (jnp.where(better, t, bt), jnp.where(better, g, bg),
                        jnp.where(better, s, bs))

            def tri_obj(s, best):
                return take(s, *tri_t(s, o, d, m), best)

            def sph_obj(s, best):
                return take(s, *sph_t(s, o, d, od, oo), best)

            best = sweep(0, n_tri_cl, tri_obj, possible, best)
            t_min, _, slot = sweep(n_tri_cl, n_cl, sph_obj, possible, best)
            hit = t_min < BIG
            attr = lambda c: coef_ref[slot, c]               # noqa: E731

            # --- miss → deferred sky (kernel.cu:154-163) ---
            miss = live & jnp.logical_not(hit)
            mw = jnp.where(miss, thr, mw)
            mdx = jnp.where(miss, dx, mdx)
            mdy = jnp.where(miss, dy, mdy)
            mdz = jnp.where(miss, dz, mdz)

            t_pos = jnp.where(hit, t_min, 0.0)
            hx, hy, hz = ox + dx * t_pos, oy + dy * t_pos, oz + dz * t_pos
            colr, colg, colb = attr(C_COL), attr(C_COL + 1), attr(C_COL + 2)
            shine, spec_e, kr = attr(C_SHINE), attr(C_SPEC), attr(C_KR)
            nvx, nvy, nvz = (attr(C_NORMAL), attr(C_NORMAL + 1),
                             attr(C_NORMAL + 2))
            is_sph = attr(C_SPH) > 0
            snx, sny, snz = _normalize3(hx - nvx, hy - nvy, hz - nvz)
            nx = jnp.where(is_sph, snx, nvx)
            ny = jnp.where(is_sph, sny, nvy)
            nz = jnp.where(is_sph, snz, nvz)

            # --- emissive sun/moon proxies (kernel.cu:169) ---
            emit = attr(C_EMIT) > 0
            lit = live & hit & emit
            ra = ra + jnp.where(lit, thr * colr, 0.0)
            ga = ga + jnp.where(lit, thr * colg, 0.0)
            ba = ba + jnp.where(lit, thr * colb, 0.0)

            # --- Phong with hard shadows (kernel.cu:172-206) ---
            shaded = live & hit & jnp.logical_not(emit)
            phr = colr * P(P_AMBIENT)
            phg = colg * P(P_AMBIENT + 1)
            phb = colb * P(P_AMBIENT + 2)
            for li, (lbase, cbase) in enumerate(((P_LPOS0, P_LCOL0),
                                                 (P_LPOS1, P_LCOL1))):
                lvx, lvy, lvz = (P(lbase) - hx, P(lbase + 1) - hy,
                                 P(lbase + 2) - hz)
                sdist = jnp.sqrt(_dot3(lvx, lvy, lvz, lvx, lvy, lvz))
                sdx, sdy, sdz = lvx / sdist, lvy / sdist, lvz / sdist
                angle = jnp.maximum(0.0, _dot3(nx, ny, nz, sdx, sdy, sdz))
                need = shaded & (angle > 0)

                so = (hx + sdx * 0.001, hy + sdy * 0.001, hz + sdz * 0.001)
                sd = (sdx, sdy, sdz)
                sm = (so[1] * sdz - so[2] * sdy, so[2] * sdx - so[0] * sdz,
                      so[0] * sdy - so[1] * sdx)
                sod = _dot3(*so, *sd)
                soo = _dot3(*so, *so)
                # occlusion is an OR: the plane goes first, and a cluster is
                # swept only while some needy lane is still unoccluded
                occ = need & (plane_t(so[1], sdy) < sdist)
                pend = need & jnp.logical_not(occ)
                hbox = _box(pend, so)
                sdbox = _box(pend, sd)
                t_hi_s = jnp.max(jnp.where(pend, sdist, 0.0))

                def s_possible(k, occ):
                    return (_any(need & jnp.logical_not(occ))
                            & (clu_ref[k, K_OCCL] > 0)
                            & _cluster_possible(*bound(k), hbox, sdbox,
                                                t_hi_s))

                def tri_occ(s, occ):
                    h, t = tri_t(s, so, sd, sm)
                    return occ | (h & (t < sdist))

                def sph_occ(s, occ):
                    h, t = sph_t(s, so, sd, sod, soo)
                    return occ | (h & (t < sdist) & (C(s, C_BLOCKS) > 0))

                occ = sweep(0, n_tri_cl, tri_occ, s_possible, occ)
                occ = sweep(n_tri_cl, n_cl, sph_occ, s_possible, occ)
                angle = jnp.where(occ, 0.0, angle)
                aint = angle * P(P_LINT + li)
                phr = phr + colr * P(cbase) * aint
                phg = phg + colg * P(cbase + 1) * aint
                phb = phb + colb * P(cbase + 2) * aint

                # Phong specular (kernel.cu:198-205): reflect -sdir
                ldn = -_dot3(nx, ny, nz, sdx, sdy, sdz)
                spx, spy, spz = _normalize3(-sdx - 2.0 * ldn * nx,
                                            -sdy - 2.0 * ldn * ny,
                                            -sdz - 2.0 * ldn * nz)
                sbase = jnp.maximum(0.0, -_dot3(spx, spy, spz, dx, dy, dz))
                spec = jnp.where(shine > 0,
                                 jnp.power(sbase, spec_e) * shine * angle, 0.0)
                phr, phg, phb = phr + spec, phg + spec, phb + spec

            w = jnp.where(shaded, thr * (1.0 - kr), 0.0)
            ra, ga, ba = ra + w * phr, ga + w * phg, ba + w * phb

            # --- mirror bounce (kernel.cu:209-218) ---
            ddn = _dot3(dx, dy, dz, nx, ny, nz)
            rx, ry, rz = _normalize3(dx - 2.0 * ddn * nx, dy - 2.0 * ddn * ny,
                                     dz - 2.0 * ddn * nz)
            bounce = shaded & (kr > 0)
            ox = jnp.where(bounce, hx + rx * 0.001, ox)
            oy = jnp.where(bounce, hy + ry * 0.001, oy)
            oz = jnp.where(bounce, hz + rz * 0.001, oz)
            dx = jnp.where(bounce, rx, dx)
            dy = jnp.where(bounce, ry, dy)
            dz = jnp.where(bounce, rz, dz)
            thr = jnp.where(bounce, thr * kr, thr)
            return (k + 1, ox, oy, oz, dx, dy, dz, thr, ra, ga, ba, bounce,
                    mw, mdx, mdy, mdz)

        def more(state):
            return (state[0] <= MAX_DEPTH) & _any(state[11])

        state = (jnp.int32(0), ox, oy, oz, dx, dy, dz, zeros + 1.0,
                 zeros, zeros, zeros, jnp.full((TH, TW), True),
                 zeros, dx, dy, dz)
        state = jax.lax.while_loop(more, level, state)
        for ref, v in zip((r_ref, g_ref, b_ref, mw_ref, mdx_ref, mdy_ref,
                           mdz_ref), state[8:11] + state[12:]):
            ref[...] = v

    return kernel


@functools.partial(jax.jit, static_argnames=(
    "height", "width", "total_h", "total_w", "n_tri_cl", "block",
    "interpret", "cull"))
def raytrace_planes(coef, table, params, *, height: int, width: int,
                    total_h: int, total_w: int, n_tri_cl: int,
                    block: tuple = BLOCK, interpret: bool = False,
                    cull: bool = True):
    """Kernel launch over a (height, width) framebuffer that is a multiple
    of block[:2] → 7 (height, width) f32 planes."""
    TH, TW, warps = block
    if height % TH or width % TW:
        raise ValueError(f"{height}x{width} is not a multiple of the "
                         f"{TH}x{TW} block")
    kernel = _make_kernel(TH, TW, total_h, total_w, n_tri_cl,
                          table.shape[0], cull)
    whole = lambda a: pl.BlockSpec(a.shape, lambda i, j: (0,) * a.ndim)  # noqa: E731
    plane = jax.ShapeDtypeStruct((height, width), f32)
    return pl.pallas_call(
        kernel,
        grid=(height // TH, width // TW),
        in_specs=[whole(params), whole(coef), whole(table)],
        out_specs=tuple(pl.BlockSpec((TH, TW), lambda i, j: (i, j))
                        for _ in range(7)),
        out_shape=(plane,) * 7,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=warps, num_stages=1),
        interpret=interpret,
        name="raytrace",
    )(params, coef, table)


def render_base_planes_pallas(scene: Scene, lights: Lights, ambient, cam_rays,
                              height: int, width: int,
                              interpret: bool = False,
                              tri_clusters: tuple | None = None,
                              sph_clusters: tuple | None = None,
                              row0=0, total_height: int | None = None,
                              t_subs: tuple | None = None,
                              block: tuple = BLOCK, cull: bool = True):
    """Scene → coefficient table + cluster table → kernel → 7 planes.

    tri_clusters: static partition of the triangle list into contiguous
    counts (e.g. island box / trees / mountain pairs), refined by t_subs;
    sph_clusters: ((count, casts_shadows), ...) over the sphere list. None
    makes each class one cluster. row0 may be traced (it rides the params
    vector), so every row band of a sharded frame runs one compiled kernel.
    The framebuffer is padded to the block and cropped; the padded rays are
    harmless. cull=False visits every object (tests pin it equal).
    """
    table, n_tri_cl = cluster_table(scene, tri_clusters, sph_clusters, t_subs)
    params = pack_params(cam_rays, lights, ambient, scene.plane_pos[1], row0)
    h_pad, w_pad = _round_up(height, block[0]), _round_up(width, block[1])
    planes = raytrace_planes(
        pack_scene(scene), table, params, height=h_pad, width=w_pad,
        total_h=total_height if total_height is not None else height,
        total_w=width, n_tri_cl=n_tri_cl, block=block, interpret=interpret,
        cull=cull)
    if (h_pad, w_pad) != (height, width):
        planes = tuple(p[:height, :width] for p in planes)
    return planes
