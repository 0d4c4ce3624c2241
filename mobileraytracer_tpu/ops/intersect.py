"""Ray-primitive intersection kernels (pure-JAX "Naive" accelerator).

This is the framework's correctness oracle, the analogue of the
reference's linear-scan accelerator (reference app/MobileRT/Accelerators/
Naive.hpp:85-94).  Every test is a dense vectorized op over a (B rays x N
primitives) tile, scanned in chunks so memory stays bounded; the BVH path
reuses the same per-primitive math.

Numeric conventions copied from the reference (epsilons, two-sided planes,
min-root spheres, Moller-Trumbore with t >= Epsilon) live here — image
parity depends on them:
 - triangles: app/MobileRT/Shapes/Triangle.cpp:63-109
 - spheres:   app/MobileRT/Shapes/Sphere.cpp:42-81 (EpsilonLarge cutoff)
 - planes:    app/MobileRT/Shapes/Plane.cpp:38-72
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import constants as C
from ..types import Hit, Lights, Planes, Scene, Spheres, Triangles, make_miss

_BIG = C.RAY_LENGTH_MAX
_CHUNK = 512  # primitives per scan step; bounds the (B, chunk) tile size
_SMALL = 32   # unroll threshold: component-wise loop beats (B, N, 3) tiles

# Layout note: for the scene tables that are always tiny (planes, spheres,
# lights; capacity <= 8 in every shipped scene) the closest-hit scans below
# unroll a Python loop over primitives with flat (B,) component math, which
# keeps a tiny trailing dimension out of every array.


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


# ---------------------------------------------------------------------------
# Per-primitive-type distance kernels.  Each returns the hit distance for
# every (ray, primitive) pair, with misses mapped to RAY_LENGTH_MAX.
# ---------------------------------------------------------------------------

def triangle_distances(o, d, point_a, ab, ac):
    """Moller-Trumbore over a (B, 3) ray batch and (N, 3) triangle SoA.

    Returns (t, u, v) each shaped (B, N).  Follows the reference's exact
    acceptance tests (Triangle.cpp:63-109): |det| >= Epsilon, 0 <= u <= 1,
    v >= 0, u + v <= 1, t >= Epsilon.
    """
    # p = d x AC : (B, N, 3)
    p = jnp.cross(d[:, None, :], ac[None, :, :])
    det = _dot(ab[None, :, :], p)                       # (B, N)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < C.EPSILON, 1.0, det)
    tvec = o[:, None, :] - point_a[None, :, :]          # (B, N, 3)
    u = inv_det * _dot(tvec, p)
    q = jnp.cross(tvec, ab[None, :, :])
    v = inv_det * _dot(d[:, None, :], q)
    t = inv_det * _dot(ac[None, :, :], q)
    ok = ((jnp.abs(det) >= C.EPSILON)
          & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0)
          & (t >= C.EPSILON))
    return jnp.where(ok, t, _BIG), u, v


def sphere_distances(o, d, center, sq_radius):
    """Quadratic ray-sphere test, reference Sphere.cpp:42-81: t is the
    smaller root over 2a and must be >= EpsilonLarge."""
    oc = center[None, :, :] - o[:, None, :]             # (B, N, 3)
    proj = _dot(oc, d[:, None, :])
    a = _dot(d, d)[:, None]                             # (B, 1); 1 for unit d
    b = 2.0 * -proj
    c = _dot(oc, oc) - sq_radius[None, :]
    disc = b * b - 4.0 * a * c
    # sqrt(where(disc >= 0, ...)) not sqrt(max(disc, 0)): sqrt's VJP at 0
    # is inf, and a missed ray's zero cotangent times inf is NaN — the
    # where routes the backward pass entirely to the disc >= 0 branch.
    # Forward-identical: sq is only consumed where disc >= 0.
    pos = disc >= 0.0
    sq = jnp.sqrt(jnp.where(pos, disc, 1.0))
    t = jnp.minimum(-b + sq, -b - sq) / (2.0 * a)
    ok = pos & (t >= C.EPSILON_LARGE)
    return jnp.where(ok, t, _BIG)


def plane_distances(o, d, point, normal):
    """Two-sided ray-plane test, reference Plane.cpp:38-72."""
    denom = _dot(normal[None, :, :], d[:, None, :])     # (B, N)
    safe = jnp.where(jnp.abs(denom) < C.EPSILON, 1.0, denom)
    num = _dot(normal[None, :, :], point[None, :, :] - o[:, None, :])
    t = num / safe
    ok = (jnp.abs(denom) >= C.EPSILON) & (t >= C.EPSILON)
    return jnp.where(ok, t, _BIG)


# ---------------------------------------------------------------------------
# Closest-hit scans per primitive type.
# ---------------------------------------------------------------------------

def _scan_min(num_prims, chunk_fn, t_init, id_init):
    """Scans primitive chunks, carrying (best_t, best_id)."""
    n_chunks = max(1, -(-num_prims // _CHUNK))

    size = min(_CHUNK, num_prims)

    def body(carry, chunk_idx):
        best_t, best_id = carry
        # Clamp like dynamic_slice does so the id base matches the slice.
        start = jnp.minimum(chunk_idx * _CHUNK, num_prims - size)
        t, ids = chunk_fn(start)
        arg = jnp.argmin(t, axis=1)
        tmin = jnp.take_along_axis(t, arg[:, None], 1)[:, 0]
        idmin = jnp.take_along_axis(ids, arg[:, None], 1)[:, 0]
        closer = tmin < best_t
        return ((jnp.where(closer, tmin, best_t),
                 jnp.where(closer, idmin, best_id)), None)

    (best_t, best_id), _ = jax.lax.scan(
        body, (t_init, id_init), jnp.arange(n_chunks))
    return best_t, best_id


def _components(a):
    return a[..., 0], a[..., 1], a[..., 2]


def _closest_planes_small(pla: Planes, o, d, t_max, prev_kind, prev_id):
    """Unrolled flat-component plane scan (same math as plane_distances)."""
    ox, oy, oz = _components(o)
    dx, dy, dz = _components(d)
    guard = prev_kind == C.PRIM_PLANE
    best_t = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), ox.shape)
    best_id = jnp.full(ox.shape, -1, jnp.int32)
    for i in range(pla.capacity):
        nx, ny, nz = _components(pla.normal[i])
        px, py, pz = _components(pla.point[i])
        denom = nx * dx + ny * dy + nz * dz
        safe = jnp.where(jnp.abs(denom) < C.EPSILON, 1.0, denom)
        num = nx * (px - ox) + ny * (py - oy) + nz * (pz - oz)
        t = num / safe
        ok = ((jnp.abs(denom) >= C.EPSILON) & (t >= C.EPSILON)
              & pla.valid[i] & ~(guard & (prev_id == i)))
        closer = ok & (t < best_t)
        best_t = jnp.where(closer, t, best_t)
        best_id = jnp.where(closer, i, best_id)
    return best_t, best_id


def _closest_spheres_small(sph: Spheres, o, d, t_max, prev_kind, prev_id,
                           exclude_prev=False):
    """Unrolled flat-component sphere scan (same math as sphere_distances)."""
    ox, oy, oz = _components(o)
    dx, dy, dz = _components(d)
    a = dx * dx + dy * dy + dz * dz
    best_t = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), ox.shape)
    best_id = jnp.full(ox.shape, -1, jnp.int32)
    guard = (prev_kind == C.PRIM_SPHERE) if exclude_prev else None
    for i in range(sph.capacity):
        cx, cy, cz = _components(sph.center[i])
        ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
        proj = ocx * dx + ocy * dy + ocz * dz
        b = 2.0 * -proj
        c = ocx * ocx + ocy * ocy + ocz * ocz - sph.sq_radius[i]
        disc = b * b - 4.0 * a * c
        pos = disc >= 0.0      # see sphere_distances: VJP-safe sqrt guard
        sq = jnp.sqrt(jnp.where(pos, disc, 1.0))
        t = jnp.minimum(-b + sq, -b - sq) / (2.0 * a)
        ok = pos & (t >= C.EPSILON_LARGE) & sph.valid[i]
        if guard is not None:
            ok = ok & ~(guard & (prev_id == i))
        closer = ok & (t < best_t)
        best_t = jnp.where(closer, t, best_t)
        best_id = jnp.where(closer, i, best_id)
    return best_t, best_id


def _mt_components(o, d, pa, ab, ac):
    """Flat-component Moller-Trumbore for one triangle row against a ray
    batch; same acceptance math as triangle_distances."""
    ox, oy, oz = _components(o)
    dx, dy, dz = _components(d)
    pax, pay, paz = _components(pa)
    abx, aby, abz = _components(ab)
    acx, acy, acz = _components(ac)
    px = dy * acz - dz * acy
    py = dz * acx - dx * acz
    pz = dx * acy - dy * acx
    det = abx * px + aby * py + abz * pz
    inv = 1.0 / jnp.where(jnp.abs(det) < C.EPSILON, 1.0, det)
    tvx, tvy, tvz = ox - pax, oy - pay, oz - paz
    u = inv * (tvx * px + tvy * py + tvz * pz)
    qx = tvy * abz - tvz * aby
    qy = tvz * abx - tvx * abz
    qz = tvx * aby - tvy * abx
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (acx * qx + acy * qy + acz * qz)
    ok = ((jnp.abs(det) >= C.EPSILON) & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0) & (t >= C.EPSILON))
    return t, ok


def _closest_lights_small(lights: Lights, o, d, t_max, prev_kind, prev_id):
    guard = prev_kind == C.PRIM_LIGHT
    b = o.shape[0]
    best_t = jnp.full((b,), _BIG, jnp.float32)
    best_id = jnp.zeros((b,), jnp.int32)
    for i in range(lights.capacity):
        t, ok = _mt_components(o, d, lights.tri_a[i], lights.tri_ab[i],
                               lights.tri_ac[i])
        active = lights.valid[i] & (lights.kind[i] == C.LIGHT_AREA)
        ok = ok & active & ~(guard & (prev_id == i))
        closer = ok & (t < best_t)
        best_t = jnp.where(closer, t, best_t)
        best_id = jnp.where(closer, i, best_id)
    tm = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (b,))
    return jnp.where(best_t < tm, best_t, _BIG), best_id


def closest_triangles(tris: Triangles, o, d, t_max, prev_kind, prev_id):
    n = tris.capacity
    guard = prev_kind == C.PRIM_TRIANGLE

    def chunk(start):
        pa = jax.lax.dynamic_slice_in_dim(tris.point_a, start, min(_CHUNK, n), 0)
        ab = jax.lax.dynamic_slice_in_dim(tris.ab, start, min(_CHUNK, n), 0)
        ac = jax.lax.dynamic_slice_in_dim(tris.ac, start, min(_CHUNK, n), 0)
        valid = jax.lax.dynamic_slice_in_dim(tris.valid, start, min(_CHUNK, n), 0)
        ids = start + jnp.arange(min(_CHUNK, n), dtype=jnp.int32)
        t, _, _ = triangle_distances(o, d, pa, ab, ac)
        t = jnp.where(valid[None, :], t, _BIG)
        # Self-intersection guard (reference Triangle.cpp:64-66 compares the
        # ray's source-primitive pointer).
        t = jnp.where(guard[:, None] & (ids[None, :] == prev_id[:, None]), _BIG, t)
        return t, jnp.broadcast_to(ids[None, :], t.shape)

    return _scan_min(n, chunk,
                     jnp.asarray(t_max, jnp.float32) * jnp.ones(o.shape[0]),
                     jnp.full((o.shape[0],), -1, jnp.int32))


def closest_spheres(sph: Spheres, o, d, t_max, prev_kind, prev_id,
                    exclude_prev=False):
    """`exclude_prev=False` matches the reference exactly: spheres carry no
    self-intersection pointer (Sphere.cpp:77 passes nullptr), EpsilonLarge
    is the only guard — transmission rays MUST be able to re-hit their own
    sphere's far side.  Occlusion queries pass `exclude_prev=True`: a
    convex sphere can never legitimately block its own surface point when
    cos(N, L) > 0 (the NEE visibility gate), and reversed shadow segments
    (shaders/common.direct_lighting) end ON the sphere at t ~ max_dist
    where the forward formulation's t~0 epsilon guard no longer covers the
    self-hit."""
    n = sph.capacity
    if n <= _SMALL:
        return _closest_spheres_small(sph, o, d, t_max, prev_kind, prev_id,
                                      exclude_prev=exclude_prev)

    def chunk(start):
        ce = jax.lax.dynamic_slice_in_dim(sph.center, start, min(_CHUNK, n), 0)
        sr = jax.lax.dynamic_slice_in_dim(sph.sq_radius, start, min(_CHUNK, n), 0)
        valid = jax.lax.dynamic_slice_in_dim(sph.valid, start, min(_CHUNK, n), 0)
        ids = start + jnp.arange(min(_CHUNK, n), dtype=jnp.int32)
        t = sphere_distances(o, d, ce, sr)
        t = jnp.where(valid[None, :], t, _BIG)
        if exclude_prev:
            t = jnp.where(((prev_kind == C.PRIM_SPHERE)[:, None]
                           & (prev_id[:, None] == ids[None, :])), _BIG, t)
        return t, jnp.broadcast_to(ids[None, :], t.shape)

    return _scan_min(n, chunk,
                     jnp.asarray(t_max, jnp.float32) * jnp.ones(o.shape[0]),
                     jnp.full((o.shape[0],), -1, jnp.int32))


def closest_planes(pla: Planes, o, d, t_max, prev_kind, prev_id):
    n = pla.capacity
    if n <= _SMALL:
        return _closest_planes_small(pla, o, d, t_max, prev_kind, prev_id)
    guard = prev_kind == C.PRIM_PLANE

    def chunk(start):
        pt = jax.lax.dynamic_slice_in_dim(pla.point, start, min(_CHUNK, n), 0)
        nm = jax.lax.dynamic_slice_in_dim(pla.normal, start, min(_CHUNK, n), 0)
        valid = jax.lax.dynamic_slice_in_dim(pla.valid, start, min(_CHUNK, n), 0)
        ids = start + jnp.arange(min(_CHUNK, n), dtype=jnp.int32)
        t = plane_distances(o, d, pt, nm)
        t = jnp.where(valid[None, :], t, _BIG)
        t = jnp.where(guard[:, None] & (ids[None, :] == prev_id[:, None]), _BIG, t)
        return t, jnp.broadcast_to(ids[None, :], t.shape)

    return _scan_min(n, chunk,
                     jnp.asarray(t_max, jnp.float32) * jnp.ones(o.shape[0]),
                     jnp.full((o.shape[0],), -1, jnp.int32))


def closest_lights(lights: Lights, o, d, t_max, prev_kind, prev_id):
    """Area-light triangles are hittable during normal tracing (reference
    Shader.cpp:111 traceLights -> AreaLight.cpp:32-41)."""
    if lights.capacity <= _SMALL:
        return _closest_lights_small(lights, o, d, t_max, prev_kind, prev_id)
    guard = prev_kind == C.PRIM_LIGHT
    t, _, _ = triangle_distances(o, d, lights.tri_a, lights.tri_ab, lights.tri_ac)
    active = lights.valid & (lights.kind == C.LIGHT_AREA)
    t = jnp.where(active[None, :], t, _BIG)
    ids = jnp.arange(lights.capacity, dtype=jnp.int32)
    t = jnp.where(guard[:, None] & (ids[None, :] == prev_id[:, None]), _BIG, t)
    arg = jnp.argmin(t, axis=1)
    tmin = jnp.take_along_axis(t, arg[:, None], 1)[:, 0]
    tmin = jnp.where(tmin < t_max, tmin, _BIG)
    return tmin, arg.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Full-scene closest hit and shadow (any-hit) queries.
# ---------------------------------------------------------------------------

def _fill_hit(scene: Scene, o, d, t_pl, id_pl, t_sp, id_sp, t_tr, id_tr,
              t_li, id_li, tri_attr=None) -> Hit:
    """Combines per-type winners and gathers surface attributes for the
    overall closest primitive.

    `tri_attr` is an optional packed (N, 32) per-triangle attribute table
    (cols 0:3 pa, 3:6 ab, 6:9 ac, 9:12 n_a, 12:15 n_b, 15:18 n_c, 18:20
    uv_a, 20:22 uv_b, 22:24 uv_c, 24 mat_id): one wide row gather in place
    of seven narrow ones."""
    b = o.shape[0]
    ts = jnp.stack([t_pl, t_sp, t_tr, t_li], 0)          # (4, B)
    ids = jnp.stack([id_pl, id_sp, id_tr, id_li], 0)
    kinds = jnp.asarray([C.PRIM_PLANE, C.PRIM_SPHERE, C.PRIM_TRIANGLE,
                         C.PRIM_LIGHT], jnp.int32)
    winner = jnp.argmin(ts, axis=0)                      # (B,)
    t = jnp.take_along_axis(ts, winner[None, :], 0)[0]
    pid = jnp.take_along_axis(ids, winner[None, :], 0)[0]
    kind = jnp.where(t < _BIG, kinds[winner], C.PRIM_NONE)
    pid = jnp.where(t < _BIG, pid, -1)
    point = o + d * t[:, None]

    gid = jnp.maximum(pid, 0)

    # Plane attributes (normal is the plane normal; reference Plane.cpp:62-69).
    n_pl = scene.planes.normal[jnp.minimum(gid, scene.planes.capacity - 1)]
    m_pl = scene.planes.mat_id[jnp.minimum(gid, scene.planes.capacity - 1)]

    # Sphere attributes (outward normal; reference Sphere.cpp:70-79).
    sid = jnp.minimum(gid, scene.spheres.capacity - 1)
    ctr = scene.spheres.center[sid]
    n_sp = point - ctr
    # Normalizations here use sqrt(max(sum-of-squares, eps)) instead of
    # max(norm, eps): jnp.linalg.norm's VJP at a zero vector is 0/0 = NaN,
    # and a zero cotangent does NOT mask it (0 * NaN = NaN), so padded
    # rows / masked lanes would poison every vertex gradient reachable
    # through the chain.  Forward values are bit-identical for non-zero
    # inputs (same sqrt, same divide).
    n_sp = n_sp / jnp.sqrt(jnp.maximum(
        jnp.sum(n_sp * n_sp, axis=-1, keepdims=True), 1e-30))
    m_sp = scene.spheres.mat_id[sid]

    # Triangle attributes: barycentric-interpolated normal and UV
    # (reference Triangle.cpp:96-106).
    tid = jnp.minimum(gid, scene.triangles.capacity - 1)
    tris = scene.triangles
    if tri_attr is not None:
        row = tri_attr[tid]                                   # (B, 32)
        pa, ab, ac = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        na_, nb_, nc_ = row[:, 9:12], row[:, 12:15], row[:, 15:18]
        uva, uvb, uvc = row[:, 18:20], row[:, 20:22], row[:, 22:24]
        m_tr = row[:, 24].astype(jnp.int32)
    else:
        pa, ab, ac = tris.point_a[tid], tris.ab[tid], tris.ac[tid]
        na_, nb_, nc_ = (tris.normal_a[tid], tris.normal_b[tid],
                         tris.normal_c[tid])
        uva, uvb, uvc = tris.uv_a[tid], tris.uv_b[tid], tris.uv_c[tid]
        m_tr = tris.mat_id[tid]
    u_t, v_t = _tri_barycentrics(o, d, pa, ab, ac)
    w_t = 1.0 - u_t - v_t
    n_tr = (na_ * w_t[:, None] + nb_ * u_t[:, None] + nc_ * v_t[:, None])
    n_tr = n_tr / jnp.sqrt(jnp.maximum(
        jnp.sum(n_tr * n_tr, axis=-1, keepdims=True), 1e-30))
    uv_tr = (uva * w_t[:, None] + uvb * u_t[:, None] + uvc * v_t[:, None])

    # Area-light attributes: geometric normal of the light triangle, mat -1
    # with bound radiance (reference AreaLight.cpp:32-41 binds the radiance
    # material; the triangle's default normal is normalize(cross(AC, AB)),
    # Triangle.cpp:328-339).
    lid = jnp.minimum(gid, scene.lights.capacity - 1)
    n_li = jnp.cross(scene.lights.tri_ac[lid], scene.lights.tri_ab[lid])
    n_li = n_li / jnp.sqrt(jnp.maximum(
        jnp.sum(n_li * n_li, axis=-1, keepdims=True), 1e-30))
    le_li = scene.lights.radiance[lid]

    sel = winner  # 0 plane, 1 sphere, 2 triangle, 3 light
    normal = jnp.select(
        [sel[:, None] == 0, sel[:, None] == 1, sel[:, None] == 2],
        [n_pl, n_sp, n_tr], n_li)
    mat_id = jnp.select([sel == 0, sel == 1, sel == 2],
                        [m_pl, m_sp, m_tr], jnp.full((b,), -1, jnp.int32))
    mat_id = jnp.where(kind == C.PRIM_NONE, -1, mat_id)
    uv = jnp.where((sel == 2)[:, None], uv_tr, jnp.full((b, 2), -1.0))
    light_le = jnp.where((sel == 3)[:, None] & (kind == C.PRIM_LIGHT)[:, None],
                         le_li, jnp.zeros((b, 3)))

    return Hit(t=t, prim_kind=kind, prim_id=pid, mat_id=mat_id, point=point,
               normal=normal, uv=uv, light_le=light_le)


def recompute_tri_t(tris: Triangles, o, d, tid):
    """Differentiable hit distance for known winning triangles (one id per
    ray, -1 = miss): the accelerator's integer winner re-derived from the
    LIVE triangle table, so d(t)/d(vertices) flows even though the
    traversal itself ran under stop_gradient on frozen tables (the
    differentiable-render path of the BVH tracers)."""
    gid = jnp.maximum(tid, 0)
    t, ok = _mt_components(o, d, tris.point_a[gid], tris.ab[gid],
                           tris.ac[gid])
    return jnp.where((tid >= 0) & ok, t, _BIG)


def _tri_barycentrics(o, d, pa, ab, ac):
    """Recomputes (u, v) for known triangle rows (one per ray)."""
    p = jnp.cross(d, ac)
    det = _dot(ab, p)
    inv = 1.0 / jnp.where(jnp.abs(det) < C.EPSILON, 1.0, det)
    tvec = o - pa
    u = inv * _dot(tvec, p)
    q = jnp.cross(tvec, ab)
    v = inv * _dot(d, q)
    return u, v


def intersect_scene_naive(scene: Scene, o, d, prev_kind, prev_id,
                          t_max=_BIG) -> Hit:
    """Closest hit across planes, spheres, triangles, then area lights —
    the reference's trace order (Shader.cpp:86-123)."""
    tm = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (o.shape[0],))
    t_pl, id_pl = closest_planes(scene.planes, o, d, tm, prev_kind, prev_id)
    t_sp, id_sp = closest_spheres(scene.spheres, o, d, tm, prev_kind, prev_id)
    t_tr, id_tr = closest_triangles(scene.triangles, o, d, tm, prev_kind, prev_id)
    t_li, id_li = closest_lights(scene.lights, o, d, tm, prev_kind, prev_id)
    return _fill_hit(scene, o, d, t_pl, id_pl, t_sp, id_sp, t_tr, id_tr,
                     t_li, id_li)


def occluded_naive(scene: Scene, o, d, max_dist, prev_kind, prev_id):
    """Shadow query: any scene primitive strictly closer than `max_dist`
    blocks the light.  Lights themselves never occlude (the reference's
    shadowTrace skips traceLights, Shader.cpp:132-158)."""
    t_pl, _ = closest_planes(scene.planes, o, d, max_dist, prev_kind, prev_id)
    t_sp, _ = closest_spheres(scene.spheres, o, d, max_dist, prev_kind,
                              prev_id, exclude_prev=True)
    t_tr, _ = closest_triangles(scene.triangles, o, d, max_dist, prev_kind, prev_id)
    t = jnp.minimum(jnp.minimum(t_pl, t_sp), t_tr)
    return t < max_dist
