"""Regular-grid accelerator: 3D-DDA traversal over a uniform cell grid.

Functional equivalent of the reference's RegularGrid (reference
app/MobileRT/Accelerators/RegularGrid.hpp: 32^3 cells by default
(Shader.cpp:57), parallel insertion with exact primitive-vs-cell tests,
Amanatides-Woo 3D-DDA stepping in `intersect`, RegularGrid.hpp:333-515).

The build is host-side numpy producing a CSR cell table (cell_start /
items).  Traversal is an Amanatides-Woo walk expressed as a batched
while_loop; like the reference it is exact, but its serial per-cell item
gathers are expected to make it slower than the block BVH (not measured
on a GPU) — it exists for capability parity and as a second correctness oracle (the reference's
AcceleratorTestEngine renders through all three accelerators).  Insertion
uses conservative AABB overlap instead of the reference's exact
triangle-vs-box test: supersets never change results, only cost.

Cells only index triangles and spheres; planes are unbounded (the
reference gives them fake +-100 AABBs, Plane.cpp:103-109) and are traced
by the linear scan here, which is exact rather than approximate.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..types import Hit, Scene, pytree_dataclass, static_field
from . import intersect as nv

_BIG = C.RAY_LENGTH_MAX

DEFAULT_GRID_SIZE = 32
MAX_ITEMS_PER_CELL_TEST = 64   # per DDA step, tested in fixed-size slices


@pytree_dataclass
class RegularGrid:
    bounds_min: jnp.ndarray   # (3,)
    bounds_max: jnp.ndarray   # (3,)
    cell_start: jnp.ndarray   # (S^3 + 1,) CSR offsets
    item_kind: jnp.ndarray    # (T,) PRIM_TRIANGLE | PRIM_SPHERE
    item_id: jnp.ndarray      # (T,)
    size: int = static_field(default=DEFAULT_GRID_SIZE)


def build_grid(scene: Scene, size: int = DEFAULT_GRID_SIZE) -> Scene:
    """Builds the cell table and stores it in the scene's `bvh` slot."""
    tris = scene.triangles
    sph = scene.spheres

    boxes = []   # (kind, id, bmin, bmax)
    tv = np.asarray(tris.valid)
    if tv.any():
        pa = np.asarray(tris.point_a)
        pb = pa + np.asarray(tris.ab)
        pc = pa + np.asarray(tris.ac)
        bmin = np.minimum(pa, np.minimum(pb, pc))
        bmax = np.maximum(pa, np.maximum(pb, pc))
        for i in np.nonzero(tv)[0]:
            boxes.append((C.PRIM_TRIANGLE, i, bmin[i], bmax[i]))
    sv = np.asarray(sph.valid)
    if sv.any():
        ce = np.asarray(sph.center)
        r = np.sqrt(np.asarray(sph.sq_radius))
        for i in np.nonzero(sv)[0]:
            boxes.append((C.PRIM_SPHERE, i, ce[i] - r[i], ce[i] + r[i]))

    if boxes:
        wmin = np.min([b[2] for b in boxes], 0).astype(np.float32)
        wmax = np.max([b[3] for b in boxes], 0).astype(np.float32)
    else:
        wmin = np.zeros(3, np.float32)
        wmax = np.ones(3, np.float32)
    ext = np.maximum(wmax - wmin, 1e-6)
    wmin = wmin - 1e-4 * ext
    wmax = wmax + 1e-4 * ext
    cell = (wmax - wmin) / size

    cells = [[] for _ in range(size ** 3)]
    for kind, pid, bmin, bmax in boxes:
        lo = np.clip(((bmin - wmin) / cell).astype(int), 0, size - 1)
        hi = np.clip(((bmax - wmin) / cell).astype(int), 0, size - 1)
        for z in range(lo[2], hi[2] + 1):
            for y in range(lo[1], hi[1] + 1):
                for x in range(lo[0], hi[0] + 1):
                    cells[(z * size + y) * size + x].append((kind, pid))

    start = np.zeros(size ** 3 + 1, np.int32)
    kinds, ids = [], []
    for ci, lst in enumerate(cells):
        start[ci + 1] = start[ci] + len(lst)
        for kind, pid in lst:
            kinds.append(kind)
            ids.append(pid)

    grid = RegularGrid(
        bounds_min=np.asarray(wmin, np.float32),
        bounds_max=np.asarray(wmax, np.float32),
        cell_start=np.asarray(start),
        item_kind=(np.asarray(kinds, np.int32)
                   if kinds else np.zeros(1, np.int32)),
        item_id=(np.asarray(ids, np.int32)
                 if ids else np.zeros(1, np.int32)),
        size=size,
    )
    return jax.device_put(scene.replace(bvh=grid))


def _ray_cell_items(grid: RegularGrid, scene: Scene, o, d, cell_idx,
                    t_best, best_kind, best_id, prev_kind, prev_id,
                    max_dist):
    """Tests every item of one cell per ray (fixed-size masked slices)."""
    start = grid.cell_start[cell_idx]
    end = grid.cell_start[cell_idx + 1]
    tris = scene.triangles
    sph = scene.spheres

    def body(j, carry):
        t_best, best_kind, best_id = carry
        idx = start + j
        live = idx < end
        idx = jnp.minimum(idx, grid.item_id.shape[0] - 1)
        kind = grid.item_kind[idx]
        pid = grid.item_id[idx]

        # Triangle test.
        tid = jnp.minimum(pid, tris.capacity - 1)
        tt = _tri_one(o, d, tris.point_a[tid], tris.ab[tid], tris.ac[tid])
        tri_ok = (live & (kind == C.PRIM_TRIANGLE)
                  & ~((prev_kind == C.PRIM_TRIANGLE) & (pid == prev_id))
                  & (tt < t_best))
        # Sphere test.
        sid = jnp.minimum(pid, sph.capacity - 1)
        ts = _sphere_one(o, d, sph.center[sid], sph.sq_radius[sid])
        sph_ok = live & (kind == C.PRIM_SPHERE) & (ts < t_best)

        t_new = jnp.where(tri_ok, tt, jnp.where(sph_ok, ts, t_best))
        k_new = jnp.where(tri_ok, C.PRIM_TRIANGLE,
                          jnp.where(sph_ok, C.PRIM_SPHERE, best_kind))
        i_new = jnp.where(tri_ok | sph_ok, pid, best_id)
        return t_new, k_new, i_new

    max_n = jnp.max(end - start)
    def cond(c):
        j, carry = c
        return j < max_n
    def wbody(c):
        j, carry = c
        return j + 1, body(j, carry)
    _, (t_best, best_kind, best_id) = jax.lax.while_loop(
        cond, wbody, (jnp.zeros((), jnp.int32), (t_best, best_kind, best_id)))
    return t_best, best_kind, best_id


def _tri_one(o, d, pa, ab, ac):
    p = jnp.cross(d, ac)
    det = jnp.sum(ab * p, -1)
    inv = 1.0 / jnp.where(jnp.abs(det) < C.EPSILON, 1.0, det)
    tvec = o - pa
    u = inv * jnp.sum(tvec * p, -1)
    q = jnp.cross(tvec, ab)
    v = inv * jnp.sum(d * q, -1)
    t = inv * jnp.sum(ac * q, -1)
    ok = ((jnp.abs(det) >= C.EPSILON) & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0) & (t >= C.EPSILON))
    return jnp.where(ok, t, _BIG)


def _sphere_one(o, d, center, sq_radius):
    oc = center - o
    proj = jnp.sum(oc * d, -1)
    a = jnp.sum(d * d, -1)
    b = 2.0 * -proj
    c = jnp.sum(oc * oc, -1) - sq_radius
    disc = b * b - 4.0 * a * c
    pos = disc >= 0.0   # VJP-safe sqrt guard (see intersect.sphere_distances)
    sq = jnp.sqrt(jnp.where(pos, disc, 1.0))
    t = jnp.minimum(-b + sq, -b - sq) / (2.0 * a)
    ok = pos & (t >= C.EPSILON_LARGE)
    return jnp.where(ok, t, _BIG)


def _dda_single(grid: RegularGrid, scene: Scene, o, d, t_max,
                prev_kind, prev_id):
    """Amanatides-Woo walk for one ray (vmapped)."""
    size = grid.size
    cell = (grid.bounds_max - grid.bounds_min) / size
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-30,
                            jnp.where(d < 0, -1e-30, 1e-30), d)

    # Clip the ray to the grid bounds.
    t0 = (grid.bounds_min - o) * inv_d
    t1 = (grid.bounds_max - o) * inv_d
    tnear = jnp.max(jnp.minimum(t0, t1))
    tfar = jnp.min(jnp.maximum(t0, t1))
    t_enter = jnp.maximum(tnear, 0.0)
    hit_grid = (tnear <= tfar) & (tfar >= 0.0)

    p_enter = o + d * (t_enter + 1e-6)
    ijk = jnp.clip(((p_enter - grid.bounds_min) / cell).astype(jnp.int32),
                   0, size - 1)
    step = jnp.where(d >= 0, 1, -1)
    next_bound = grid.bounds_min + (ijk + (step > 0)) * cell
    t_next = jnp.where(jnp.abs(d) < 1e-30, _BIG, (next_bound - o) * inv_d)
    t_delta = jnp.abs(cell * inv_d)

    def cond(state):
        ijk, t_next, t_best, bk, bi, alive = state
        return alive

    def body(state):
        ijk, t_next, t_best, bk, bi, alive = state
        ci = (ijk[2] * size + ijk[1]) * size + ijk[0]
        t_best, bk, bi = _ray_cell_items(
            grid, scene, o, d, ci, t_best, bk, bi, prev_kind, prev_id, t_max)
        # Advance to the next cell.
        axis = jnp.argmin(t_next)
        t_exit = t_next[axis]
        ijk = ijk.at[axis].add(step[axis])
        t_next = t_next.at[axis].add(t_delta[axis])
        inside = (ijk >= 0).all() & (ijk < size).all()
        # Stop when a hit lies inside the current cell (closest found) or
        # the walk leaves the grid.
        alive = inside & (t_best > t_exit) & (t_exit < t_max)
        return ijk, t_next, t_best, bk, bi, alive

    init = (ijk, t_next,
            jnp.asarray(t_max, jnp.float32),
            jnp.zeros((), jnp.int32), jnp.full((), -1, jnp.int32),
            hit_grid)
    _, _, t_best, bk, bi, _ = jax.lax.while_loop(cond, body, init)
    return t_best, bk, bi


def traverse_grid(grid: RegularGrid, scene: Scene, o, d, t_max,
                  prev_kind, prev_id):
    tm = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (o.shape[0],))
    f = jax.vmap(lambda o_, d_, t_, pk_, pi_: _dda_single(
        grid, scene, o_, d_, t_, pk_, pi_))
    return f(o, d, tm, prev_kind, prev_id)


def intersect_scene_grid(scene: Scene, o, d, prev_kind, prev_id,
                         t_max=_BIG) -> Hit:
    grid = scene.bvh
    assert isinstance(grid, RegularGrid), "call ops.grid.build_grid first"
    tm = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (o.shape[0],))
    t_pl, id_pl = nv.closest_planes(scene.planes, o, d, tm, prev_kind, prev_id)
    t_g, k_g, id_g = traverse_grid(grid, scene, o, d, tm, prev_kind, prev_id)
    t_tr = jnp.where(k_g == C.PRIM_TRIANGLE, t_g, _BIG)
    id_tr = jnp.where(k_g == C.PRIM_TRIANGLE, id_g, -1)
    t_sp = jnp.where(k_g == C.PRIM_SPHERE, t_g, _BIG)
    id_sp = jnp.where(k_g == C.PRIM_SPHERE, id_g, -1)
    t_li, id_li = nv.closest_lights(scene.lights, o, d, tm, prev_kind, prev_id)
    return nv._fill_hit(scene, o, d, t_pl, id_pl, t_sp, id_sp, t_tr, id_tr,
                        t_li, id_li)


def occluded_grid(scene: Scene, o, d, max_dist, prev_kind, prev_id):
    grid = scene.bvh
    assert isinstance(grid, RegularGrid), "call ops.grid.build_grid first"
    t_pl, _ = nv.closest_planes(scene.planes, o, d, max_dist, prev_kind,
                                prev_id)
    t_g, _, _ = traverse_grid(grid, scene, o, d, max_dist, prev_kind, prev_id)
    return (t_g < max_dist) | (t_pl < max_dist)
