"""Two-level "block BVH" traversal in plain XLA: the BVH accelerator.

The escape-index walk in ops/bvh.py is exact but serial: one tiny gather
per ray per node inside a while_loop.  This module keeps the same
median-split build but traverses with dense fixed-shape phases:

  level 0  supers:  groups of `blocks_per_super` consecutive leaf blocks
                    (consecutive preorder leaves are spatially local
                    subtrees).  Phase A slab-tests every ray against every
                    super AABB — one dense (rays x K1) vector op — and
                    keeps each ray's `top_s` nearest intersected supers.
  level 1  blocks:  leaves of the build cut at `block_size` triangles,
                    each a *contiguous* range of the reordered triangle
                    array.  Phase B gathers the candidate supers' block
                    AABBs ((rays, top_s * blocks_per_super)) and keeps the
                    `top_m` nearest blocks.
  level 2  tris:    a fixed `top_m`-step scan; each step gathers one
                    contiguous triangle tile per ray and runs dense masked
                    Moller-Trumbore.

`top_s`/`top_m` bound per-ray work; a ray whose true hit lies behind more
than `top_s` supers / `top_m` blocks could in principle miss it, so they
must be sized for the scene — parity with the exact naive oracle is
enforced in tests for every shipped scene and results only improve as the
budgets grow.

Reference behavior being replaced: app/MobileRT/Accelerators/BVH.hpp
327-384 (stack traversal with near-child ordering + shadow early-out).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..types import Hit, Scene, Triangles, pytree_dataclass, static_field
from . import intersect as nv
from .bvh import build_triangle_bvh

_BIG = C.RAY_LENGTH_MAX

DEFAULT_BLOCK_SIZE = 64
DEFAULT_BLOCKS_PER_SUPER = 16
DEFAULT_TOP_S = 48
DEFAULT_TOP_M = 96
_RAY_CHUNK = 65536


@pytree_dataclass
class BlockGrid:
    """Two-level block table over the reordered triangle array.  The
    budgets are static (hashed into the jit cache), the arrays are leaves.

    Geometry is laid out componentwise: AABBs as (3, ...) planes (no
    trailing-3 dims) and triangles packed into one (N, 12) row so phase C
    issues a single gather per step.
    """
    super_lo: jnp.ndarray     # (3, K1) componentwise AABB min
    super_hi: jnp.ndarray     # (3, K1)
    block_lo: jnp.ndarray     # (3, K1, BPS)
    block_hi: jnp.ndarray     # (3, K1, BPS)
    block_first: jnp.ndarray  # (K1, BPS)
    block_count: jnp.ndarray  # (K1, BPS) 0 on padding
    # Per-block packed triangle tiles: one contiguous (BS, 12) row per
    # block — pax..paz, abx..abz, acx..acz, valid, 0, 0 — so phase C is a
    # single large-row gather per step.
    tri_blocks: jnp.ndarray   # (K1 * BPS, BS, 12)
    block_size: int = static_field(default=128)
    top_s: int = static_field(default=DEFAULT_TOP_S)
    top_m: int = static_field(default=DEFAULT_TOP_M)
    tile: int = static_field(default=16)

    @property
    def num_supers(self) -> int:
        return self.super_lo.shape[1]


def build_blocks(tris: Triangles, block_size: int = DEFAULT_BLOCK_SIZE,
                 blocks_per_super: int = DEFAULT_BLOCKS_PER_SUPER,
                 top_s: int = DEFAULT_TOP_S,
                 top_m: int = DEFAULT_TOP_M,
                 tile: int = 16) -> Tuple[Triangles, BlockGrid]:
    tris2, bvh = build_triangle_bvh(tris, leaf_size=block_size)
    counts = np.asarray(bvh.node_count)
    leaf = counts > 0
    bmin = np.asarray(bvh.node_min)[leaf]
    bmax = np.asarray(bvh.node_max)[leaf]
    bfirst = np.asarray(bvh.node_first)[leaf]
    bcount = counts[leaf]
    k = bmin.shape[0]

    # A scene without triangles still gets one empty block, so the
    # traversal keeps its shapes and finds nothing.
    bps = max(1, min(blocks_per_super, k))
    k1 = max(1, -(-k // bps))
    padded = k1 * bps

    def pad(a, fill):
        out = np.full((padded,) + a.shape[1:], fill, a.dtype)
        out[:k] = a
        return out

    bmin_p = pad(bmin, np.float32(3e38)).reshape(k1, bps, 3)
    bmax_p = pad(bmax, np.float32(-3e38)).reshape(k1, bps, 3)
    bfirst_p = pad(bfirst, np.int32(0)).reshape(k1, bps)
    bcount_p = pad(bcount.astype(np.int32), np.int32(0)).reshape(k1, bps)

    # Per-block packed triangle tiles (blocks are contiguous ranges of the
    # reordered array, so this is a strided copy).
    bs_max = int(bcount.max()) if k else 1
    pa_np = np.asarray(tris2.point_a)
    ab_np = np.asarray(tris2.ab)
    ac_np = np.asarray(tris2.ac)
    va_np = np.asarray(tris2.valid)
    tb = np.zeros((padded, bs_max, 12), np.float32)
    bf_flat = bfirst_p.reshape(-1)
    bc_flat = bcount_p.reshape(-1)
    for bi in range(padded):
        cnt = int(bc_flat[bi])
        if cnt == 0:
            continue
        f0 = int(bf_flat[bi])
        tb[bi, :cnt, 0:3] = pa_np[f0:f0 + cnt]
        tb[bi, :cnt, 3:6] = ab_np[f0:f0 + cnt]
        tb[bi, :cnt, 6:9] = ac_np[f0:f0 + cnt]
        tb[bi, :cnt, 9] = va_np[f0:f0 + cnt].astype(np.float32)

    grid = BlockGrid(
        super_lo=bmin_p.min(1).T.copy(),
        super_hi=bmax_p.max(1).T.copy(),
        block_lo=np.moveaxis(bmin_p, 2, 0).copy(),
        block_hi=np.moveaxis(bmax_p, 2, 0).copy(),
        block_first=bfirst_p,
        block_count=bcount_p,
        tri_blocks=tb,
        block_size=bs_max,
        top_s=min(top_s, k1),
        top_m=min(top_m, k1 * bps),
        tile=tile,
    )
    return tris2, grid


def _entry_cw(ox, oy, oz, ix, iy, iz, lo, hi):
    """Componentwise slab entry distance; +inf on miss.

    ox..iz are ray components broadcastable against lo/hi's leading box
    axes; lo/hi are (3, ...) componentwise bounds.  All arithmetic happens
    on well-aligned trailing dims (no trailing-3 vectors).
    """
    tx0 = (lo[0] - ox) * ix
    tx1 = (hi[0] - ox) * ix
    ty0 = (lo[1] - oy) * iy
    ty1 = (hi[1] - oy) * iy
    tz0 = (lo[2] - oz) * iz
    tz1 = (hi[2] - oz) * iz
    tnear = jnp.maximum(jnp.maximum(jnp.minimum(tx0, tx1),
                                    jnp.minimum(ty0, ty1)),
                        jnp.minimum(tz0, tz1))
    tfar = jnp.minimum(jnp.minimum(jnp.maximum(tx0, tx1),
                                   jnp.maximum(ty0, ty1)),
                       jnp.maximum(tz0, tz1))
    hit = (tnear <= tfar) & (tfar >= 0.0)
    return jnp.where(hit, jnp.maximum(tnear, 0.0), jnp.inf)


def _mt_cw(ox, oy, oz, dx, dy, dz,
           pax, pay, paz, abx, aby, abz, acx, acy, acz):
    """Componentwise Moller-Trumbore (reference acceptance tests,
    Triangle.cpp:63-109).  Ray components broadcast against triangle
    components; every operand keeps the well-aligned trailing layout."""
    # p = d x ac
    px = dy * acz - dz * acy
    py = dz * acx - dx * acz
    pz = dx * acy - dy * acx
    det = abx * px + aby * py + abz * pz
    inv = 1.0 / jnp.where(jnp.abs(det) < C.EPSILON, 1.0, det)
    tvx = ox - pax
    tvy = oy - pay
    tvz = oz - paz
    u = inv * (tvx * px + tvy * py + tvz * pz)
    # q = tvec x ab
    qx = tvy * abz - tvz * aby
    qy = tvz * abx - tvx * abz
    qz = tvx * aby - tvy * abx
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (acx * qx + acy * qy + acz * qz)
    ok = ((jnp.abs(det) >= C.EPSILON) & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0) & (t >= C.EPSILON))
    return jnp.where(ok, t, _BIG)


def _traverse_chunk(grid: BlockGrid, tris: Triangles, o, d, t_init,
                    prev_kind, prev_id):
    """Tile-cooperative traversal over one ray chunk (B multiple of TILE).

    Rays are grouped into tiles of TILE consecutive lanes; every phase
    selects candidates *per tile* (reducing entry distances over the
    tile's rays), so all triangle/AABB fetches are tile-level — a few
    hundred contiguous rows per step instead of per-ray gathers.  Primary
    and shadow rays are coherent in lane order by construction
    (pixel-ordered batches), bounce rays approximately so.
    """
    b = o.shape[0]
    TILE = grid.tile
    assert b % TILE == 0
    nt = b // TILE
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-30,
                            jnp.where(d < 0, -1e-30, 1e-30), d)
    guard = prev_kind == C.PRIM_TRIANGLE

    # Componentwise ray views (trailing dims stay large and aligned).
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    ix, iy, iz = inv_d[:, 0], inv_d[:, 1], inv_d[:, 2]

    # Phase A: per-ray super entries, reduced per tile.
    e_super = _entry_cw(
        ox[:, None], oy[:, None], oz[:, None],
        ix[:, None], iy[:, None], iz[:, None],
        grid.super_lo[:, None, :], grid.super_hi[:, None, :])      # (B, K1)
    e_super_t = jnp.min(e_super.reshape(nt, TILE, -1), axis=1)     # (nt, K1)
    s = grid.top_s
    neg_s, sup_ids = jax.lax.top_k(-e_super_t, s)                  # (nt, s)
    sup_ok = jnp.isfinite(-neg_s)

    # Phase B: candidate blocks of the tile's supers (tile-level gathers).
    cb_lo = grid.block_lo[:, sup_ids]       # (3, nt, s, BPS)
    cb_hi = grid.block_hi[:, sup_ids]
    cb_first = grid.block_first[sup_ids]    # (nt, s, BPS)
    cb_count = grid.block_count[sup_ids]
    bps = cb_first.shape[2]
    nc = s * bps
    # Per-ray entries against the tile's candidates, then tile-reduce.
    def tile_ray(c):
        return c.reshape(nt, TILE, 1)
    e_blk = _entry_cw(
        tile_ray(ox), tile_ray(oy), tile_ray(oz),
        tile_ray(ix), tile_ray(iy), tile_ray(iz),
        cb_lo.reshape(3, nt, 1, nc), cb_hi.reshape(3, nt, 1, nc))  # (nt, T, nc)
    cand_ok = (cb_count.reshape(nt, nc) > 0) & jnp.repeat(sup_ok, bps, 1)
    e_blk = jnp.where(cand_ok[:, None, :], e_blk, jnp.inf)
    e_blk_t = jnp.min(e_blk, axis=1)                               # (nt, nc)
    m = min(grid.top_m, nc)
    neg_b, cand = jax.lax.top_k(-e_blk_t, m)                       # (nt, m)
    cand_entry_t = -neg_b
    cand_first = jnp.take_along_axis(cb_first.reshape(nt, nc), cand, 1)
    # Flat block id into the packed (K1*BPS, BS, 12) triangle tiles.
    gids = (sup_ids[:, :, None] * bps
            + jnp.arange(bps, dtype=jnp.int32)[None, None, :])
    cand_gid = jnp.take_along_axis(gids.reshape(nt, nc), cand, 1)
    # Per-ray entry for the selected blocks (for per-ray usefulness tests).
    e_ray = jnp.take_along_axis(
        e_blk, jnp.broadcast_to(cand[:, None, :], (nt, TILE, m)), 2)

    # Phase C: fixed-m scan; per step one contiguous packed-triangle tile
    # per image-tile (a single gather), tested densely against the tile's
    # TILE rays with componentwise Moller-Trumbore.
    offs = jnp.arange(grid.block_size, dtype=jnp.int32)
    otx = ox.reshape(nt, TILE, 1)
    oty = oy.reshape(nt, TILE, 1)
    otz = oz.reshape(nt, TILE, 1)
    dtx = d[:, 0].reshape(nt, TILE, 1)
    dty = d[:, 1].reshape(nt, TILE, 1)
    dtz = d[:, 2].reshape(nt, TILE, 1)
    guard3 = guard.reshape(nt, TILE)
    prev3 = prev_id.reshape(nt, TILE)

    def step(carry, i):
        t_best, best_id = carry                       # (nt, TILE)
        tile_ok = jnp.isfinite(cand_entry_t[:, i])    # (nt,)
        first = cand_first[:, i]                      # (nt,)
        slot = first[:, None] + offs[None, :]         # (nt, BS)
        slot = jnp.minimum(slot, tris.capacity - 1)
        in_blk = jnp.broadcast_to(tile_ok[:, None], slot.shape)
        rows = grid.tri_blocks[cand_gid[:, i]]        # (nt, BS, 12)
        pax, pay, paz = rows[..., 0], rows[..., 1], rows[..., 2]
        abx, aby, abz = rows[..., 3], rows[..., 4], rows[..., 5]
        acx, acy, acz = rows[..., 6], rows[..., 7], rows[..., 8]
        tvalid = rows[..., 9] > 0.5
        # (nt, TILE, BS) distances.
        t = _mt_cw(otx, oty, otz, dtx, dty, dtz,
                   pax[:, None, :], pay[:, None, :], paz[:, None, :],
                   abx[:, None, :], aby[:, None, :], abz[:, None, :],
                   acx[:, None, :], acy[:, None, :], acz[:, None, :])
        useful = e_ray[:, :, i] < t_best              # (nt, TILE)
        ok = (in_blk[:, None, :] & tvalid[:, None, :]
              & useful[:, :, None]
              & (t < t_best[:, :, None])
              & ~(guard3[:, :, None] & (slot[:, None, :] == prev3[:, :, None])))
        t = jnp.where(ok, t, _BIG)
        arg = jnp.argmin(t, axis=2)                   # (nt, TILE)
        tmin = jnp.take_along_axis(t, arg[:, :, None], 2)[:, :, 0]
        smin = jnp.take_along_axis(
            jnp.broadcast_to(slot[:, None, :], t.shape), arg[:, :, None],
            2)[:, :, 0]
        closer = tmin < t_best
        return (jnp.where(closer, tmin, t_best),
                jnp.where(closer, smin, best_id)), None

    init = (t_init.reshape(nt, TILE),
            jnp.full((nt, TILE), -1, jnp.int32))
    (t_best, best_id), _ = jax.lax.scan(step, init, jnp.arange(m))
    return t_best.reshape(b), best_id.reshape(b)


def traverse_closest(grid: BlockGrid, tris: Triangles, o, d, t_max,
                     prev_kind, prev_id):
    b = o.shape[0]
    t0 = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (b,))
    chunk = min(_RAY_CHUNK, -(-b // grid.tile) * grid.tile)
    n_chunks = -(-b // chunk)
    pad = n_chunks * chunk - b
    if pad == 0 and n_chunks == 1:
        return _traverse_chunk(grid, tris, o, d, t0, prev_kind, prev_id)

    def pad0(x, fill=0.0):
        return jnp.concatenate(
            [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)], 0)

    oc = pad0(o).reshape(n_chunks, chunk, 3)
    dc = pad0(d, 1.0).reshape(n_chunks, chunk, 3)
    tc = pad0(t0).reshape(n_chunks, chunk)
    pk = pad0(prev_kind).reshape(n_chunks, chunk)
    pi = pad0(prev_id, -1).reshape(n_chunks, chunk)

    def one(args):
        o_, d_, t_, pk_, pi_ = args
        return _traverse_chunk(grid, tris, o_, d_, t_, pk_, pi_)

    t_best, best_id = jax.lax.map(one, (oc, dc, tc, pk, pi))
    return t_best.reshape(-1)[:b], best_id.reshape(-1)[:b]


def traverse_any(grid: BlockGrid, tris: Triangles, o, d, max_dist,
                 prev_kind, prev_id):
    md = jnp.broadcast_to(jnp.asarray(max_dist, jnp.float32), (o.shape[0],))
    t_best, _ = traverse_closest(grid, tris, o, d, md, prev_kind, prev_id)
    return t_best < md


# ---------------------------------------------------------------------------
# Scene-level dispatch.
# ---------------------------------------------------------------------------

def build(scene: Scene, block_size: int = DEFAULT_BLOCK_SIZE,
          **kwargs) -> Scene:
    """Attaches the two-level block table to the scene (reordering its
    triangles).  Stored in the scene's `bvh` slot as a BlockGrid.  Ships
    the finished scene to the default device in one batched transfer."""
    tris2, grid = build_blocks(scene.triangles, block_size, **kwargs)
    return jax.device_put(scene.replace(triangles=tris2, bvh=grid))


def intersect_scene_blocks(scene: Scene, o, d, prev_kind, prev_id,
                           t_max=_BIG, differentiable: bool = False) -> Hit:
    grid = scene.bvh
    assert isinstance(grid, BlockGrid), "call ops.block_bvh.build first"
    tm = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (o.shape[0],))
    t_pl, id_pl = nv.closest_planes(scene.planes, o, d, tm, prev_kind, prev_id)
    t_sp, id_sp = nv.closest_spheres(scene.spheres, o, d, tm, prev_kind, prev_id)
    t_tr, id_tr = traverse_closest(grid, scene.triangles, o, d, tm,
                                   prev_kind, prev_id)
    if differentiable:
        # The traversal walks frozen block tables (no gradient path); the
        # winner's t is re-derived from the live triangle table so hit
        # points/normals/uvs differentiate w.r.t. vertex parameters.
        id_tr = jax.lax.stop_gradient(id_tr)
        t_tr = nv.recompute_tri_t(scene.triangles, o, d, id_tr)
    t_tr = jnp.where(id_tr >= 0, t_tr, _BIG)
    t_li, id_li = nv.closest_lights(scene.lights, o, d, tm, prev_kind, prev_id)
    return nv._fill_hit(scene, o, d, t_pl, id_pl, t_sp, id_sp, t_tr, id_tr,
                        t_li, id_li)


def occluded_blocks(scene: Scene, o, d, max_dist, prev_kind, prev_id):
    grid = scene.bvh
    assert isinstance(grid, BlockGrid), "call ops.block_bvh.build first"
    t_pl, _ = nv.closest_planes(scene.planes, o, d, max_dist, prev_kind, prev_id)
    t_sp, _ = nv.closest_spheres(scene.spheres, o, d, max_dist, prev_kind,
                                 prev_id, exclude_prev=True)
    blocked = traverse_any(grid, scene.triangles, o, d, max_dist,
                           prev_kind, prev_id)
    return blocked | (t_pl < max_dist) | (t_sp < max_dist)
