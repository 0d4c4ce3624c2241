"""BVH build + stackless escape-index traversal (the exact BVH reference).

The reference builds a bucket-SAH BVH with explicit stacks and traverses it
with a 512-deep stack and near-child-first ordering (reference
app/MobileRT/Accelerators/BVH.hpp:161-283 build, 327-384 traversal).
Pointer-chasing stacks are hostile to XLA, so this module re-designs both
halves for it:

 - **Build** (numpy, once per scene): median-split over the longest
   centroid axis, leaves <= 4 triangles, nodes emitted in DFS preorder,
   triangles physically reordered so every leaf is a contiguous range.
   Each node stores an *escape index* (`node_skip`): the traversal is then
   a single forward-moving cursor — no stack, no recursion.
 - **Traversal** (JAX): each ray walks `cursor = hit ? cursor+1 : skip`,
   testing <= 4 triangles per leaf with masked vector ops.  The whole batch
   runs as one `while_loop` over fixed-shape gathers: uniform control flow,
   divergence handled by masking.  The renderer traces through the block
   BVH (ops/block_bvh.py), which reuses this build; this walk stays as an
   exact reference for it.

Also hosts the ray/AABB slab test (reference AABB.cpp:34-54).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..types import BVH, Hit, Scene, Triangles
from . import intersect as nv

LEAF_SIZE = 4
_BIG = C.RAY_LENGTH_MAX


# ---------------------------------------------------------------------------
# Build (host side).
# ---------------------------------------------------------------------------

_SAH_BUCKETS = 10  # reference bucket count (BVH.hpp getSplitIndexSah)


def _sah_split(cen_axis: np.ndarray, bmin: np.ndarray, bmax: np.ndarray):
    """Binned SAH split (the reference's 10-bucket strategy,
    BVH.hpp:398-439): bucket centroids along the longest axis, pick the
    bucket boundary minimizing count*surfaceArea left + right.  Returns
    (mid, permutation) partitioning [0, n) into [0, mid) and [mid, n).
    Falls back to a median split when centroids are degenerate."""
    n = cen_axis.shape[0]
    c0, c1 = cen_axis.min(), cen_axis.max()
    if c1 - c0 < 1e-12:
        mid = n // 2
        return mid, np.argpartition(cen_axis, mid)

    nb = _SAH_BUCKETS
    bins = np.minimum(((cen_axis - c0) / (c1 - c0) * nb).astype(np.int64),
                      nb - 1)
    counts = np.bincount(bins, minlength=nb)

    big = np.float64(1e30)
    lo_b = np.full((nb, 3), big)
    hi_b = np.full((nb, 3), -big)
    for b in range(nb):
        sel = bins == b
        if counts[b]:
            lo_b[b] = bmin[sel].min(0)
            hi_b[b] = bmax[sel].max(0)

    def area(lo, hi):
        e = np.maximum(hi - lo, 0.0)
        return 2.0 * (e[:, 0] * e[:, 1] + e[:, 0] * e[:, 2]
                      + e[:, 1] * e[:, 2])

    pre_lo = np.minimum.accumulate(lo_b, 0)
    pre_hi = np.maximum.accumulate(hi_b, 0)
    suf_lo = np.minimum.accumulate(lo_b[::-1], 0)[::-1]
    suf_hi = np.maximum.accumulate(hi_b[::-1], 0)[::-1]
    nl = np.cumsum(counts)[:-1]                     # left counts per cut
    nr = n - nl
    cost = (nl * area(pre_lo[:-1], pre_hi[:-1])
            + nr * area(suf_lo[1:], suf_hi[1:]))
    cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
    if not np.isfinite(cost).any():
        mid = n // 2
        return mid, np.argpartition(cen_axis, mid)
    cut = int(np.argmin(cost))                      # split after bucket `cut`
    part = np.argsort(bins > cut, kind="stable")
    return int(nl[cut]), part


def build_triangle_bvh(tris: Triangles,
                       leaf_size: int = LEAF_SIZE) -> Tuple[Triangles, BVH]:
    """Builds the threaded BVH and returns (reordered triangles, bvh).

    Only valid triangles participate; padding rows are moved to the tail
    and never referenced by any leaf.
    """
    pa = np.asarray(tris.point_a)
    ab = np.asarray(tris.ab)
    ac = np.asarray(tris.ac)
    valid = np.asarray(tris.valid)
    n_valid = int(valid.sum())

    if n_valid == 0:
        bvh = BVH(node_min=np.zeros((1, 3), np.float32),
                  node_max=np.zeros((1, 3), np.float32),
                  node_first=np.zeros((1,), np.int32),
                  node_skip=np.ones((1,), np.int32),
                  node_count=np.zeros((1,), np.int32))
        return tris, bvh

    ids = np.nonzero(valid)[0]
    pb = pa + ab
    pc = pa + ac
    bb_min = np.minimum(pa, np.minimum(pb, pc))[ids]
    bb_max = np.maximum(pa, np.maximum(pb, pc))[ids]
    centroid = 0.5 * (bb_min + bb_max)

    order = np.arange(n_valid)

    node_min, node_max, node_first, node_count = [], [], [], []
    out_order = np.empty(n_valid, np.int64)
    # Iterative DFS emitting nodes in preorder; each node records its
    # primitive range so escape indices can be resolved afterwards.
    stack = [(0, n_valid)]
    range_lo, range_hi = [], []

    while stack:
        lo, hi = stack.pop()
        idx = order[lo:hi]
        bmin = bb_min[idx].min(0)
        bmax = bb_max[idx].max(0)
        node_min.append(bmin)
        node_max.append(bmax)
        range_lo.append(lo)
        range_hi.append(hi)
        if hi - lo <= leaf_size:
            node_first.append(lo)
            node_count.append(hi - lo)
            out_order[lo:hi] = idx
        else:
            node_first.append(0)
            node_count.append(0)
            cen = centroid[idx]
            ext = cen.max(0) - cen.min(0)
            axis = int(np.argmax(ext))
            mid, part = _sah_split(cen[:, axis], bb_min[idx], bb_max[idx])
            order[lo:hi] = idx[part]
            # Push right first so left is emitted next (preorder).
            stack.append((lo + mid, hi))
            stack.append((lo, lo + mid))

    k = len(node_min)
    node_first = np.asarray(node_first, np.int32)
    node_count = np.asarray(node_count, np.int32)
    range_lo = np.asarray(range_lo)
    range_hi = np.asarray(range_hi)

    # skip[i] = the next node after i's subtree.  In preorder, i's subtree
    # is exactly the nodes j >= i with range within [range_lo[i],
    # range_hi[i]); the first node after it is the smallest j > i with
    # range_lo[j] >= range_hi[i].  Compute with a monotonic stack.
    node_skip = np.full(k, k, np.int32)
    stack2 = []  # indices whose skip is pending
    for i in range(k):
        while stack2 and range_hi[stack2[-1]] <= range_lo[i]:
            node_skip[stack2.pop()] = i
        stack2.append(i)
    # Remaining nodes' subtrees extend to the end: skip = k (terminate).

    # Physically reorder triangles: new position p holds old out_order[p].
    perm = np.concatenate([ids[out_order],
                           np.nonzero(~valid)[0]]).astype(np.int32)

    def g(a):
        # Stays numpy: the caller (or the scene-level build()) ships the
        # finished tables to the device in one batched transfer.
        return np.asarray(a)[perm]

    tris2 = Triangles(
        point_a=g(tris.point_a), ab=g(tris.ab), ac=g(tris.ac),
        normal_a=g(tris.normal_a), normal_b=g(tris.normal_b),
        normal_c=g(tris.normal_c),
        uv_a=g(tris.uv_a), uv_b=g(tris.uv_b), uv_c=g(tris.uv_c),
        mat_id=g(tris.mat_id), valid=g(tris.valid))

    bvh = BVH(node_min=np.stack(node_min).astype(np.float32),
              node_max=np.stack(node_max).astype(np.float32),
              node_first=node_first,
              node_skip=node_skip,
              node_count=node_count)
    return tris2, bvh


def build(scene: Scene) -> Scene:
    """Attaches a triangle BVH to the scene (reordering its triangles).
    Spheres and planes stay on the linear path — real scenes carry at most
    a handful (the reference builds per-type BVHs but its OBJ scenes are
    triangles-only).  The finished scene ships to the default device in one
    batched transfer."""
    tris2, bvh = build_triangle_bvh(scene.triangles)
    return jax.device_put(scene.replace(triangles=tris2, bvh=bvh))


# ---------------------------------------------------------------------------
# Traversal (device side).
# ---------------------------------------------------------------------------

def _slab_test(o, inv_d, bmin, bmax, t_best):
    """Ray/AABB slab test (reference AABB.cpp:34-54), vectorized over the
    batch; returns whether the box is hit closer than t_best."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (tnear <= tfar) & (tfar >= 0.0) & (tnear < t_best)


def traverse_closest(bvh: BVH, tris: Triangles, o, d, t_max,
                     prev_kind, prev_id):
    """Closest-hit over the triangle BVH for a ray batch.

    Returns (t, prim_id) with prim_id indexing the *reordered* triangle
    array.  One while_loop iteration advances every ray's cursor by one
    node; finished rays idle at cursor == K.
    """
    b = o.shape[0]
    k = bvh.num_nodes
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-30, jnp.where(d < 0, -1e-30, 1e-30), d)
    guard = prev_kind == C.PRIM_TRIANGLE

    def cond(state):
        cursor, t_best, best_id = state
        return jnp.any(cursor < k)

    def body(state):
        cursor, t_best, best_id = state
        cur = jnp.minimum(cursor, k - 1)
        bmin = bvh.node_min[cur]
        bmax = bvh.node_max[cur]
        cnt = bvh.node_count[cur]
        first = bvh.node_first[cur]
        active = cursor < k

        hit_box = _slab_test(o, inv_d, bmin, bmax, t_best) & active
        is_leaf = (cnt > 0) & hit_box

        # Test up to LEAF_SIZE triangles (masked).
        slot = first[:, None] + jnp.arange(LEAF_SIZE)[None, :]
        slot = jnp.minimum(slot, tris.capacity - 1)
        in_leaf = (jnp.arange(LEAF_SIZE)[None, :] < cnt[:, None]) & is_leaf[:, None]

        pa = tris.point_a[slot]           # (B, L, 3)
        ab = tris.ab[slot]
        ac = tris.ac[slot]
        t, u, v = _tri_batch(o, d, pa, ab, ac)
        tvalid = tris.valid[slot]
        ok = in_leaf & tvalid & (t < t_best[:, None]) \
            & ~(guard[:, None] & (slot == prev_id[:, None]))
        t = jnp.where(ok, t, _BIG)
        arg = jnp.argmin(t, axis=1)
        tmin = jnp.take_along_axis(t, arg[:, None], 1)[:, 0]
        smin = jnp.take_along_axis(slot, arg[:, None], 1)[:, 0]
        closer = tmin < t_best
        t_best = jnp.where(closer, tmin, t_best)
        best_id = jnp.where(closer, smin, best_id)

        descend = hit_box & (cnt == 0)
        nxt = jnp.where(descend, cursor + 1, bvh.node_skip[cur])
        cursor = jnp.where(active, nxt, cursor)
        return cursor, t_best, best_id

    t0 = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (b,))
    state = (jnp.zeros((b,), jnp.int32), t0, jnp.full((b,), -1, jnp.int32))
    _, t_best, best_id = jax.lax.while_loop(cond, body, state)
    return t_best, best_id


def _tri_batch(o, d, pa, ab, ac):
    """Moller-Trumbore for (B, L) triangle tiles against (B,) rays; same
    acceptance tests as the naive kernel (Triangle.cpp:63-109)."""
    ov = o[:, None, :]
    dv = d[:, None, :]
    p = jnp.cross(dv, ac)
    det = jnp.sum(ab * p, -1)
    inv = 1.0 / jnp.where(jnp.abs(det) < C.EPSILON, 1.0, det)
    tvec = ov - pa
    u = inv * jnp.sum(tvec * p, -1)
    q = jnp.cross(tvec, ab)
    v = inv * jnp.sum(dv * q, -1)
    t = inv * jnp.sum(ac * q, -1)
    ok = ((jnp.abs(det) >= C.EPSILON) & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0) & (t >= C.EPSILON))
    return jnp.where(ok, t, _BIG), u, v


def traverse_any(bvh: BVH, tris: Triangles, o, d, max_dist,
                 prev_kind, prev_id):
    """Shadow (any-hit) traversal with early exit per ray."""
    b = o.shape[0]
    k = bvh.num_nodes
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-30, jnp.where(d < 0, -1e-30, 1e-30), d)
    guard = prev_kind == C.PRIM_TRIANGLE
    md = jnp.broadcast_to(jnp.asarray(max_dist, jnp.float32), (b,))

    def cond(state):
        cursor, found = state
        return jnp.any((cursor < k) & ~found)

    def body(state):
        cursor, found = state
        cur = jnp.minimum(cursor, k - 1)
        active = (cursor < k) & ~found
        hit_box = _slab_test(o, inv_d, bvh.node_min[cur], bvh.node_max[cur],
                             md) & active
        cnt = bvh.node_count[cur]
        first = bvh.node_first[cur]
        is_leaf = (cnt > 0) & hit_box

        slot = first[:, None] + jnp.arange(LEAF_SIZE)[None, :]
        slot = jnp.minimum(slot, tris.capacity - 1)
        in_leaf = (jnp.arange(LEAF_SIZE)[None, :] < cnt[:, None]) & is_leaf[:, None]
        t, _, _ = _tri_batch(o, d, tris.point_a[slot], tris.ab[slot],
                             tris.ac[slot])
        ok = in_leaf & tris.valid[slot] & (t < md[:, None]) \
            & ~(guard[:, None] & (slot == prev_id[:, None]))
        found = found | jnp.any(ok, axis=1)

        descend = hit_box & (cnt == 0)
        nxt = jnp.where(descend, cursor + 1, bvh.node_skip[cur])
        cursor = jnp.where(active, nxt, cursor)
        return cursor, found

    state = (jnp.zeros((b,), jnp.int32), jnp.zeros((b,), bool))
    _, found = jax.lax.while_loop(cond, body, state)
    return found


# ---------------------------------------------------------------------------
# Scene-level dispatch (planes/spheres linear, triangles via BVH, lights).
# ---------------------------------------------------------------------------

def intersect_scene_bvh(scene: Scene, o, d, prev_kind, prev_id,
                        t_max=_BIG) -> Hit:
    assert scene.bvh is not None, "call ops.bvh.build(scene) first"
    tm = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (o.shape[0],))
    t_pl, id_pl = nv.closest_planes(scene.planes, o, d, tm, prev_kind, prev_id)
    t_sp, id_sp = nv.closest_spheres(scene.spheres, o, d, tm, prev_kind, prev_id)
    t_tr, id_tr = traverse_closest(scene.bvh, scene.triangles, o, d, tm,
                                   prev_kind, prev_id)
    t_tr = jnp.where(id_tr >= 0, t_tr, _BIG)
    t_li, id_li = nv.closest_lights(scene.lights, o, d, tm, prev_kind, prev_id)
    return nv._fill_hit(scene, o, d, t_pl, id_pl, t_sp, id_sp, t_tr, id_tr,
                        t_li, id_li)


def occluded_bvh(scene: Scene, o, d, max_dist, prev_kind, prev_id):
    assert scene.bvh is not None, "call ops.bvh.build(scene) first"
    t_pl, _ = nv.closest_planes(scene.planes, o, d, max_dist, prev_kind, prev_id)
    t_sp, _ = nv.closest_spheres(scene.spheres, o, d, max_dist, prev_kind,
                                 prev_id, exclude_prev=True)
    blocked = traverse_any(scene.bvh, scene.triangles, o, d, max_dist,
                           prev_kind, prev_id)
    return blocked | (t_pl < max_dist) | (t_sp < max_dist)
