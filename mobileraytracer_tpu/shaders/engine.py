"""The wavefront shading engine.

The reference shades by *recursion*: `Shader::rayTrace` traces, binds a
material and calls a virtual `shade()` which may recurse into reflection /
refraction / diffuse-indirect children (reference app/MobileRT/Shader.cpp:
86-123; Components/Shaders/*.cpp).  Recursion does not exist under XLA, so
this engine evaluates the same contribution *tree* iteratively: each lane
(ray) owns a small explicit stack of pending tree nodes (ray, depth,
throughput weight); a `lax.scan` pops one node per lane per iteration,
traces the whole batch at once, accumulates the node's own contribution and
pushes its children.  Contributions are purely additive with multiplicative
weights, so the walk order does not change the sum.

Every iteration is a full-batch trace + NEE — uniform work, no divergence.
Radiance is differentiable w.r.t. material tables (albedo/emission)
because all weights are smooth functions of them; the scan has a fixed
trip count so reverse-mode AD works.

The PathTracer NEE guard (reference PathTracer.cpp:107-113) is post-order:
a node whose NEE succeeded (Ld > 0) zeroes its *entire* indirect-diffuse
subtree contribution when the diffuse spine below later terminated at an
emissive surface (`intersectedLight` propagates up through diffuse-indirect
edges only, Shader.cpp:123 return).  The walker reproduces this exactly
with per-lane *bucketed accumulation*: each diffuse-indirect edge opens a
bucket; contributions route to the innermost enclosing bucket; because the
per-lane stack is LIFO the walk is a DFS, so a bucket closes exactly when
the stack top's bucket depth drops back to its level — at close the bucket
either flows into its enclosing accumulator or is killed by the guard.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .. import constants as C
from .. import sampling
from ..ops import intersect
from ..types import Hit, RenderConfig, Scene
from . import common


class Tracer(NamedTuple):
    """Accelerator dispatch: closest-hit and shadow queries."""
    closest: Callable  # (scene, o, d, prev_kind, prev_id) -> Hit
    occluded: Callable  # (scene, o, d, max_dist, prev_kind, prev_id) -> bool


def make_tracer(config: RenderConfig, differentiable: bool = False) -> Tracer:
    """The closest-hit and shadow queries of `config.accelerator`.  The grid
    and BVH tracers read the structure that `ops.build_accelerator` put in
    the scene's `bvh` slot; a grid config on a scene without its grid falls
    back to the naive scan."""
    if config.accelerator in (C.ACC_NONE, C.ACC_NAIVE):
        return Tracer(closest=intersect.intersect_scene_naive,
                      occluded=intersect.occluded_naive)
    if config.accelerator == C.ACC_REGULAR_GRID:
        from ..ops import grid as grid_ops

        def closest_g(scene, o, d, pk, pi):
            if isinstance(scene.bvh, grid_ops.RegularGrid):
                return grid_ops.intersect_scene_grid(scene, o, d, pk, pi)
            return intersect.intersect_scene_naive(scene, o, d, pk, pi)

        def occluded_g(scene, o, d, md, pk, pi):
            if isinstance(scene.bvh, grid_ops.RegularGrid):
                return grid_ops.occluded_grid(scene, o, d, md, pk, pi)
            return intersect.occluded_naive(scene, o, d, md, pk, pi)

        return Tracer(closest=closest_g, occluded=occluded_g)
    if config.accelerator == C.ACC_BVH:
        from ..ops import block_bvh

        def closest(scene, o, d, pk, pi):
            return block_bvh.intersect_scene_blocks(
                scene, o, d, pk, pi, differentiable=differentiable)

        def occluded(scene, o, d, md, pk, pi):
            if differentiable:
                # Occlusion is boolean (no gradient path); keep the
                # traversal entirely off the AD tape.
                sg = jax.lax.stop_gradient
                scene, o, d, md = sg(scene), sg(o), sg(d), sg(md)
            return block_bvh.occluded_blocks(scene, o, d, md, pk, pi)

        return Tracer(closest=closest, occluded=occluded)
    raise ValueError(f"unknown accelerator {config.accelerator}")


# ---------------------------------------------------------------------------
# Stack helpers.  The per-lane stack arrays have shape (B, S, ...).
# ---------------------------------------------------------------------------

class WalkState(NamedTuple):
    sp: jnp.ndarray         # (B,) stack pointer (number of pending entries)
    st_org: jnp.ndarray     # (B, S, 3)
    st_dir: jnp.ndarray     # (B, S, 3)
    st_weight: jnp.ndarray  # (B, S, 3) product of K factors along ancestors
    st_depth: jnp.ndarray   # (B, S)
    st_pkind: jnp.ndarray   # (B, S) source-primitive kind (self-hit guard)
    st_pid: jnp.ndarray     # (B, S) source-primitive id
    st_flags: jnp.ndarray   # (B, S) bit 0: entry is a diffuse-indirect child
    st_nb: jnp.ndarray      # (B, S) number of enclosing diffuse buckets
    rgb: jnp.ndarray        # (B, 3) accumulated radiance
    rays: jnp.ndarray      # (B,) number of rays popped (casted-ray metric)
    pops: jnp.ndarray      # (B,) pops so far — the lane-local iteration
    # counter.  Event keys fold in this counter (not a global iteration
    # index) so the compacted walk below draws the exact same RNG stream a
    # full-batch walk would: in a full-batch walk every lane pops every
    # iteration, making pops == iteration index.
    #
    # PathTracer NEE-guard buckets (PathTracer.cpp:107-113): one slot per
    # diffuse-indirect nesting level (K = depth_max).  Dummy (B, 1) arrays
    # for the other shaders.
    bkt_rgb: jnp.ndarray    # (B, K, 3) pending subtree contribution
    bkt_ld: jnp.ndarray     # (B, K) bool: the edge's parent had Ld > 0
    bkt_light: jnp.ndarray  # (B, K) bool: the diffuse spine hit an emitter
    bkt_pspine: jnp.ndarray  # (B, K) bool: the edge's parent is itself a
    #                          spine node of the enclosing bucket
    bkt_open: jnp.ndarray   # (B, K) bool


FLAG_SPINE = 1


def _push(state: WalkState, mask, org, dirn, weight, depth, pkind, pid,
          flags, nb):
    """Pushes one entry on each masked lane's stack (drops on overflow —
    cannot happen for the reference's single-lobe materials within the
    default stack size)."""
    s = state.st_depth.shape[1]
    pos = jnp.clip(state.sp, 0, s - 1)
    lane_ok = mask & (state.sp < s)
    onehot = (jnp.arange(s)[None, :] == pos[:, None]) & lane_ok[:, None]
    oh3 = onehot[:, :, None]
    return state._replace(
        sp=jnp.where(lane_ok, state.sp + 1, state.sp),
        st_org=jnp.where(oh3, org[:, None, :], state.st_org),
        st_dir=jnp.where(oh3, dirn[:, None, :], state.st_dir),
        st_weight=jnp.where(oh3, weight[:, None, :], state.st_weight),
        st_depth=jnp.where(onehot, depth[:, None], state.st_depth),
        st_pkind=jnp.where(onehot, pkind[:, None], state.st_pkind),
        st_pid=jnp.where(onehot, pid[:, None], state.st_pid),
        st_flags=jnp.where(onehot, flags[:, None], state.st_flags),
        st_nb=jnp.where(onehot, nb[:, None], state.st_nb),
    )


def _pop(state: WalkState):
    idx = jnp.maximum(state.sp - 1, 0)
    b = jnp.arange(state.sp.shape[0])
    entry = dict(
        org=state.st_org[b, idx],
        dirn=state.st_dir[b, idx],
        weight=state.st_weight[b, idx],
        depth=state.st_depth[b, idx],
        pkind=state.st_pkind[b, idx],
        pid=state.st_pid[b, idx],
        flags=state.st_flags[b, idx],
        nb=state.st_nb[b, idx],
    )
    active = state.sp > 0
    return state._replace(sp=jnp.maximum(state.sp - 1, 0),
                          rays=state.rays + active.astype(jnp.int32),
                          pops=state.pops + 1), entry, active


def _close_buckets(state: WalkState, maxnb):
    """Closes every open bucket at level >= the lane's current stack-top
    bucket depth `maxnb` — at that point no pending entry can contribute to
    the bucket's subtree, so the reference's post-order guard is decidable
    (PathTracer.cpp:107-113): a killed bucket is discarded outright,
    otherwise it flows into its enclosing accumulator, and its spine-light
    flag propagates to the enclosing bucket when its parent was itself a
    spine node (`return intersectedLight`, PathTracer.cpp:143)."""
    k_levels = state.bkt_open.shape[1]
    rgb = state.rgb
    bkt_rgb, bkt_ld = state.bkt_rgb, state.bkt_ld
    bkt_light, bkt_pspine = state.bkt_light, state.bkt_pspine
    bkt_open = state.bkt_open
    for k in range(k_levels - 1, -1, -1):
        close = bkt_open[:, k] & (maxnb <= k)
        killed = bkt_ld[:, k] & bkt_light[:, k]
        flow = jnp.where((close & ~killed)[:, None], bkt_rgb[:, k], 0.0)
        if k == 0:
            rgb = rgb + flow
        else:
            bkt_rgb = bkt_rgb.at[:, k - 1].add(flow)
            bkt_light = bkt_light.at[:, k - 1].set(
                bkt_light[:, k - 1]
                | (close & bkt_light[:, k] & bkt_pspine[:, k]))
        bkt_rgb = bkt_rgb.at[:, k].set(
            jnp.where(close[:, None], 0.0, bkt_rgb[:, k]))
        bkt_light = bkt_light.at[:, k].set(jnp.where(close, False,
                                                     bkt_light[:, k]))
        bkt_ld = bkt_ld.at[:, k].set(jnp.where(close, False, bkt_ld[:, k]))
        bkt_open = bkt_open.at[:, k].set(jnp.where(close, False,
                                                   bkt_open[:, k]))
    return state._replace(rgb=rgb, bkt_rgb=bkt_rgb, bkt_ld=bkt_ld,
                          bkt_light=bkt_light, bkt_open=bkt_open)


# ---------------------------------------------------------------------------
# The walker.
# ---------------------------------------------------------------------------

def trace_radiance(scene: Scene, config: RenderConfig, tracer: Tracer,
                   o: jnp.ndarray, d: jnp.ndarray, keys: jax.Array,
                   differentiable: bool = False):
    """Evaluates the Whitted or path-tracing contribution tree for a batch
    of primary rays.  Returns (rgb, casted_ray_count)."""
    b = o.shape[0]
    s = config.stack_size
    shader = config.shader

    zeros3 = jnp.zeros((b, 3), jnp.float32)
    # Bucket slots only carry state for the PathTracer's post-order guard.
    kb = config.depth_max if shader == C.SHADER_PATHTRACER else 1
    state = WalkState(
        sp=jnp.ones((b,), jnp.int32),
        st_org=jnp.zeros((b, s, 3), jnp.float32).at[:, 0].set(o),
        st_dir=jnp.zeros((b, s, 3), jnp.float32).at[:, 0].set(d),
        st_weight=jnp.zeros((b, s, 3), jnp.float32).at[:, 0].set(1.0),
        st_depth=jnp.ones((b, s), jnp.int32),  # primary rays have depth 1
        st_pkind=jnp.zeros((b, s), jnp.int32),
        st_pid=jnp.full((b, s), -1, jnp.int32),
        st_flags=jnp.zeros((b, s), jnp.int32),
        st_nb=jnp.zeros((b, s), jnp.int32),
        rgb=zeros3,
        rays=jnp.zeros((b,), jnp.int32),
        pops=jnp.zeros((b,), jnp.int32),
        bkt_rgb=jnp.zeros((b, kb, 3), jnp.float32),
        bkt_ld=jnp.zeros((b, kb), bool),
        bkt_light=jnp.zeros((b, kb), bool),
        bkt_pspine=jnp.zeros((b, kb), bool),
        bkt_open=jnp.zeros((b, kb), bool),
    )

    def step(state: WalkState, keys, primary: bool = False):
        it = state.pops                      # (lane-local) iteration index
        bb = state.sp.shape[0]               # chunk size (== b uncompacted)
        state, e, active = _pop(state)
        # Drained lanes re-trace a duplicate of a live lane in their subtile
        # (result discarded; keeps traversal bounds tight) and fully-dead
        # subtiles park at the far sentinel and exit immediately — the
        # wavefront analogue of the reference's threads going idle once
        # their tiles are done (Renderer.cpp:117-167).
        org, dirn = common.park_dead_lanes(e["org"], e["dirn"], active)
        hit = tracer.closest(scene, org, dirn, e["pkind"], e["pid"])
        le, kd, ks, kt, ior = common.bind_material(scene, hit)

        hit_ok = active & ~hit.missed
        # Depth cap first, then emissive early-out — the reference's shade()
        # order (Whitted.cpp:14-24, PathTracer.cpp:23-33).
        in_depth = e["depth"] <= config.depth_max
        emissive = common.has_positive(le)
        live = hit_ok & in_depth

        node_keys = sampling.event_key(keys, it, 0)
        zero_i = jnp.zeros((bb,), jnp.int32)

        # --- emission ----------------------------------------------------
        emit_w = live & emissive
        contrib = jnp.where(emit_w[:, None], e["weight"] * le, 0.0)

        cont = live & ~emissive  # non-emissive surface: shade + children

        # --- diffuse direct (NEE) ---------------------------------------
        diffuse = cont & common.has_positive(kd)
        if shader in (C.SHADER_WHITTED, C.SHADER_PATHTRACER, C.SHADER_NOSHADOWS):
            nee_keys = sampling.event_key(keys, it, 1)
            # First-bounce NEE with a shared per-group light point traces
            # its occlusion segments REVERSED (from the light point toward
            # the surfaces): the shared origin collapses the traversal's
            # interval hulls to the exact shadow cone (see
            # common.direct_lighting).
            # On the primary step every lane has it == 0, so sharing is
            # statically total and sampling runs on the downsampled key
            # set (bit-identical, ~share_width x cheaper).  With
            # nee_share_secondary the same applies to every step.
            shared_step = primary or config.nee_share_secondary
            # The grid DDA's occlusion walk cannot exclude the endpoint
            # sphere (it guards prev triangles only), so the reversed
            # formulation stays off on ACC_REGULAR_GRID.
            rev = (shared_step and config.nee_reverse
                   and config.accelerator != C.ACC_REGULAR_GRID)
            ld_sum, n_shadow = common.direct_lighting(
                scene, hit, nee_keys, config.samples_light,
                shadows=(shader != C.SHADER_NOSHADOWS),
                occluded_fn=tracer.occluded, mask=diffuse,
                share_mask=None if shared_step else (it == 0),
                share_width=config.nee_share,
                share_all=shared_step, reverse=rev)
            ld = kd * ld_sum / jnp.float32(config.samples_light)
            has_l = scene.lights.num > 0
            ld = jnp.where((diffuse & has_l)[:, None], ld, 0.0)
            contrib = contrib + e["weight"] * ld
            state = state._replace(
                rays=state.rays + jnp.where(diffuse, n_shadow, 0))
            if shader in (C.SHADER_WHITTED, C.SHADER_NOSHADOWS):
                # Ambient term "rgb += kD * 0.1" (Whitted.cpp:91,
                # NoShadows.cpp:46) — added whenever the surface is shaded.
                contrib = contrib + jnp.where(
                    cont[:, None], e["weight"] * kd * C.WHITTED_AMBIENT, 0.0)
        else:
            ld = jnp.zeros((bb, 3), jnp.float32)

        if shader == C.SHADER_PATHTRACER:
            # Route this node's own terms to the innermost enclosing
            # diffuse-edge bucket (or straight to the film when the node is
            # outside every diffuse subtree).
            kb = state.bkt_open.shape[1]
            nb = e["nb"]
            top = nb == 0
            state = state._replace(
                rgb=state.rgb + jnp.where(top[:, None], contrib, 0.0))
            oh = ((jnp.arange(kb)[None, :] == (nb - 1)[:, None])
                  & ~top[:, None])
            state = state._replace(
                bkt_rgb=state.bkt_rgb + jnp.where(oh[:, :, None],
                                                  contrib[:, None, :], 0.0))
            # An emissive hit on a diffuse spine flags the enclosing bucket:
            # `intersectedLight` (PathTracer.cpp:30-33,102).
            spine_emit = emit_w & ((e["flags"] & FLAG_SPINE) != 0) & ~top
            state = state._replace(
                bkt_light=state.bkt_light | (oh & spine_emit[:, None]))
        else:
            state = state._replace(rgb=state.rgb + contrib)

        if shader == C.SHADER_NOSHADOWS:
            return state, None  # no recursion

        # --- children ----------------------------------------------------
        depth1 = e["depth"] + 1

        # Specular reflection child (Whitted.cpp:73-79, PathTracer.cpp:117-124).
        spec = cont & common.has_positive(ks)
        rdir = common.reflect(e["dirn"], hit.normal)
        state = _push(state, spec, hit.point, rdir, e["weight"] * ks, depth1,
                      hit.prim_kind, hit.prim_id, zero_i, e["nb"])

        # Specular transmission child (Whitted.cpp:82-90, PathTracer.cpp:127-135).
        trans = cont & common.has_positive(kt)
        tdir, tvalid = common.refract(e["dirn"], hit.normal, 1.0 / ior)
        state = _push(state, trans & tvalid, hit.point, tdir,
                      e["weight"] * kt, depth1, hit.prim_kind, hit.prim_id,
                      zero_i, e["nb"])

        if shader == C.SHADER_PATHTRACER:
            # Diffuse indirect child with Russian roulette
            # (PathTracer.cpp:88-113): always continue while depth <=
            # RayDepthMin, afterwards continue when u > finishProbability and
            # compensate by 1 / (continueProbability * 0.5).
            rr_key = sampling.event_key(keys, it, 2)
            rr = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(rr_key)
            go_indirect = diffuse & (
                (e["depth"] <= config.depth_min)
                | (rr > C.RR_FINISH_PROBABILITY))
            hemi_key = sampling.event_key(keys, it, 3)
            ndir = sampling.cosine_sample_hemisphere(hemi_key, hit.normal)
            boost = jnp.where(e["depth"] > config.depth_min,
                              1.0 / ((1.0 - C.RR_FINISH_PROBABILITY) * 0.5), 1.0)
            w_ind = e["weight"] * kd * boost[:, None]
            # Open the edge's guard bucket at level nb (the child runs at
            # nb + 1): remember whether this vertex's NEE succeeded and
            # whether the vertex itself sits on the enclosing spine.
            nee_hit = common.has_positive(ld)
            kb = state.bkt_open.shape[1]
            ohb = ((jnp.arange(kb)[None, :] == e["nb"][:, None])
                   & go_indirect[:, None])
            state = state._replace(
                bkt_open=state.bkt_open | ohb,
                bkt_ld=jnp.where(ohb, nee_hit[:, None], state.bkt_ld),
                bkt_light=jnp.where(ohb, False, state.bkt_light),
                bkt_pspine=jnp.where(
                    ohb, ((e["flags"] & FLAG_SPINE) != 0)[:, None],
                    state.bkt_pspine),
                bkt_rgb=jnp.where(ohb[:, :, None], 0.0, state.bkt_rgb))
            flags = jnp.full((bb,), FLAG_SPINE, jnp.int32)
            state = _push(state, go_indirect, hit.point, ndir, w_ind, depth1,
                          hit.prim_kind, hit.prim_id, flags, e["nb"] + 1)

            # Close every bucket whose subtree just drained: the stack top's
            # bucket depth is the number of still-pending levels.
            bidx = jnp.arange(bb)
            topnb = jnp.where(state.sp > 0,
                              state.st_nb[bidx, jnp.maximum(state.sp - 1, 0)],
                              0)
            state = _close_buckets(state, topnb)

        return state, None

    max_iters = 1 if shader == C.SHADER_NOSHADOWS \
        else config.resolved_max_walk_iters()

    # Per-lane iteration budget: in a full-batch walk every lane pops once
    # per iteration, so capping pops at max_iters is exactly the reference
    # truncation contract regardless of the execution layout below.
    def lane_live(st):
        return (st.sp > 0) & (st.pops < max_iters)

    unit = C.SUBTILE * max(1, 128 // C.SUBTILE)  # traversal padding unit

    if differentiable:
        # Fixed trip count => reverse-mode AD works through the walk.
        state, _ = jax.lax.scan(lambda st, _: (step(st, keys)[0], None),
                                state, jnp.arange(max_iters))
    elif b < 8 * unit or shader == C.SHADER_NOSHADOWS:
        # Small batches: plain full-batch loop, stop when drained.
        def cond(carry):
            it, st = carry
            return (it < max_iters) & jnp.any(lane_live(st))

        def body(carry):
            it, st = carry
            st, _ = step(st, keys)
            return it + 1, st

        _, state = jax.lax.while_loop(cond, body, (jnp.asarray(0), state))
    else:
        # Wavefront compaction: iteration 1 runs the full batch (every lane
        # is live), then live lanes are gathered into dense chunks of
        # b/8 rays so late iterations cost O(live), not O(all) — the
        # wavefront analogue of the reference's work-queue shrinking as
        # tiles finish (Renderer.cpp:117-167).  Contributions are additive
        # and event keys are lane-local (see WalkState.pops), so chunked
        # execution is bitwise-identical to the full-batch walk.
        state, _ = step(state, keys, primary=True)
        # Chunk size: the PathTracer keeps ~every diffuse lane live after
        # iteration 1 (indirect bounce), so large chunks amortize the
        # per-iteration fixed costs — which include gather/scatter of the
        # FULL WalkState (tens of MB at big batches) every chunk
        # iteration; Whitted/NoShadows tails carry only specular lanes —
        # small chunks stop the tail from re-tracing mostly-dead batches.
        # The divisors 4 and 32 were tuned on other hardware; they are not
        # yet measured on a GPU.
        div = config.walk_chunk_div
        if div is None:
            div = 4 if shader == C.SHADER_PATHTRACER else 32
        bc = max(unit, (b // div + unit - 1) // unit * unit)
        max_chunks = -(-b // bc) * max_iters

        def cond(carry):
            it, st = carry
            return (it < max_chunks) & jnp.any(lane_live(st))

        # COHERENCE-SORTED compaction (PathTracer only): pick each chunk's
        # lanes in (direction-octant, origin-morton) order of their pending
        # stack-top rays instead of lane order.  Hemisphere bounce rays are
        # directionally incoherent in lane order, which fattens the
        # traversal's 16-ray interval hulls; sorting regroups them into
        # tight bundles.  The
        # image is unchanged: contributions are additive and event keys
        # are lane-local, so processing order is irrelevant (with
        # nee_share_secondary the grouping is a sampling policy and
        # coherent groups are exactly what it wants).  Whitted's tail is
        # mostly mirror rays that are already lane-coherent, so the sort
        # stays off there.
        sort_chunks = shader == C.SHADER_PATHTRACER

        def body(carry):
            it, st = carry
            live = lane_live(st)
            if sort_chunks:
                bidx = jnp.arange(b)
                top = jnp.maximum(st.sp - 1, 0)
                o_t = st.st_org[bidx, top]
                d_t = st.st_dir[bidx, top]
                octant = ((d_t[:, 0] > 0).astype(jnp.int32) * 4
                          + (d_t[:, 1] > 0).astype(jnp.int32) * 2
                          + (d_t[:, 2] > 0).astype(jnp.int32))
                lo = jnp.min(jnp.where(live[:, None], o_t, jnp.inf), axis=0)
                hi = jnp.max(jnp.where(live[:, None], o_t, -jnp.inf), axis=0)
                inv = 1.0 / jnp.maximum(hi - lo, 1e-20)
                q = jnp.clip(((o_t - lo) * inv * 32.0).astype(jnp.int32),
                             0, 31)

                def spread5(x):        # 5 bits -> every 3rd bit
                    x = (x | (x << 8)) & 0x100F
                    x = (x | (x << 4)) & 0x10C3
                    x = (x | (x << 2)) & 0x1249
                    return x

                morton = (spread5(q[:, 0]) | (spread5(q[:, 1]) << 1)
                          | (spread5(q[:, 2]) << 2))
                key_c = octant * (1 << 15) + morton
                order = jnp.argsort(jnp.where(
                    live, key_c, jnp.int32(1 << 24))).astype(jnp.int32)
                # A slice of a permutation (all distinct); dead lanes
                # sorted past the live ones may fill the tail of a final
                # partial chunk — processing them is a no-op.
                idx = order[:bc]
            else:
                pos = jnp.cumsum(live) - 1
                sel = live & (pos < bc)
                # Unfilled slots default to lane 0; duplicates compute the
                # identical update and the scatter writes it once.
                idx = jnp.zeros((bc,), jnp.int32).at[
                    jnp.where(sel, pos, bc)].set(
                        jnp.arange(b, dtype=jnp.int32), mode="drop")
            sub = jax.tree.map(lambda a: a[idx], st)
            sub, _ = step(sub, keys[idx])
            st = jax.tree.map(lambda a, u: a.at[idx].set(u), st, sub)
            return it + 1, st

        _, state = jax.lax.while_loop(cond, body, (jnp.asarray(0), state))
    if shader == C.SHADER_PATHTRACER:
        # Force-close any bucket left open (lanes truncated by the pops
        # budget with pending stack entries): unresolved spines count as
        # "did not reach a light", matching the reference's recursion which
        # would have returned false past the depth cap.
        state = _close_buckets(state, jnp.zeros((b,), jnp.int32))
    return state.rgb, jnp.sum(state.rays)


# ---------------------------------------------------------------------------
# Single-trace shaders (DepthMap / DiffuseMaterial) and dispatch.
# ---------------------------------------------------------------------------

def shade_depthmap(scene: Scene, config: RenderConfig, tracer: Tracer,
                   o, d, max_point):
    """Grayscale by distance (reference DepthMap.cpp:12-17): maxDist =
    |maxPoint - ray.origin| * 1.1; depth = max((maxDist - t)/maxDist, 0)."""
    hit = tracer.closest(scene, o, d, jnp.zeros(o.shape[0], jnp.int32),
                         jnp.full((o.shape[0],), -1, jnp.int32))
    max_dist = jnp.linalg.norm(max_point - o, axis=-1) * 1.1
    val = jnp.maximum((max_dist - hit.t) / max_dist, 0.0)
    return jnp.repeat(val[:, None], 3, axis=1), jnp.asarray(o.shape[0])


def shade_diffuse(scene: Scene, config: RenderConfig, tracer: Tracer, o, d):
    """Flat material visualization (reference DiffuseMaterial.cpp:11-27):
    first non-zero of Kd / Ks / Kt / Le."""
    hit = tracer.closest(scene, o, d, jnp.zeros(o.shape[0], jnp.int32),
                         jnp.full((o.shape[0],), -1, jnp.int32))
    le, kd, ks, kt, _ = common.bind_material(scene, hit)
    rgb = jnp.zeros_like(kd)
    rgb = jnp.where(common.has_positive(le)[:, None], le, rgb)
    rgb = jnp.where(common.has_positive(kt)[:, None], kt, rgb)
    rgb = jnp.where(common.has_positive(ks)[:, None], ks, rgb)
    rgb = jnp.where(common.has_positive(kd)[:, None], kd, rgb)
    rgb = jnp.where(hit.missed[:, None], 0.0, rgb)
    return rgb, jnp.asarray(o.shape[0])


def trace_image_sample(scene: Scene, config: RenderConfig, o, d, keys,
                       max_point=None, differentiable: bool = False):
    """Radiance for one sample of every pixel, dispatching on the shader id
    the way C_wrapper.cpp:154-194 does."""
    tracer = make_tracer(config, differentiable=differentiable)
    if config.shader == C.SHADER_DEPTHMAP:
        if max_point is None:
            max_point = jnp.ones((3,), jnp.float32)
        return shade_depthmap(scene, config, tracer, o, d, max_point)
    if config.shader == C.SHADER_DIFFUSE:
        return shade_diffuse(scene, config, tracer, o, d)
    return trace_radiance(scene, config, tracer, o, d, keys,
                          differentiable=differentiable)
