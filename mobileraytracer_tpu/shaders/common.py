"""Shared shading math: material binding, reflection/refraction, fresnel,
next-event estimation.  All functions operate on ray batches.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import constants as C
from .. import sampling
from ..ops import intersect
from ..types import Hit, Scene


def park_dead_lanes(o: jnp.ndarray, d: jnp.ndarray, live: jnp.ndarray):
    """Replaces dead lanes' rays so traversal subtiles stay coherent.

    The tile-cooperative traversals bound each 16-ray subtile with interval
    arithmetic over the lanes' origins/directions; one far-sentinel lane
    blows the bounds wide open and forces the subtile to walk nearly every
    candidate.  Instead, each dead lane *duplicates one live lane of its
    own subtile* — the bounds stay exactly the live hull and the
    duplicate's result is discarded.
    Fully-dead subtiles get the far sentinel so their walk finds zero
    candidates and exits immediately.  All values stay finite, keeping
    reverse-mode AD NaN-free.
    """
    b = o.shape[0]
    st = C.SUBTILE
    if b % st != 0:
        o2 = jnp.where(live[:, None], o, C.FAR_SENTINEL)
        d2 = jnp.where(live[:, None], d, jnp.array([1.0, 0.0, 0.0], o.dtype))
        return o2, d2
    nt = b // st
    live_t = live.reshape(nt, st)
    pick = jnp.argmax(live_t, axis=1)                      # first live lane
    any_live = jnp.any(live_t, axis=1)
    rows = jnp.arange(nt)
    o_rep = o.reshape(nt, st, 3)[rows, pick]               # (nt, 3)
    d_rep = d.reshape(nt, st, 3)[rows, pick]
    o_rep = jnp.where(any_live[:, None], o_rep, C.FAR_SENTINEL)
    d_rep = jnp.where(any_live[:, None], d_rep,
                      jnp.array([1.0, 0.0, 0.0], o.dtype))
    o_fill = jnp.repeat(o_rep, st, axis=0)
    d_fill = jnp.repeat(d_rep, st, axis=0)
    # The fill values are an execution-layout artifact (the duplicate
    # lane's result is discarded), so they carry no gradient: without
    # stop_gradient, a dead lane's downstream cotangent — including NaN
    # born from inf * 0 in chains that are where-masked only at the END —
    # would flow back INTO the duplicated live lane through the gather's
    # VJP and corrupt real vertex gradients.
    o_fill = jax.lax.stop_gradient(o_fill)
    d_fill = jax.lax.stop_gradient(d_fill)
    o2 = jnp.where(live[:, None], o, o_fill)
    d2 = jnp.where(live[:, None], d, d_fill)
    return o2, d2


def has_positive(v: jnp.ndarray) -> jnp.ndarray:
    """hasPositiveValue: any component > 0 (reference Utils.hpp)."""
    return jnp.any(v > 0.0, axis=-1)


def reflect(i: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """glm::reflect: i - 2*dot(n,i)*n."""
    return i - 2.0 * jnp.sum(n * i, -1, keepdims=True) * n


def refract(i: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray):
    """glm::refract.  Returns (direction, valid): on total internal
    reflection glm yields the zero vector, which the reference then traces
    as a guaranteed-miss ray (Whitted.cpp:82-90); we report valid=False and
    the caller skips the child instead."""
    cosi = jnp.sum(n * i, -1)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    valid = k >= 0.0
    # VJP-safe sqrt: sqrt(max(k, 0)) has an inf derivative at the TIR
    # boundary, and 0-cotangent * inf = NaN poisons reverse-mode AD even
    # though invalid lanes are masked below (see ops/intersect).
    d = (eta[..., None] * i
         - (eta * cosi + jnp.sqrt(jnp.where(valid, k, 1.0)))[..., None] * n)
    return jnp.where(valid[..., None], d, 0.0), valid


def fresnel(i: jnp.ndarray, n: jnp.ndarray, ior: jnp.ndarray) -> jnp.ndarray:
    """Fresnel reflectance (reference Utils.cpp:206-229).  Note: the
    reference calls glm::clamp with swapped arguments, producing
    cosi = min(1, dot(I, N)); we reproduce that since Whitted computes (and
    discards) this value — kept for API completeness."""
    cosi = jnp.minimum(1.0, jnp.sum(i * n, -1))
    etai = jnp.where(cosi > 0, ior, jnp.ones_like(ior))
    etat = jnp.where(cosi > 0, jnp.ones_like(ior), ior)
    sint = etai / etat * jnp.sqrt(jnp.maximum(0.0, 1.0 - cosi * cosi))
    cost = jnp.sqrt(jnp.maximum(0.0, 1.0 - sint * sint))
    acosi = jnp.abs(cosi)
    rs = (etat * acosi - etai * cost) / (etat * acosi + etai * cost)
    rp = (etai * acosi - etat * cost) / (etai * acosi + etat * cost)
    kr = (rs * rs + rp * rp) / 2.0
    return jnp.where(sint >= 1.0, 1.0, kr)


def sample_atlas(scene: Scene, tex_id: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Nearest texel fetch matching Texture::loadColor (Texture.cpp:37-48):
    x = int(u * W), y = int(v * H), row-major from the top."""
    atlas = scene.atlas
    tid = jnp.clip(tex_id, 0, atlas.num_textures - 1)
    size = atlas.sizes[tid]                       # (B, 2) (h, w)
    h = size[..., 0].astype(jnp.float32)
    w = size[..., 1].astype(jnp.float32)
    x = jnp.clip((uv[..., 0] * w).astype(jnp.int32), 0, size[..., 1] - 1)
    y = jnp.clip((uv[..., 1] * h).astype(jnp.int32), 0, size[..., 0] - 1)
    return atlas.data[tid, y, x]


def bind_material(scene: Scene, hit: Hit):
    """Material binding at a hit (reference Shader.cpp:112-121): gather the
    material row; override Kd with the texture sample when the hit carries
    valid texcoords; area-light hits (mat_id == -1 on PRIM_LIGHT) bind the
    light radiance as Le."""
    mats = scene.materials
    mid = jnp.clip(hit.mat_id, 0, mats.capacity - 1)
    has_mat = hit.mat_id >= 0
    le = jnp.where(has_mat[:, None], mats.le[mid], 0.0)
    kd = jnp.where(has_mat[:, None], mats.kd[mid], 0.0)
    ks = jnp.where(has_mat[:, None], mats.ks[mid], 0.0)
    kt = jnp.where(has_mat[:, None], mats.kt[mid], 0.0)
    ior = jnp.where(has_mat, mats.ior[mid], 1.0)

    tex_id = jnp.where(has_mat, mats.tex_id[mid], -1)
    textured = (tex_id >= 0) & (hit.uv[:, 0] >= 0) & (hit.uv[:, 1] >= 0)
    kd = jnp.where(textured[:, None], sample_atlas(scene, tex_id, hit.uv), kd)

    is_light = (hit.prim_kind == C.PRIM_LIGHT)
    le = jnp.where(is_light[:, None], hit.light_le, le)
    return le, kd, ks, kt, ior


def direct_lighting(scene: Scene, hit: Hit, keys: jax.Array,
                    samples_light: int, shadows: bool,
                    occluded_fn=None, mask=None,
                    share_mask=None, share_width: int = 16,
                    reverse: bool = False,
                    share_all: bool = False) -> jnp.ndarray:
    """Next-event estimation for diffuse hits.

    Per sample: pick a uniform light (Shader.cpp:223-233), take its position
    (point light) or a uniform triangle point (AreaLight.cpp:17-26), add
    radiance * cos(N, L) when the light is above the horizon and — with
    `shadows` — unoccluded (Whitted.cpp:37-65; NoShadows.cpp skips the
    shadow ray and normalizes without the distance).  Returns the *summed*
    radiance (caller multiplies by kD / samplesLight) and the per-lane count
    of shadow rays cast (the reference constructs a Ray — incrementing the
    casted-ray counter — whenever cos(N, L) > 0, Whitted.cpp:51-56).

    `reverse=True` traces each occlusion segment FROM the light point
    TOWARD the surface (occlusion is symmetric in the segment).  With a
    shared per-group light point (share_width lanes aim at one L), the
    reversed bundle has a *point* origin, so the traversal's interval
    hulls collapse from [hit-point box x direction box] to the exact
    cone — the hit points of a coherent pixel tile can be scattered
    across depth discontinuities while L is one point.  The acceptance
    window maps t_fwd in [eps, dist) to t_rev in [eps, dist - eps]: the
    eps-guard against surface acne moves to the light end analytically,
    while the surface's own primitive stays excluded by prev-id; the only
    semantic difference is blockers within EPSILON of the light point
    (measure-zero; the emissive surface itself is not in the BVH).
    """
    b = hit.t.shape[0]
    total = jnp.zeros((b, 3), jnp.float32)
    shadow_rays = jnp.zeros((b,), jnp.int32)
    has_lights = scene.lights.num > 0
    if occluded_fn is None:
        occluded_fn = intersect.occluded_naive
    # Lanes outside `mask` trace a duplicate of a live lane's shadow ray
    # (discarded) so traversal subtiles stay coherent; see park_dead_lanes.
    origin = hit.point

    share_all = share_all and b % share_width == 0
    if share_all:
        # Every lane group shares one pick/point drawn from its first
        # lane's key, so fold/pick/sample on the DOWNSAMPLED key set and
        # broadcast — bit-identical to folding per lane and taking lane 0
        # (which is what the non-share_all path below computes), but
        # ~share_width x fewer threefry evaluations.
        sw = share_width
        keys_ds = keys.reshape(b // sw, sw, -1)[:, 0]

    for s in range(samples_light):
        if share_all:
            kp_ds = jax.vmap(jax.random.fold_in, (0, None))(keys_ds, 2 * s)
            kpt_ds = jax.vmap(jax.random.fold_in, (0, None))(keys_ds,
                                                             2 * s + 1)
            lidx_ds = jax.vmap(sampling.pick_light, (0, None))(
                kp_ds, scene.lights.num)
            kind_ds = scene.lights.kind[lidx_ds]
            p_ds = jax.vmap(sampling.sample_triangle_point)(
                kpt_ds, scene.lights.tri_a[lidx_ds],
                scene.lights.tri_ab[lidx_ds], scene.lights.tri_ac[lidx_ds])
            lpos_ds = jnp.where((kind_ds == C.LIGHT_AREA)[:, None], p_ds,
                                scene.lights.position[lidx_ds])
            lpos = jnp.repeat(lpos_ds, sw, axis=0)
            radiance = jnp.repeat(scene.lights.radiance[lidx_ds], sw, axis=0)
            kind = jnp.repeat(kind_ds, sw, axis=0)
        else:
            k_pick = jax.vmap(jax.random.fold_in, (0, None))(keys, 2 * s)
            k_point = jax.vmap(jax.random.fold_in, (0, None))(keys, 2 * s + 1)
            # The light *pick* is shared across each share-width lane group
            # (first lane's key): every pixel's marginal pick is still
            # uniform, so the estimator is unbiased — the reference's
            # shared atomic RNG cursors correlate neighboring pixels the
            # same way (Sampler.hpp:58-63).  Coherent picks keep a
            # subtile's shadow bundle aimed at one light, which the
            # tile-interval traversal bounds depend on.
            #
            # `share_mask` limits sharing to lanes on their first bounce:
            # later bounces run through the compacted wavefront
            # (engine.py), where execution grouping depends on batch size —
            # a per-lane pick keeps the image invariant to sharding and
            # compaction layout.  The lane-group width sharing one light
            # sample is a SAMPLING POLICY (RenderConfig.nee_share): 16 =
            # one traversal subtile, 128 = the benchmark's setting.  Any
            # width keeps every pixel's marginal sample uniform
            # (unbiased); batches not divisible by the width skip sharing.
            st = share_width
            if b % st == 0:
                def subtile_share(k):
                    shared = jnp.repeat(k.reshape(b // st, st, -1)[:, 0],
                                        st, 0)
                    if share_mask is None:
                        return shared
                    return jnp.where(share_mask[:, None], shared, k)
                k_pick = subtile_share(k_pick)
                # The light *point* is shared per group too: each pixel's
                # marginal point is still uniform over the light (unbiased,
                # same argument as the pick), and one shared target point
                # collapses the subtile's shadow bundle to a tight cone.
                k_point = subtile_share(k_point)
            lidx = jax.vmap(sampling.pick_light, (0, None))(
                k_pick, scene.lights.num)
            kind = scene.lights.kind[lidx]
            p_area = jax.vmap(sampling.sample_triangle_point)(
                k_point, scene.lights.tri_a[lidx], scene.lights.tri_ab[lidx],
                scene.lights.tri_ac[lidx])
            lpos = jnp.where((kind == C.LIGHT_AREA)[:, None], p_area,
                             scene.lights.position[lidx])
            radiance = scene.lights.radiance[lidx]

        to_light = lpos - origin
        # sqrt(sum-sq) == vector norm bit-for-bit, with a finite VJP at 0
        # (jnp.linalg.norm's VJP at a zero vector is NaN, which a masked
        # lane's zero cotangent does not absorb).
        dist = jnp.sqrt(jnp.maximum(jnp.sum(to_light * to_light, -1), 1e-30))
        ldir = to_light / jnp.maximum(dist[:, None], 1e-30)
        cos_nl = jnp.sum(hit.normal * ldir, -1)
        visible = cos_nl > 0.0
        if shadows:
            shadow_rays = shadow_rays + (visible & has_lights).astype(jnp.int32)
            live = visible if mask is None else (mask & visible)
            if reverse:
                org_s, dir_s = lpos, -ldir
                md_s = jnp.maximum(dist - C.EPSILON, 0.0)
            else:
                org_s, dir_s, md_s = origin, ldir, dist
            org_t, dir_t = park_dead_lanes(org_s, dir_s, live)
            blocked = occluded_fn(
                scene, org_t, dir_t, md_s, hit.prim_kind, hit.prim_id)
            visible = visible & ~blocked
        contrib = radiance * cos_nl[:, None]
        total = total + jnp.where((visible & has_lights)[:, None], contrib, 0.0)
    return total, shadow_rays
