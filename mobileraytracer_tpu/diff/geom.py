"""Vertex-position gradients with visibility (edge-sampling) terms.

The image is discontinuous in vertex positions at silhouette edges, so
plain reverse-mode through the renderer only yields the *interior* term
(shading/geometry at fixed visibility).  The missing *boundary* term is
the classic edge-sampling integral (Li et al. 2018, "Differentiable Monte
Carlo Ray Tracing through Edge Sampling" — public technique, re-derived
here for this camera model): for a loss L = mean(image),

    dL/dv = interior (AD, fixed hit topology)
          + sum_edges INT_0^1 [L_in(s) - L_out(s)] (n_hat . dq(x(s))/dv)
                              |q1 - q0| ds

where q(x) maps a world point to the camera's *factor space* — the
(right, up)-plane coordinates that `cameras.generate_rays` perturbs with
the pixel jitter (reference Renderer.cpp:137-140), so the pixel-box filter
is exactly a box in q and the mean image is (up to pixel-tiling warp) the
area integral the boundary term differentiates.  The edge is a straight
segment in q (perspective maps lines to lines), n_hat its outward 2-D
normal, and L_in/L_out are radiances traced just inside/outside — which
makes partial occlusion of the edge by other geometry handled for free
(occluded stretches have L_in == L_out).

Shape: all edges x samples evaluated as one flat ray batch through the
standard wavefront tracer; the projection Jacobians are a vmapped 3x3
solve + jacrev.  The small contractions are written as elementwise
products and sums, so no float32 product can drop to a reduced-precision
matrix unit.  No reference counterpart exists
(the C++ engine is forward-only); cited files are for the camera/jitter
contracts only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from .. import constants as C
from .. import sampling
from ..shaders.engine import trace_image_sample
from ..types import Camera, RenderConfig, Scene, Triangles
from ..types import CAMERA_PERSPECTIVE


def factors_of_point(camera: Camera, x: jnp.ndarray) -> jnp.ndarray:
    """Maps world points (..., 3) to camera factor coordinates (..., 2):
    the (right, up) plane offsets that generate_rays turns into rays.
    Perspective: solve s(x - p) = direction + rf*right + uf*up.
    Orthographic: solve x - p = rf*right + uf*up + s*direction."""
    p = camera.position
    w = x - p

    def solve_one(wv):
        a_persp = jnp.stack([wv, -camera.right, -camera.up], axis=1)
        sol_p = jnp.linalg.solve(a_persp, camera.direction)
        a_orth = jnp.stack([camera.right, camera.up, camera.direction],
                           axis=1)
        sol_o = jnp.linalg.solve(a_orth, wv)
        persp = camera.kind == CAMERA_PERSPECTIVE
        rf = jnp.where(persp, sol_p[1], sol_o[0])
        uf = jnp.where(persp, sol_p[2], sol_o[1])
        return jnp.stack([rf, uf])

    flat = w.reshape(-1, 3)
    q = jax.vmap(solve_one)(flat)
    return q.reshape(x.shape[:-1] + (2,))


def rays_from_factors(camera: Camera, q: jnp.ndarray):
    """Rays through factor coordinates q (..., 2) — the jitterless core of
    cameras.generate_rays with (rf, uf) given directly."""
    rf, uf = q[..., 0], q[..., 1]
    dest = (camera.position + camera.direction
            + camera.right * rf[..., None] + camera.up * uf[..., None])
    dir_p = dest - camera.position
    dir_p = dir_p / jnp.linalg.norm(dir_p, axis=-1, keepdims=True)
    org_p = jnp.broadcast_to(camera.position, dir_p.shape)
    org_o = (camera.position + camera.right * rf[..., None]
             + camera.up * uf[..., None])
    dir_o = jnp.broadcast_to(camera.direction, org_o.shape)
    persp = camera.kind == CAMERA_PERSPECTIVE
    return (jnp.where(persp, org_p, org_o),
            jnp.where(persp, dir_p, dir_o))


def pixel_density(camera: Camera, q: jnp.ndarray) -> jnp.ndarray:
    """Pixels per unit factor-space area, normalized by the pixel count:
    the weight that turns the factor-space area integral into the actual
    pixel-mean image (see vertex_grad)."""
    rf, uf = q[..., 0], q[..., 1]
    persp = (1.0 + jnp.tan(rf) ** 2) * (1.0 + jnp.tan(uf) ** 2)
    dens = jnp.where(camera.kind == CAMERA_PERSPECTIVE, persp, 1.0)
    return dens / (camera.param_u * camera.param_v)


def viewport_mask(camera: Camera, config: RenderConfig,
                  q: jnp.ndarray) -> jnp.ndarray:
    """1.0 where factor points q (..., 2) land inside the rendered image's
    factor-space support, else 0.0.  Boundary curves are only integrated
    where the image actually sees them: the pixel grid covers
    u in [0, (w-1)/w] plus the +-0.5/w jitter box (cameras.generate_rays),
    warped by fastArcTan for the perspective model."""
    from ..cameras import fast_arctan
    w, h = config.width, config.height
    persp = camera.kind == CAMERA_PERSPECTIVE

    def bounds(p, n, lo_u, hi_u):
        lo_p = fast_arctan(p * (lo_u - 0.5)) - 0.5 / n
        hi_p = fast_arctan(p * (hi_u - 0.5)) + 0.5 / n
        lo_o = p * (lo_u - 0.5) - 0.5 / n
        hi_o = p * (hi_u - 0.5) + 0.5 / n
        return (jnp.where(persp, lo_p, lo_o), jnp.where(persp, hi_p, hi_o))

    r_lo, r_hi = bounds(camera.param_u, w, 0.0, (w - 1.0) / w)
    # uf = f(0.5 - v): v in [0, (h-1)/h] maps to (0.5 - v) in
    # [0.5 - (h-1)/h, 0.5].
    u_lo, u_hi = bounds(camera.param_v, h, 1.0 - (h - 1.0) / h, 1.0)
    inside = ((q[..., 0] >= r_lo) & (q[..., 0] <= r_hi)
              & (q[..., 1] >= u_lo) & (q[..., 1] <= u_hi))
    return inside.astype(jnp.float32)


def triangle_vertices(tris: Triangles) -> Dict[str, jnp.ndarray]:
    """The vertex parameterization: va/vb/vc (N, 3) world positions."""
    va = jnp.asarray(tris.point_a)
    return {"va": va, "vb": va + jnp.asarray(tris.ab),
            "vc": va + jnp.asarray(tris.ac)}


def scene_with_vertices(scene: Scene, verts: Dict[str, jnp.ndarray]) -> Scene:
    """Rebuilds the triangle table (and geometric shading normals) from
    vertex positions — every derived quantity stays differentiable."""
    va, vb, vc = verts["va"], verts["vb"], verts["vc"]
    ab = vb - va
    ac = vc - va
    # Reference normal convention: normalize(cross(AC, AB))
    # (Triangle.cpp:328-339; SceneBuilder.add_triangle matches).
    gn = jnp.cross(ac, ab)
    # sqrt(max(sum-sq)) not max(norm): norm's VJP at the zero vectors of
    # padded rows is NaN even under zero cotangents (see intersect._fill_hit).
    gn = gn / jnp.sqrt(jnp.maximum(
        jnp.sum(gn * gn, axis=-1, keepdims=True), 1e-30))
    tris = scene.triangles.replace(point_a=va, ab=ab, ac=ac,
                                   normal_a=gn, normal_b=gn, normal_c=gn)
    return scene.replace(triangles=tris)


def _mean_radiance(scene: Scene, camera: Camera, config: RenderConfig,
                   q: jnp.ndarray, keys, mesh=None) -> jnp.ndarray:
    """Mean radiance of rays through factor points q (B, 2).  With `mesh`,
    the ray batch shards over the devices (scene replicated, lanes split —
    the BASELINE #5 multi-chip probe layout); results are identical to the
    unsharded evaluation (counter-based keys)."""
    if mesh is None:
        o, d = rays_from_factors(camera, q)
        rgb, _ = trace_image_sample(scene, config, o, d, keys,
                                    differentiable=True)
        return rgb

    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    n = mesh.devices.size
    b = q.shape[0]
    bp = -(-b // n) * n
    if bp != b:
        q = jnp.concatenate(
            [q, jnp.zeros((bp - b, 2), q.dtype)], 0)
        keys = jnp.concatenate([keys, keys[:1].repeat(bp - b, 0)], 0)
    axes = tuple(mesh.axis_names)

    def fn(scene, camera, q, keys):
        o, d = rays_from_factors(camera, q)
        rgb, _ = trace_image_sample(scene, config, o, d, keys,
                                    differentiable=True)
        return rgb

    sh = P(axes)
    out = shard_map(fn, mesh=mesh, in_specs=(P(), P(), sh, sh),
                    out_specs=sh, check_vma=False)(scene, camera, q, keys)
    return out[:b]


def edge_topology(tris: Triangles, quantum: float = 1e-5) -> "np.ndarray":
    """Host-side static edge culling (numpy, concrete arrays only): a
    directed edge of the triangle soup can carry a boundary term only if
    the image can actually jump across it.  A shared edge whose two faces
    are coplanar with identical shading normals and the same material is
    radiance-continuous (the tessellation diagonals of flat walls — the
    bulk of a scene like conference), so both copies drop; boundary
    (unshared) edges, creases, and material seams keep.  Returns a (3N,)
    bool keep mask over the [ab | bc | ca] edge slots that vertex_grad
    enumerates.

    This is the static part of silhouette culling: view-dependent
    silhouette tests do not apply to two-sided surfaces (every face is
    hittable from both sides, ops/intersect.py's two-sided MT), so only
    provably-zero jumps are dropped — the estimator stays exact."""
    import numpy as np

    va = np.asarray(tris.point_a)
    vb = va + np.asarray(tris.ab)
    vc = va + np.asarray(tris.ac)
    n = va.shape[0]
    valid = np.asarray(tris.valid)
    nrm = np.cross(np.asarray(tris.ab), np.asarray(tris.ac))
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / np.maximum(ln, 1e-30)
    mat = np.asarray(tris.mat_id)

    def key_of(p):
        return np.round(p / quantum).astype(np.int64)

    ka, kb, kc = key_of(va), key_of(vb), key_of(vc)
    # Undirected edge keys: sorted endpoint tuples.
    e_ends = [(ka, kb), (kb, kc), (kc, ka)]
    keys = []
    for (p, q) in e_ends:
        lo = np.minimum(p, q)
        hi = np.maximum(p, q)
        keys.append(np.concatenate([lo, hi], axis=1))
    allk = np.concatenate(keys, axis=0)                  # (3N, 6)
    order = np.lexsort(allk.T)
    sk = allk[order]
    same_prev = np.concatenate([[False],
                                np.all(sk[1:] == sk[:-1], axis=1)])
    same_next = np.concatenate([same_prev[1:], [False]])
    # Mate lookup (adjacent in sort order; runs > 2 — non-manifold —
    # still pair up arbitrarily, which only makes the cull weaker).
    mate_sorted = np.full(3 * n, -1, np.int64)
    prev_idx = np.nonzero(same_prev)[0]
    mate_sorted[prev_idx] = order[prev_idx - 1]
    next_idx = np.nonzero(same_next)[0]
    mate_sorted[next_idx] = order[next_idx + 1]
    mate = np.full(3 * n, -1, np.int64)
    mate[order] = mate_sorted

    tri_of = np.tile(np.arange(n), 3)
    keep = np.ones(3 * n, bool)
    has_mate = mate >= 0
    m_tri = tri_of[np.maximum(mate, 0)]
    coplanar = np.abs(np.einsum("ij,ij->i", nrm[tri_of],
                                nrm[m_tri])) > 1.0 - 1e-6
    same_nrm = np.linalg.norm(nrm[tri_of] - nrm[m_tri], axis=-1) < 1e-6
    same_mat = mat[tri_of] == mat[m_tri]
    drop = has_mate & coplanar & same_nrm & same_mat
    keep &= ~drop
    # Edge arrays are slot-major ([ab x N | bc x N | ca x N]): tile, not
    # repeat.
    keep &= np.tile(valid, 3)
    # Degenerate faces contribute nothing.
    keep &= np.tile(ln[:, 0] > 1e-20, 3)
    return keep


def _shadow_boundary_term(scene: Scene, camera: Camera, config: RenderConfig,
                          base_key: jax.Array, verts: Dict[str, jnp.ndarray],
                          w_e: jnp.ndarray, budget: int, samples: int,
                          eps: float) -> Dict[str, jnp.ndarray]:
    """Boundary gradient from NEE *shadow* discontinuities (the secondary
    term the round-3 implementation lacked — primary-only boundaries bias
    vertex grads in shadowed regions, VERDICT r3 item 4b).

    For a blocker edge (v0, v1) and a light sample y, the single-sample
    direct-lighting integrand f(x, y) = kd(x) Le cos+(x, y) V(x, y) jumps
    across the shadow curve — the projection of the edge from y onto the
    receiver.  Its image-space contribution to d mean(image) / dv is the
    line integral of

        [f_in - f_out](q*) rho_pix(q*) (n_q . dq*/dv) |dq*/ds|

    over the curve q*(s) = q(x*(s)), x* = ray(y -> z(s)) cap receiver,
    z(s) = (1-s) v0 + s v1 — the same edge-sampling form as the primary
    silhouette term, with the curve generated by light projection instead
    of camera projection (Li et al. 2018's secondary edges).  Everything
    hard is obtained by construction rather than derivation:

      - the receiver is found by TRACING the ray y -> z past the edge; its
        tangent plane (hit point, hit normal) defines a differentiable
        local model x*(z), so dq*/dv and |dq*/ds| come out of jacfwd of
        the composed map v -> z -> x* -> q;
      - [f_in - f_out] is PROBED: camera rays at q* -/+ eps n_q find the
        surfaces the camera actually sees there and each side evaluates
        f with a real shadow ray — so hidden shadow curves, partial
        occlusion of the segment y->z, and horizon terms all contribute
        their true (often zero) jump without case analysis;
      - the orientation of n_q cancels between the probe difference and
        the velocity dot product, exactly as in the primary term.

    Edges are length-importance-sampled with `budget` draws from the
    `w_e` weights (the silhouette-culled kept set: a coplanar interior
    edge casts no shadow boundary either).  One light sample y per
    (edge, s) draw mirrors direct_lighting's uniform pick/point sampler,
    so the estimator is unbiased for the expected NEE image at the
    primary bounce.  Secondary-bounce shadow terms remain out of scope
    (documented in PARITY.md)."""
    from .. import sampling
    from ..shaders import common
    from ..shaders.engine import make_tracer

    n_tri = verts["va"].shape[0]
    va, vb, vc = verts["va"], verts["vb"], verts["vc"]
    e0 = jnp.concatenate([va, vb, vc], 0)
    e1 = jnp.concatenate([vb, vc, va], 0)

    tracer = make_tracer(config)
    bkey = jax.random.fold_in(base_key, 0x511ad0)
    total_w = jnp.sum(w_e)
    logits = jnp.log(jnp.maximum(w_e, 1e-30))
    sel = jax.random.categorical(bkey, logits, shape=(budget,))
    p_e = w_e[sel] / jnp.maximum(total_w, 1e-30)
    mc_w = jnp.where(p_e > 0, 1.0 / (budget * p_e), 0.0)    # (E,)
    tri_sel = (sel % n_tri).astype(jnp.int32)

    sa = (jnp.arange(samples, dtype=jnp.float32) + 0.5) / samples
    v0 = jnp.repeat(e0[sel], samples, 0)                    # (B, 3)
    v1 = jnp.repeat(e1[sel], samples, 0)
    ss = jnp.tile(sa, budget)[:, None]                      # (B, 1)
    z = (1.0 - ss) * v0 + ss * v1
    bsize = z.shape[0]
    blk_tri = jnp.repeat(tri_sel, samples)

    # Light sample y per (edge, s) — the NEE sampler's uniform pick +
    # uniform triangle point (shaders/common.direct_lighting).
    skeys = sampling.ray_key(base_key, jnp.arange(bsize, dtype=jnp.int32), 2)
    k_pick = jax.vmap(jax.random.fold_in, (0, None))(skeys, 0)
    k_point = jax.vmap(jax.random.fold_in, (0, None))(skeys, 1)
    lidx = jax.vmap(sampling.pick_light, (0, None))(k_pick, scene.lights.num)
    p_area = jax.vmap(sampling.sample_triangle_point)(
        k_point, scene.lights.tri_a[lidx], scene.lights.tri_ab[lidx],
        scene.lights.tri_ac[lidx])
    y = jnp.where((scene.lights.kind[lidx] == C.LIGHT_AREA)[:, None],
                  p_area, scene.lights.position[lidx])
    radiance = scene.lights.radiance[lidx]                  # (B, 3)

    # Receiver: first hit PAST the edge along y -> z (self-hit guard on
    # the blocker triangle).
    udir = z - y
    ulen = jnp.linalg.norm(udir, axis=-1, keepdims=True)
    udir = udir / jnp.maximum(ulen, 1e-30)
    pk_blk = jnp.full((bsize,), C.PRIM_TRIANGLE, jnp.int32)
    rhit = tracer.closest(scene, z, udir, pk_blk, blk_tri)
    recv_p = rhit.point
    recv_n = rhit.normal
    recv_ok = ~rhit.missed

    # Differentiable local model of the shadow point: the ray y -> z
    # intersected with the receiver tangent plane (held fixed).
    def q_of_z(zz, yy, rp, rn):
        dirn = zz - yy
        rn_d = jnp.sum(rn * dirn)
        tau = jnp.sum(rn * (rp - yy)) / jnp.where(
            jnp.abs(rn_d) < 1e-12, 1e-12, rn_d)
        xs = yy + tau * dirn
        return factors_of_point(camera, xs)

    qstar = jax.vmap(q_of_z)(z, y, recv_p, recv_n)          # (B, 2)
    jq = jax.vmap(jax.jacfwd(q_of_z))(z, y, recv_p, recv_n)  # (B, 2, 3)
    tang = jnp.sum(jq * (v1 - v0)[:, None, :], -1)          # (B, 2)
    tlen = jnp.linalg.norm(tang, axis=-1)
    n_q = jnp.stack([tang[:, 1], -tang[:, 0]], -1)
    n_q = n_q / jnp.maximum(tlen[:, None], 1e-20)

    # Probe both sides of the curve with REAL camera rays + single-y NEE.
    def side_f(qp):
        o_p, d_p = rays_from_factors(camera, qp)
        hit = tracer.closest(scene, o_p, d_p,
                             jnp.zeros((bsize,), jnp.int32),
                             jnp.full((bsize,), -1, jnp.int32))
        _, kd, _, _, _ = common.bind_material(scene, hit)
        to_l = y - hit.point
        dist = jnp.linalg.norm(to_l, axis=-1)
        ldir = to_l / jnp.maximum(dist[:, None], 1e-30)
        cos_nl = jnp.sum(hit.normal * ldir, -1)
        blocked = tracer.occluded(scene, hit.point, ldir, dist,
                                  hit.prim_kind, hit.prim_id)
        vis = (cos_nl > 0) & ~blocked & ~hit.missed
        return jnp.where(vis[:, None], kd * radiance * cos_nl[:, None], 0.0)

    f_in = side_f(qstar - eps * n_q)
    f_out = side_f(qstar + eps * n_q)
    df = jnp.mean(f_in - f_out, axis=-1)                    # (B,)

    live = recv_ok & (scene.lights.num > 0)
    wgt = jnp.where(live, df * pixel_density(camera, qstar)
                    * viewport_mask(camera, config, qstar)
                    * tlen / samples, 0.0)
    wgt = wgt * jnp.repeat(mc_w, samples)
    ndotj = jnp.sum(n_q[:, :, None] * jq, 1)                # (B, 3)
    g0 = (wgt * (1.0 - ss[:, 0]))[:, None] * ndotj
    g1 = (wgt * ss[:, 0])[:, None] * ndotj
    g0 = g0.reshape(budget, samples, 3).sum(1)
    g1 = g1.reshape(budget, samples, 3).sum(1)

    slot = sel // n_tri
    zeros = jnp.zeros((n_tri, 3), jnp.float32)
    g = {"va": zeros, "vb": zeros, "vc": zeros}
    names = ["va", "vb", "vc"]
    for sl in range(3):
        msk = (slot == sl)[:, None]
        p0, p1 = names[sl], names[(sl + 1) % 3]
        g[p0] = g[p0].at[tri_sel].add(jnp.where(msk, g0, 0.0))
        g[p1] = g[p1].at[tri_sel].add(jnp.where(msk, g1, 0.0))
    return g


def vertex_grad(scene: Scene, camera: Camera, config: RenderConfig,
                base_key: jax.Array, edge_samples: int = 8,
                edge_eps: float = 1e-3,
                spp: int = 1, edge_keep=None,
                edge_budget: int = None,
                shadow_edges: bool = False,
                shadow_budget: int = 256,
                mesh=None,
                pixel_chunk: Optional[int] = None,
                ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Gradient of L = mean(image) w.r.t. every triangle vertex.

    Returns (loss, {"va": (N,3), "vb": ..., "vc": ...}).  interior term:
    reverse-mode through `spp` jitterless samples at fixed visibility;
    boundary term: `edge_samples` points per triangle edge, two-sided
    radiance probes offset `edge_eps` in factor space.

    `edge_keep`: optional (3N,) bool mask from `edge_topology` zeroing
    provably-continuous edges.  `edge_budget`: if set, the boundary term
    is a length-importance-sampled Monte-Carlo estimate over `edge_budget`
    kept edges instead of the full 3N enumeration — O(budget) probe rays
    (the silhouette-scaling mode for large scenes; unbiased, each sampled
    edge weighted by 1/(budget * p_edge)).  `shadow_edges`: adds the NEE
    shadow-discontinuity boundary term (`_shadow_boundary_term`) with
    `shadow_budget` edge draws.
    """
    from .. import sampling
    from ..renderer import _pixel_order

    w, h = config.width, config.height
    verts = triangle_vertices(scene.triangles)
    u, v, pids, _ = _pixel_order(config)
    keys = sampling.ray_key(base_key, pids, 0)

    # ---- interior: AD at fixed visibility through the standard tracer ---
    from ..cameras import fast_arctan

    b_pix = u.shape[0]
    if pixel_chunk is None or pixel_chunk >= b_pix:
        def interior_loss(vt):
            s2 = scene_with_vertices(scene, vt)
            qs = jnp.stack([fast_arctan(camera.param_u * (u - 0.5)),
                            fast_arctan(camera.param_v * (0.5 - v))],
                           axis=-1)
            rgb = _mean_radiance(s2, camera, config, qs, keys, mesh=mesh)
            return jnp.mean(rgb)

        loss, g_int = jax.value_and_grad(interior_loss)(verts)
    else:
        # Chunked interior AD (1080p-scale gradients): L = mean over ALL
        # pixels, so grad(L) is the sum of per-chunk grads of
        # sum(rgb)/(3B).  Each chunk is one dispatch that bounds
        # backward-pass memory; the
        # result is the same interior gradient up to fp summation order.
        ck = max(128, pixel_chunk - pixel_chunk % 128)
        denom = jnp.float32(b_pix * 3)

        def chunk_loss(vt, uc, vc_, kc):
            s2 = scene_with_vertices(scene, vt)
            qs = jnp.stack([fast_arctan(camera.param_u * (uc - 0.5)),
                            fast_arctan(camera.param_v * (0.5 - vc_))],
                           axis=-1)
            rgb = _mean_radiance(s2, camera, config, qs, kc, mesh=mesh)
            return jnp.sum(rgb) / denom

        chunk_vg = jax.jit(jax.value_and_grad(chunk_loss))
        loss = jnp.zeros(())
        g_int = {k: jnp.zeros_like(x) for k, x in verts.items()}
        for lo in range(0, b_pix, ck):
            hi = min(lo + ck, b_pix)
            lc, gc = chunk_vg(verts, u[lo:hi], v[lo:hi], keys[lo:hi])
            loss = loss + lc
            g_int = {k: g_int[k] + gc[k] for k in g_int}

    # ---- boundary: edge sampling in factor space ------------------------
    # Wrapped in a function so the chunked mode (pixel_chunk set — the
    # 1080p-scale path that must NOT run as one mega-dispatch) can jit
    # this phase as its own executable; the default mode traces it inline
    # exactly as before.
    n_tri = verts["va"].shape[0]
    ek_arr = (jnp.asarray(edge_keep, jnp.float32) if edge_keep is not None
              else jnp.ones((3 * n_tri,), jnp.float32))

    def _boundary(verts, scene, camera, base_key, ek_arr):
        return _boundary_terms(
            verts, scene, camera, base_key, ek_arr, config=config,
            edge_samples=edge_samples, edge_eps=edge_eps,
            edge_budget=edge_budget, shadow_edges=shadow_edges,
            shadow_budget=shadow_budget, mesh=mesh)
    if pixel_chunk is None or pixel_chunk >= b_pix:
        g_bnd = _boundary(verts, scene, camera, base_key, ek_arr)
    else:
        g_bnd = _boundary_terms_jit(
            verts, scene, camera, base_key, ek_arr, config=config,
            edge_samples=edge_samples, edge_eps=edge_eps,
            edge_budget=edge_budget, shadow_edges=shadow_edges,
            shadow_budget=shadow_budget, mesh=mesh)
    grads = {k: g_int[k] + g_bnd[k] for k in g_int}

    # Padded (invalid) triangle rows have no defined gradient; zero them
    # so callers can reduce without masking.
    valid = scene.triangles.valid.astype(bool)[:, None]
    grads = {k: jnp.where(valid, g, 0.0) for k, g in grads.items()}
    return loss, grads


def _boundary_terms(verts, scene, camera, base_key, ek_arr, *, config,
                    edge_samples, edge_eps, edge_budget, shadow_edges,
                    shadow_budget, mesh):
    """The silhouette (+ optional shadow) boundary gradient terms — the
    body of vertex_grad's edge-sampling phase, hoisted to module level so
    the chunked (1080p-scale) mode can jit it as its own stable-cache
    executable instead of fusing it into one large dispatch."""
    n_tri = verts["va"].shape[0]
    sa = (jnp.arange(edge_samples, dtype=jnp.float32) + 0.5) / edge_samples

    va, vb, vc = verts["va"], verts["vb"], verts["vc"]
    # Edge list: (E, 2, 3) endpoints and the opposite vertex (for the
    # inward direction); E = 3 * n_tri in slot order [ab | bc | ca].
    e0 = jnp.concatenate([va, vb, vc], 0)
    e1 = jnp.concatenate([vb, vc, va], 0)
    opp = jnp.concatenate([vc, va, vb], 0)

    q0 = factors_of_point(camera, e0)                    # (E, 2)
    q1 = factors_of_point(camera, e1)
    qo = factors_of_point(camera, opp)
    seg = q1 - q0
    seg_len = jnp.linalg.norm(seg, axis=-1)              # (E,)
    n_hat = jnp.stack([seg[:, 1], -seg[:, 0]], -1)
    n_hat = n_hat / jnp.maximum(seg_len[:, None], 1e-20)
    # Orient outward: flip if the opposite vertex lies on the +n side.
    inward = jnp.sum((qo - q0) * n_hat, -1)
    n_hat = jnp.where((inward > 0)[:, None], -n_hat, n_hat)

    w_e = seg_len * ek_arr

    if edge_budget is None:
        # Full enumeration: every kept edge integrated with S samples.
        sel = jnp.arange(e0.shape[0], dtype=jnp.int32)
        mc_w = jnp.where(w_e > 0, 1.0, 0.0)
    else:
        # Length-importance-sampled edge subset: O(budget) probes
        # regardless of scene size (the silhouette-scaling mode).  Each
        # sampled edge is weighted by 1/(budget * p_e); edges with zero
        # weight are never drawn.
        bkey = jax.random.fold_in(base_key, 0x5ed6e)
        total_w = jnp.sum(w_e)
        logits = jnp.log(jnp.maximum(w_e, 1e-30))
        sel = jax.random.categorical(bkey, logits, shape=(edge_budget,))
        p_e = w_e[sel] / jnp.maximum(total_w, 1e-30)
        mc_w = jnp.where(p_e > 0, 1.0 / (edge_budget * p_e), 0.0)

    e0s, e1s = e0[sel], e1[sel]
    segs, lens, nhs = seg[sel], seg_len[sel], n_hat[sel]
    q0s = q0[sel]

    # Edge sample points in factor space: (Es, S, 2).
    qs = q0s[:, None, :] + segs[:, None, :] * sa[None, :, None]
    probe_in = (qs - edge_eps * nhs[:, None, :]).reshape(-1, 2)
    probe_out = (qs + edge_eps * nhs[:, None, :]).reshape(-1, 2)

    e_total = probe_in.shape[0]
    pkeys = sampling.ray_key(base_key,
                             jnp.arange(e_total, dtype=jnp.int32), 1)
    l_in = _mean_radiance(scene, camera, config, probe_in, pkeys,
                          mesh=mesh)
    l_out = _mean_radiance(scene, camera, config, probe_out, pkeys,
                           mesh=mesh)
    dl = jnp.mean(l_in - l_out, axis=-1).reshape(-1, edge_samples)

    # Pixel-density weight: the jitter box has width 1/w x 1/h in
    # factor space but pixel centers are arctan-warped
    # (Renderer.cpp:137-140 adds the deviation AFTER fastArcTan), so
    # the image mean is the density-weighted integral
    # mean = INT L(q) rho(q) dq with
    # rho = (1+tan^2 rf)(1+tan^2 uf)/(pu pv) (perspective) or
    # 1/(pu pv) (orthographic).  Curve stretches outside the image's
    # factor-space support contribute nothing (viewport clipping).
    dl = dl * pixel_density(camera, qs) * viewport_mask(camera, config,
                                                        qs)

    # dq/dv at each sample: x(s) = (1-s) p0 + s p1, so
    # dq/dv0 = (1-s) J(x) and dq/dv1 = s J(x) with
    # J = d factors / d world point (2x3).
    xs = (e0s[:, None, :] * (1 - sa)[None, :, None]
          + e1s[:, None, :] * sa[None, :, None]).reshape(-1, 3)
    jac = jax.vmap(jax.jacrev(
        lambda p: factors_of_point(camera, p)))(xs)   # (Es*S, 2, 3)
    ndotj = jnp.sum(jnp.repeat(nhs, edge_samples, 0)[:, :, None] * jac,
                    1)                                # (Es*S, 3)
    ndotj = ndotj.reshape(-1, edge_samples, 3)

    wgt = dl * (lens * mc_w)[:, None] / edge_samples  # (Es, S)
    g0 = jnp.sum(wgt[:, :, None] * ndotj * (1 - sa)[None, :, None],
                 axis=1)
    g1 = jnp.sum(wgt[:, :, None] * ndotj * sa[None, :, None], axis=1)

    # Scatter per-edge endpoint gradients back to the vertex slots:
    # edge id e has slot e // n_tri (0 ab, 1 bc, 2 ca) and triangle
    # e % n_tri; endpoint 0 of slot 0/1/2 is va/vb/vc, endpoint 1 is
    # vb/vc/va.
    slot = sel // n_tri
    tri = sel % n_tri
    zeros = jnp.zeros((n_tri, 3), jnp.float32)
    g_bnd = {"va": zeros, "vb": zeros, "vc": zeros}
    names = ["va", "vb", "vc"]
    for sl in range(3):
        msk = (slot == sl)[:, None]
        p0, p1 = names[sl], names[(sl + 1) % 3]
        g_bnd[p0] = g_bnd[p0].at[tri].add(jnp.where(msk, g0, 0.0))
        g_bnd[p1] = g_bnd[p1].at[tri].add(jnp.where(msk, g1, 0.0))

    if shadow_edges:
        # World-space edge lengths drive the shadow-edge importance
        # (the image-space projection of a shadow curve is
        # light-dependent).
        wl = jnp.linalg.norm(e1 - e0, axis=-1) * ek_arr
        g_sh = _shadow_boundary_term(scene, camera, config, base_key,
                                     verts, wl, shadow_budget,
                                     edge_samples, edge_eps)
        g_bnd = {k: g_bnd[k] + g_sh[k] for k in g_bnd}
    return g_bnd


_boundary_terms_jit = jax.jit(
    _boundary_terms,
    static_argnames=("config", "edge_samples", "edge_eps", "edge_budget",
                     "shadow_edges", "shadow_budget", "mesh"))
