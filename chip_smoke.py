#!/usr/bin/env python
"""Smoke test of the renderer's main path on an NVIDIA GPU.

Run from the root of a checkout:

    python chip_smoke.py          # one GPU: phases 0-7 below
    python chip_smoke.py --four   # four GPUs: the sharded path only

One process drives every card.  Each phase prints its readings; a failed
check exits non-zero.  The last line of standard output is one JSON
object, {"ok": true, "device": {"platform", "kind", "count"}}, printed
only when every phase passed.  The script refuses to run (non-zero exit,
no result) when JAX's first device is not a GPU.

Phases (one GPU):
  0 device      platform, device kind, count, JAX version, nvidia-smi
  1 load        conference proxy (331,179 triangles, 2 area lights) and
                its block BVH, host seconds each
  2 traversal   block_bvh on 4,096 conference primaries and their shadow
                segments: GPU against the CPU backend (t to 1e-5, ids and
                occlusion except ties) and against the naive oracle; then
                the timing bar on a full 512^2 frame of primaries
  3 whitted     Renderer.render(), Whitted 512^2 1 spp (BASELINE #3):
                compile and warm-frame seconds, rays/s, memory
  4 pathtracer  render_frame, PathTracer 512^2 16 spp (BASELINE #4)
  5 goldens     eight analytic reference-binary goldens, naive and BVH
  6 gradients   vertex_grad on the conference at 512^2; cornell2 64^2
                GPU against the CPU backend
  7 cli         cli.main renders cornell with the BVH in-process
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from mobileraytracer_tpu import constants as C
from mobileraytracer_tpu import scenes
from mobileraytracer_tpu.bench_scenes import conference_proxy
from mobileraytracer_tpu.cameras import generate_rays
from mobileraytracer_tpu.ops import block_bvh, build_accelerator
from mobileraytracer_tpu.ops import intersect as nv
from mobileraytracer_tpu.renderer import (Renderer, _pixel_order,
                                          render_frame, render_frame_auto)
from mobileraytracer_tpu.types import RenderConfig

REPO = pathlib.Path(__file__).resolve().parent
BIG = C.RAY_LENGTH_MAX
# Relative tolerance on hit distances between two backends: float32
# Moller-Trumbore evaluated with and without fused multiply-adds.
T_RTOL = 1e-5
MAX_TIE_SHARE = 1e-3
# BASELINE #3 / #4 as bench.py runs them.
WHITTED_512 = RenderConfig(width=512, height=512, spp=1,
                           shader=C.SHADER_WHITTED, accelerator=C.ACC_BVH,
                           nee_share=128)
PATHTRACER_512 = RenderConfig(width=512, height=512, spp=16,
                              shader=C.SHADER_PATHTRACER,
                              accelerator=C.ACC_BVH, nee_share=128,
                              nee_share_secondary=True)
# Cornell2 gradients on two backends.  Loss and gradients are sums over
# thousands of pixels and edge probes, taken in another order on the GPU,
# with float32 transcendentals (arctan, tan, sqrt) that differ in the last
# ulps; a relative 1e-3 of the largest component bounds that, while a
# wrong gradient is off by its own size.
GRAD_RTOL = 1e-3
# Largest sharded-vs-single-device pixel difference accepted (see
# phase_four); the frame is in [0, ~1] radiance units.
SHARD_ATOL = 1e-5


class PhaseFailed(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise PhaseFailed(msg)


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def now():
    return time.perf_counter()


def nvidia_smi_line() -> str:
    """Card name and power limit, read by a child that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def memory_fields(compiled) -> dict:
    m = compiled.memory_analysis()
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}


def peak_bytes(device) -> int:
    return int((device.memory_stats() or {}).get("peak_bytes_in_use", -1))


# ---------------------------------------------------------------------------
# Phase 1: load.
# ---------------------------------------------------------------------------

def phase_load(make_scene=conference_proxy, config=WHITTED_512):
    t = now()
    scene, cam, info = make_scene()
    t_scene = now() - t
    t = now()
    scene = jax.block_until_ready(build_accelerator(scene, config))
    t_build = now() - t
    say("load", scene_s=t_scene, accelerator_build_s=t_build,
        triangles=int(np.asarray(scene.triangles.valid).sum()),
        lights=int(scene.lights.num), supers=scene.bvh.num_supers)
    return scene, cam


# ---------------------------------------------------------------------------
# Phase 2: traversal parity.
# ---------------------------------------------------------------------------

def primary_rays(cam, side):
    """side^2 primary rays over the whole view in patch-major lane order."""
    u, v, _, _ = _pixel_order(RenderConfig(width=side, height=side))
    return generate_rays(cam, u, v, jnp.zeros_like(u), jnp.zeros_like(v))


def shadow_segments(scene, o, d, t, tri_id, seed=0):
    """Forward NEE segments from each primary triangle hit to a fixed
    point on one of the scene's lights (deterministic numpy draws)."""
    o, d, t, tri_id = (np.asarray(x) for x in (o, d, t, tri_id))
    hit = tri_id >= 0
    p = o[hit] + d[hit] * t[hit, None]
    n = p.shape[0]
    rng = np.random.default_rng(seed)
    lights = scene.lights
    li = rng.integers(0, int(lights.num), n)
    r1, r2 = rng.random(n), rng.random(n)
    fold = r1 + r2 > 1.0
    r1, r2 = np.where(fold, 1.0 - r1, r1), np.where(fold, 1.0 - r2, r2)
    lp = (np.asarray(lights.tri_a)[li]
          + r1[:, None] * np.asarray(lights.tri_ab)[li]
          + r2[:, None] * np.asarray(lights.tri_ac)[li]).astype(np.float32)
    to_l = lp - p
    dist = np.linalg.norm(to_l, axis=-1).astype(np.float32)
    ldir = (to_l / dist[:, None]).astype(np.float32)
    pk = np.full(n, C.PRIM_TRIANGLE, np.int32)
    return (p.astype(np.float32), ldir, dist, pk,
            tri_id[hit].astype(np.int32))


@jax.jit
def _closest(grid, tris, o, d, t_max, pk, pi):
    return block_bvh.traverse_closest(grid, tris, o, d, t_max, pk, pi)


@jax.jit
def _any(grid, tris, o, d, max_dist, pk, pi):
    return block_bvh.traverse_any(grid, tris, o, d, max_dist, pk, pi)


@jax.jit
def _oracle(tris, o, d, t_max, pk, pi):
    # closest_triangles scans the primitives in fixed chunks, so the
    # intermediates are (rays x chunk), not (rays x triangles).
    return nv.closest_triangles(tris, o, d, t_max, pk, pi)


def _on(device, *xs):
    return jax.device_put(xs, device)


def _close(a, b):
    return np.abs(a - b) <= T_RTOL * np.maximum(np.abs(b), 1e-30)


def phase_traversal(scene, cam, side=64, device=None, cpu=None,
                    ray_chunk=4096):
    """block_bvh on `device` against block_bvh on `cpu` and against the
    naive oracle on `device`."""
    device = device or jax.devices()[0]
    cpu = cpu or jax.devices("cpu")[0]
    grid, tris = scene.bvh, scene.triangles
    o, d = primary_rays(cam, side)
    n = o.shape[0]
    pk = np.zeros(n, np.int32)
    pi = np.full(n, -1, np.int32)
    tmax = np.full(n, BIG, np.float32)

    def both(fn, *args):
        dev = jax.device_get(fn(*_on(device, grid, tris, *args)))
        host = jax.device_get(fn(*_on(cpu, grid, tris, *args)))
        return dev, host

    def oracle(*rays):
        outs = []
        for i in range(0, rays[0].shape[0], ray_chunk):
            part = [np.asarray(x)[i:i + ray_chunk] for x in rays]
            outs.append(jax.device_get(_oracle(*_on(device, tris, *part))))
        return (np.concatenate([x[0] for x in outs]),
                np.concatenate([x[1] for x in outs]))

    # Primaries: closest hit.
    (t_g, id_g), (t_c, id_c) = both(_closest, o, d, tmax, pk, pi)
    check(np.array_equal(t_g >= BIG, t_c >= BIG),
          f"primary hit/miss differs between GPU and CPU on "
          f"{int(np.sum((t_g >= BIG) != (t_c >= BIG)))} rays")
    t_ok = _close(t_g, t_c)
    check(t_ok.all(), f"primary t differs beyond {T_RTOL} on "
                      f"{int((~t_ok).sum())} rays")
    ties_p = int(np.sum(id_g != id_c))
    t_o, id_o = oracle(np.asarray(o), np.asarray(d), tmax, pk, pi)
    miss_p = [int(np.sum((i != id_o) & ~_close(t, t_o)))
              for t, i in ((t_g, id_g), (t_c, id_c))]

    # Shadow segments from the CPU's primary hits.
    so, sd, md, spk, spi = shadow_segments(scene, o, d, t_c, id_c)
    m = so.shape[0]
    occ_g, occ_c = both(_any, so, sd, md, spk, spi)
    # A segment whose nearest blocker lies within T_RTOL of its far end is
    # a tie: either answer is right to float32 precision.
    t_end, _ = jax.device_get(_closest(*_on(
        cpu, grid, tris, so, sd, md * (1 + 2 * T_RTOL), spk, spi)))
    tie_s = _close(t_end, md)
    bad_s = (occ_g != occ_c) & ~tie_s
    check(not bad_s.any(), f"occlusion differs between GPU and CPU on "
                           f"{int(bad_s.sum())} non-tie segments")
    ties_s = int(np.sum((occ_g != occ_c) & tie_s))
    t_os, _ = oracle(so, sd, md * (1 + 2 * T_RTOL), spk, spi)
    occ_o = t_os < md
    miss_s = [int(np.sum((occ != occ_o) & ~_close(t_os, md)))
              for occ in (occ_g, occ_c)]

    say("traversal", primaries=n, primary_hits=int(np.sum(id_c >= 0)),
        primary_ties=ties_p, shadow_segments=m,
        occluded=int(occ_c.sum()), shadow_ties=ties_s,
        oracle_misses_gpu=miss_p[0] + miss_s[0],
        oracle_misses_cpu=miss_p[1] + miss_s[1])
    check(ties_p <= MAX_TIE_SHARE * n and ties_s <= MAX_TIE_SHARE * m,
          f"ties above {MAX_TIE_SHARE:.1%}: {ties_p}/{n}, {ties_s}/{m}")
    check(miss_p[0] + miss_s[0] <= miss_p[1] + miss_s[1],
          "block_bvh misses the oracle more often on the GPU than on the CPU")
    return {"ties": ties_p + ties_s, "oracle_misses": miss_p[0] + miss_s[0]}


def traversal_bar(scene, cam, side=512, reps=5):
    """The bar a hand-written traversal must beat: seconds per call of
    traverse_closest on a full frame of primaries and of traverse_any on
    their shadow segments (median of `reps` warm calls, host clock around
    block_until_ready)."""
    grid, tris = scene.bvh, scene.triangles

    def timed(fn, *args):
        out = jax.block_until_ready(fn(grid, tris, *args))
        ts = []
        for _ in range(reps):
            t = now()
            jax.block_until_ready(fn(grid, tris, *args))
            ts.append(now() - t)
        return out, float(np.median(ts))

    o, d = primary_rays(cam, side)
    n = o.shape[0]
    (t, i), s_closest = timed(
        _closest, o, d, jnp.full((n,), BIG, jnp.float32),
        jnp.zeros((n,), jnp.int32), jnp.full((n,), -1, jnp.int32))
    seg = jax.device_put(shadow_segments(scene, o, d, t, i))
    occ, s_any = timed(_any, *seg)
    say("traversal", bar=f"{side}x{side} primaries", rays=n,
        closest_ms=s_closest * 1e3, shadow_segments=seg[0].shape[0],
        occluded=int(np.asarray(occ).sum()), any_ms=s_any * 1e3)
    return s_closest, s_any


# ---------------------------------------------------------------------------
# Phases 3-4: renders.
# ---------------------------------------------------------------------------

def phase_whitted(scene, cam, config=WHITTED_512, card=""):
    r = Renderer(scene, cam, config)
    t = now()
    compiled = r._step.lower(r.scene, r.camera, r._key, r._accum,
                             0).compile()
    t_compile = now() - t
    r.render()                 # loads the executable just compiled
    r.reset()
    img = r.render()
    check(np.isfinite(img).all(), "non-finite pixels in the Whitted frame")
    device = jax.devices()[0]
    say("whitted", size=f"{config.width}x{config.height}", spp=config.spp,
        compile_s=t_compile, frame_s=r.render_seconds, rays=r.total_rays,
        rays_per_s=r.total_rays / r.render_seconds, card=f"'{card}'",
        image_mean=float(img.mean()), peak_bytes_in_use=peak_bytes(device),
        **memory_fields(compiled))
    return img


def phase_pathtracer(scene, cam, config=PATHTRACER_512, card=""):
    key = jax.random.PRNGKey(config.seed)
    device = jax.devices()[0]
    t = now()
    compiled = render_frame.lower(scene, cam, config, key).compile()
    t_compile = now() - t
    mem = memory_fields(compiled)
    limit = int((device.memory_stats() or {}).get("bytes_limit", 0))
    need = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
            + mem["temp_size_in_bytes"])
    fused = limit == 0 or need <= limit
    t = now()
    out = (compiled(scene, cam, key) if fused
           else render_frame_auto(scene, cam, config, key))
    img = np.asarray(jax.block_until_ready(out)["image"])
    t_frame = now() - t
    check(np.isfinite(img).all(), "non-finite pixels in the PathTracer frame")
    rays = int(out["rays"])
    say("pathtracer", ran="render_frame" if fused else "render_frame_auto",
        size=f"{config.width}x{config.height}", spp=config.spp,
        compile_s=t_compile, frame_s=t_frame, rays=rays,
        rays_per_s=rays / t_frame, card=f"'{card}'", bytes_needed=need,
        bytes_limit=limit, image_mean=float(img.mean()),
        peak_bytes_in_use=peak_bytes(device), **mem)
    return img


# ---------------------------------------------------------------------------
# Phase 5: reference-binary goldens.
# ---------------------------------------------------------------------------

def phase_goldens(goldens=None, accelerators=(C.ACC_NAIVE, C.ACC_BVH),
                  size=None):
    from mobileraytracer_tpu.utils.golden import (ANALYTIC_GOLDENS,
                                                  assert_close, load_golden,
                                                  render_builtin)
    results = {}
    for name, scene_id, shader in goldens or ANALYTIC_GOLDENS:
        ref = load_golden(name)
        for acc in accelerators:
            t = now()
            ours = render_builtin(scene_id, shader, size or ref.shape[0],
                                  acc=acc)
            seconds = now() - t
            if size is not None and size != ref.shape[0]:
                # A rehearsal at another size: no golden to compare with.
                check(np.isfinite(ours).all(), f"{name}: non-finite pixels")
                say("goldens", name=name, accelerator=acc, size=size,
                    finite=True)
                results[(name, acc)] = None
                continue
            diff = np.abs(ours - ref)
            say("goldens", name=name, accelerator=acc, seconds=seconds,
                mean_abs_diff_255=float(diff.mean() * 255),
                outlier_share=float((diff.max(-1) > 4 / 255).mean()))
            try:
                assert_close(ours, ref, label=f"{name} acc={acc}")
            except AssertionError as e:
                raise PhaseFailed(str(e)) from None
            results[(name, acc)] = float(diff.mean())
    return results


# ---------------------------------------------------------------------------
# Phase 6: vertex gradients.
# ---------------------------------------------------------------------------

def _grad_fn(config, **kwargs):
    from mobileraytracer_tpu.diff import vertex_grad
    return jax.jit(lambda scene, cam, key, keep: vertex_grad(
        scene, cam, config, key, edge_samples=8, edge_keep=keep, **kwargs))


def phase_gradients(scene, cam, config=WHITTED_512, small_size=64,
                    edge_budget=4096, shadow_budget=1024, cpu=None):
    """bench_grad.py's edge options on `scene` at `config`, then cornell2
    with the naive scan on the GPU against the CPU backend."""
    from mobileraytracer_tpu.diff.geom import edge_topology
    device = jax.devices()[0]
    key = jax.random.PRNGKey(0)
    keep = jnp.asarray(edge_topology(scene.triangles))
    fn = _grad_fn(config, edge_budget=edge_budget, shadow_edges=True,
                  shadow_budget=shadow_budget)
    t = now()
    compiled = fn.lower(scene, cam, key, keep).compile()
    t_compile = now() - t
    compiled(scene, cam, key, keep)
    t = now()
    loss, grads = jax.block_until_ready(compiled(scene, cam, key, keep))
    t_step = now() - t
    finite = bool(np.isfinite(float(loss))) and all(
        bool(np.isfinite(np.asarray(g)).all()) for g in grads.values())
    px = config.width * config.height
    say("gradients", size=f"{config.width}x{config.height}",
        compile_s=t_compile, step_s=t_step,
        mpixel_grads_per_s=px / t_step / 1e6, loss=float(loss),
        finite=finite, peak_bytes_in_use=peak_bytes(device),
        **memory_fields(compiled))
    check(finite, "non-finite vertex gradients")

    cpu = cpu or jax.devices("cpu")[0]
    s2, cam2 = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    cfg2 = RenderConfig(width=small_size, height=small_size, spp=1,
                        shader=C.SHADER_WHITTED, accelerator=C.ACC_NAIVE,
                        scene_id=C.SCENE_CORNELL2)
    keep2 = jnp.asarray(edge_topology(s2.triangles))
    fn2 = _grad_fn(cfg2)
    l_g, g_g = jax.device_get(fn2(*_on(device, s2, cam2, key, keep2)))
    l_c, g_c = jax.device_get(fn2(*_on(cpu, s2, cam2, key, keep2)))
    scale = max(float(np.max(np.abs(g))) for g in g_c.values())
    err = max(float(np.max(np.abs(g_g[k] - g_c[k]))) for k in g_c)
    loss_err = abs(float(l_g) - float(l_c)) / max(abs(float(l_c)), 1e-30)
    say("gradients", check="cornell2 GPU vs CPU", size=small_size,
        loss_rel_err=loss_err, grad_max_abs_err=err, grad_scale=scale,
        rtol=GRAD_RTOL)
    check(loss_err <= GRAD_RTOL and err <= GRAD_RTOL * scale,
          f"cornell2 gradients differ between GPU and CPU: "
          f"loss {loss_err:.2e}, grads {err:.3e} of {scale:.3e}")
    return err / scale


# ---------------------------------------------------------------------------
# Phase 7: CLI.
# ---------------------------------------------------------------------------

def phase_cli(size=256):
    from mobileraytracer_tpu import cli
    argv = ["--scene", str(C.SCENE_CORNELL), "--shader",
            str(C.SHADER_WHITTED), "--acc", str(C.ACC_BVH),
            "--width", str(size), "--height", str(size)]
    t = now()
    rc = cli.main(argv)
    say("cli", argv=" ".join(argv), rc=rc, seconds=now() - t)
    check(rc == 0, f"cli.main returned {rc}")


# ---------------------------------------------------------------------------
# --four: the sharded path on four cards.
# ---------------------------------------------------------------------------

def phase_four(scene, cam, config=WHITTED_512, grad_size=64, n=4):
    from mobileraytracer_tpu.parallel import mesh as pmesh
    devices = jax.devices()[:n]
    check(len(devices) == n, f"--four needs {n} devices, found "
                             f"{len(jax.devices())}")
    key = jax.random.PRNGKey(0)
    mesh = pmesh.make_mesh(devices=devices)
    single = render_frame(scene, cam, config, key)
    img_1 = np.asarray(single["image"])
    t = now()
    jax.block_until_ready(render_frame(scene, cam, config, key)["image"])
    t_single = now() - t
    t = now()
    sharded = pmesh.render_frame_sharded(scene, cam, config, key, mesh)
    img_n = np.asarray(jax.block_until_ready(sharded["image"]))
    t_first = now() - t
    t = now()
    jax.block_until_ready(
        pmesh.render_frame_sharded(scene, cam, config, key, mesh)["image"])
    t_warm = now() - t
    same = np.array_equal(img_1, img_n)
    diff = np.abs(img_1 - img_n)
    say("four", render="conference Whitted", devices=n,
        bit_identical=same, differing_pixels=int((diff.max(-1) > 0).sum()),
        max_abs_diff=float(diff.max()),
        rays_equal=int(single["rays"]) == int(sharded["rays"]),
        first_call_s=t_first, warm_frame_s=t_warm,
        single_device_warm_frame_s=t_single,
        rays_per_s=int(sharded["rays"]) / t_warm)
    check(np.isfinite(img_n).all(), "non-finite pixels in the sharded frame")
    check(int(single["rays"]) == int(sharded["rays"]),
          "sharded ray count differs from the single-device frame")
    # Counter-based keys make the sharded frame the same computation per
    # pixel; where the compiler fuses the per-shard program differently,
    # float32 rounding may move the last bits.  A wrong shard or pixel
    # order is off by whole colour steps, far above this bound.
    check(float(diff.max()) <= SHARD_ATOL,
          f"sharded frame differs from the single-device frame by "
          f"{float(diff.max()):.3e} > {SHARD_ATOL}")

    s2, cam2 = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    cfg2 = RenderConfig(width=grad_size, height=grad_size, spp=1,
                        shader=C.SHADER_WHITTED, accelerator=C.ACC_NAIVE,
                        scene_id=C.SCENE_CORNELL2)
    target = jnp.zeros((grad_size, grad_size, 3), jnp.float32)
    one = pmesh.make_mesh(devices=devices[:1])
    l_1, g_1 = jax.device_get(pmesh.train_step_sharded(
        s2, cam2, cfg2, key, target, one))
    l_n, g_n = jax.device_get(pmesh.train_step_sharded(
        s2, cam2, cfg2, key, target, mesh))
    # The psum over four shards adds the per-shard sums in another order
    # than one device's sum over all pixels: float32 reassociation only.
    # Non-finite entries (a NaN ior gradient on cornell2) must match in
    # place; the rest are compared.
    nan_same = all(np.array_equal(np.isnan(g_1[k]), np.isnan(g_n[k]))
                   for k in g_1)
    scale = max(float(np.nanmax(np.abs(g))) for g in g_1.values())
    err = max(float(np.nanmax(np.abs(g_n[k] - g_1[k]))) for k in g_1)
    loss_err = abs(float(l_n) - float(l_1)) / max(abs(float(l_1)), 1e-30)
    say("four", train_step="cornell2 materials", devices=n,
        loss_rel_err=loss_err, grad_max_abs_err=err, grad_scale=scale,
        rtol=1e-5, nan_entries=sum(int(np.isnan(g).sum())
                                   for g in g_1.values()),
        nan_pattern_same=nan_same)
    check(nan_same and loss_err <= 1e-5 and err <= 1e-5 * scale,
          "sharded material gradients differ from the single-device ones")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (first device is "
              f"{device.platform!r}); refusing to run", file=sys.stderr)
        return 2
    import mobileraytracer_tpu
    if pathlib.Path(mobileraytracer_tpu.__file__).resolve().parent.parent \
            != REPO:
        print("chip_smoke: the package is not the one beside this script",
              file=sys.stderr)
        return 2
    from mobileraytracer_tpu.utils.compile_cache import enable_compile_cache

    card = nvidia_smi_line()
    say("device", platform=device.platform, kind=f"'{device.device_kind}'",
        count=len(jax.devices()), jax=jax.__version__,
        compile_cache=enable_compile_cache())
    print(card, flush=True)

    t0 = now()
    try:
        scene, cam = phase_load()
        if args.four:
            phase_four(scene, cam)
            count = 4
        else:
            phase_traversal(scene, cam)
            traversal_bar(scene, cam)
            phase_whitted(scene, cam, card=card)
            phase_pathtracer(scene, cam, card=card)
            phase_goldens()
            phase_gradients(scene, cam)
            phase_cli()
            count = len(jax.devices())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    say("done", seconds=now() - t0)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
