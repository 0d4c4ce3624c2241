#!/usr/bin/env python
"""Benchmark: rays/s on the canonical conference workload, printed as one
JSON line.

Metric definition matches the reference: total casted rays (camera +
secondary + shadow) divided by render wall time (reference
app/System_dependent/Native/C_wrapper.cpp:256 "Total Millions rays per
second"; numerator from the global Ray-id counter, Ray.cpp:26-28).

Workload: the reference's conference OBJ is not vendored (only .cam/.mtl),
so we render the procedural conference proxy at the reference's exact
scale — 331,179 triangles, 2 area lights, the real conference.mtl
materials and conference.cam camera — Whitted, BVH, 512x512, 1 SPP
(BASELINE.md config #3) by default.  The JSON line names the device it
was measured on; the script exits non-zero when JAX finds no GPU.

Other BASELINE configs are reachable by flags (the default invocation —
what the driver runs — is unchanged):
    python bench.py --shader 2 --spp 16     # config #4: PathTracer 16 spp
    python bench.py --acc 2 --size 256      # RegularGrid datapoint
"""
import argparse
import json
import sys
import time

import jax


def require_gpu() -> dict:
    """The device the numbers belong to; exits when it is not a GPU, so a
    CPU run never prints a device metric."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU found (JAX platform {dev.platform!r}); refusing "
                 "to time the fallback backend")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shader", type=int, default=None,
                    help="shader id (default Whitted=1; 2=PathTracer)")
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--spl", type=int, default=1)
    ap.add_argument("--acc", type=int, default=None,
                    help="accelerator id (default BVH=3; 2=RegularGrid)")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=None,
                    help="frames per timing executable (default: 9 at "
                         "1 spp, 3 otherwise)")
    ap.add_argument("--no-share2", action="store_true",
                    help="disable secondary-bounce NEE sharing (PathTracer "
                         "A/B; default on for shader 2)")
    args = ap.parse_args()

    device = require_gpu()
    from mobileraytracer_tpu import constants as C
    from mobileraytracer_tpu.bench_scenes import conference_proxy
    from mobileraytracer_tpu.ops import build_accelerator
    from mobileraytracer_tpu.renderer import render_frame
    from mobileraytracer_tpu.types import RenderConfig
    from mobileraytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    shader = C.SHADER_WHITTED if args.shader is None else args.shader
    acc = C.ACC_BVH if args.acc is None else args.acc

    # nee_share / nee_share_secondary are SAMPLING POLICY (unbiased; see
    # RenderConfig): one shared light pick/point per 128-lane group on
    # every bounce keeps the shadow bundles one reversed cone each.
    # --no-share2 restores per-lane secondary picks for A/B.
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                       samples_light=args.spl, shader=shader,
                       accelerator=acc, nee_share=128,
                       nee_share_secondary=not args.no_share2)
    scene, cam, info = conference_proxy()
    scene = build_accelerator(scene, cfg)
    key = jax.random.PRNGKey(0)

    # All reps run inside one executable (a fori_loop whose carry chains
    # frame results, forcing sequential execution and defeating CSE) and
    # one scalar comes back; frame time = (T(reps) - T(1)) / (reps - 1)
    # subtracts the fetch and dispatch constant.
    import jax.numpy as jnp

    from mobileraytracer_tpu.renderer import (DISPATCH_UNIT_BUDGET,
                                              _dispatch_cost,
                                              render_frame_auto)

    if _dispatch_cost(cfg) <= DISPATCH_UNIT_BUDGET:
        @jax.jit
        def frames(n):
            def body(i, carry):
                out = render_frame(scene, cam, cfg,
                                   jax.random.fold_in(key, i + carry[1] * 0))
                return (carry[0] * 1e-20 + jnp.sum(out["image"]),
                        carry[1] + out["rays"])
            return jax.lax.fori_loop(0, n, body,
                                     (jnp.zeros(()), jnp.zeros((), jnp.int32)))
    else:
        # Big configs (512^2/16spp PathTracer, big grid frames) self-chunk
        # into per-sample dispatches (render_frame_auto); the dispatches
        # queue without a per-step fetch, so (T(n)-T(1))/(n-1) still
        # isolates steady-state frame time.
        def frames(n):
            rays = jnp.zeros((), jnp.int32)
            out = None
            for i in range(int(n)):
                out = render_frame_auto(scene, cam, cfg,
                                        jax.random.fold_in(key, i))
                rays = rays + out["rays"]
            return jnp.sum(out["image"]), rays

    _, r1 = frames(1)
    rays_per_frame = int(r1)  # compile + warm the relay
    t0 = time.perf_counter()
    _ = float(frames(1)[0])
    t1 = time.perf_counter() - t0

    reps = args.reps or (9 if args.spp <= 1 else 3)
    t0 = time.perf_counter()
    _, rn = frames(reps)
    total_rays = int(rn)
    tn = time.perf_counter() - t0

    dt = (tn - t1) / (reps - 1)
    rays = total_rays // reps
    rays_per_s = rays / dt
    print(json.dumps({
        "metric": "rays_per_second",
        "value": rays_per_s,
        "unit": "rays/s",
        "device": device,
    }))


if __name__ == "__main__":
    main()
