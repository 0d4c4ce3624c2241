#!/usr/bin/env python
"""Benchmark: vertex-gradient throughput (Mpixel-grads/s), printed as one
JSON line.

Default workload (BASELINE.md config #5 scale, one GPU): the
conference proxy (331k triangles), Whitted, block BVH, 512x512 —
full d(mean image)/d(vertices) with interior AD through the
differentiable BVH tracer path, silhouette-culled length-importance-
sampled edge boundaries (edge_budget), and the NEE shadow-edge boundary
term.  `--small` runs the round-3 cornell2/naive/256 configuration for
comparison.  Metric: pixels whose gradient contribution was computed per
second.  Timing: repetitions inside one executable via fori_loop, with
varying keys and one scalar fetch.  The JSON line names the device; the
script exits non-zero when JAX finds no GPU.
"""
import argparse
import json
import time

import jax
import jax.numpy as jnp

from bench import require_gpu


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="round-3 config: cornell2 analytic, naive, 256^2")
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--edge-budget", type=int, default=4096)
    ap.add_argument("--shadow-budget", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=None,
                    help="interior-AD pixel chunk (defaults to 256k lanes "
                         "for frames above 512^2 — the memory guard for "
                         "1080p-scale gradients)")
    args = ap.parse_args()

    device = require_gpu()
    from mobileraytracer_tpu import constants as C
    from mobileraytracer_tpu import scenes
    from mobileraytracer_tpu.diff import vertex_grad
    from mobileraytracer_tpu.diff.geom import edge_topology
    from mobileraytracer_tpu.ops import build_accelerator
    from mobileraytracer_tpu.types import RenderConfig
    from mobileraytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.small:
        scene, cam = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
        scene = jax.device_put(scene)
        size = args.size or 256
        cfg = RenderConfig(width=size, height=size, spp=1,
                           shader=C.SHADER_WHITTED, accelerator=C.ACC_NAIVE,
                           scene_id=C.SCENE_CORNELL2)
        kwargs = {}
    else:
        from mobileraytracer_tpu.bench_scenes import conference_proxy
        scene, cam, info = conference_proxy()
        size = args.size or 512
        cfg = RenderConfig(width=size, height=size, spp=1,
                           shader=C.SHADER_WHITTED, accelerator=C.ACC_BVH,
                           nee_share=128)
        # The build reorders the triangles; the edge mask indexes them, so
        # it is computed on the reordered table.
        scene = build_accelerator(scene, cfg)
        keep = edge_topology(scene.triangles)
        kwargs = dict(edge_keep=jnp.asarray(keep),
                      edge_budget=args.edge_budget,
                      shadow_edges=True, shadow_budget=args.shadow_budget)
        print(f"# edges kept: {int(keep.sum())} / {keep.size}", flush=True)
    chunk = args.chunk
    if chunk is None and size * size > 512 * 512:
        chunk = 256 * 1024
    if chunk:
        kwargs["pixel_chunk"] = chunk
    key = jax.random.PRNGKey(0)

    if "pixel_chunk" in kwargs:
        # Chunked mode (1080p-scale): vertex_grad runs phase-wise — its
        # interior chunks and jitted boundary phase each dispatch
        # separately and queue without a fetch; timing fetches once per
        # repetition set.
        def run(n):
            s = jnp.zeros(())
            for i in range(int(n)):
                loss, grads = vertex_grad(scene, cam, cfg,
                                          jax.random.fold_in(key, i),
                                          edge_samples=8, **kwargs)
                s = s * 1e-20 + loss + sum(jnp.sum(g)
                                           for g in grads.values())
            return s
    else:
        @jax.jit
        def run(n):
            def body(i, carry):
                loss, grads = vertex_grad(scene, cam, cfg,
                                          jax.random.fold_in(key, i),
                                          edge_samples=8, **kwargs)
                s = sum(jnp.sum(g) for g in grads.values())
                return carry * 1e-20 + loss + s
            return jax.lax.fori_loop(0, n, body, jnp.zeros(()))

    float(run(1))
    t0 = time.perf_counter()
    float(run(1))
    t1 = time.perf_counter() - t0
    reps = 4
    t0 = time.perf_counter()
    float(run(reps + 1))
    tn = time.perf_counter() - t0
    dt = max((tn - t1) / reps, 1e-9)

    mpx = size * size / dt / 1e6
    print(json.dumps({
        "metric": "mpixel_grads_per_second",
        "value": mpx,
        "unit": "Mpixel-grads/s",
        "device": device,
    }))


if __name__ == "__main__":
    main()
