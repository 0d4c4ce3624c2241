#!/usr/bin/env python
"""Quantify the dropped secondary-bounce shadow-edge gradient term
(PARITY.md #11, VERDICT r4 #7).

vertex_grad's estimator covers interior + primary-silhouette +
first-bounce NEE shadow boundaries.  Visibility discontinuities of
bounce >= 2 paths (PathTracer indirect shadows, secondary silhouettes)
are not edge-sampled.  This experiment measures the total dropped term on
cornell2 directly: central finite differences of the PathTracer loss
L = mean(image) under a vertex perturbation — computed with COMMON RANDOM
NUMBERS (the counter-based RNG reuses identical sample decisions for the
+eps and -eps scenes, so the MC noise of the difference collapses to the
discontinuity-crossing paths) — versus the estimator's gradient.

bias = AD(interior + primary boundaries) - FD(everything).

Run from the repository root: PYTHONPATH=. python scripts/shadow_bias.py
"""
import json

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

SIZE = 64
SPP = 16
EPS = 0.15
TRI, VCH = 1, 1          # green triangle, vertex A, y (as test_refgrad)
SEEDS = 6


def main():
    from mobileraytracer_tpu import constants as C, scenes
    from mobileraytracer_tpu.diff.geom import (scene_with_vertices,
                                               triangle_vertices,
                                               vertex_grad)
    from mobileraytracer_tpu.renderer import render_sample
    from mobileraytracer_tpu.types import RenderConfig

    scene, cam = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    scene = jax.device_put(scene)
    cfg = RenderConfig(width=SIZE, height=SIZE, spp=SPP,
                       shader=C.SHADER_PATHTRACER, accelerator=C.ACC_NAIVE,
                       scene_id=C.SCENE_CORNELL2, pixel_jitter=False)

    verts0 = triangle_vertices(scene.triangles)

    @jax.jit
    def loss(delta, key):
        verts = dict(verts0)
        verts["va"] = verts0["va"].at[TRI, VCH % 3].add(delta)
        s2 = scene_with_vertices(scene, verts)
        accum = jnp.zeros((SIZE * SIZE, 3), jnp.float32)
        for s in range(SPP):
            rgb, _ = render_sample(s2, cam, cfg, key, s)
            accum = accum + rgb
        return jnp.mean(accum / SPP)

    fds = []
    for seed in range(SEEDS):
        key = jax.random.PRNGKey(seed)
        lp = float(loss(+EPS, key))
        lm = float(loss(-EPS, key))
        fds.append((lp - lm) / (2 * EPS))
        print(f"seed {seed}: fd {fds[-1]:+.5f}", flush=True)
    fd = float(np.mean(fds))
    fd_err = float(np.std(fds) / np.sqrt(len(fds)))

    ads = []
    for seed in range(3):
        _, g = vertex_grad(scene, cam, cfg, jax.random.PRNGKey(100 + seed),
                           edge_samples=16, spp=8, shadow_edges=True)
        ads.append(float(np.asarray(g["va"])[TRI, VCH % 3]))
        print(f"ad seed {seed}: {ads[-1]:+.5f}", flush=True)
    ad = float(np.mean(ads))
    ad_err = float(np.std(ads) / np.sqrt(len(ads)))

    print(json.dumps({
        "fd_all_terms": round(fd, 5), "fd_stderr": round(fd_err, 5),
        "ad_estimator": round(ad, 5), "ad_stderr": round(ad_err, 5),
        "dropped_term_bias": round(ad - fd, 5),
        "bias_rel_to_fd": round((ad - fd) / fd, 3) if fd else None,
    }))


if __name__ == "__main__":
    main()
