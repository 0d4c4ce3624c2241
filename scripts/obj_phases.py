#!/usr/bin/env python
"""Loader-path phase timings at the reference's canonical bench scale.

The reference's native driver logs four phases on the 331k-triangle
conference workload: "Loading Obj file" (tinyobjloader parse), "Filling
scene", "Creating shader" (accelerator build) and "Rendering"
(reference app/System_dependent/Native/C_wrapper.cpp:103-130,
248-251).  This script produces the same table for our stack: the
procedural conference proxy is serialized once to OBJ+MTL (bit-exact
round trip, tests/test_loaders.py), then loaded through the REAL parser
path (native/objparser.cpp via ctypes + numpy assembly), and the
block-BVH build is timed.  Render-phase numbers live in bench.py / PERF.md.

Run from the repository root: PYTHONPATH=. python scripts/obj_phases.py
"""
import json
import os
import pathlib
import time

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    from mobileraytracer_tpu.bench_scenes import conference_proxy
    from mobileraytracer_tpu.loaders.obj import (load_obj_scene_ex,
                                                 save_obj_scene)

    root = pathlib.Path(__file__).resolve().parent.parent
    path = str(root / ".cache" / "conference_proxy.obj")
    os.makedirs(os.path.dirname(path), exist_ok=True)

    t0 = time.perf_counter()
    scene, cam, info = conference_proxy()
    t_proxy = time.perf_counter() - t0

    t0 = time.perf_counter()
    w = save_obj_scene(scene, path)
    t_write = time.perf_counter() - t0

    t0 = time.perf_counter()
    s2, li = load_obj_scene_ex(path)
    t_load = time.perf_counter() - t0

    from mobileraytracer_tpu.ops import block_bvh

    t0 = time.perf_counter()
    _ = block_bvh.build(s2)
    t_block = time.perf_counter() - t0

    rows = {
        "triangles": w["triangles"],
        "obj_mbytes": round(w["obj_bytes"] / 1e6, 1),
        "proxy_build_s": round(t_proxy, 2),
        "obj_write_s": round(t_write, 2),
        "obj_parse_s": round(li["parse_seconds"], 3),
        "scene_fill_s": round(li["fill_seconds"], 3),
        "obj_load_total_s": round(t_load, 2),
        "block_bvh_build_s": round(t_block, 2),
    }
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
