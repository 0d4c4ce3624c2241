"""Golden-image parity vs the actual reference binary.

Round 1's "parity by construction" is replaced here with measured parity:
refgold/build.sh compiles the reference MobileRT engine headlessly (original
shims for its vendored third-party deps), refgold/capture.py renders the
driver configs through the real `RayTrace(config, async=false)` entry
(reference app/System_dependent/Native/C_wrapper.cpp:271-290) and stores the
int32 ABGR bitmaps in refgold/golden/.  These tests re-render the same
configs through our framework and compare.

Deterministic configs (spp=1 Constant sampler + shaders that draw no random
numbers for the scene's light types) compare pixelwise with a small epsilon
budget: isolated silhouette pixels may differ (float-order effects at
geometry edges), so the oracle is {mean |diff| small} + {few outlier
pixels}, not bitwise equality.
"""
import pathlib

import jax
import numpy as np
import pytest

from mobileraytracer_tpu import constants as C
from mobileraytracer_tpu import scenes
from mobileraytracer_tpu.ops import build_accelerator
from mobileraytracer_tpu.renderer import render_frame
from mobileraytracer_tpu.types import RenderConfig
from mobileraytracer_tpu.utils.golden import (ANALYTIC_GOLDENS, GOLDEN_DIR,
                                              assert_close, load_golden,
                                              render_builtin, unpack_bitmap)

RES = pathlib.Path("/root/reference/app/src/androidTest/resources")

pytestmark = pytest.mark.skipif(
    not (GOLDEN_DIR / "manifest.json").exists(),
    reason="no goldens captured (run refgold/build.sh + capture.py)")


_OBJ_CACHE = {}


def _obj_scene(base, acc):
    """Loads an OBJ scene once per (path, accelerator) across the module."""
    key = (str(base), acc)
    if key not in _OBJ_CACHE:
        from mobileraytracer_tpu.loaders import load_camera_file
        from mobileraytracer_tpu.loaders.obj import load_obj_scene_ex
        scene, info = load_obj_scene_ex(str(base) + ".obj",
                                        str(base) + ".mtl")
        scene = build_accelerator(scene, RenderConfig(accelerator=acc))
        camera = load_camera_file(str(base) + ".cam", 1.0)
        _OBJ_CACHE[key] = (scene, camera)
    return _OBJ_CACHE[key]


def render_obj(base, shader, size, spp=1, spl=1, acc=C.ACC_BVH):
    scene, camera = _obj_scene(base, acc)
    cfg = RenderConfig(width=size, height=size, spp=spp, shader=shader,
                       accelerator=acc, samples_light=spl,
                       scene_id=C.SCENE_OBJ, accumulation="int_parity")
    out = render_frame(
        scene, camera, cfg, jax.random.PRNGKey(0),
        max_point=np.asarray(scenes.DEPTHMAP_MAX_POINT[C.SCENE_OBJ],
                             np.float32))
    return unpack_bitmap(out["bitmap"])


# --- deterministic analytic-scene goldens ---------------------------------

@pytest.mark.parametrize("name,scene_id,shader", ANALYTIC_GOLDENS)
def test_analytic_golden(name, scene_id, shader):
    ref = load_golden(name)
    ours = render_builtin(scene_id, shader, ref.shape[0])
    assert_close(ours, ref, label=name)


# --- deterministic OBJ-scene goldens (loader + BVH + camera parity) -------

@pytest.mark.parametrize("name,base,shader", [
    ("water_depthmap_128", RES / "CornellBox" / "CornellBox-Water",
     C.SHADER_DEPTHMAP),
    ("water_diffuse_128", RES / "CornellBox" / "CornellBox-Water",
     C.SHADER_DIFFUSE),
    ("teapot_depthmap_128", RES / "teapot" / "teapot", C.SHADER_DEPTHMAP),
    ("teapot_diffuse_128", RES / "teapot" / "teapot", C.SHADER_DIFFUSE),
])
def test_obj_golden(name, base, shader):
    if not (base.parent.exists()):
        pytest.skip("reference test resources unavailable")
    ref = load_golden(name)
    ours = render_obj(base, shader, ref.shape[0])
    assert_close(ours, ref, label=name)


# --- statistical goldens (RNG-dependent configs) ---------------------------

@pytest.mark.slow
def test_teapot_whitted_statistical():
    """teapot.mtl's emissive "light" material becomes AreaLights
    (OBJLoader.cpp:367-387), so Whitted draws random light-surface points;
    compare 16-spp means.  Also exercises the textured (map_Kd) path."""
    base = RES / "teapot" / "teapot"
    if not base.parent.exists():
        pytest.skip("reference test resources unavailable")
    ref = load_golden("teapot_whitted_128_16spp")
    ours = render_obj(base, C.SHADER_WHITTED, ref.shape[0], spp=16)
    assert_close(ours, ref, mean_tol=4.0 / 255, outlier_tol=16.0 / 255,
                 outlier_frac=0.05, label="teapot_whitted_16spp")


@pytest.mark.slow
def test_cornell2_whitted_statistical():
    """AreaLight sampling differs by RNG design (PARITY.md §RNG); at 16 spp
    the mean images must agree within Monte-Carlo tolerance."""
    ref = load_golden("cornell2_whitted_256_16spp")
    ours = render_builtin(C.SCENE_CORNELL2, C.SHADER_WHITTED, 256, spp=16)
    assert_close(ours, ref, mean_tol=4.0 / 255, outlier_tol=16.0 / 255,
                 outlier_frac=0.05, label="cornell2_whitted_16spp")


@pytest.mark.slow
def test_water_whitted_statistical():
    """Whitted refraction parity on the transmissive water mesh — the
    hardest Whitted branch (reference Whitted.cpp:82-90: refract + kT
    child), validated against the real binary at 16 spp / spl=4."""
    base = RES / "CornellBox" / "CornellBox-Water"
    if not base.parent.exists():
        pytest.skip("reference test resources unavailable")
    ref = load_golden("water_whitted_128_16spp")
    ours = render_obj(base, C.SHADER_WHITTED, ref.shape[0], spp=16, spl=4)
    assert_close(ours, ref, mean_tol=4.0 / 255, outlier_tol=16.0 / 255,
                 outlier_frac=0.05, label="water_whitted_16spp")


# --- engine-test matrix: every shader x accelerator through the OBJ path ---
# The exact analogue of the reference's system-test tier
# (app/Unit_Testing/engine/ShaderTestEngine.cpp:35-123 and
# AcceleratorTestEngine.cpp:34-84): 32x32 CornellBox-Water, 1 spp, spl=1,
# each shader against each accelerator, vs bitmaps captured from the real
# binary (refgold/capture.py "water30_s{shader}_a{acc}").

# DepthMap/Diffuse draw no random numbers; the captured reference bitmaps
# are bitwise-identical across its three accelerators, so strict pixel
# parity applies.  NoShadows/Whitted/PathTracer sample random area-light
# points (AreaLight::getPosition) even at spp=1 — the reference's own
# accelerators disagree by mean|diff| ~0.012 (NoShadows/Whitted) to ~0.11
# (PathTracer) on these goldens purely from RNG-stream differences — so
# those rows compare seed-averaged center-sampled renders statistically.
_DETERMINISTIC_SHADERS = (C.SHADER_DEPTHMAP, C.SHADER_DIFFUSE)


def render_obj_seed_mean(base, shader, size, acc, n_seeds=16):
    """Mean over `n_seeds` 1-spp renders (center-sampled rays, fresh RNG
    per seed): converges to the expectation of the reference's single
    1-spp draw without introducing pixel-jitter edge bias."""
    import jax.numpy as jnp
    scene, camera = _obj_scene(base, acc)
    cfg = RenderConfig(width=size, height=size, spp=1, shader=shader,
                       accelerator=acc, samples_light=1,
                       scene_id=C.SCENE_OBJ)
    acc_img = None
    for seed in range(n_seeds):
        out = render_frame(scene, camera, cfg, jax.random.PRNGKey(seed))
        # Clamp each draw like the reference's 8-bit bitmap does: the
        # golden is E[clip(X)], not clip(E[X]) — at PathTracer 1-spp noise
        # the difference is ~0.05 in the image mean.
        img = np.clip(np.asarray(out["image"]), 0.0, 1.0)
        acc_img = img if acc_img is None else acc_img + img
    return acc_img / n_seeds


@pytest.mark.parametrize("shader", range(5))
@pytest.mark.parametrize("acc", (C.ACC_NAIVE, C.ACC_REGULAR_GRID, C.ACC_BVH))
@pytest.mark.slow
def test_engine_matrix_water30(shader, acc):
    base = RES / "CornellBox" / "CornellBox-Water"
    if not base.parent.exists():
        pytest.skip("reference test resources unavailable")
    name = f"water30_s{shader}_a{acc}"
    ref = load_golden(name)
    if shader in _DETERMINISTIC_SHADERS:
        ours = render_obj(base, shader, ref.shape[0], acc=acc)
        assert_close(ours, ref, label=name)
        return
    ours = render_obj_seed_mean(base, shader, ref.shape[0], acc)
    bias = abs(float(ours.mean()) - float(ref.mean()))
    # Image-mean noise of one reference draw: ~0.001 (NoShadows/Whitted,
    # measured across its accelerators) to ~0.004 (PathTracer).
    mean_tol = 0.02 if shader == C.SHADER_PATHTRACER else 0.012
    assert bias < mean_tol, f"{name}: image-mean bias {bias:.4f} >= {mean_tol}"
    if shader != C.SHADER_PATHTRACER:
        # Per-pixel sanity at the reference's own cross-accelerator spread
        # (~0.012); PathTracer's 1-spp per-pixel noise (~0.11) makes a
        # per-pixel bound uninformative there.
        d = np.abs(ours - ref).mean()
        assert d < 0.04, f"{name}: per-pixel mean|diff| {d:.4f} >= 0.04"


@pytest.mark.slow
def test_cornell2_pathtracer_statistical():
    """PathTracer parity incl. the post-order NEE guard
    (PathTracer.cpp:107-113; shaders/engine.py bucket walk).

    Two *independent* 64-spp MC estimates differ by ~sqrt(2)*sigma_64 per
    pixel (~0.09 here) no matter how exact the estimator is, so a per-pixel
    tolerance below that is statistically unreachable.  The oracle instead
    compares 16x16-block means — averaging 256 pixels drops the noise floor
    to ~0.006 while preserving any systematic error at block scale (the
    round-2 forward-guard bug showed ~0.09 mean error that block averaging
    does NOT remove) — plus a tight global-bias check."""
    ref = load_golden("cornell2_pt_256_64spp")
    ours = render_builtin(C.SCENE_CORNELL2, C.SHADER_PATHTRACER, 256, spp=64)
    blk = 16
    rb = ref.reshape(256 // blk, blk, 256 // blk, blk, 3).mean(axis=(1, 3))
    ob = ours.reshape(256 // blk, blk, 256 // blk, blk, 3).mean(axis=(1, 3))
    assert_close(ob, rb, mean_tol=6.0 / 255, outlier_tol=24.0 / 255,
                 outlier_frac=0.08, label="cornell2_pt_64spp_blockmean")
    bias = np.abs((ours - ref).mean(axis=(0, 1))).max()
    assert bias < 2.0 / 255, f"global channel bias {bias:.5f}"
