"""Reference-binary goldens: loading, rendering and the comparison rule.

refgold/build.sh compiles the reference MobileRT engine headlessly,
refgold/capture.py renders the capture configs through its real
`RayTrace(config, async=false)` entry and stores the int32 ABGR bitmaps in
refgold/golden/.  These helpers re-render the deterministic analytic
configs through this engine and compare them pixelwise; tests/test_golden.py
and chip_smoke.py share them.
"""
from __future__ import annotations

import pathlib

import jax
import numpy as np

from .. import constants as C
from .. import scenes
from ..ops import build_accelerator
from ..renderer import render_frame
from ..types import RenderConfig

GOLDEN_DIR = pathlib.Path(__file__).resolve().parents[2] / "refgold" / "golden"

# Deterministic configs: spp=1 Constant sampler + shaders that draw no
# random numbers for the scene's light types.
ANALYTIC_GOLDENS = (
    ("cornell_noshadows_256", C.SCENE_CORNELL, C.SHADER_NOSHADOWS),
    ("cornell_whitted_256", C.SCENE_CORNELL, C.SHADER_WHITTED),
    ("cornell_depthmap_256", C.SCENE_CORNELL, C.SHADER_DEPTHMAP),
    ("cornell_diffuse_256", C.SCENE_CORNELL, C.SHADER_DIFFUSE),
    ("spheres_whitted_256", C.SCENE_SPHERES, C.SHADER_WHITTED),
    ("spheres2_whitted_256", C.SCENE_SPHERES2, C.SHADER_WHITTED),
    ("cornell2_depthmap_256", C.SCENE_CORNELL2, C.SHADER_DEPTHMAP),
    ("cornell2_diffuse_256", C.SCENE_CORNELL2, C.SHADER_DIFFUSE),
)


def unpack_bitmap(bitmap) -> np.ndarray:
    """ABGR int32 bitmap -> (H, W, 3) float RGB in [0, 1]."""
    bm = np.asarray(bitmap).astype(np.int64)
    r = (bm & 0xFF).astype(np.float32)
    g = ((bm >> 8) & 0xFF).astype(np.float32)
    b = ((bm >> 16) & 0xFF).astype(np.float32)
    return np.stack([r, g, b], axis=-1) / 255.0


def load_golden(name: str) -> np.ndarray:
    raw = np.fromfile(GOLDEN_DIR / f"{name}.bin", dtype=np.int32)
    w, h = int(raw[0]), int(raw[1])
    return unpack_bitmap(raw[2:].reshape(h, w))


def assert_close(ours, ref, mean_tol=1.5 / 255, outlier_tol=4.0 / 255,
                 outlier_frac=0.02, label=""):
    """Isolated silhouette pixels may differ (float-order effects at
    geometry edges), so the rule is {mean |diff| small} + {few outlier
    pixels}, not bitwise equality."""
    diff = np.abs(ours - ref)
    mean = diff.mean()
    frac = (diff.max(axis=-1) > outlier_tol).mean()
    assert mean < mean_tol, (
        f"{label}: mean |diff| {mean:.5f} >= {mean_tol:.5f}")
    assert frac < outlier_frac, (
        f"{label}: {frac * 100:.2f}% pixels differ by more than "
        f"{outlier_tol * 255:.0f}/255")


def render_builtin(scene_id, shader, size, spp=1, spl=1, acc=C.ACC_NAIVE):
    """Renders a built-in scene as the reference does for its goldens
    (integer-parity accumulation) and returns (H, W, 3) float RGB."""
    scene, cam = scenes.load_builtin(scene_id, 1.0)
    cfg = RenderConfig(width=size, height=size, spp=spp, shader=shader,
                       accelerator=acc, samples_light=spl, scene_id=scene_id,
                       accumulation="int_parity")
    out = render_frame(
        build_accelerator(scene, cfg), cam, cfg, jax.random.PRNGKey(0),
        max_point=np.asarray(scenes.DEPTHMAP_MAX_POINT[scene_id],
                             np.float32))
    return unpack_bitmap(out["bitmap"])
