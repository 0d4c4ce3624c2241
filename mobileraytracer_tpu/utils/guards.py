"""Debug guards and structured failure detection — the analogue of
the reference's sanitizer + checkSystemError layers.

The reference compiles ASan/LSan into debug builds (reference
app/CMakeLists.txt:208-213), inspects errno after every phase via
`checkSystemError` (reference app/MobileRT/Utils/Utils.cpp:237-280,
ErrorCode table), asserts geometry validity in shape ctors (death-tested
by app/Unit_Testing/TestAABB.cpp:27-32), and maps native failures to
typed Java exceptions including `LowMemoryException` for bad_alloc
(JNI_layer.cpp:114-126,231-239).  None of those mechanisms reach code
compiled by XLA; SURVEY.md §5.2/§5.3 names the equivalents built here:

* `checked_render` — runs a frame under `jax.experimental.checkify`
  float checks (NaN / inf / div-by-zero detected *inside* the compiled
  program, with source location), raising `RenderError` instead of
  silently corrupting the film;
* `validate_scene` — host-side geometry validation (the ctor-assert /
  death-test tier): finite vertices, non-negative radii, finite
  materials, raising `SceneError`;
* `device_oom_guard` — context manager translating XLA
  RESOURCE_EXHAUSTED into `LowDeviceMemoryError` carrying the device
  memory stats (the LowMemoryException + printFreeMemory analogue,
  Utils.cpp:285-303).
"""
from __future__ import annotations

import contextlib

import jax
import numpy as np
from jax.experimental import checkify


class RenderError(RuntimeError):
    """A float-check (NaN/inf/div0) tripped inside the compiled render."""


class SceneError(ValueError):
    """Invalid scene geometry/materials (the ctor-assert tier)."""


class LowDeviceMemoryError(MemoryError):
    """Device allocation failed (the LowMemoryException analogue)."""


def _finite(name: str, a, where=None) -> None:
    a = np.asarray(a)
    bad = ~np.isfinite(a)
    if where is not None:
        bad = bad & np.asarray(where).reshape(
            bad.shape[:1] + (1,) * (bad.ndim - 1))
    if bad.any():
        raise SceneError(f"scene.{name} has {int(bad.sum())} non-finite values")


def validate_scene(scene) -> None:
    """Host-side geometry validation, raising SceneError on the classes of
    input the reference death-tests (TestAABB.cpp:27-32: lower bound >
    upper bound aborts; Ray ctor asserts finite direction, Ray.hpp:13-72).
    """
    tri = scene.triangles
    _finite("triangles.point_a", tri.point_a, tri.valid)
    _finite("triangles.ab", tri.ab, tri.valid)
    _finite("triangles.ac", tri.ac, tri.valid)
    sph = scene.spheres
    _finite("spheres.center", sph.center, sph.valid)
    r2 = np.asarray(sph.sq_radius)
    if (np.asarray(sph.valid) & ~(r2 > 0)).any():
        raise SceneError("spheres.sq_radius must be positive for valid spheres")
    pl = scene.planes
    _finite("planes.point", pl.point, pl.valid)
    n = np.asarray(pl.normal)
    nl = np.linalg.norm(n, axis=-1)
    if (np.asarray(pl.valid) & ~np.isfinite(nl)).any() or \
       (np.asarray(pl.valid) & (nl < 1e-6)).any():
        raise SceneError("planes.normal must be finite and non-degenerate")
    for f in ("kd", "ks", "kt", "le"):
        _finite(f"materials.{f}", getattr(scene.materials, f))


def checked_render(scene, camera, config, base_key, max_point=None) -> dict:
    """`render_frame` under checkify float checks.

    Compiles the whole frame with NaN/inf/div-by-zero detection baked in
    (SURVEY §5.2's `jax_debug_nans`/checkify equivalent — but scoped to
    this call, jit-compatible, and with the failing source location in
    the message).  ~2x slower than the unchecked path; debug tool, not
    the production entry.
    """
    from ..renderer import render_frame

    def run(scene, camera, base_key, max_point):
        return render_frame(scene, camera, config, base_key, max_point)

    checked = checkify.checkify(run, errors=checkify.float_checks)
    err, out = jax.jit(checked)(scene, camera, base_key, max_point)
    failure = err.get()
    if failure is not None:
        raise RenderError(f"float check tripped during render: {failure}")
    return out


@contextlib.contextmanager
def device_oom_guard():
    """Translate XLA RESOURCE_EXHAUSTED into LowDeviceMemoryError with the
    device's memory stats attached (printFreeMemory analogue)."""
    try:
        yield
    except Exception as e:  # XlaRuntimeError has no stable import path
        msg = str(e)
        if "RESOURCE_EXHAUSTED" not in msg and "out of memory" not in msg.lower():
            raise
        stats = {}
        try:
            dev = jax.devices()[0]
            stats = dev.memory_stats() or {}
        except Exception:
            pass
        free = stats.get("bytes_limit", 0) - stats.get("bytes_in_use", 0)
        raise LowDeviceMemoryError(
            f"device allocation failed (free ~{free / 1e6:.1f} MB of "
            f"{stats.get('bytes_limit', 0) / 1e6:.1f} MB): {msg}") from e
