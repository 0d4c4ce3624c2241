"""The render engine: progressive samples-per-pixel accumulation over a
jitted whole-frame wavefront.

Replaces the reference's thread-pool + 256-tile work queue
(reference app/MobileRT/Renderer.cpp:53-197) with one pjit-able function:
all pixels trace as one wavefront batch, SPP progresses as a `lax.scan`
(or a Python loop when a per-sample callback wants progressive frames —
the analogue of the reference's live-bitmap polling UI).
"""
from __future__ import annotations

import time
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C
from . import film, samplers, sampling
from .cameras import generate_rays
from .ops import build_accelerator
from .shaders.engine import trace_image_sample
from .types import Camera, RenderConfig, Scene

# Render lifecycle states (reference JNI_layer.hpp:12-14 {IDLE, BUSY,
# FINISHED, STOPPED} and constants/State.java).
STATE_IDLE = "IDLE"
STATE_BUSY = "BUSY"
STATE_FINISHED = "FINISHED"
STATE_STOPPED = "STOPPED"


def _pixel_order(config: RenderConfig):
    """Pixel evaluation order: 4x4 image patches, patch-major.

    Consecutive lanes cover a small square patch so the tile-cooperative
    BVH traversal (ops/block_bvh.py) sees spatially coherent ray tiles.
    The counter-based RNG keys by pixel id, so the order never changes the
    image — only the execution layout.  Returns (u, v, pixel_ids,
    inverse_permutation) with u = x / width, v = y / height (pixel
    corners, matching Renderer.cpp:108-136).
    """
    w, h = config.width, config.height
    ph, pw = max(C.SUBTILE // 4, 1), 4
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    order = np.lexsort((xs.ravel() % pw, ys.ravel() % ph,
                        xs.ravel() // pw, ys.ravel() // ph))
    pids = (ys.ravel() * w + xs.ravel())[order].astype(np.int32)
    inv = np.empty_like(pids)
    inv[pids] = np.arange(w * h, dtype=np.int32)
    u = jnp.asarray((pids % w).astype(np.float32) / w)
    v = jnp.asarray((pids // w).astype(np.float32) / h)
    return u, v, jnp.asarray(pids), jnp.asarray(inv)


def _pixel_uv(config: RenderConfig):
    u, v, _, _ = _pixel_order(config)
    return u, v


def sample_pixels(scene: Scene, camera: Camera, config: RenderConfig,
                  base_key: jax.Array, sample_idx, u, v, pixel_ids,
                  max_point=None, differentiable: bool = False):
    """Traces one sample of an arbitrary pixel subset (the shardable unit);
    returns (rgb (B, 3), rays)."""
    w, h = config.width, config.height
    keys = sampling.ray_key(base_key, pixel_ids, sample_idx)

    if config.resolved_pixel_jitter():
        if config.pixel_sampler == "halton":
            # (2,3)-Halton over the sample index with a per-pixel
            # Cranley-Patterson rotation for decorrelation.
            jkeys = sampling.event_key(keys, 0, sampling.PURPOSE_PIXEL_JITTER)
            off = jax.vmap(
                lambda k: jax.random.uniform(k, (2,), jnp.float32))(jkeys)
            h2 = sampling.halton(jnp.full_like(pixel_ids, sample_idx), 2)
            h3 = sampling.halton(jnp.full_like(pixel_ids, sample_idx), 3)
            r = jnp.stack([jnp.mod(h2 + off[:, 0], 1.0),
                           jnp.mod(h3 + off[:, 1], 1.0)], -1)
        elif config.pixel_sampler == "prng":
            jkeys = sampling.event_key(keys, 0, sampling.PURPOSE_PIXEL_JITTER)
            r = jax.vmap(
                lambda k: jax.random.uniform(k, (2,), jnp.float32))(jkeys)
        else:
            # One of the reference's 8 sampler components (samplers.py).
            r = samplers.pixel_jitter(config.pixel_sampler, base_key,
                                      pixel_ids, sample_idx, w * h)
        # deviation = (r - 0.5) * 2 * (0.5 / size)  (Renderer.cpp:137-140)
        dev_u = (r[:, 0] - 0.5) * 2.0 * (0.5 / w)
        dev_v = (r[:, 1] - 0.5) * 2.0 * (0.5 / h)
    else:
        # spp <= 1 uses the Constant(0.5) sampler => zero deviation
        # (C_wrapper.cpp:144-148).
        dev_u = jnp.zeros_like(u)
        dev_v = jnp.zeros_like(v)

    o, d = generate_rays(camera, u, v, dev_u, dev_v)
    return trace_image_sample(scene, config, o, d, keys, max_point=max_point,
                              differentiable=differentiable)


def render_sample(scene: Scene, camera: Camera, config: RenderConfig,
                  base_key: jax.Array, sample_idx, max_point=None,
                  differentiable: bool = False):
    """Traces one sample of every pixel in patch-major lane order;
    returns (rgb (B,3) in lane order, rays).  Use `_pixel_order`'s inverse
    permutation to go back to row-major pixels."""
    u, v, pixel_ids, _ = _pixel_order(config)
    return sample_pixels(scene, camera, config, base_key, sample_idx, u, v,
                         pixel_ids, max_point=max_point,
                         differentiable=differentiable)


@partial(jax.jit, static_argnames=("config",))
def render_frame(scene: Scene, camera: Camera, config: RenderConfig,
                 base_key: jax.Array, max_point=None):
    """Full frame at `config.spp` samples.  Returns a dict with:
    - "image": (H, W, 3) float32 mean radiance
    - "bitmap": (H, W) int32 packed ABGR (reference bitmap format)
    - "rays": () int64-ish total casted rays (the reference's throughput
      numerator, Renderer.cpp:204-207)
    """
    w, h = config.width, config.height
    _, _, _, inv = _pixel_order(config)

    if config.accumulation == "int_parity":
        def body(carry, s):
            bitmap, rays = carry
            rgb, r = render_sample(scene, camera, config, base_key, s, max_point)
            bitmap = film.incremental_avg_int(bitmap, rgb, s + 1)
            return (bitmap, rays + r), None
        init = (jnp.zeros((w * h,), jnp.int32), jnp.zeros((), jnp.int32))
        (bitmap, rays), _ = jax.lax.scan(body, init, jnp.arange(config.spp))
        bitmap = bitmap[inv]
        image = film.unpack_abgr(bitmap)
    else:
        def body(carry, s):
            accum, rays = carry
            rgb, r = render_sample(scene, camera, config, base_key, s, max_point)
            accum = film.incremental_avg_float(accum, rgb, s + 1)
            return (accum, rays + r), None
        init = (jnp.zeros((w * h, 3), jnp.float32), jnp.zeros((), jnp.int32))
        (accum, rays), _ = jax.lax.scan(body, init, jnp.arange(config.spp))
        image = accum[inv]
        bitmap = film.quantize_abgr(image)

    return {
        "image": image.reshape(h, w, 3),
        "bitmap": bitmap.reshape(h, w),
        "rays": rays,
    }


# ---------------------------------------------------------------------------
# Self-chunking dispatch: `render_frame_auto` estimates a frame's cost and,
# above a budget, splits it into per-sample and, if still too big,
# per-pixel-chunk dispatches, accumulating on-device so the result is
# numerically identical to `render_frame`'s float32 path (the per-sample
# loop is the reference's own progressive rendering structure,
# app/MobileRT/Renderer.cpp:107-170).  Splitting bounds the memory and the
# length of one dispatch; whether a GPU needs it at all is not yet
# measured.
# ---------------------------------------------------------------------------

# Cost units are pixel-samples weighted by rough per-shader cost ratios
# (PathTracer ~10x Whitted per ray; the RegularGrid DDA ~500x the BVH per
# pixel), chosen on other hardware and not re-measured on a GPU.
DISPATCH_UNIT_BUDGET = 4.0e6

_SHADER_COST = {C.SHADER_NOSHADOWS: 1.0, C.SHADER_WHITTED: 2.0,
                C.SHADER_PATHTRACER: 20.0, C.SHADER_DEPTHMAP: 0.5,
                C.SHADER_DIFFUSE: 0.5}


def _dispatch_cost(config: RenderConfig) -> float:
    acc_w = 500.0 if config.accelerator == C.ACC_REGULAR_GRID else 1.0
    return (float(config.width * config.height) * config.spp
            * _SHADER_COST.get(config.shader, 2.0)
            * max(config.samples_light, 1) * acc_w)


def render_frame_auto(scene: Scene, camera: Camera, config: RenderConfig,
                      base_key: jax.Array, max_point=None,
                      budget: float = DISPATCH_UNIT_BUDGET):
    """`render_frame` with automatic dispatch chunking.  Returns the same
    dict; small frames take the single fused dispatch, large frames run
    per-sample (and per-pixel-chunk) dispatches with one final fetch."""
    config = config.rounded()
    cost = _dispatch_cost(config)
    if cost <= budget:
        return render_frame(scene, camera, config, base_key, max_point)

    w, h = config.width, config.height
    b = w * h
    u, v, pids, inv = _pixel_order(config)
    int_parity = config.accumulation == "int_parity"

    per_sample = cost / config.spp
    n_chunks = max(1, int(-(-per_sample // budget)))
    # Chunk = contiguous patch-major lane range, a multiple of the 128-ray
    # traversal tile (chunk boundaries never split a tile, so traversal
    # coherence and the nee_share grouping are preserved) that divides the
    # pixel count exactly — overlapping a lane would re-apply its running
    # mean update (not idempotent) and double-count its rays.
    unit = C.SUBTILE * max(1, 128 // C.SUBTILE)
    n_units = b // unit
    per = max(1, n_units // n_chunks)
    while n_units % per:
        per -= 1
    chunk = per * unit
    n_chunks = n_units // per

    @partial(jax.jit, static_argnames=())
    def step(scene, camera, key, acc, rays, s, start):
        uc = jax.lax.dynamic_slice(u, (start,), (chunk,))
        vc = jax.lax.dynamic_slice(v, (start,), (chunk,))
        pc = jax.lax.dynamic_slice(pids, (start,), (chunk,))
        rgb, r = sample_pixels(scene, camera, config, key, s, uc, vc, pc,
                               max_point=max_point)
        if int_parity:
            accc = jax.lax.dynamic_slice(acc, (start,), (chunk,))
            accc = film.incremental_avg_int(accc, rgb, s + 1)
            acc = jax.lax.dynamic_update_slice(acc, accc, (start,))
        else:
            accc = jax.lax.dynamic_slice(acc, (start, 0), (chunk, 3))
            accc = film.incremental_avg_float(accc, rgb, s + 1)
            acc = jax.lax.dynamic_update_slice(acc, accc, (start, 0))
        return acc, rays + r

    if int_parity:
        acc = jnp.zeros((b,), jnp.int32)
    else:
        acc = jnp.zeros((b, 3), jnp.float32)
    rays = jnp.zeros((), jnp.int32)
    for s in range(config.spp):
        for ci in range(n_chunks):
            acc, rays = step(scene, camera, base_key, acc, rays,
                             jnp.asarray(s), jnp.asarray(ci * chunk))

    if int_parity:
        bitmap = acc[inv]
        image = film.unpack_abgr(bitmap)
    else:
        image = acc[inv]
        bitmap = film.quantize_abgr(image)
    return {"image": image.reshape(h, w, 3),
            "bitmap": bitmap.reshape(h, w),
            "rays": rays}


class Renderer:
    """Stateful progressive renderer — the L4/engine-driver analogue
    (reference C_wrapper.cpp RayTrace / JNI lifecycle): renders sample by
    sample, exposes the current sample index and running bitmap, supports
    cooperative stop (stop = don't schedule the next sample)."""

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig,
                 max_point=None):
        self.scene = build_accelerator(scene, config)
        self.camera = camera
        self.config = config.rounded()
        self.max_point = (jnp.asarray(max_point, jnp.float32)
                          if max_point is not None else None)
        self._stop = False
        self.sample = 0
        self.total_rays = 0
        self.state = STATE_IDLE
        self.fps = 0.0
        w, h = self.config.width, self.config.height
        self._accum = jnp.zeros((w * h, 3), jnp.float32)
        _, _, _, self._inv = _pixel_order(self.config)
        self._key = jax.random.PRNGKey(self.config.seed)
        self._step = jax.jit(
            lambda scene, camera, key, accum, s: self._step_impl(
                scene, camera, key, accum, s))

    def _step_impl(self, scene, camera, key, accum, s):
        rgb, rays = render_sample(scene, camera, self.config, key, s,
                                  self.max_point)
        accum = film.incremental_avg_float(accum, rgb, s + 1)
        return accum, rays

    def stop_render(self):
        """Graceful cancel (reference Renderer.cpp:93-99): the running
        render loop (sync or async) stops scheduling further samples.
        Safe to call from any thread while `render_async` is in flight —
        the reference's `rtStopRender(wait)` contract
        (JNI_layer.cpp:429-462)."""
        self._stop = True

    def reset(self):
        self._stop = False
        self.sample = 0
        self.total_rays = 0
        self.state = STATE_IDLE
        w, h = self.config.width, self.config.height
        self._accum = jnp.zeros((w * h, 3), jnp.float32)

    @property
    def image(self) -> np.ndarray:
        w, h = self.config.width, self.config.height
        return np.asarray(self._accum[self._inv]).reshape(h, w, 3)

    @property
    def bitmap(self) -> np.ndarray:
        w, h = self.config.width, self.config.height
        return np.asarray(
            film.quantize_abgr(self._accum[self._inv])).reshape(h, w)

    def render(self, callback: Optional[Callable] = None) -> np.ndarray:
        """Runs up to config.spp samples; `callback(renderer)` fires after
        each sample (the progressive-display hook, like the live-bitmap
        polling of the Android UI, RenderTask.kt:284-317)."""
        t0 = time.perf_counter()
        self.state = STATE_BUSY
        while self.sample < self.config.spp and not self._stop:
            ts = time.perf_counter()
            self._accum, rays = self._step(
                self.scene, self.camera, self._key, self._accum, self.sample)
            self._accum.block_until_ready()
            self.sample += 1
            self.total_rays += int(np.asarray(rays))
            self.fps = 1.0 / max(time.perf_counter() - ts, 1e-9)
            if callback is not None:
                callback(self)
        self.render_seconds = time.perf_counter() - t0
        self.state = STATE_STOPPED if self._stop else STATE_FINISHED
        return self.image

    def render_async(self, callback: Optional[Callable] = None):
        """Detached render thread — the reference's primary entry mode
        (`RayTrace(config, async=true)` detaches a worker thread,
        C_wrapper.cpp:283-290; `rtRenderIntoBitmap` detaches and the UI
        polls state/fps/sample while pixels accumulate,
        JNI_layer.cpp:744-901, RenderTask.kt:284-317).

        Returns immediately.  While rendering, `state` is BUSY and
        `sample` / `fps` / `bitmap` / `image` / `stats_line()` give live
        progressive values (each sample's accumulator swap is atomic under
        the GIL, so pollers always see a complete frame at some sample
        count — the reference's torn-but-benign live bitmap is actually
        *tear-free* here).  `stop_render()` cancels cooperatively;
        `wait()` joins and returns the final state."""
        import threading
        if self.state == STATE_BUSY:
            raise RuntimeError("render already in progress")
        # BUSY before returning so a poller never observes IDLE after
        # render_async() (the JNI layer sets state under the same mutex
        # before detaching, JNI_layer.cpp:783-801).
        self.state = STATE_BUSY
        self._thread = threading.Thread(
            target=self.render, args=(callback,), daemon=True)
        self._thread.start()
        return self._thread

    def wait(self, timeout: Optional[float] = None) -> str:
        """Joins an in-flight `render_async` (reference rtStopRender's
        condvar wait, JNI_layer.cpp:444-459).  Returns the final state."""
        t = getattr(self, "_thread", None)
        if t is not None:
            t.join(timeout)
        return self.state

    def preview(self) -> np.ndarray:
        """Fast single-sample DiffuseMaterial pass — the analogue of the
        Android GL-rasterized preview (MainRenderer.java renderSceneToBitmap)
        as a flat-color ray pass."""
        import dataclasses as _dc
        cfg = _dc.replace(self.config, shader=C.SHADER_DIFFUSE, spp=1)
        out = render_frame(self.scene, self.camera, cfg, self._key,
                           self.max_point)
        return np.asarray(out["image"])

    def stats_line(self) -> str:
        """Live stats string mirroring the Android UI's RenderTask line
        (RenderTask.kt:169-260)."""
        from .types import scene_num_primitives
        prims = scene_num_primitives(self.scene)
        n_prims = prims["triangles"] + prims["spheres"] + prims["planes"]
        return (f"fps:{self.fps:.1f} r:{self.config.width}x"
                f"{self.config.height} spp:{self.config.spp} "
                f"sample:{self.sample} state:{self.state} "
                f"p:{n_prims} l:{prims['lights']}")

    # -- checkpoint / resume (aux subsystem; the reference's open TODO) ---
    def save_checkpoint(self, path: str) -> None:
        from .utils.checkpoint import save_render_state
        save_render_state(path, self._accum, self.sample, self.total_rays,
                          self.config)

    def load_checkpoint(self, path: str) -> None:
        from .utils.checkpoint import load_render_state
        accum, sample, rays, config, _ = load_render_state(path)
        if config != self.config:
            raise ValueError("checkpoint config does not match renderer "
                             f"config: {config} vs {self.config}")
        self._accum = accum
        self.sample = sample
        self.total_rays = rays
        self._stop = False
        self.state = STATE_IDLE
