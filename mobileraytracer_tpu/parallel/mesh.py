"""Multi-chip execution: ray/tile data parallelism over a device mesh.

The reference's only parallelism is a shared-memory thread pool pulling
image tiles off an atomic work queue (reference app/MobileRT/Renderer.cpp:
62-84, 189-197, SURVEY.md §2.6).  This design replaces the
dynamic queue with a *static* sharded partition of the pixel/ray space:

  - mesh axes ("hosts", "rays"): rays/tiles sharded over all chips,
    the scene/BVH replicated per host (BASELINE north star);
  - per-step image accumulation needs no collective (pixels are disjoint);
  - parameter gradients are `psum`-reduced across devices inside the same
    shard_map that runs the backward pass, letting XLA overlap the
    all-reduce with remaining backward compute;
  - determinism: the per-(pixel, sample) counter-based RNG makes 1-chip and
    N-chip renders bitwise identical regardless of sharding.

A CPU mesh (xla_force_host_platform_device_count) stands in for real chips
in tests — fake the mesh, not the math (SURVEY.md §4).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .. import film, sampling
from ..renderer import sample_pixels
from ..types import Camera, Materials, RenderConfig, Scene

RAY_AXIS = "rays"
HOST_AXIS = "hosts"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over all (or the first n) local devices.  Multi-host
    extension: pass the global device list; the ray axis then spans hosts
    while the scene stays replicated per host."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (RAY_AXIS,))


def distributed_init(coordinator_address: str, num_processes: int,
                     process_id: int, **kwargs) -> None:
    """Multi-host entry (SURVEY.md §2.6): joins this
    process to the jax.distributed runtime so `jax.devices()` returns the
    GLOBAL device list and collectives run across hosts.  Call before
    any other JAX API; then build the (hosts x chips) mesh with
    `make_mesh_2d`."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kwargs)


def make_mesh_2d(n_hosts: Optional[int] = None, devices=None) -> Mesh:
    """2-D (hosts x chips) mesh: the leading axis maps one row per host
    (the network boundary), the trailing axis the devices within a host.
    Pixel rows shard over BOTH axes; gradient psums reduce over both, so
    XLA emits the hierarchical within-host-then-across-hosts all-reduce."""
    if devices is None:
        devices = jax.devices()
    if n_hosts is None:
        n_hosts = max(jax.process_count(), 1)
    per_host = len(devices) // n_hosts
    arr = np.asarray(devices[:n_hosts * per_host]).reshape(n_hosts, per_host)
    return Mesh(arr, (HOST_AXIS, RAY_AXIS))


def _shard_spec(mesh: Mesh) -> P:
    """Pixel rows sharded over every mesh axis (1-D or 2-D meshes)."""
    return P(tuple(mesh.axis_names))


def _all_axes(mesh: Mesh):
    return tuple(mesh.axis_names)


def _lane_order(config: RenderConfig):
    """The renderer's patch-major pixel order (renderer._pixel_order):
    each shard receives a CONTIGUOUS range of 4x4-patch-major lanes, so
    the tile-cooperative traversal sees the same spatially coherent ray
    tiles sharded as it does unsharded (sharding row-major pixels
    destroys the patch interval bounds its candidate selection depends
    on)."""
    from ..renderer import _pixel_order
    return _pixel_order(config)


def render_frame_sharded(scene: Scene, camera: Camera, config: RenderConfig,
                         base_key: jax.Array, mesh: Mesh, max_point=None):
    """Full frame with pixels sharded across `mesh`; scene replicated.

    Returns the same dict as renderer.render_frame, bit-identical to the
    unsharded render (counter-based RNG keys by pixel id; lanes shard in
    the same patch-major order the unsharded renderer traces).  Pixel
    count must be a multiple of the mesh size (the tile contract
    guarantees W*H % 256 == 0, covering every power-of-two mesh up to
    256).
    """
    w, h = config.width, config.height
    n = mesh.devices.size
    assert (w * h) % n == 0, f"{w*h} pixels not divisible by {n} devices"
    u, v, pids, inv = _lane_order(config)
    if max_point is None:
        max_point = jnp.ones((3,), jnp.float32)
    acc, rays = _sharded_render(config, mesh)(scene, camera, base_key, u, v,
                                              pids, max_point)
    if config.accumulation == "int_parity":
        bitmap = acc[inv]
        image = film.unpack_abgr(bitmap)
    else:
        image = acc[inv]
        bitmap = film.quantize_abgr(image)
    return {
        "image": image.reshape(h, w, 3),
        "bitmap": bitmap.reshape(h, w),
        "rays": rays,
    }


@lru_cache(maxsize=None)
def _sharded_render(config: RenderConfig, mesh: Mesh):
    """The jitted per-shard frame for one (config, mesh): built once, so
    repeated frames reuse the compiled program instead of re-tracing."""
    replicated = P()
    sharded = _shard_spec(mesh)
    axes = _all_axes(mesh)
    int_parity = config.accumulation == "int_parity"

    def shard_fn(scene, camera, key, u, v, pids, max_point):
        if int_parity:
            def body(carry, s):
                bitmap, rays = carry
                rgb, r = sample_pixels(scene, camera, config, key, s, u, v,
                                       pids, max_point=max_point)
                return (film.incremental_avg_int(bitmap, rgb, s + 1),
                        rays + r), None
            init = (jnp.zeros((u.shape[0],), jnp.int32),
                    jnp.zeros((), jnp.int32))
        else:
            def body(carry, s):
                accum, rays = carry
                rgb, r = sample_pixels(scene, camera, config, key, s, u, v,
                                       pids, max_point=max_point)
                return (film.incremental_avg_float(accum, rgb, s + 1),
                        rays + r), None
            init = (jnp.zeros((u.shape[0], 3), jnp.float32),
                    jnp.zeros((), jnp.int32))
        (acc, rays), _ = jax.lax.scan(body, init, jnp.arange(config.spp))
        # Ray counts are per-shard; reduce so every shard returns the total.
        rays = jax.lax.psum(rays, axes)
        return acc, rays

    return jax.jit(shard_map(
        shard_fn, mesh=mesh,
        in_specs=(replicated, replicated, replicated, sharded, sharded,
                  sharded, replicated),
        out_specs=(sharded, replicated),
        check_vma=False))


# ---------------------------------------------------------------------------
# Differentiable rendering + gradient all-reduce: the "training step".
# ---------------------------------------------------------------------------

def material_params(mat: Materials) -> dict:
    """The differentiable (float) subset of the material table."""
    return {"le": mat.le, "kd": mat.kd, "ks": mat.ks, "kt": mat.kt,
            "ior": mat.ior}


def _scene_with_params(scene: Scene, params: dict) -> Scene:
    mat = scene.materials.replace(**params)
    return scene.replace(materials=mat)


def render_loss_fn(params: dict, scene: Scene, camera: Camera,
                   config: RenderConfig, key, target, u, v, pids, max_point):
    """Per-shard L2 loss between the rendered sample mean and `target`
    (sharded rows).  Differentiable w.r.t. the material parameters."""
    scene = _scene_with_params(scene, params)

    def body(carry, s):
        accum = carry
        rgb, _ = sample_pixels(scene, camera, config, key, s, u, v, pids,
                               max_point=max_point, differentiable=True)
        return film.incremental_avg_float(accum, rgb, s + 1), None

    accum, _ = jax.lax.scan(
        body, jnp.zeros((u.shape[0], 3), jnp.float32), jnp.arange(config.spp))
    # Sum (not mean) per shard; the psum over shards then divides by the
    # global pixel count so the loss equals the unsharded mean.
    return jnp.sum((accum - target) ** 2)


def train_step_sharded(scene: Scene, camera: Camera, config: RenderConfig,
                       base_key: jax.Array, target_image: jnp.ndarray,
                       mesh: Mesh, max_point=None):
    """One differentiable-rendering optimization step over the mesh:
    forward render, backward pass, gradient psum across devices
    (overlapped by XLA with backward compute).  Returns (loss,
    grads-on-Materials)."""
    w, h = config.width, config.height
    n = mesh.devices.size
    assert (w * h) % n == 0
    u, v, pids, _ = _lane_order(config)
    # Targets permute into the same patch-major lane order as the render
    # (the summed loss is permutation-invariant, so loss/grads match the
    # row-major formulation bitwise up to reduction order).
    target = target_image.reshape(w * h, 3)[pids]
    if max_point is None:
        max_point = jnp.ones((3,), jnp.float32)

    return _sharded_train_step(config, mesh)(
        material_params(scene.materials), scene, camera, base_key, target,
        u, v, pids, max_point)


@lru_cache(maxsize=None)
def _sharded_train_step(config: RenderConfig, mesh: Mesh):
    """The jitted loss-and-gradient step for one (config, mesh)."""
    denom = float(config.width * config.height * 3)
    axes = _all_axes(mesh)

    def shard_fn(params, scene, camera, key, target, u, v, pids, max_point):
        loss, grads = jax.value_and_grad(render_loss_fn)(
            params, scene, camera, config, key, target, u, v, pids, max_point)
        # Gradient all-reduce over the ray axis — the distributed-training
        # analogue the reference lacks entirely (SURVEY.md §2.6).
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, axes) / denom, grads)
        loss = jax.lax.psum(loss, axes) / denom
        return loss, grads

    rep = P()
    sh = _shard_spec(mesh)
    return jax.jit(shard_map(
        shard_fn, mesh=mesh,
        in_specs=(rep, rep, rep, rep, sh, sh, sh, sh, rep),
        out_specs=(rep, rep),
        check_vma=False))
