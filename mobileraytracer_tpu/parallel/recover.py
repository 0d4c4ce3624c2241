"""Material recovery by differentiable rendering (BASELINE.md config #4).

Optimizes a scene's material table so its render matches target images —
the inverse-rendering workload the reference cannot express at all (its
engine is forward-only C++).  The loop is a single jitted update over the
device mesh: forward render, reverse-mode backward, gradient psum across
devices and hosts (on a 2-D mesh), optax update — compiled once,
stepped many times.  Optimizer state checkpoints/resumes through
utils.checkpoint so long recoveries survive preemption.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..types import Camera, RenderConfig, Scene
from . import mesh as pmesh


def make_recovery_step(scene: Scene, camera: Camera, config: RenderConfig,
                       mesh, params_subset: Iterable[str] = ("kd", "le"),
                       learning_rate: float = 0.05, max_point=None):
    """Returns (step_fn, init_state): `step_fn(state, key) -> (state,
    loss)` jitted once; state = (params, opt_state).  Only the keys in
    `params_subset` are optimized; the rest of the material table stays
    frozen at the scene's values."""
    scene = jax.device_put(scene)
    full = pmesh.material_params(scene.materials)
    params0 = {k: full[k] for k in params_subset}
    opt = optax.adam(learning_rate)

    w, h = config.width, config.height
    # Patch-major lane order (parallel/mesh.py): shards stay coherent
    # 128-ray tiles; targets permute into the same order below.
    u, v, pids, _ = pmesh._lane_order(config)
    if max_point is None:
        max_point = jnp.ones((3,), jnp.float32)
    denom = float(w * h * 3)
    axes = pmesh._all_axes(mesh)
    sh = pmesh._shard_spec(mesh)
    rep = P()

    def shard_fn(params, key, target, u, v, pids):
        merged = dict(full, **params)
        loss, grads = jax.value_and_grad(pmesh.render_loss_fn)(
            merged, scene, camera, config, key, target, u, v, pids,
            max_point)
        grads = {k: jax.lax.psum(grads[k], axes) / denom
                 for k in params}
        loss = jax.lax.psum(loss, axes) / denom
        return loss, grads

    sharded_grad = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(rep, rep, sh, sh, sh, sh),
        out_specs=(rep, rep), check_vma=False)

    @jax.jit
    def step_fn(state, key, target):
        params, opt_state = state
        loss, grads = sharded_grad(params, key,
                                   target.reshape(w * h, 3)[pids],
                                   u, v, pids)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        # Physical clamp: reflectances stay in [0, 1], emission >= 0.
        params = {k: jnp.clip(p, 0.0, None if k == "le" else 1.0)
                  for k, p in params.items()}
        return (params, opt_state), loss

    return step_fn, (params0, opt.init(params0))


def recover_materials(scene: Scene, camera: Camera, config: RenderConfig,
                      target_image: jnp.ndarray, mesh,
                      steps: int = 200,
                      params_subset: Iterable[str] = ("kd",),
                      learning_rate: float = 0.05,
                      base_key: Optional[jax.Array] = None,
                      init_params: Optional[dict] = None,
                      checkpoint_path: Optional[str] = None,
                      checkpoint_every: int = 50,
                      resume: bool = False,
                      max_point=None) -> Tuple[dict, np.ndarray]:
    """Runs the recovery loop; returns (recovered params, per-step losses).

    With `checkpoint_path`, optimizer state + params persist every
    `checkpoint_every` steps and `resume=True` continues an interrupted
    run (per-(pixel, sample, step) RNG keys make the continuation match an
    uninterrupted run exactly).
    """
    from ..utils import checkpoint as ckpt

    step_fn, state = make_recovery_step(
        scene, camera, config, mesh, params_subset=params_subset,
        learning_rate=learning_rate, max_point=max_point)
    if init_params is not None:
        state = (jax.tree.map(jnp.asarray, dict(init_params)), state[1])
    key = base_key if base_key is not None else jax.random.PRNGKey(
        config.seed)
    start = 0
    losses = []
    if resume and checkpoint_path:
        loaded = ckpt.load_opt_state(checkpoint_path, state)
        if loaded is not None:
            state, start, losses = loaded
            losses = list(losses)

    target = jnp.asarray(target_image, jnp.float32)
    for s in range(start, steps):
        state, loss = step_fn(state, jax.random.fold_in(key, s), target)
        losses.append(float(loss))
        if checkpoint_path and (s + 1) % checkpoint_every == 0:
            ckpt.save_opt_state(checkpoint_path, state, s + 1, losses)
    return state[0], np.asarray(losses)
