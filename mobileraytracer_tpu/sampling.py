"""Deterministic, counter-based random sampling.

The reference engine draws randomness from global 2^20-entry precomputed
arrays advanced by relaxed atomic cursors (reference app/MobileRT/
Sampler.hpp:58-63, Shader.cpp:188-233) — a lock-free shared-memory design
that has no useful analogue on an accelerator.  We replace the *plumbing* with JAX's
counter-based `threefry` keys folded over (pixel, sample, bounce, purpose)
so every draw is reproducible by construction and identical regardless of
device count or sharding.  The *distributions* (uniform pixel jitter,
cosine-weighted hemisphere, uniform triangle points, uniform light pick)
match the reference's math exactly.

The Halton low-discrepancy sequence is kept for parity experiments
(reference app/MobileRT/Utils/Utils.cpp:43-53).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

TWO_PI = 6.283185307179586

# Purpose tags keep independent streams decorrelated.
PURPOSE_PIXEL_JITTER = 0
PURPOSE_LIGHT_PICK = 1
PURPOSE_LIGHT_POINT = 2
PURPOSE_HEMISPHERE = 3
PURPOSE_RUSSIAN_ROULETTE = 4
PURPOSE_LOBE_PICK = 5


def ray_key(base_key: jax.Array, pixel_id: jnp.ndarray, sample_id) -> jax.Array:
    """Key for one (pixel, spp-sample) pair; `pixel_id` may be a batch."""
    k = jax.random.fold_in(base_key, sample_id)
    return jax.vmap(jax.random.fold_in, in_axes=(None, 0))(k, pixel_id)


def event_key(keys: jax.Array, bounce, purpose: int) -> jax.Array:
    """Derives the key for a particular event at a given bounce.

    `keys` is a batch of per-ray keys; `bounce` may be scalar or batched.
    """
    fold = jax.vmap(jax.random.fold_in, in_axes=(0, None if jnp.ndim(bounce) == 0 else 0))
    k = fold(keys, bounce)
    return jax.vmap(jax.random.fold_in, in_axes=(0, None))(k, purpose)


def uniform(key: jax.Array, shape=()) -> jnp.ndarray:
    return jax.random.uniform(key, shape, jnp.float32)


def halton(index: jnp.ndarray, base: int = 2) -> jnp.ndarray:
    """Vectorized Halton sequence, matching reference Utils.cpp:43-53."""
    index = jnp.asarray(index, jnp.uint32)
    # 32 divisions always suffice for uint32 indices in base >= 2.
    def body(_, carry):
        idx, fraction, value = carry
        active = idx > 0
        fraction = jnp.where(active, fraction / base, fraction)
        value = jnp.where(active, value + fraction * (idx % base).astype(jnp.float32), value)
        idx = jnp.where(active, idx // base, idx)
        return idx, fraction, value
    _, _, value = jax.lax.fori_loop(
        0, 32, body,
        (index, jnp.ones_like(index, jnp.float32), jnp.zeros_like(index, jnp.float32)))
    return value


def cosine_sample_hemisphere(key: jax.Array, normal: jnp.ndarray) -> jnp.ndarray:
    """Cosine-weighted hemisphere direction around `normal`.

    The frame construction and the (phi, r2) mapping mirror the reference
    (reference app/MobileRT/Shader.cpp:188-216): pick helper axis (0,1,0) if
    |n.x| > 0.1 else (1,0,0); u = normalize(cross(helper, n)); v = cross(n, u);
    dir = u cos(phi) sqrt(r2) + v sin(phi) sqrt(r2) + n sqrt(1-r2).
    """
    if jnp.ndim(normal) > 1:
        r = jax.vmap(lambda k: jax.random.uniform(k, (2,), jnp.float32))(key)
    else:
        r = jax.random.uniform(key, (2,), jnp.float32)
    phi = TWO_PI * r[..., 0]
    r2 = r[..., 1]
    cos_theta = jnp.sqrt(r2)

    # Dead/missed lanes carry a zero normal; cross(helper, 0) = 0 and the
    # 0/norm(0) normalization poisons reverse-mode AD with NaN even though
    # the lanes are masked downstream (0 * NaN = NaN in the backward
    # pass).  Sanitize the normal first (where() cuts the grad path to the
    # untaken branch) and clamp the squared norms — bit-identical forward
    # for unit normals, finite gradients everywhere.
    nsq = jnp.sum(normal * normal, axis=-1, keepdims=True)
    normal = jnp.where(
        nsq > 0.25, normal,
        jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                         normal.shape))
    helper = jnp.where(
        (jnp.abs(normal[..., :1]) > 0.1),
        jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], jnp.float32), normal.shape),
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], jnp.float32), normal.shape))
    u = jnp.cross(helper, normal)
    u = u / jnp.sqrt(jnp.maximum(
        jnp.sum(u * u, axis=-1, keepdims=True), 1e-20))
    v = jnp.cross(normal, u)
    d = (u * (jnp.cos(phi) * cos_theta)[..., None]
         + v * (jnp.sin(phi) * cos_theta)[..., None]
         + normal * jnp.sqrt(jnp.maximum(1.0 - r2, 0.0))[..., None])
    return d / jnp.sqrt(jnp.maximum(
        jnp.sum(d * d, axis=-1, keepdims=True), 1e-20))


def pick_light(key: jax.Array, num_lights: jnp.ndarray) -> jnp.ndarray:
    """Uniform light index: floor(u * numLights * 0.99999)
    (reference app/MobileRT/Shader.cpp:223-233)."""
    u = jax.random.uniform(key, (), jnp.float32)
    idx = jnp.floor(u * num_lights.astype(jnp.float32) * 0.99999).astype(jnp.int32)
    return jnp.clip(idx, 0, jnp.maximum(num_lights - 1, 0))


def sample_triangle_point(key: jax.Array, tri_a, tri_ab, tri_ac) -> jnp.ndarray:
    """Uniform point on a triangle via the folded-parallelogram trick
    (reference app/Components/Lights/AreaLight.cpp:17-26)."""
    rs = jax.random.uniform(key, (2,), jnp.float32)
    r, s = rs[0], rs[1]
    flip = (r + s) >= 1.0
    r = jnp.where(flip, 1.0 - r, r)
    s = jnp.where(flip, 1.0 - s, s)
    return tri_a + r * tri_ab + s * tri_ac
