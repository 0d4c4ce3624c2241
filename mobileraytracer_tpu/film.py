"""Progressive film accumulation and ABGR8 quantization.

The reference accumulates directly in an int32 ABGR bitmap using an
integer-packed incremental mean (reference app/MobileRT/Utils/Utils.cpp:
66-90).  Here a float32 accumulator is kept (better precision, free
fusion into the shading kernel) and quantize once for display; an exact
integer-parity mode reproduces the reference's per-sample rounding for
golden-image comparison tests.
"""
from __future__ import annotations

import jax.numpy as jnp


def quantize_abgr(rgb: jnp.ndarray) -> jnp.ndarray:
    """Float RGB in [0,1] -> packed int32 0xFF_BB_GG_RR, truncating like the
    reference's `static_cast<uint32>(sample * 255)` (Utils.cpp:75-77)."""
    q = jnp.clip((rgb * 255.0).astype(jnp.uint32), 0, 255)
    packed = (jnp.uint32(0xFF000000)
              | (q[..., 2] << 16) | (q[..., 1] << 8) | q[..., 0])
    return packed.astype(jnp.int32)


def unpack_abgr(bitmap: jnp.ndarray) -> jnp.ndarray:
    """Packed int32 ABGR -> float RGB in [0,1]."""
    b = bitmap.astype(jnp.uint32)
    r = (b & 0xFF).astype(jnp.float32)
    g = ((b >> 8) & 0xFF).astype(jnp.float32)
    bl = ((b >> 16) & 0xFF).astype(jnp.float32)
    return jnp.stack([r, g, bl], -1) / 255.0


def incremental_avg_float(accum: jnp.ndarray, sample_rgb: jnp.ndarray,
                          num_sample: jnp.ndarray) -> jnp.ndarray:
    """Float running mean: mean_k = mean_{k-1} + (x - mean_{k-1}) / k."""
    k = jnp.asarray(num_sample, jnp.float32)
    return accum + (sample_rgb - accum) / k


def incremental_avg_int(bitmap: jnp.ndarray, sample_rgb: jnp.ndarray,
                        num_sample: jnp.ndarray) -> jnp.ndarray:
    """Bit-exact replica of the reference's integer-packed progressive mean
    (reference Utils.cpp:66-90): each channel updates as
    ((n-1) * last + trunc(sample*255)) / n in uint arithmetic, clamped to
    255, packed as 0xFF | B<<16 | G<<8 | R."""
    avg = bitmap.astype(jnp.uint32)
    n = jnp.asarray(num_sample, jnp.uint32)
    last = jnp.stack([avg & 0xFF, (avg >> 8) & 0xFF, (avg >> 16) & 0xFF], -1)
    samp = (sample_rgb * 255.0).astype(jnp.uint32)
    cur = ((n - 1) * last + samp) // n
    cur = jnp.minimum(cur, 255)
    packed = (jnp.uint32(0xFF000000)
              | (cur[..., 2] << 16) | (cur[..., 1] << 8) | cur[..., 0])
    return packed.astype(jnp.int32)


def is_uniform(bitmap: jnp.ndarray) -> jnp.ndarray:
    """The reference's engine-test oracle: "bitmap is not uniform after a
    render" (reference app/Unit_Testing/engine/ShaderTestEngine.cpp:46-48)."""
    flat = bitmap.reshape(-1)
    return jnp.all(flat == flat[0])
