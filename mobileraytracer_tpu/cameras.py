"""Vectorized primary-ray generation for perspective and orthographic
cameras, numerically matching the reference components.

Pixel-to-uv convention (reference app/MobileRT/Renderer.cpp:107-141):
u = x / width, v = y / height (pixel *corner*, not center), and the jitter
deviation is (r - 0.5) * 2 * (0.5 / width) added to the *angle factor*
(perspective, reference app/Components/Cameras/Perspective.cpp:16-28) or to
the plane offset (orthographic, Orthographic.cpp:16-24).
"""
from __future__ import annotations

import jax.numpy as jnp

from .types import CAMERA_ORTHOGRAPHIC, CAMERA_PERSPECTIVE, Camera

QUARTER_PI = 0.7853981633974483


def fast_arctan(x: jnp.ndarray) -> jnp.ndarray:
    """Polynomial arctan approximation (max error ~0.0015 rad) replicated
    exactly from the reference for pixel parity (reference
    app/Components/Cameras/Perspective.cpp:40-46)."""
    ax = jnp.abs(x)
    return QUARTER_PI * x - (x * (ax - 1.0)) * (0.2447 + 0.0663 * ax)


def generate_rays(camera: Camera, u: jnp.ndarray, v: jnp.ndarray,
                  dev_u: jnp.ndarray, dev_v: jnp.ndarray):
    """Returns (origins, directions) batches for uv batches in [0,1).

    Both camera models are evaluated and selected with `where` — the camera
    kind is a traced scalar, which keeps one compiled renderer for any
    camera (a branchless select instead of one compile per camera kind).
    """
    u = jnp.asarray(u, jnp.float32)
    v = jnp.asarray(v, jnp.float32)

    # Perspective (reference Perspective.cpp:16-28).
    right_factor_p = fast_arctan(camera.param_u * (u - 0.5)) + dev_u
    up_factor_p = fast_arctan(camera.param_v * (0.5 - v)) + dev_v
    dest = (camera.position + camera.direction
            + camera.right * right_factor_p[..., None]
            + camera.up * up_factor_p[..., None])
    dir_p = dest - camera.position
    dir_p = dir_p / jnp.linalg.norm(dir_p, axis=-1, keepdims=True)
    org_p = jnp.broadcast_to(camera.position, dir_p.shape)

    # Orthographic (reference Orthographic.cpp:16-24): param_u/v hold the
    # half extents; deviation is applied un-scaled along right/up.
    right_factor_o = (u - 0.5) * camera.param_u
    up_factor_o = (0.5 - v) * camera.param_v
    org_o = (camera.position
             + camera.right * (right_factor_o + dev_u)[..., None]
             + camera.up * (up_factor_o + dev_v)[..., None])
    dir_o = jnp.broadcast_to(camera.direction, org_o.shape)

    is_persp = camera.kind == CAMERA_PERSPECTIVE
    origins = jnp.where(is_persp, org_p, org_o)
    directions = jnp.where(is_persp, dir_p, dir_o)
    return origins, directions


__all__ = ["fast_arctan", "generate_rays", "CAMERA_PERSPECTIVE",
           "CAMERA_ORTHOGRAPHIC"]
