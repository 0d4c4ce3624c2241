"""BVH tests: hit-for-hit parity with the naive oracle (the reference's
correctness strategy inverted — its Naive accelerator is the baseline the
BVH must reproduce, AcceleratorTestEngine.cpp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mobileraytracer_tpu import constants as C
from mobileraytracer_tpu import scenes
from mobileraytracer_tpu.builder import SceneBuilder
from mobileraytracer_tpu.ops import build_accelerator
from mobileraytracer_tpu.ops import bvh as bvh_ops
from mobileraytracer_tpu.ops import intersect as nv
from mobileraytracer_tpu.renderer import render_frame
from mobileraytracer_tpu.types import RenderConfig


def _random_tri_scene(n, seed=0, emissive=False):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    m = b.add_material(kd=(0.8, 0.7, 0.6))
    centers = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    e1 = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    e2 = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    for i in range(n):
        b.add_triangle(centers[i], centers[i] + e1[i], centers[i] + e2[i], m)
    if emissive:
        b.add_point_light((0, 8, 0), (0.9, 0.9, 0.9))
    return b.build()


def _random_rays(nr, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, size=(nr, 3)).astype(np.float32)
    d = rng.normal(size=(nr, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _no_prev(n):
    return jnp.zeros((n,), jnp.int32), jnp.full((n,), -1, jnp.int32)


@pytest.mark.parametrize("n_tris", [3, 37, 300])
def test_bvh_matches_naive_closest(n_tris):
    scene = _random_tri_scene(n_tris)
    scene_b = bvh_ops.build(scene)
    o, d = _random_rays(256)
    hit_n = nv.intersect_scene_naive(scene_b, o, d, *_no_prev(256))
    hit_b = bvh_ops.intersect_scene_bvh(scene_b, o, d, *_no_prev(256))
    np.testing.assert_allclose(np.asarray(hit_n.t), np.asarray(hit_b.t),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(hit_n.prim_kind),
                                  np.asarray(hit_b.prim_kind))
    # Same triangle, same reordered array => identical ids.
    np.testing.assert_array_equal(np.asarray(hit_n.prim_id),
                                  np.asarray(hit_b.prim_id))


def test_bvh_matches_naive_shadow():
    scene = bvh_ops.build(_random_tri_scene(120, seed=3))
    o, d = _random_rays(256, seed=4)
    dist = jnp.full((256,), 6.0)
    blocked_n = nv.occluded_naive(scene, o, d, dist, *_no_prev(256))
    blocked_b = bvh_ops.occluded_bvh(scene, o, d, dist, *_no_prev(256))
    np.testing.assert_array_equal(np.asarray(blocked_n), np.asarray(blocked_b))


def test_bvh_respects_self_intersection_guard():
    scene = bvh_ops.build(_random_tri_scene(50, seed=5))
    # Shoot from the surface of triangle 0 (reordered) along its plane.
    pa = scene.triangles.point_a[0]
    o = pa[None, :]
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    prev_kind = jnp.asarray([C.PRIM_TRIANGLE], jnp.int32)
    prev_id = jnp.asarray([0], jnp.int32)
    hit = bvh_ops.intersect_scene_bvh(scene, o, d, prev_kind, prev_id)
    assert int(hit.prim_id[0]) != 0 or hit.prim_kind[0] != C.PRIM_TRIANGLE


@pytest.mark.slow
def test_bvh_render_matches_naive_render():
    """Engine-level: same image through both accelerators (the reference's
    AcceleratorTestEngine parity, strengthened to exact-image equality)."""
    scene, cam = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    key = jax.random.PRNGKey(0)
    cfg_n = RenderConfig(width=32, height=32, spp=1, shader=C.SHADER_WHITTED,
                         accelerator=C.ACC_NAIVE)
    cfg_b = RenderConfig(width=32, height=32, spp=1, shader=C.SHADER_WHITTED,
                         accelerator=C.ACC_BVH)
    scene_b = build_accelerator(scene, cfg_b)
    img_n = np.asarray(render_frame(scene_b, cam, cfg_n, key)["image"])
    img_b = np.asarray(render_frame(scene_b, cam, cfg_b, key)["image"])
    np.testing.assert_allclose(img_n, img_b, atol=1e-6)


def test_bvh_empty_triangles():
    b = SceneBuilder()
    m = b.add_material(kd=(0.5, 0.5, 0.5))
    b.add_sphere((0, 0, 3), 1.0, m)
    scene = bvh_ops.build(b.build())
    o, d = _random_rays(16)
    hit = bvh_ops.intersect_scene_bvh(scene, o, d, *_no_prev(16))
    assert np.isfinite(np.asarray(hit.t)).all()


def test_bvh_obj_scene():
    from mobileraytracer_tpu.loaders.obj import load_obj_scene_ex
    base = ("/root/reference/app/src/androidTest/resources/CornellBox/"
            "CornellBox-Water")
    scene, info = load_obj_scene_ex(base + ".obj")
    scene = bvh_ops.build(scene)
    o, d = _random_rays(128, seed=9)
    hit_n = nv.intersect_scene_naive(scene, o, d, *_no_prev(128))
    hit_b = bvh_ops.intersect_scene_bvh(scene, o, d, *_no_prev(128))
    np.testing.assert_allclose(np.asarray(hit_n.t), np.asarray(hit_b.t),
                               rtol=1e-5)
