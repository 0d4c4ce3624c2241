"""Two-level tile-cooperative block traversal (the ACC_BVH path): parity
with the naive oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mobileraytracer_tpu import constants as C
from mobileraytracer_tpu import scenes
from mobileraytracer_tpu.builder import SceneBuilder
from mobileraytracer_tpu.ops import block_bvh, build_accelerator
from mobileraytracer_tpu.ops import grid as grid_ops
from mobileraytracer_tpu.ops import intersect as nv
from mobileraytracer_tpu.renderer import render_frame
from mobileraytracer_tpu.types import RenderConfig


def _no_prev(n):
    return jnp.zeros((n,), jnp.int32), jnp.full((n,), -1, jnp.int32)


def _random_rays(nr, lo, hi, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(nr, 3)).astype(np.float32)
    d = rng.normal(size=(nr, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_block_matches_naive_random_scene():
    rng = np.random.default_rng(0)
    b = SceneBuilder()
    m = b.add_material(kd=(0.8, 0.7, 0.6))
    centers = rng.uniform(-5, 5, size=(900, 3)).astype(np.float32)
    e1 = rng.normal(size=(900, 3)).astype(np.float32) * 0.4
    e2 = rng.normal(size=(900, 3)).astype(np.float32) * 0.4
    for i in range(900):
        b.add_triangle(centers[i], centers[i] + e1[i], centers[i] + e2[i], m)
    scene = block_bvh.build(b.build())
    o, d = _random_rays(512, -8, 8)
    hit_n = nv.intersect_scene_naive(scene, o, d, *_no_prev(512))
    hit_b = block_bvh.intersect_scene_blocks(scene, o, d, *_no_prev(512))
    np.testing.assert_allclose(np.asarray(hit_n.t), np.asarray(hit_b.t),
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(hit_n.prim_id),
                                  np.asarray(hit_b.prim_id))


def test_block_matches_naive_cornell_water():
    from mobileraytracer_tpu.loaders.obj import load_obj_scene_ex
    base = ("/root/reference/app/src/androidTest/resources/CornellBox/"
            "CornellBox-Water")
    scene, _ = load_obj_scene_ex(base + ".obj")
    scene = block_bvh.build(scene)
    o, d = _random_rays(512, -1.5, 1.5, seed=3)
    hit_n = nv.intersect_scene_naive(scene, o, d, *_no_prev(512))
    hit_b = block_bvh.intersect_scene_blocks(scene, o, d, *_no_prev(512))
    np.testing.assert_allclose(np.asarray(hit_n.t), np.asarray(hit_b.t),
                               rtol=1e-5)


def test_block_shadow_matches_naive():
    from mobileraytracer_tpu.loaders.obj import load_obj_scene_ex
    base = ("/root/reference/app/src/androidTest/resources/CornellBox/"
            "CornellBox-Water")
    scene, _ = load_obj_scene_ex(base + ".obj")
    scene = block_bvh.build(scene)
    o, d = _random_rays(512, -1.5, 1.5, seed=5)
    dist = jnp.full((512,), 2.0)
    bn = nv.occluded_naive(scene, o, d, dist, *_no_prev(512))
    bb_ = block_bvh.occluded_blocks(scene, o, d, dist, *_no_prev(512))
    np.testing.assert_array_equal(np.asarray(bn), np.asarray(bb_))


@pytest.mark.slow
def test_block_render_matches_naive_render():
    scene, cam = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    key = jax.random.PRNGKey(0)
    scene_b = block_bvh.build(scene)
    img_n = np.asarray(render_frame(
        scene_b, cam, RenderConfig(width=32, height=32, spp=1,
                                   shader=C.SHADER_WHITTED,
                                   accelerator=C.ACC_NAIVE), key)["image"])
    img_b = np.asarray(render_frame(
        scene_b, cam, RenderConfig(width=32, height=32, spp=1,
                                   shader=C.SHADER_WHITTED,
                                   accelerator=C.ACC_BVH), key)["image"])
    np.testing.assert_allclose(img_n, img_b, atol=1e-6)


def test_block_nondivisible_batch():
    """Ray batches not divisible by the tile size are padded internally."""
    scene, _ = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    scene = block_bvh.build(scene)
    o, d = _random_rays(37, -1, 1, seed=7)
    hit = block_bvh.intersect_scene_blocks(scene, o, d, *_no_prev(37))
    assert hit.t.shape == (37,)
    assert np.isfinite(np.asarray(hit.t)).all()


def _soup_scene(n, seed=0):
    """n random triangles in [-1, 1]^3 with edges up to 0.3."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    m = b.add_material(kd=(0.5, 0.5, 0.5))
    pa = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    for i in range(n):
        b.add_triangle(pa[i], pa[i] + e1[i], pa[i] + e2[i], m)
    return b.build()


@pytest.mark.parametrize("block_size", [16, 32, 64])
@pytest.mark.parametrize("n", [40, 700])
def test_closest_matches_naive(n, block_size):
    """At these sizes the default budgets hold every candidate super and
    block, so the traversal must equal the oracle hit for hit."""
    tris, grid = jax.device_put(block_bvh.build_blocks(
        _soup_scene(n).triangles, block_size=block_size))
    assert grid.top_s == grid.num_supers
    assert grid.top_m == grid.block_first.size
    b = 256
    o, d = _random_rays(b, -2, 2)
    pk, pi = _no_prev(b)
    t, i = block_bvh.traverse_closest(grid, tris, o, d, C.RAY_LENGTH_MAX,
                                      pk, pi)
    t_n, i_n = nv.closest_triangles(
        tris, o, d, jnp.full((b,), C.RAY_LENGTH_MAX), pk, pi)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_n))
    hit = np.asarray(i_n) >= 0
    assert hit.any()
    np.testing.assert_allclose(np.asarray(t)[hit], np.asarray(t_n)[hit],
                               rtol=1e-5)


@pytest.mark.parametrize("n", [40, 700])
def test_any_hit_matches_occluded_naive(n):
    scene = block_bvh.build(_soup_scene(n, seed=2))
    b = 256
    o, d = _random_rays(b, -2, 2, seed=4)
    dist = jnp.full((b,), 1.5)
    occ_b = block_bvh.occluded_blocks(scene, o, d, dist, *_no_prev(b))
    occ_n = nv.occluded_naive(scene, o, d, dist, *_no_prev(b))
    np.testing.assert_array_equal(np.asarray(occ_b), np.asarray(occ_n))
    assert 0 < int(np.sum(np.asarray(occ_n))) < b


@pytest.mark.parametrize("acc,kind", [
    (C.ACC_NAIVE, type(None)),
    (C.ACC_REGULAR_GRID, grid_ops.RegularGrid),
    (C.ACC_BVH, block_bvh.BlockGrid),
])
def test_build_accelerator_choice(acc, kind):
    """One builder serves every entry point: the structure it attaches
    follows the config, and a scene that has it already is kept."""
    scene, _ = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    cfg = RenderConfig(accelerator=acc)
    built = build_accelerator(scene, cfg)
    assert isinstance(built.bvh, kind)
    assert build_accelerator(built, cfg) is built


def test_block_empty_triangles():
    """A scene without triangles (spheres2) builds and traces."""
    scene, _ = scenes.load_builtin(C.SCENE_SPHERES2, 1.0)
    assert not np.asarray(scene.triangles.valid).any()
    scene = block_bvh.build(scene)
    o, d = _random_rays(32, -1, 1, seed=11)
    hit_b = block_bvh.intersect_scene_blocks(scene, o, d, *_no_prev(32))
    hit_n = nv.intersect_scene_naive(scene, o, d, *_no_prev(32))
    np.testing.assert_array_equal(np.asarray(hit_b.prim_kind),
                                  np.asarray(hit_n.prim_kind))
    np.testing.assert_allclose(np.asarray(hit_b.t), np.asarray(hit_n.t),
                               rtol=1e-6)
