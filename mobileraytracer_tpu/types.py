"""Scene / camera / hit-record pytrees and the run configuration.

The reference engine stores scenes as arrays-of-structs C++ objects
(reference app/MobileRT/Scene.hpp:20-63, Shapes/*.hpp).  Here the same
information is kept as structure-of-arrays device arrays so every
intersection test is a dense vectorized op.  All geometry arrays are padded to a static
capacity with a validity mask so shapes stay static under jit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree.  Fields made with
    `static_field` are hashed into the tree structure (and so into jit
    cache keys); every other field is a leaf.  Adds `replace(**changes)`."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    meta = [f.name for f in fields if f.metadata.get("static", False)]
    data = [f.name for f in fields if not f.metadata.get("static", False)]
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls, data_fields=data,
                                            meta_fields=meta)


def static_field(**kwargs):
    """A `pytree_dataclass` field that is static metadata, not a leaf."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def _f32(x) -> jnp.ndarray:
    return jnp.asarray(x, jnp.float32)


def _i32(x) -> jnp.ndarray:
    return jnp.asarray(x, jnp.int32)


@pytree_dataclass
class Triangles:
    """SoA triangle batch (reference app/MobileRT/Shapes/Triangle.hpp:18-27:
    pointA, AB, AC, per-vertex normals, per-vertex UV, materialIndex)."""

    point_a: jnp.ndarray    # (N, 3) f32
    ab: jnp.ndarray         # (N, 3) f32  pointB - pointA
    ac: jnp.ndarray         # (N, 3) f32  pointC - pointA
    normal_a: jnp.ndarray   # (N, 3) f32 unit
    normal_b: jnp.ndarray   # (N, 3) f32 unit
    normal_c: jnp.ndarray   # (N, 3) f32 unit
    uv_a: jnp.ndarray       # (N, 2) f32, -1 when untextured
    uv_b: jnp.ndarray       # (N, 2) f32
    uv_c: jnp.ndarray       # (N, 2) f32
    mat_id: jnp.ndarray     # (N,) i32
    valid: jnp.ndarray      # (N,) bool

    @property
    def capacity(self) -> int:
        return self.point_a.shape[0]


@pytree_dataclass
class Spheres:
    """SoA sphere batch (reference app/MobileRT/Shapes/Sphere.hpp: center,
    squared radius, materialIndex)."""

    center: jnp.ndarray     # (N, 3) f32
    sq_radius: jnp.ndarray  # (N,) f32
    mat_id: jnp.ndarray     # (N,) i32
    valid: jnp.ndarray      # (N,) bool

    @property
    def capacity(self) -> int:
        return self.center.shape[0]


@pytree_dataclass
class Planes:
    """SoA plane batch (reference app/MobileRT/Shapes/Plane.hpp: point,
    unit normal, materialIndex).  Planes are unbounded two-sided surfaces."""

    point: jnp.ndarray   # (N, 3) f32
    normal: jnp.ndarray  # (N, 3) f32 unit
    mat_id: jnp.ndarray  # (N,) i32
    valid: jnp.ndarray   # (N,) bool

    @property
    def capacity(self) -> int:
        return self.point.shape[0]


@pytree_dataclass
class Materials:
    """Material table (reference app/MobileRT/Material.hpp:13-67).

    `le`/`kd`/`ks`/`kt` are exactly the differentiable shading parameters.
    `tex_id` is -1 for untextured materials, otherwise an index into the
    texture atlas.
    """

    le: jnp.ndarray      # (M, 3) f32 emission
    kd: jnp.ndarray      # (M, 3) f32 diffuse
    ks: jnp.ndarray      # (M, 3) f32 specular reflection
    kt: jnp.ndarray      # (M, 3) f32 specular transmission
    ior: jnp.ndarray     # (M,)  f32 refractive index
    tex_id: jnp.ndarray  # (M,)  i32

    @property
    def capacity(self) -> int:
        return self.le.shape[0]


@pytree_dataclass
class Lights:
    """Unified light table covering the reference's PointLight and AreaLight
    components (reference app/Components/Lights/{PointLight,AreaLight}.cpp).

    Point lights have a fixed `position` and are not hittable.  Area lights
    are emissive triangles: they are intersected during normal tracing
    (reference AreaLight.cpp:32-41 binds the radiance material with
    materialIndex=-1) and NEE samples uniform points on them
    (AreaLight.cpp:17-26).
    """

    kind: jnp.ndarray      # (L,) i32: LIGHT_POINT | LIGHT_AREA
    position: jnp.ndarray  # (L, 3) f32 point-light position (area: unused)
    tri_a: jnp.ndarray     # (L, 3) f32 area-light triangle vertex A
    tri_ab: jnp.ndarray    # (L, 3) f32 area-light AB edge
    tri_ac: jnp.ndarray    # (L, 3) f32 area-light AC edge
    radiance: jnp.ndarray  # (L, 3) f32 Le of the light material
    valid: jnp.ndarray     # (L,) bool
    num: jnp.ndarray       # () i32 number of valid lights

    @property
    def capacity(self) -> int:
        return self.kind.shape[0]


@pytree_dataclass
class TextureAtlas:
    """Nearest-sampled RGB texture atlas.

    The reference point-samples stb_image-backed RGB8 textures (reference
    app/MobileRT/Texture.cpp:37-48).  We stack all textures into one padded
    (T, H, W, 3) float array plus per-texture sizes.
    """

    data: jnp.ndarray    # (T, H, W, 3) f32 in [0, 1]
    sizes: jnp.ndarray   # (T, 2) i32 (height, width) actually used

    @property
    def num_textures(self) -> int:
        return self.data.shape[0]


def empty_texture_atlas() -> TextureAtlas:
    return TextureAtlas(
        data=jnp.zeros((1, 1, 1, 3), jnp.float32),
        sizes=jnp.ones((1, 2), jnp.int32),
    )


@pytree_dataclass
class Scene:
    """Scene pytree: geometry + materials + lights (+ optional accelerator
    arrays attached by `ops.build_accelerator`).  Replicated per host on a
    mesh."""

    triangles: Triangles
    spheres: Spheres
    planes: Planes
    materials: Materials
    lights: Lights
    atlas: TextureAtlas
    # Acceleration structure (block BVH, regular grid, or the escape-index
    # BVH); None until ops.build_accelerator (or a module's build) runs.
    bvh: Optional["BVH"] = None


@pytree_dataclass
class BVH:
    """Flat threaded (escape-index) BVH over the triangle batch.

    Replaces the reference's pointer+stack BVH (reference
    app/MobileRT/Accelerators/BVH.hpp:56-60, 327-384) with a stackless
    hit-link/miss-link layout: traversal is a single index walk, which maps
    to a bounded `while_loop` instead of divergent stack juggling.

    Nodes are stored in DFS preorder, so an internal node's left child is
    the next node; `node_skip` is the escape index taken when the node's
    AABB is missed or a leaf is done.  Triangles are physically reordered at
    build time so each leaf covers the contiguous range
    [node_first, node_first + node_count).
    """

    node_min: jnp.ndarray    # (K, 3) f32 AABB min
    node_max: jnp.ndarray    # (K, 3) f32 AABB max
    node_first: jnp.ndarray  # (K,) i32 first triangle of a leaf (0 internal)
    node_skip: jnp.ndarray   # (K,) i32 next node when AABB missed / leaf done
    node_count: jnp.ndarray  # (K,) i32 number of primitives in leaf (0 = internal)

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


@pytree_dataclass
class Camera:
    """Camera pytree (reference app/MobileRT/Camera.hpp:16-71 plus the
    Perspective/Orthographic components).

    The basis follows the reference exactly: direction = normalize(lookAt -
    position), right = cross(up_in, direction), up = cross(direction, right)
    — deliberately NOT re-normalized (reference app/MobileRT/Camera.cpp:14-18).
    `param_u`/`param_v` are hFov/vFov in radians for perspective cameras and
    the half extents sizeH/2, sizeV/2 for orthographic ones.
    """

    kind: jnp.ndarray       # () i32: 0 = perspective, 1 = orthographic
    position: jnp.ndarray   # (3,) f32
    direction: jnp.ndarray  # (3,) f32 unit
    right: jnp.ndarray      # (3,) f32
    up: jnp.ndarray         # (3,) f32
    param_u: jnp.ndarray    # () f32
    param_v: jnp.ndarray    # () f32


CAMERA_PERSPECTIVE = 0
CAMERA_ORTHOGRAPHIC = 1


def make_camera_basis(position, look_at, up):
    position = _f32(position)
    look_at = _f32(look_at)
    up = _f32(up)
    direction = look_at - position
    direction = direction / jnp.linalg.norm(direction)
    right = jnp.cross(up, direction)
    up_out = jnp.cross(direction, right)
    return position, direction, right, up_out


def perspective_camera(position, look_at, up, hfov_deg: float, vfov_deg: float) -> Camera:
    """Perspective camera with fields of view in degrees (reference
    app/Components/Cameras/Perspective.cpp:8-14)."""
    position, direction, right, up_out = make_camera_basis(position, look_at, up)
    return Camera(
        kind=_i32(CAMERA_PERSPECTIVE),
        position=position,
        direction=direction,
        right=right,
        up=up_out,
        param_u=_f32(np.deg2rad(hfov_deg)),
        param_v=_f32(np.deg2rad(vfov_deg)),
    )


def orthographic_camera(position, look_at, up, size_h: float, size_v: float) -> Camera:
    """Orthographic camera with full extents sizeH/sizeV (reference
    app/Components/Cameras/Orthographic.cpp:7-13 halves them)."""
    position, direction, right, up_out = make_camera_basis(position, look_at, up)
    return Camera(
        kind=_i32(CAMERA_ORTHOGRAPHIC),
        position=position,
        direction=direction,
        right=right,
        up=up_out,
        param_u=_f32(size_h / 2.0),
        param_v=_f32(size_v / 2.0),
    )


@pytree_dataclass
class Hit:
    """Closest-hit record batch (reference app/MobileRT/Intersection.hpp:14-55).

    "Closer wins" updates are expressed as `jnp.where(t_new < t, new, old)`.
    A miss keeps t == RAY_LENGTH_MAX and prim_kind == PRIM_NONE.
    `mat_id == -1` with prim_kind == PRIM_LIGHT marks an area-light hit whose
    radiance is carried in `light_le`.
    """

    t: jnp.ndarray          # (B,) f32
    prim_kind: jnp.ndarray  # (B,) i32
    prim_id: jnp.ndarray    # (B,) i32
    mat_id: jnp.ndarray     # (B,) i32
    point: jnp.ndarray      # (B, 3) f32
    normal: jnp.ndarray     # (B, 3) f32
    uv: jnp.ndarray         # (B, 2) f32 texcoords (-1 when none)
    light_le: jnp.ndarray   # (B, 3) f32 radiance bound on area-light hits

    @property
    def missed(self) -> jnp.ndarray:
        return self.prim_kind == C.PRIM_NONE


def make_miss(batch_shape) -> Hit:
    b = tuple(batch_shape)
    return Hit(
        t=jnp.full(b, C.RAY_LENGTH_MAX, jnp.float32),
        prim_kind=jnp.zeros(b, jnp.int32),
        prim_id=jnp.full(b, -1, jnp.int32),
        mat_id=jnp.full(b, -1, jnp.int32),
        point=jnp.zeros(b + (3,), jnp.float32),
        normal=jnp.concatenate(
            [jnp.zeros(b + (2,), jnp.float32), jnp.ones(b + (1,), jnp.float32)], -1),
        uv=jnp.full(b + (2,), -1.0, jnp.float32),
        light_le=jnp.zeros(b + (3,), jnp.float32),
    )


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static run parameters, mirroring the reference Config POD (reference
    app/MobileRT/Config.hpp:12-83) plus this engine's own sampling and
    scheduling options.

    This is a plain (hashable) dataclass — it is passed as a static argument
    to jitted render functions.
    """

    width: int = 256
    height: int = 256
    spp: int = 1                       # samples per pixel
    samples_light: int = 1             # NEE samples per diffuse hit (spl)
    shader: int = C.SHADER_WHITTED
    accelerator: int = C.ACC_NAIVE
    scene_id: int = C.SCENE_CORNELL
    depth_max: int = C.RAY_DEPTH_MAX
    depth_min: int = C.RAY_DEPTH_MIN
    repeats: int = 1
    seed: int = 0
    # Maximum wavefront iterations of the shading tree walker; each bounce of
    # a single-lobe material consumes one iteration, dual-lobe materials
    # consume extra stack entries.  2*(depth+1) covers every scene the
    # reference ships.
    max_walk_iters: Optional[int] = None
    # Per-lane ray stack capacity for the tree walker.
    stack_size: int = 8
    # "int_parity" reproduces the reference's integer-packed progressive mean
    # bit-for-bit (reference app/MobileRT/Utils/Utils.cpp:66-90);
    # "float32" keeps a float accumulator and quantizes once at the end.
    accumulation: str = "float32"
    # Jitter pixels only when spp > 1, like the reference which switches the
    # pixel sampler to Constant(0.5) when spp <= 1
    # (reference app/System_dependent/Native/C_wrapper.cpp:144-148).
    pixel_jitter: Optional[bool] = None
    # Pixel jitter stream: "prng" (counter-based keys), "halton"
    # (per-pixel Cranley-Patterson-rotated (2,3)-Halton), or any of the
    # reference's 8 sampler components by name — constant, stratified,
    # haltonseq, mersenne, pcg, static_haltonseq, static_mersenne,
    # static_pcg (samplers.py; reference app/Components/Samplers/*.cpp).
    pixel_sampler: str = "prng"
    # Width of the lane group sharing one NEE light pick/point on the
    # FIRST bounce (shaders/common.direct_lighting): every pixel's
    # marginal sample stays uniform, so any width is unbiased — wider
    # groups trade sample decorrelation for shadow-bundle coherence.
    # The benchmark runs 128, a width chosen on other hardware and not
    # yet measured on a GPU; 16 (one traversal subtile) is the default.
    # Like the reference's shared atomic sampler
    # cursors (Sampler.hpp:58-63), this is a sampling policy, not an
    # execution detail: images are invariant to sharding/compaction for
    # any fixed width, provided every shard holds a multiple of the
    # width (renderer and parallel/mesh.py both shard patch-major lanes).
    nee_share: int = 16
    # Trace first-bounce NEE occlusion segments from the (group-shared)
    # light point toward the surfaces instead of surface->light: occlusion
    # is symmetric in the segment, and the point origin collapses the
    # traversal's candidate hulls to the exact shadow cone.  See
    # shaders/common.direct_lighting.
    nee_reverse: bool = True
    # Share NEE light picks/points across execution lane groups on
    # SECONDARY bounces too (first bounces always share via nee_share).
    # Unbiased — every pixel's marginal sample stays uniform — but the
    # grouping follows the compacted wavefront's execution layout, so the
    # image is no longer bit-invariant to compaction/sharding layout
    # (which is why it defaults off; the sharded bit-identity tests rely
    # on per-lane secondary picks).  The PathTracer's indirect bounces
    # spend most of their time in divergent per-lane shadow walks; with
    # sharing they get the same reversed shared-cone treatment as the
    # primary NEE (the PathTracer benchmark turns it on).
    nee_share_secondary: bool = False
    # Wavefront-compaction chunk divisor (batch/div lanes per compacted
    # chunk iteration; None = per-shader default in shaders/engine.py).
    # Bigger chunks amortize the per-iteration WalkState gather/scatter
    # against re-tracing more drained lanes.
    walk_chunk_div: Optional[int] = None

    def resolved_max_walk_iters(self) -> int:
        if self.max_walk_iters is not None:
            return self.max_walk_iters
        return 2 * (self.depth_max + 1)

    def resolved_pixel_jitter(self) -> bool:
        if self.pixel_jitter is not None:
            return self.pixel_jitter
        return self.spp > 1

    def rounded(self) -> "RenderConfig":
        """Round width/height down to a multiple of 16, the reference's tile
        contract (reference Qt main.cpp:36-44, JNI_layer.cpp:966-981)."""
        def round_down(v: int) -> int:
            rest = v % C.TILE_MULTIPLE
            return v - rest if rest > 1 else v
        return dataclasses.replace(
            self, width=round_down(self.width), height=round_down(self.height))


def scene_num_primitives(scene: Scene) -> dict:
    return {
        "triangles": int(np.asarray(jnp.sum(scene.triangles.valid))),
        "spheres": int(np.asarray(jnp.sum(scene.spheres.valid))),
        "planes": int(np.asarray(jnp.sum(scene.planes.valid))),
        "lights": int(np.asarray(scene.lights.num)),
    }
