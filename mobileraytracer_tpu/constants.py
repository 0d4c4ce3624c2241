"""Numeric constants shared by the whole framework.

These mirror the reference engine's conventions (reference:
app/MobileRT/Utils/Constants.hpp:22-79) because image parity depends on
matching the epsilons, the ray-length cap, and the bounce-depth window.
"""

# Geometric tolerance used by ray-plane / ray-triangle intersection and
# most float comparisons (reference Constants.hpp: Epsilon).
EPSILON = 1.0e-06

# Larger tolerance used only by the ray-sphere intersection to counter
# floating-point cancellation (reference Constants.hpp: EpsilonLarge).
EPSILON_LARGE = 1.0e-05

# Maximum distance a ray may travel; doubles as the "miss" sentinel in hit
# records (reference Constants.hpp: RayLengthMax).
RAY_LENGTH_MAX = 1.0e+30

# Minimum number of bounces before Russian roulette may terminate a path
# (reference Constants.hpp: RayDepthMin).
RAY_DEPTH_MIN = 1

# Maximum number of bounces for Whitted and path tracing
# (reference Constants.hpp: RayDepthMax).
RAY_DEPTH_MAX = 6

# The reference splits the image plane into 256 tiles and rounds the
# resolution down to a multiple of sqrt(256)=16 (reference Constants.hpp:
# NumberOfTiles; Qt main.cpp:36-44).  We keep the same rounding contract so
# CLI arguments map to identical resolutions.
NUMBER_OF_TILES = 256
TILE_MULTIPLE = 16  # sqrt(NUMBER_OF_TILES)

# Ambient light factor added by the Whitted shader (reference
# app/Components/Shaders/Whitted.cpp:91: "rgb += kD * 0.1F").
WHITTED_AMBIENT = 0.1

# Russian-roulette finish probability used by the path tracer (reference
# app/Components/Shaders/PathTracer.cpp:42).
RR_FINISH_PROBABILITY = 0.5

# Primitive kind tags used in hit records and for the self-intersection
# guard (the reference threads a primitive pointer through the Ray for the
# same purpose; reference app/MobileRT/Ray.hpp:13-72).
PRIM_NONE = 0
PRIM_PLANE = 1
PRIM_SPHERE = 2
PRIM_TRIANGLE = 3
PRIM_LIGHT = 4

# Light kind tags (reference has PointLight and AreaLight components).
LIGHT_POINT = 0
LIGHT_AREA = 1

# Shader ids, matching the reference's integer shader enum (reference
# app/System_dependent/Native/C_wrapper.cpp:154-194 and
# app/src/main/java/puscas/mobilertapp/constants/Shader.java).
SHADER_NOSHADOWS = 0
SHADER_WHITTED = 1
SHADER_PATHTRACER = 2
SHADER_DEPTHMAP = 3
SHADER_DIFFUSE = 4

# Accelerator ids (reference app/MobileRT/Shader.hpp:20-24 and
# constants/Accelerator.java:14-34).
ACC_NONE = 0
ACC_NAIVE = 1
ACC_REGULAR_GRID = 2
ACC_BVH = 3

# Scene ids (reference app/System_dependent/Native/C_wrapper.cpp:76-141).
SCENE_CORNELL = 0
SCENE_SPHERES = 1
SCENE_CORNELL2 = 2
SCENE_SPHERES2 = 3
SCENE_OBJ = 4

# Far-away-but-finite ray origin used to park dead/masked lanes: every
# AABB/primitive test misses (so accelerator subtiles whose lanes are all
# parked exit their walk immediately), yet all intermediate products stay
# finite in float32, keeping reverse-mode AD NaN-free.
FAR_SENTINEL = 1.0e7

# Rays per traversal subtile: the granularity at which the block-BVH
# traversal (ops/block_bvh.py) shares candidate lists, and therefore the
# coherence unit the shading engine packs rays for.  A plain-XLA shape
# choice: 16 was tuned on other hardware and is not yet measured on a GPU.
# Env-tunable (MRT_SUBTILE) for sweeps; must divide 128.
import os as _os

SUBTILE = int(_os.environ.get("MRT_SUBTILE", "16"))
