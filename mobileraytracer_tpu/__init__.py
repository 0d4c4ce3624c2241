"""mobileraytracer_tpu — a differentiable ray tracer with the capability
surface of MobileRT (TiagoMSSantos/MobileRayTracer), built from scratch on
JAX / XLA.

Layer map (mirrors SURVEY.md §1, re-designed as a wavefront engine):
  engine      renderer.Renderer / renderer.render_frame   (L1 Renderer)
  shading     shaders.engine (wavefront tree walker)      (L1/L2 Shaders)
  geometry    ops.intersect (naive oracle), ops.block_bvh (L1 Accelerators)
  scene       types.Scene pytree + builder.SceneBuilder   (L1 Scene)
  components  cameras, sampling, film, scenes, loaders    (L2/L3)
  frontends   cli                                         (L4/L5)
  scale       parallel.mesh (shard_map over device mesh)  (new, §2.6)
"""

from . import constants  # noqa: F401
from .types import (Camera, Hit, Materials, Lights, Planes, RenderConfig,  # noqa: F401
                    Scene, Spheres, Triangles, orthographic_camera,
                    perspective_camera)
from .builder import SceneBuilder  # noqa: F401
from .renderer import Renderer, render_frame  # noqa: F401

__version__ = "0.1.0"
