"""path_tracer_tpu_torch — the path tracer on PyTorch, with hand-written
CUDA kernels for an NVIDIA H100 (Hopper, sm_90a).

A port of ``path_tracer_tpu`` (JAX on a TPU), which stays the reference.
This package imports torch and numpy, never jax or ``path_tracer_tpu``.
The layout mirrors the JAX package's, so each module's counterpart has the
same path; its Pallas kernels become CUDA C++ under ``csrc/``, each with a
plain torch version beside it (``ops/kernels/``).

Ported so far: every built-in scene, scene JSON → ``render(scene, config,
device=...)`` → PPM, with progress, cancel and checkpoints, and the
``spp res_y scene`` CLI. Scenes of at most 128 primitives take the
regenerative trace kernel (K1); ``mesh`` takes the portal scheduler with
its cheap and resolve kernels (K2, K3); other triangle-heavy scenes take the
regenerative loop over the full scene (K4). Backend ``exact`` or ``fast``,
``mock_random`` and ``estimator="literal"`` take the wavefront integrator
(plain torch). Also ported: the interactive and raster previews, the viewer
app and the host native runtime. See ROADMAP.md for the slices still to
come.
"""

from path_tracer_tpu_torch.models.material import Material, ReflectType
from path_tracer_tpu_torch.models.camera import Camera
from path_tracer_tpu_torch.models.geometry import Mesh, Triangle
from path_tracer_tpu_torch.models.scene import (
    SceneDescriptor,
    SceneObject,
    ScenePacked,
    pack_scene,
)
from path_tracer_tpu_torch.models.scenes import (
    builtin_scenes, load_scene, load_scene_ids,
)
from path_tracer_tpu_torch.utils.config import RenderConfig, Resolution
# eager import: `render` (the function) shadows the `render` subpackage
from path_tracer_tpu_torch.render.pipeline import render, RenderDone, RenderUpdate
from path_tracer_tpu_torch.version import __version__

__all__ = [
    "Material",
    "ReflectType",
    "Camera",
    "Mesh",
    "Triangle",
    "SceneDescriptor",
    "SceneObject",
    "ScenePacked",
    "pack_scene",
    "builtin_scenes",
    "load_scene",
    "load_scene_ids",
    "RenderConfig",
    "Resolution",
    "render",
    "RenderDone",
    "RenderUpdate",
    "__version__",
]
