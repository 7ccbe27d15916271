"""rustraytrace_tpu_torch — the PyTorch / CUDA port of ``rustraytrace_tpu``.

A second package beside the JAX one, for a single NVIDIA H100: host code is
NumPy and PyTorch, and every Pallas kernel of the JAX package becomes a CUDA
C++ kernel written for Hopper (``csrc/``, built with ``nvcc`` at first use).
The JAX package stays the reference each module is tested against; this
package never imports it, nor JAX.

Ported so far: config and camera, the scene compiler, the whole scene
catalog, the SAH clustering and table packing, the closest-hit kernel K1
(``csrc/sphere_hit.cu``), the persist path tracer K2 (``csrc/persist.cu``)
with its between-launch ray sort and per-tile launch bounds, the respawn
megakernel K3 (``csrc/megakernel.cu``), their shared device code for
spheres, boxes, quads, constant media and textures (``csrc/path.cuh``),
the monolithic megakernel K4 (``csrc/mono.cu``) and the per-bounce segment
kernel K5 (``csrc/segment.cu``), the render pass loop, the reference
integrators (``camera.py``, ``ops/intersect.py``, ``ops/materials.py``,
``ops/textures.py``, ``ops/perlin.py``, ``ops/integrator.py``) behind the
``"reference"`` and ``"sphere_kernel"`` backends (the latter with K1 as its
closest hit), and S1, the dense closest-sphere spike's two kernels
(``csrc/dense_hit.cu``), the training path: the silhouette warp
(``ops/warp.py``), the differentiable pass and its tent splat
(``render.trace_rays_diff``, ``render.splat_terms``), the inverse-rendering
fit on ``torch.optim`` (``diff``) and the render and train-state
checkpoints (``utils/checkpoint.py``); sharding over ``torch.distributed``
(``parallel``: the mesh, the reference route's sharded pass and
contraction, the sharded router and image loop, the kernel routes'
sharded passes, the multi-process bring-up), the command line
(``cli.py``) and the throughput meter and profiler hooks
(``utils/metrics.py``).

Entry points: ``python -m rustraytrace_tpu_torch <scene> [options]`` (or
``torchrun ... -m rustraytrace_tpu_torch <scene> --sharded``), and the
library's ``render.render_image`` / ``render_pass``,
``parallel.render_image_sharded`` / ``render_image_multihost``, ``diff.fit``
and ``scripts.inverse_rendering``.  They run on the card
(``device="cuda"``, ``--device cuda``) unless the caller asks for
``device="cpu"``.
"""

from .config import CameraParams, RenderConfig, derive_camera
from .scene import (
    DIELECTRIC,
    DIFFUSE_LIGHT,
    ISOTROPIC,
    LAMBERTIAN,
    METAL,
    Scene,
    SceneBuilder,
    scene_from_numpy,
)
from .render import finalize_image, render_image, render_pass
from . import diff, models, parallel

__all__ = [
    "RenderConfig",
    "CameraParams",
    "derive_camera",
    "SceneBuilder",
    "Scene",
    "scene_from_numpy",
    "LAMBERTIAN",
    "METAL",
    "DIELECTRIC",
    "DIFFUSE_LIGHT",
    "ISOTROPIC",
    "render_image",
    "render_pass",
    "finalize_image",
    "models",
    "parallel",
    "diff",
]

__version__ = "0.1.0"
