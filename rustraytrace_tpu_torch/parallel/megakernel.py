"""spp-sharded kernel-route rendering over the ('px', 'spp') mesh of
``torch.distributed`` ranks (counterpart:
``rustraytrace_tpu/parallel/megakernel.py``).

The single-card kernel passes (``ops/wavefront.render_pass_wavefront``:
the persist loop K2 or the respawn megakernel K3; ``ops/megakernel
.render_pass_megakernel``: K4, or K3 with ``respawn``) trace the whole
image; they scale across ranks on the sample axis, whatever the mesh's
shape.  Every rank runs the same pass over the same (replicated) scene at
its own sample offset ``sample_offset + rank * spp_local`` and the sums
are added with ``all_reduce``.  The port's draws are Philox keyed by
(slot, absolute sample, bounce, stream), never by launch or rank, so the
N-rank render traces exactly the samples of the 1-rank render and equals
it up to the order of the f32 sums; the 1-rank render is
``render.render_image``, bitwise.

The JAX package's compiled-function cache (``_cached_sharded_fn``) has no
counterpart: ``prepare_megakernel_cached`` already caches the tables.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..config import CameraParams, RenderConfig, derive_camera
from ..ops import megakernel as mk
from ..ops import wavefront as wf
from ..ops._cuda import device as _device
from ..render import effective_spp_per_pass, render_passes, samples_total
from ..scene import Scene
from .mesh import Mesh, make_mesh


def _on_cuda(device) -> bool:
    return _device(device).type == "cuda"


def megakernel_shard_eligible(scene: Scene, integrator: str, mesh: Mesh,
                              device="cuda") -> bool:
    """True when the sharded render can route through the megakernels:
    the device is CUDA (the kernels do not run on the CPU; JAX asks for a
    TPU mesh), the integrator is ``path`` or ``mis``, the scene has no
    image texture (those take the image route) and the kernels cover it
    (``ops/megakernel.kernel_gap`` is None)."""
    if not _on_cuda(device) or integrator not in ("path", "mis"):
        return False
    return ("image" not in scene.features
            and mk.kernel_gap(scene, integrator) is None)


def wavefront_shard_eligible(scene: Scene, integrator: str, mesh: Mesh,
                             device="cuda") -> bool:
    """Sharded-wavefront routing: a CUDA device and a scene the kernels
    cover, image-textured ones included."""
    if not _on_cuda(device) or integrator not in ("path", "mis"):
        return False
    return mk.kernel_gap(scene, integrator) is None


def sharded_megakernel_wiring(pass_fn, arrays, seed: int, offsets,
                              mesh: Mesh) -> torch.Tensor:
    """The sharding's plumbing, apart from the kernel so that a substitute
    ``pass_fn`` can test it: ``pass_fn(arrays, seed, offsets[rank])`` ->
    this rank's radiance sum [H, W, 3], then the sum over the mesh's group
    (``all_reduce``; nothing without a group), the same on every rank.
    ``offsets`` holds one sample offset a rank, in the mesh's rank order
    (px-major, as JAX flattens its ('px', 'spp') devices)."""
    img = pass_fn(arrays, seed, offsets[mesh.rank])
    if mesh.group is not None:
        img = img.contiguous()
        dist.all_reduce(img, group=mesh.group)
    return img


def spp_traced_mesh(spp: int, mesh: Mesh) -> int:
    """Samples per pixel a kernel-route sharded pass traces: ``spp``
    rounded up to a multiple of the mesh's size."""
    n = mesh.size
    return -(-spp // n) * n


def _offsets(sample_offset: int, spp: int, mesh: Mesh) -> tuple:
    """(samples a rank, each rank's sample offset)."""
    spp_local = -(-spp // mesh.size)
    return spp_local, [sample_offset + r * spp_local
                       for r in range(mesh.size)]


def render_pass_megakernel_sharded(scene: Scene, cam: CameraParams,
                                   seed: int, *, width: int, height: int,
                                   spp: int, max_depth: int,
                                   mesh: Optional[Mesh] = None,
                                   mis: bool = False,
                                   stratified: bool = False,
                                   sqrt_spp: int = 0, sample_offset: int = 0,
                                   respawn: bool = False, step=None,
                                   device="cuda") -> torch.Tensor:
    """Trace ``spp_traced_mesh(spp, mesh)`` samples per pixel across the
    mesh with ``ops/megakernel.render_pass_megakernel`` on every rank: K4,
    or K3 with ``respawn`` (``step`` replaces the pass, e.g. with a plain
    twin).  Returns the radiance SUM [H, W, 3], the same on every rank."""
    mesh = make_mesh() if mesh is None else mesh
    spp_local, offsets = _offsets(sample_offset, spp, mesh)

    def pass_fn(arrays, seed, off):
        scene, cam = arrays
        return mk.render_pass_megakernel(
            scene, cam, seed, width=width, height=height, spp=spp_local,
            max_depth=max_depth, sample_offset=off, mis=mis,
            stratified=stratified, sqrt_spp=sqrt_spp, respawn=respawn,
            device=device, step=step)

    return sharded_megakernel_wiring(pass_fn, (scene, cam), seed, offsets,
                                     mesh)


def render_pass_wavefront_sharded(scene: Scene, cam: CameraParams,
                                  seed: int, *, width: int, height: int,
                                  spp: int, max_depth: int,
                                  mesh: Optional[Mesh] = None,
                                  stratified: bool = False,
                                  sqrt_spp: int = 0, mis: bool = False,
                                  sample_offset: int = 0,
                                  step=wf.persist_step,
                                  respawn_step=mk.respawn_pass,
                                  device="cuda") -> torch.Tensor:
    """Trace ``spp_traced_mesh(spp, mesh)`` samples per pixel across the
    mesh with ``ops/wavefront.render_pass_wavefront`` on every rank, which
    routes each scene as the single card does (the image route, the
    sorted persist loop, or K3); ``step`` and ``respawn_step`` as there.
    Returns the radiance SUM [H, W, 3], the same on every rank."""
    mesh = make_mesh() if mesh is None else mesh
    spp_local, offsets = _offsets(sample_offset, spp, mesh)

    def pass_fn(arrays, seed, off):
        scene, cam = arrays
        return wf.render_pass_wavefront(
            scene, cam, seed, width=width, height=height, spp=spp_local,
            max_depth=max_depth, sample_offset=off, mis=mis,
            stratified=stratified, sqrt_spp=sqrt_spp, step=step,
            respawn_step=respawn_step, device=device)

    return sharded_megakernel_wiring(pass_fn, (scene, cam), seed, offsets,
                                     mesh)


def render_image_sharded_megakernel(scene: Scene, cfg: RenderConfig, *,
                                    mesh: Optional[Mesh] = None,
                                    integrator: str = "path",
                                    progress=None,
                                    accum_state: Optional[dict] = None,
                                    on_pass=None,
                                    backend: str = "megakernel",
                                    device="cuda"):
    """Full sharded render on the kernel routes: ``render.render_passes``
    (the host pass loop, with the contract of ``parallel.render
    .render_image_sharded``, which routes here) over
    ``render_pass_wavefront_sharded``.  ``backend`` is ``"megakernel"`` or
    ``"wavefront"`` (one route under two names, as in
    ``render.render_pass``) or ``"plain"`` (the kernels' plain twins).
    Passes take ``effective_spp_per_pass`` samples rounded up to a
    multiple of the mesh's size."""
    dev = _device(device)
    mesh = make_mesh() if mesh is None else mesh
    plain = backend == "plain"
    cam = derive_camera(cfg, device=dev)
    h, w = cfg.image_height, cfg.image_width

    def one_pass(spp, sample_offset, stratified, sqrt_spp):
        return render_pass_wavefront_sharded(
            scene, cam, cfg.seed, width=w, height=h, spp=spp,
            max_depth=cfg.max_depth, mesh=mesh, stratified=stratified,
            sqrt_spp=sqrt_spp, mis=integrator == "mis",
            sample_offset=sample_offset,
            step=wf.persist_step_plain if plain else wf.persist_step,
            respawn_step=mk.respawn_pass_plain if plain else mk.respawn_pass,
            device=dev)

    per_pass = effective_spp_per_pass(cfg, backend, samples_total(cfg),
                                      h * w)
    return render_passes(cfg, one_pass, spp_traced_mesh(per_pass, mesh),
                         unit=mesh.size, progress=progress,
                         accum_state=accum_state, on_pass=on_pass,
                         device=dev)
