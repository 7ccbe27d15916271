"""Render orchestration: pass loop, accumulation, finalize (counterpart:
``rustraytrace_tpu/render.py``).

``render_image`` runs a host loop of passes and accumulates (RGB sum,
sample count), so every pass boundary is a checkpoint; ``render_pass``
traces one pass.  It routes as the JAX package does: image-textured scenes
take the image route and scenes on the sorted persist route (>= 256
primitives, at most 2 Mi slot lanes) the persist launch loop (K2); every
other scene runs one launch of the respawn megakernel (K3).  Backends:

* ``"wavefront"`` (auto for ``path`` and for image-textured scenes on a
  CUDA device) and ``"megakernel"`` (auto for other ``mis`` scenes) — the
  CUDA kernels.  The two are one backend under two names, kept as the JAX
  package names them: both route by the scene as above, and
  ``"megakernel"`` does not force K3;
* ``"plain"`` — the plain PyTorch twin of the kernel the route uses (auto
  on the CPU; on a CUDA device only when asked for, to compare against the
  kernel).

The entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``).  Unlike the JAX package there is no
fallback: a kernel that fails to build or launch raises, ``device="cuda"``
without a card raises, and nothing moves to the CPU or to the plain version
on its own.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import CameraParams, RenderConfig, derive_camera
from .ops._cuda import device as _device
from .ops.megakernel import megakernel_eligible
from .scene import Scene

BACKENDS = ("wavefront", "megakernel", "plain")

# Per-pass ray budget for kernel backends (render.py:291-294 there).
_PASS_RAY_TARGET = 64 * 1024 * 1024
_PASS_SPP_CAP = 1024
_PASS_SPP_FLOOR = 32
_DEFAULT_SPP_PER_PASS = 16


def finalize_image(accum_sum: np.ndarray, spp_total: int) -> np.ndarray:
    """(sum, count) -> 8-bit image; exactly render_io.rs:8-27: non-finite
    -> 0, divide by spp, gamma-2 sqrt, clamp to 0.999, scale by 256."""
    img = np.asarray(accum_sum, np.float32)
    scale = 1.0 / spp_total if spp_total > 0 else 0.0
    img = img * scale
    img = np.where(np.isfinite(img), img, 0.0)
    img = np.sqrt(np.maximum(img, 0.0))
    return (np.clip(img, 0.0, 0.999) * 256.0).astype(np.uint8)


def resolve_backend(scene: Scene, integrator: str = "path",
                    backend: str = "auto", device="cuda") -> str:
    """'auto' follows the JAX package's rule (render.py:248-282 there): on a
    CUDA device ``path`` and image-textured scenes -> ``"wavefront"``, other
    ``mis`` scenes -> ``"megakernel"``; on the CPU ``"plain"``.  Scenes and
    integrators the port does not cover raise ``NotImplementedError`` (see
    ops.megakernel.megakernel_eligible), and ``device="cuda"`` without a
    card raises ``RuntimeError``."""
    megakernel_eligible(scene, integrator)
    if backend != "auto":
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
        return backend
    if _device(device).type != "cuda":
        return "plain"
    if integrator == "mis" and "image" not in scene.features:
        return "megakernel"
    return "wavefront"


def effective_spp_per_pass(cfg: RenderConfig, spp_total: int,
                           n_pix: int) -> int:
    """Samples per pass.  ``cfg.spp_per_pass == 0`` means AUTO: fold
    samples into passes of up to 64 Mi rays (at most 1024 spp, at least
    32); an explicit value is honored exactly."""
    base = cfg.spp_per_pass
    explicit = base > 0
    if not explicit:
        base = _DEFAULT_SPP_PER_PASS
    if explicit:
        return max(1, min(spp_total, base))
    raise_to = min(_PASS_RAY_TARGET // max(n_pix, 1), _PASS_SPP_CAP)
    return max(1, min(spp_total, max(base, raise_to, _PASS_SPP_FLOOR)))


def render_pass(scene: Scene, cam: CameraParams, seed: int, *, width: int,
                height: int, spp: int, max_depth: int,
                integrator: str = "path", sample_offset: int = 0,
                stratified: bool = False, sqrt_spp: int = 0,
                backend: str = "auto", device="cuda",
                stats: Optional[dict] = None) -> torch.Tensor:
    """Trace ``spp`` samples per pixel, absolute sample indices
    ``sample_offset + [0, spp)`` (stratified over a ``sqrt_spp`` grid when
    asked); returns the RGB radiance SUM [H, W, 3] as a float32 tensor on
    ``device``.  ``stats`` receives the persist loop's counts (sorted route
    only)."""
    from .ops import megakernel as mk
    from .ops import wavefront as wf

    dev = _device(device)
    backend = resolve_backend(scene, integrator, backend, dev)
    plain = backend == "plain"
    return wf.render_pass_wavefront(
        scene, cam, seed, width=width, height=height, spp=spp,
        max_depth=max_depth, sample_offset=sample_offset,
        mis=integrator == "mis", stratified=stratified, sqrt_spp=sqrt_spp,
        step=wf.persist_step_plain if plain else wf.persist_step,
        respawn_step=mk.respawn_pass_plain if plain else mk.respawn_pass,
        device=dev, stats=stats)


def render_image(scene: Scene, cfg: RenderConfig, *,
                 integrator: str = "path", progress=None,
                 accum_state: Optional[dict] = None, backend: str = "auto",
                 on_pass=None, device="cuda"):
    """Full render: host pass loop over spp batches.  Returns
    (image_u8 [H, W, 3], {"accum": sum [H, W, 3], "spp_done": n});
    ``accum_state`` from an earlier call resumes the accumulation.  A
    stratified config renders floor(sqrt(spp))^2 samples (render.py:351-353
    there)."""
    dev = _device(device)
    backend = resolve_backend(scene, integrator, backend, dev)
    cam = derive_camera(cfg, device=dev)
    h, w = cfg.image_height, cfg.image_width
    stratified = cfg.stratified
    sqrt_spp = int(np.sqrt(cfg.samples_per_pixel)) if stratified else 0
    spp_total = sqrt_spp * sqrt_spp if stratified else cfg.samples_per_pixel
    if accum_state is None:
        accum = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
        done = 0
    else:
        accum = torch.as_tensor(np.asarray(accum_state["accum"], np.float32),
                                device=dev)
        done = int(accum_state["spp_done"])
    per_pass = effective_spp_per_pass(cfg, spp_total, h * w)
    while done < spp_total:
        this = min(per_pass, spp_total - done)
        accum = accum + render_pass(
            scene, cam, cfg.seed, width=w, height=h, spp=this,
            max_depth=cfg.max_depth, integrator=integrator,
            sample_offset=done, stratified=stratified, sqrt_spp=sqrt_spp,
            backend=backend, device=dev)
        done += this
        if progress is not None:
            progress(done, spp_total)
        if on_pass is not None:
            on_pass({"accum": accum, "spp_done": done})
    accum_np = accum.cpu().numpy()
    return finalize_image(accum_np, done), {"accum": accum_np,
                                            "spp_done": done}
