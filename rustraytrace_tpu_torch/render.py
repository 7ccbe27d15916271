"""Render orchestration: pass loop, accumulation, finalize (counterpart:
``rustraytrace_tpu/render.py``).

``render_image`` runs a host loop of passes and accumulates (RGB sum,
sample count), so every pass boundary is a checkpoint; ``render_pass``
traces one pass.  It routes as the JAX package does: image-textured scenes
take the image route and scenes on the sorted persist route (>= 256
primitives, at most 2 Mi slot lanes) the persist launch loop (K2); every
other scene runs one launch of the respawn megakernel K3.  Scenes the
kernels do not cover (image-textured media; ``mis`` without 1 to 16 NEE
lights) take the sphere_kernel route for ``path`` when
``hit.sphere_kernel_eligible`` holds, else the reference route, as the
JAX package sends them off the TPU.  Backends:

* ``"wavefront"`` (auto for ``path`` and for image-textured scenes on a
  CUDA device) and ``"megakernel"`` (auto for other ``mis`` scenes) — the
  CUDA kernels.  The two are one backend under two names, kept as the JAX
  package names them: both route by the scene as above, and
  ``"megakernel"`` does not force K3;
* ``"plain"`` — the plain PyTorch twin of the kernel the route uses (auto
  on the CPU; on a CUDA device only when asked for, to compare against the
  kernel);
* ``"sphere_kernel"`` — the reference integrator ``trace_path`` with K1
  as its closest-hit step every bounce (``ops/hit.py``
  ``closest_hit_spheres``), the JAX package's auto route for ``path``
  scenes off the TPU;
* ``"reference"`` (also ``"xla"``, the JAX package's name) — the
  reference integrators in plain PyTorch (``ops/integrator.py``), chunked
  over pixels; their draws are Philox keyed by (pixel, sample, bounce,
  stream), so an image does not depend on the chunk size.

The entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``).  Unlike the JAX package there is no
fallback: a kernel that fails to build or launch raises, ``device="cuda"``
without a card raises, and nothing moves to the CPU or to the plain version
on its own.  Which route a scene takes is decided from its features before
anything runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import camera
from .config import CameraParams, RenderConfig, derive_camera
from .ops import rng
from .ops._cuda import device as _device
from .ops.hit import sphere_kernel_eligible
from .ops.integrator import IntegratorOptions, n_media, trace_mis, trace_path
from .ops.megakernel import kernel_gap, megakernel_eligible
from .scene import Scene

KERNEL_BACKENDS = ("wavefront", "megakernel", "plain")
REFERENCE_BACKENDS = ("sphere_kernel", "reference")
BACKENDS = KERNEL_BACKENDS + REFERENCE_BACKENDS + ("xla",)

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


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def resolve_backend(scene: Scene, integrator: str = "path",
                    backend: str = "auto", device="cuda") -> str:
    """'auto' follows the JAX package's rule (render.py:248-282 there):
    where the CUDA kernels cover the scene (``megakernel.kernel_gap`` is
    None), on a CUDA device ``path`` and image-textured scenes ->
    ``"wavefront"``, other ``mis`` scenes -> ``"megakernel"``, on the CPU
    ``"plain"``; elsewhere ``"sphere_kernel"`` for ``path`` when
    ``sphere_kernel_eligible`` holds, else ``"reference"``.  This is
    routing by the scene's features, not a fallback.  ``"xla"`` names
    ``"reference"``.  A kernel backend asked for by name raises
    ``NotImplementedError`` on a scene it does not cover, and
    ``"sphere_kernel"`` ``ValueError`` off ``path`` or where
    ``sphere_kernel_eligible`` fails;
    ``device="cuda"`` without a card raises ``RuntimeError`` where the
    route depends on the device."""
    if integrator not in ("path", "mis"):
        raise ValueError(f"unknown integrator {integrator!r}")
    if backend == "xla":
        backend = "reference"
    if backend != "auto":
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
        if backend in KERNEL_BACKENDS:
            megakernel_eligible(scene, integrator)
        elif backend == "sphere_kernel" and not (
                integrator == "path" and sphere_kernel_eligible(scene)):
            raise ValueError("backend 'sphere_kernel' takes the 'path' "
                             "integrator on scenes without box primitives "
                             "and with at most 256 quads")
        return backend
    if kernel_gap(scene, integrator) is None:
        if _device(device).type != "cuda":
            return "plain"
        if integrator == "mis" and "image" not in scene.features:
            return "megakernel"
        return "wavefront"
    if integrator == "path" and sphere_kernel_eligible(scene):
        return "sphere_kernel"
    return "reference"


def effective_spp_per_pass(cfg: RenderConfig, backend: str, spp_total: int,
                           n_pix: int) -> int:
    """Samples per pass, with the JAX package's signature and argument
    order (render.py:297 there).  ``cfg.spp_per_pass == 0`` means AUTO: on
    the reference and sphere_kernel routes 16 (the JAX package's XLA rule:
    launches are not their cost, memory is), on the kernel routes samples
    folded into passes of up to 64 Mi rays (at most 1024 spp, at least
    32); an explicit value is honored exactly."""
    base = cfg.spp_per_pass
    explicit = base > 0
    if not explicit:
        base = _DEFAULT_SPP_PER_PASS
    if backend in REFERENCE_BACKENDS + ("xla",):
        return base
    if explicit:
        return max(1, min(spp_total, base))
    raise_to = min(_PASS_RAY_TARGET // max(n_pix, 1), _PASS_SPP_CAP)
    return max(1, min(spp_total, max(base, raise_to, _PASS_SPP_FLOOR)))


def _draw_source(scene: Scene, integrator: str, seed: int, s_idx,
                 pix: torch.Tensor):
    """The integrators' per-bounce draw source of rays ``pix`` at samples
    ``s_idx``: streams (BOUNCE[, MIS_A], MEDIA...), keyed by (pixel,
    sample, bounce, stream)."""
    key = rng.seed_key(seed)
    head = (rng.STREAM_BOUNCE, rng.STREAM_MIS_A) if integrator == "mis" \
        else (rng.STREAM_BOUNCE,)
    streams = head + tuple(rng.STREAM_MEDIA + g
                           for g in range(-(-n_media(scene) // 4)))

    def draws(bounce: int, n: int) -> torch.Tensor:
        return rng.uniforms(pix, s_idx, bounce, streams, n, key)

    return draws


def _camera_draws(seed: int, s_idx, pix: torch.Tensor) -> torch.Tensor:
    """The camera's 5 uniforms of rays ``pix``: streams (CAMERA, TIME) at
    bounce 0."""
    return rng.uniforms(pix, s_idx, 0, (rng.STREAM_CAMERA, rng.STREAM_TIME),
                        5, rng.seed_key(seed))


def trace_rays(scene: Scene, cam: CameraParams, seed: int, s_idx,
               pix: torch.Tensor, px: torch.Tensor, py: torch.Tensor, *,
               max_depth: int, integrator: str = "path",
               stratified: bool = False, sqrt_spp: int = 0,
               backend: str = "reference", hit_fn=None, cam_draws=None,
               draws=None) -> torch.Tensor:
    """One sample of each ray: absolute sample indices ``s_idx`` (an int,
    or an int tensor [R]) of pixels ``pix`` (flat indices [R]) at
    coordinates px, py (float32): camera rays, then ``trace_path`` or
    ``trace_mis`` (render.py:50-73 there).  Returns the radiance [R, 3].
    Draws: the camera's 5 from Philox streams (CAMERA, TIME) at bounce 0,
    each bounce's from streams (BOUNCE[, MIS_A], MEDIA...), keyed by
    (pixel, sample, bounce, stream).  ``cam_draws`` ([R, 5]) and ``draws``
    (a source ``(bounce, n) -> [R, n]``) replace them, so that a test can
    hand in the JAX package's uniforms."""
    if cam_draws is None:
        cam_draws = _camera_draws(seed, s_idx, pix)
    if draws is None:
        draws = _draw_source(scene, integrator, seed, s_idx, pix)
    o, d, time = camera.generate_rays(
        cam, px, py, cam_draws, camera.strata(s_idx, stratified, sqrt_spp))
    opts = IntegratorOptions(max_depth=max_depth, bg_mode=cam.bg_mode,
                             backend=backend, hit_fn=hit_fn)
    trace = trace_mis if integrator == "mis" else trace_path
    return trace(draws, o, d, time, scene, cam.background, opts)


def trace_rays_diff(scene: Scene, cam: CameraParams, seed: int, s_idx,
                    pix: torch.Tensor, px: torch.Tensor, py: torch.Tensor, *,
                    max_depth: int, integrator: str = "path",
                    stratified: bool = False, sqrt_spp: int = 0,
                    warp: bool = True, cam_draws=None, draws=None):
    """The differentiable path's inner unit (render.py:76-101 there): the
    draws of ``trace_rays`` (and its ``cam_draws``/``draws`` overrides),
    primary rays through ``warp.warped_primary_rays`` (``warp=True`` adds
    the silhouette warp, False is the value-identical plain forward), the
    reference integrators.  The caller tent-splats each sample onto its
    2x2 pixel neighborhood (``splat_terms``).  Returns (radiance * det
    [R, 3], u_w [R, 2])."""
    from .ops.warp import warped_primary_rays

    if cam_draws is None:
        cam_draws = _camera_draws(seed, s_idx, pix)
    if draws is None:
        draws = _draw_source(scene, integrator, seed, s_idx, pix)
    o, d, time, det, u_w = warped_primary_rays(
        scene, cam, px, py, cam_draws,
        camera.strata(s_idx, stratified, sqrt_spp), warp=warp)
    opts = IntegratorOptions(max_depth=max_depth, bg_mode=cam.bg_mode)
    trace = trace_mis if integrator == "mis" else trace_path
    rad = trace(draws, o, d, time, scene, cam.background, opts)
    return rad * det[:, None], u_w


def splat_terms(px, py, u_w, valid, width: int, height: int):
    """The tent splat of a sample at pixel (px, py) + jitter ``u_w`` as four
    (flat pixel index [R], weight [R]) pairs (render.py:104-119 there).
    Neighbors outside the image clamp to the border pixel, which keeps the
    energy; ``valid`` (0/1 float) zeroes padding lanes."""
    from .ops.warp import splat_weights

    ix = px.to(torch.int64)
    iy = py.to(torch.int64)
    dx, dy, w00, w10, w01, w11 = splat_weights(u_w)
    nx = torch.clamp(ix + dx, 0, width - 1)
    ny = torch.clamp(iy + dy, 0, height - 1)
    return ((iy * width + ix, w00 * valid),
            (iy * width + nx, w10 * valid),
            (ny * width + ix, w01 * valid),
            (ny * width + nx, w11 * valid))


def _render_pass_reference(scene: Scene, cam: CameraParams, seed: int, *,
                           width: int, height: int, spp: int,
                           max_depth: int, integrator: str = "path",
                           chunk: int = 65536, stratified: bool = False,
                           sqrt_spp: int = 0, sample_offset: int = 0,
                           backend: str = "reference", hit_fn=None,
                           device="cuda") -> torch.Tensor:
    """The reference and sphere_kernel routes' pass (``_render_pass_xla``,
    render.py:185-232 there): ``spp`` samples of every pixel, in chunks of
    ``chunk`` pixels (at most the image, rounded up to 256), each chunk's
    samples traced as one batch of spp x chunk rays and summed in sample
    order; returns the radiance SUM [H, W, 3].  So a pass launches K1
    max_depth times per chunk.  ``hit_fn`` replaces K1 on the
    sphere_kernel route (``hit.sphere_hit_plain``, to compare the kernel
    with its twin)."""
    dev = _device(device)
    scene = _scene_on(scene, dev)
    n_pix = width * height
    chunk = min(chunk, _ceil_to(n_pix, 256))
    n_pad = _ceil_to(n_pix, chunk)
    pix = torch.arange(n_pad, dtype=torch.int64, device=dev)
    px_all = (pix % width).to(torch.float32)
    py_all = torch.clamp(pix // width, max=height - 1).to(torch.float32)
    samples = torch.arange(sample_offset, sample_offset + spp,
                           dtype=torch.int64, device=dev)
    accum = torch.zeros((n_pad, 3), dtype=torch.float32, device=dev)
    for lo in range(0, n_pad, chunk):
        sl = slice(lo, lo + chunk)

        def rep(x):  # [chunk] -> [spp * chunk], sample-major
            return x.repeat(spp)

        rad = trace_rays(
            scene, cam, seed, samples.repeat_interleave(chunk), rep(pix[sl]),
            rep(px_all[sl]), rep(py_all[sl]), max_depth=max_depth,
            integrator=integrator, stratified=stratified, sqrt_spp=sqrt_spp,
            backend=backend, hit_fn=hit_fn).reshape(spp, chunk, 3)
        for s in range(spp):
            accum[sl] += rad[s]
    return accum[:n_pix].reshape(height, width, 3)


def _scene_on(scene: Scene, dev) -> Scene:
    """The scene with every tensor on ``dev`` (the kernel routes upload
    their own tables)."""
    if scene.sph_center.device == dev:
        return scene
    return dataclasses.replace(scene, **{
        f.name: getattr(scene, f.name).to(dev)
        for f in dataclasses.fields(scene) if f.name != "features"})


def render_pass(scene: Scene, cam: CameraParams, seed: int, *, width: int,
                height: int, spp: int, max_depth: int,
                integrator: str = "path", sample_offset: int = 0,
                stratified: bool = False, sqrt_spp: int = 0,
                backend: str = "auto", device="cuda", chunk: int = 65536,
                stats: Optional[dict] = None) -> torch.Tensor:
    """Trace ``spp`` samples per pixel, absolute sample indices
    ``sample_offset + [0, spp)`` (stratified over a ``sqrt_spp`` grid when
    asked); returns the RGB radiance SUM [H, W, 3] as a float32 tensor on
    ``device``.  ``chunk`` is the reference routes' pixels per chunk;
    ``stats`` receives the persist loop's counts (sorted route only).

    ``backend`` defaults to ``"auto"``, where the JAX package's
    ``render_pass`` defaults to ``"xla"``: here "auto" takes the kernel
    route on a card and the plain twins on the CPU, so a call without a
    backend runs the port's fast path; pass ``backend="reference"`` (or
    ``"xla"``) for the JAX default's route."""
    from .ops import megakernel as mk
    from .ops import wavefront as wf

    dev = _device(device)
    backend = resolve_backend(scene, integrator, backend, dev)
    if backend in REFERENCE_BACKENDS:
        return _render_pass_reference(
            scene, cam, seed, width=width, height=height, spp=spp,
            max_depth=max_depth, integrator=integrator, chunk=chunk,
            stratified=stratified, sqrt_spp=sqrt_spp,
            sample_offset=sample_offset, backend=backend, device=dev)
    plain = backend == "plain"
    return wf.render_pass_wavefront(
        scene, cam, seed, width=width, height=height, spp=spp,
        max_depth=max_depth, sample_offset=sample_offset,
        mis=integrator == "mis", stratified=stratified, sqrt_spp=sqrt_spp,
        step=wf.persist_step_plain if plain else wf.persist_step,
        respawn_step=mk.respawn_pass_plain if plain else mk.respawn_pass,
        device=dev, stats=stats)


def samples_total(cfg: RenderConfig) -> int:
    """Samples a pixel a full render traces: floor(sqrt(spp))^2 when
    stratified (render.py:351-353 there), else spp."""
    if cfg.stratified:
        return int(np.sqrt(cfg.samples_per_pixel)) ** 2
    return cfg.samples_per_pixel


def render_passes(cfg: RenderConfig, pass_fn, per_pass: int, *,
                  unit: int = 1, progress=None,
                  accum_state: Optional[dict] = None, on_pass=None,
                  device="cuda"):
    """The host pass loop of every full render (``render_image`` and the
    sharded loops of ``parallel``; render.py:351-380 there).
    ``pass_fn(spp, sample_offset, stratified, sqrt_spp)`` traces one pass
    of ``spp`` samples a pixel from absolute sample ``sample_offset``,
    rounded up to a multiple of ``unit``, and returns its radiance sum
    [H, W, 3] on the device; a pass takes at most ``per_pass`` samples (a
    multiple of ``unit``).  A stratified config renders
    floor(sqrt(spp))^2 samples.  ``accum_state`` from an earlier call
    resumes the accumulation; ``progress(done, total)`` and
    ``on_pass({"accum": a CPU copy of the running sum, "spp_done": n})``
    fire after every pass.  Returns (image_u8 [H, W, 3], {"accum": sum
    [H, W, 3], "spp_done": n})."""
    dev = _device(device)
    h, w = cfg.image_height, cfg.image_width
    stratified = cfg.stratified
    sqrt_spp = int(np.sqrt(cfg.samples_per_pixel)) if stratified else 0
    spp_total = samples_total(cfg)
    if accum_state is None:
        accum = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
        done = 0
    else:
        accum = torch.as_tensor(np.asarray(accum_state["accum"], np.float32),
                                device=dev)
        done = int(accum_state["spp_done"])
    while done < spp_total:
        this = min(per_pass, _ceil_to(spp_total - done, unit))
        accum = accum + pass_fn(this, done, stratified, sqrt_spp)
        done += _ceil_to(this, unit)
        if progress is not None:
            progress(done, spp_total)
        if on_pass is not None:
            # a host copy, as the JAX package hands over an array that
            # np.asarray reads; made only for a callback
            on_pass({"accum": accum.to("cpu", copy=True), "spp_done": done})
    accum_np = accum.cpu().numpy()
    return finalize_image(accum_np, done), {"accum": accum_np,
                                            "spp_done": done}


def render_image(scene: Scene, cfg: RenderConfig, *,
                 integrator: str = "path", chunk: int = 65536, progress=None,
                 accum_state: Optional[dict] = None, backend: str = "auto",
                 on_pass=None, device="cuda"):
    """Full render: host pass loop over spp batches (``render_passes``).
    Returns (image_u8 [H, W, 3], {"accum": sum [H, W, 3], "spp_done": n});
    ``accum_state`` from an earlier call resumes the accumulation.  A
    stratified config renders floor(sqrt(spp))^2 samples (render.py:351-353
    there).  ``chunk``: pixels per chunk on the reference routes (at most
    the image, rounded up to 256).  ``on_pass``, when given, receives
    {"accum": a CPU copy of the running sum, "spp_done": n} after every
    pass."""
    dev = _device(device)
    backend = resolve_backend(scene, integrator, backend, dev)
    cam = derive_camera(cfg, device=dev)
    h, w = cfg.image_height, cfg.image_width
    chunk = min(chunk, _ceil_to(h * w, 256))

    def one_pass(spp, sample_offset, stratified, sqrt_spp):
        return render_pass(
            scene, cam, cfg.seed, width=w, height=h, spp=spp,
            max_depth=cfg.max_depth, integrator=integrator,
            sample_offset=sample_offset, stratified=stratified,
            sqrt_spp=sqrt_spp, backend=backend, device=dev, chunk=chunk)

    return render_passes(
        cfg, one_pass,
        effective_spp_per_pass(cfg, backend, samples_total(cfg), h * w),
        progress=progress, accum_state=accum_state, on_pass=on_pass,
        device=dev)
