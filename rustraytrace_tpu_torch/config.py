"""Render configuration and camera derivation (counterpart:
``rustraytrace_tpu/config.py``).

``RenderConfig`` keeps the reference's eleven camera/render fields plus the
execution knobs of the JAX package, with the same names and defaults.
``derive_camera`` runs the same float64 NumPy math as the JAX package
(``src/books/in_one_weekend/camera.rs:102-150`` of the reference) and only
the final cast differs: float32 tensors on ``device`` instead of jnp arrays,
so the two packages' cameras are bit-equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

# Background modes: 0 selects the sky gradient, 1 a flat color.
BG_SKY = 0
BG_FLAT = 1


@dataclasses.dataclass
class RenderConfig:
    """User-facing render settings (the reference's 11 fields + knobs)."""

    aspect_ratio: float = 1.0
    image_width: int = 100
    samples_per_pixel: int = 10
    max_depth: int = 10
    vfov: float = 90.0
    lookfrom: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    lookat: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    vup: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    defocus_angle: float = 0.0
    focus_dist: float = 10.0
    # None => sky-gradient miss shading (book 1); a color => flat background
    background: Optional[Tuple[float, float, float]] = None
    # Samples per pass; 0 = AUTO (see render.effective_spp_per_pass).
    spp_per_pass: int = 0
    # Stratified sqrt(spp) x sqrt(spp) sub-pixel sampling (book 3).
    stratified: bool = False
    seed: int = 0

    @property
    def image_height(self) -> int:
        h = int(self.image_width / self.aspect_ratio)
        return max(h, 1)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class CameraParams:
    """Derived camera uniforms: float32 [3] tensors plus static fields."""

    center: torch.Tensor
    pixel00: torch.Tensor
    pixel_delta_u: torch.Tensor
    pixel_delta_v: torch.Tensor
    defocus_disk_u: torch.Tensor
    defocus_disk_v: torch.Tensor
    background: torch.Tensor  # zeros when bg_mode == BG_SKY
    lens_radius_gt0: bool
    bg_mode: int
    image_width: int
    image_height: int
    # every value above, on the host: what the prepared-table cache keys on
    key: tuple


def derive_camera(cfg: RenderConfig, device,
                  dtype=torch.float32) -> CameraParams:
    """Viewport basis and pixel grid (reference camera.rs:102-150), as
    tensors on ``device``."""
    width = cfg.image_width
    height = cfg.image_height

    lookfrom = np.asarray(cfg.lookfrom, dtype=np.float64)
    lookat = np.asarray(cfg.lookat, dtype=np.float64)
    vup = np.asarray(cfg.vup, dtype=np.float64)

    theta = math.radians(cfg.vfov)
    h = math.tan(theta / 2.0)
    viewport_height = 2.0 * h * cfg.focus_dist
    viewport_width = viewport_height * (width / height)

    w = lookfrom - lookat
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    viewport_u = viewport_width * u
    viewport_v = viewport_height * -v
    pixel_delta_u = viewport_u / width
    pixel_delta_v = viewport_v / height

    viewport_upper_left = lookfrom - cfg.focus_dist * w - viewport_u / 2.0 - viewport_v / 2.0
    pixel00 = viewport_upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

    defocus_radius = cfg.focus_dist * math.tan(math.radians(cfg.defocus_angle / 2.0))
    defocus_disk_u = u * defocus_radius
    defocus_disk_v = v * defocus_radius

    if cfg.background is None:
        bg_mode = BG_SKY
        background = np.zeros(3)
    else:
        bg_mode = BG_FLAT
        background = np.asarray(cfg.background, dtype=np.float64)

    def dev(x):
        # cast in NumPy first: float64 -> float32 rounding identical to jnp
        return torch.as_tensor(np.asarray(x, np.float32), dtype=dtype,
                               device=device)

    vecs = (lookfrom, pixel00, pixel_delta_u, pixel_delta_v, defocus_disk_u,
            defocus_disk_v, background)
    return CameraParams(
        center=dev(lookfrom),
        pixel00=dev(pixel00),
        pixel_delta_u=dev(pixel_delta_u),
        pixel_delta_v=dev(pixel_delta_v),
        defocus_disk_u=dev(defocus_disk_u),
        defocus_disk_v=dev(defocus_disk_v),
        background=dev(background),
        lens_radius_gt0=cfg.defocus_angle > 0.0,
        bg_mode=bg_mode,
        image_width=width,
        image_height=height,
        key=(tuple(np.asarray(vecs, np.float32).reshape(-1).tolist()),
             cfg.defocus_angle > 0.0, bg_mode, width, height),
    )
