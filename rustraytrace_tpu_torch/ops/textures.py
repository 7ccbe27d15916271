"""Texture evaluation, every kind computed and the ray's kind selected
(counterpart: ``rustraytrace_tpu/ops/textures.py``; the reference's
``TextureObject::value``, the_next_week/texture.rs:159-168).  The scene's
feature flags skip kinds it does not use."""

from __future__ import annotations

import torch

from ..scene import TEX_CHECKER, TEX_IMAGE, TEX_NOISE, Scene
from . import perlin


def image_texel(scene: Scene, img_id: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """Nearest texel at clamped (u, v), v flipped (texture.rs:89-109); any
    matching batch shape -> [..., 3]."""
    img_id = img_id.to(torch.int64)
    hw = scene.image_hw.to(torch.int64)[img_id]
    h = hw[..., 0].to(u.dtype)
    w = hw[..., 1].to(u.dtype)
    uc = torch.clamp(u, 0.0, 1.0)
    vc = 1.0 - torch.clamp(v, 0.0, 1.0)
    i = torch.minimum((uc * w).to(torch.int64), hw[..., 1] - 1)
    j = torch.minimum((vc * h).to(torch.int64), hw[..., 0] - 1)
    ih, iw = scene.images.shape[1], scene.images.shape[2]
    return scene.images.reshape(-1, 3)[(img_id * ih + j) * iw + i]


def texture_value(tex_id: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  p: torch.Tensor, scene: Scene) -> torch.Tensor:
    """Albedo of textures ``tex_id`` [R] at (u, v) [R] and p [R, 3]."""
    tex_id = tex_id.to(torch.int64)
    kind = scene.tex_kind[tex_id]
    c1 = scene.tex_color1[tex_id]
    value = c1  # TEX_SOLID (texture.rs:33-37)
    if "checker" in scene.features:
        # 3-D lattice parity (texture.rs:63-77)
        inv_scale = scene.tex_inv_scale[tex_id][:, None]
        cell = torch.floor(inv_scale * p).to(torch.int64)
        even = (cell[:, 0] + cell[:, 1] + cell[:, 2]) % 2 == 0
        checker = torch.where(even[:, None], c1, scene.tex_color2[tex_id])
        value = torch.where((kind == TEX_CHECKER)[:, None], checker, value)
    if "image" in scene.features:
        texel = image_texel(scene, scene.tex_image[tex_id], u, v)
        value = torch.where((kind == TEX_IMAGE)[:, None], texel, value)
    if "noise" in scene.features:
        # marble: 0.5 (1 + sin(scale z + 10 turb(p, 7))) (texture.rs:122-126)
        t = perlin.turb(p, scene.perlin_randvec, scene.perlin_perm, depth=7)
        marble = 0.5 * (1.0 + torch.sin(
            scene.tex_noise_scale[tex_id] * p[:, 2] + 10.0 * t))
        value = torch.where((kind == TEX_NOISE)[:, None], marble[:, None],
                            value)
    return value
