"""Camera rays from uniforms (counterpart: ``rustraytrace_tpu/camera.py``).

``Camera::get_ray`` of the reference (in_one_weekend/camera.rs:152-180): a
jittered sub-pixel sample, or book 3's stratified one
(the_rest_of_your_life/camera.rs:156-177), an optional defocus-disk origin,
a direction that is not normalized, and a ray time uniform in [0, 1)
(the_next_week/camera.rs:160-162).
"""

from __future__ import annotations

import torch

from .config import CameraParams
from .ops import rng


def strata(s_idx, stratified: bool, sqrt_spp: int):
    """(s_i, s_j, sqrt_spp) of absolute sample indices ``s_idx`` (an int
    or an int tensor) on the sqrt_spp x sqrt_spp grid, or None
    unstratified (render.py:36-47 of the JAX package: the index wraps into
    the grid)."""
    if not stratified:
        return None
    s_idx = s_idx % (sqrt_spp * sqrt_spp)
    if isinstance(s_idx, torch.Tensor):
        return ((s_idx % sqrt_spp).to(torch.float32),
                (s_idx // sqrt_spp).to(torch.float32), float(sqrt_spp))
    return (float(s_idx % sqrt_spp), float(s_idx // sqrt_spp),
            float(sqrt_spp))


def generate_rays(cam: CameraParams, px: torch.Tensor, py: torch.Tensor,
                  draws: torch.Tensor, strat=None):
    """px, py: [R] pixel coordinates (column, row) as float32; draws:
    [R, 5] uniforms (jitter x, jitter y, disk u1, disk u2, time); strat:
    None or ``strata(...)``.  Returns (origin [R, 3], direction [R, 3],
    time [R])."""
    if strat is None:
        ox = draws[:, 0] - 0.5
        oy = draws[:, 1] - 0.5
    else:
        s_i, s_j, sqrt_spp = strat
        recip = 1.0 / sqrt_spp
        ox = (s_i + draws[:, 0]) * recip - 0.5
        oy = (s_j + draws[:, 1]) * recip - 0.5
    pixel_sample = (cam.pixel00[None, :]
                    + (px + ox)[:, None] * cam.pixel_delta_u[None, :]
                    + (py + oy)[:, None] * cam.pixel_delta_v[None, :])
    if cam.lens_radius_gt0:
        disk = rng.in_unit_disk(draws[:, 2], draws[:, 3])
        origin = (cam.center[None, :]
                  + disk[:, 0:1] * cam.defocus_disk_u[None, :]
                  + disk[:, 1:2] * cam.defocus_disk_v[None, :])
    else:
        origin = cam.center[None, :].expand_as(pixel_sample)
    return origin, pixel_sample - origin, draws[:, 4]
