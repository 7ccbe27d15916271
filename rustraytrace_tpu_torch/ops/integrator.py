"""Path-tracing integrators as fixed-depth masked bounce loops
(counterpart: ``rustraytrace_tpu/ops/integrator.py``).

The reference's recursive ``ray_color`` (in_one_weekend/camera.rs:182-209,
the_next_week/camera.rs:174-201) becomes a loop over ``max_depth``
bounces carrying (origin, direction, attenuation, radiance, alive); dead
rays are masked, not removed.  Russian roulette from bounce 5 with
p = clamp(max channel of the running attenuation, 0.05, 0.95)
(renderer.wgsl:225-231).  ``trace_mis`` is book 3's NEE/MIS estimator
(the_rest_of_your_life/camera.rs:184-254): emission plus a specular
skip-pdf branch, else a 50/50 mixture of the light pdf and the material
pdf, with the roulette folded into the weight.

The integrators take their uniforms from a draw source ``draws(bounce,
n) -> [R, n]`` with the JAX package's layout: 4 + n_media columns a
bounce for ``trace_path`` (scatter u1, u2, the dielectric's choice, the
roulette, then one per medium), 8 + n_media for ``trace_mis`` (the same
four, then the mixture choice, the light pick, two for the material or
light direction, then the media).  The render path draws them with Philox
(``rng.uniforms``); a test can hand in the JAX package's own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..config import BG_SKY
from ..scene import LIGHT_QUAD, Scene
from . import rng
from .intersect import T_MAX, T_MIN, closest_hit, sphere_roots
from .materials import gather_mat, scatter
from .rng import cross, dot, sqrt

_PI = 3.14159265358979

RR_START_BOUNCE = 5  # renderer.wgsl:225 / camera.rs:189
RR_P_MIN = 0.05
RR_P_MAX = 0.95


@dataclasses.dataclass(frozen=True)
class IntegratorOptions:
    """The JAX package's options less the two no caller sets there
    (``emit_front_only``: off for ``trace_path``, on for ``trace_mis``;
    ``rr_from_running_product``: on)."""

    max_depth: int
    bg_mode: int  # config.BG_SKY | config.BG_FLAT
    # "reference": intersect.closest_hit; "sphere_kernel": hit.closest_hit_
    # spheres, whose closest-hit step is K1 (``hit_fn`` replaces it)
    backend: str = "reference"
    hit_fn: Optional[Callable] = None


def n_media(scene: Scene) -> int:
    return scene.msph_center.shape[0] + scene.mbox_cos.shape[0]


def sky_color(d: torch.Tensor) -> torch.Tensor:
    """lerp((1, 1, 1) -> (0.5, 0.7, 1.0)) on unit-direction y
    (camera.rs:206-208)."""
    a = 0.5 * (rng.normalize(d)[:, 1] + 1.0)
    white = torch.tensor([1.0, 1.0, 1.0], dtype=d.dtype, device=d.device)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
    return (1.0 - a)[:, None] * white + a[:, None] * blue


def _background(d, scene_bg, bg_mode):
    if bg_mode == BG_SKY:
        return sky_color(d)
    return scene_bg[None, :].expand_as(d)


def _init(o):
    R = o.shape[0]
    return (torch.ones((R, 3), dtype=o.dtype, device=o.device),
            torch.zeros((R, 3), dtype=o.dtype, device=o.device),
            torch.ones(R, dtype=torch.bool, device=o.device))


def trace_path(draws, o, d, time, scene: Scene, background,
               opts: IntegratorOptions) -> torch.Tensor:
    """Books 1 and 2: o, d [R, 3], time [R] -> radiance [R, 3]."""
    nm = n_media(scene)
    kernel = opts.backend == "sphere_kernel"
    if kernel:
        from .hit import closest_hit_spheres, sphere_kernel_tables

        tables = sphere_kernel_tables(scene)
    atten, radiance, alive = _init(o)
    for bounce in range(opts.max_depth):
        u = draws(bounce, 4 + nm)
        if kernel:
            rec, mat = closest_hit_spheres(o, d, time, scene,
                                           u_media=u[:, 4:], tables=tables,
                                           hit_fn=opts.hit_fn)
        else:
            rec = closest_hit(o, d, time, scene, u[:, 4:])
            mat = gather_mat(scene, rec)
        # miss -> background, the path ends (camera.rs:206-208)
        bg = _background(d, background, opts.bg_mode)
        radiance = radiance + torch.where((alive & ~rec.valid)[:, None],
                                          atten * bg, 0.0)
        sc = scatter(d, rec, mat, u[:, 0:3], emit_front_only=False)
        radiance = radiance + torch.where((alive & rec.valid)[:, None],
                                          atten * sc.emitted, 0.0)
        new_alive = alive & rec.valid & sc.scattered
        new_atten = atten * sc.attenuation
        # Russian roulette on the running product (renderer.wgsl:225-231);
        # the survival probability is a sampling decision, so detached: the
        # gradient flows through the continuous factors only
        p = torch.clamp(torch.amax(new_atten, dim=-1), RR_P_MIN,
                        RR_P_MAX).detach()
        if bounce >= RR_START_BOUNCE:
            new_alive = new_alive & (u[:, 3] <= p)
            new_atten = torch.where(new_alive[:, None],
                                    new_atten / p[:, None], new_atten)
        o = torch.where(new_alive[:, None], rec.p, o)
        d = torch.where(new_alive[:, None], sc.direction, d)
        atten, alive = new_atten, new_alive
    # paths alive after max_depth add nothing more (camera.rs:183-185)
    return radiance


def _light_pdf_value(p, d, scene: Scene):
    """Mean over the active lights of each light's pdf of direction d
    [R, 3] from p [R, 3] (hittable_list.rs:60-69) -> [R]."""
    d_len2 = dot(d, d)
    d_len = sqrt(d_len2)
    total = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    n_active = torch.clamp(torch.sum(scene.light_mask), min=1.0)
    for l in range(scene.light_kind.shape[0]):
        # quad pdf (quad.rs:93-102)
        q, u, v = scene.light_q[l], scene.light_u[l], scene.light_v[l]
        n = cross(u, v)
        nn = torch.clamp(dot(n, n), min=1e-30)
        area = sqrt(nn)
        normal = n / area
        w = n / nn
        dplane = dot(normal, q)
        denom = dot(normal[None, :], d)
        safe = torch.where(torch.abs(denom) < 1e-8, 1.0, denom)
        t = (dplane - dot(normal[None, :], p)) / safe
        rel = p + t[:, None] * d - q[None, :]
        alpha = dot(w[None, :], cross(rel, v[None, :]))
        beta = dot(w[None, :], cross(u[None, :], rel))
        qhit = ((torch.abs(denom) >= 1e-8) & (t >= T_MIN) & (t <= T_MAX)
                & (alpha >= 0) & (alpha <= 1) & (beta >= 0) & (beta <= 1))
        cosine = torch.abs(denom) / torch.clamp(d_len, min=1e-30)
        qpdf = torch.where(qhit, t * t * d_len2 / torch.clamp(
            cosine * area, min=1e-30), 0.0)
        # sphere solid-angle pdf (sphere.rs:102-115)
        ctr = scene.light_center[l]
        rad = scene.light_radius[l]
        t_near, t_far, has = sphere_roots(
            p, d, ctr.expand(p.shape[0], 1, 3), rad[None, None])
        root = torch.where(t_near[:, 0] > T_MIN, t_near[:, 0], t_far[:, 0])
        shit = has[:, 0] & (root > T_MIN) & (root < T_MAX)
        to_c = ctr[None, :] - p
        dist2 = dot(to_c, to_c)
        cos_max = sqrt(torch.clamp(
            1.0 - rad * rad / torch.clamp(dist2, min=1e-30), min=0.0))
        solid_angle = 2.0 * _PI * (1.0 - cos_max)
        spdf = torch.where(shit, 1.0 / torch.clamp(solid_angle, min=1e-30),
                           0.0)
        pdf_l = torch.where(scene.light_kind[l] == LIGHT_QUAD, qpdf, spdf)
        total = total + scene.light_mask[l] * pdf_l
    return total / n_active


def _light_sample(p, scene: Scene, draws):
    """Direction from p [R, 3] toward a uniformly picked active light
    (hittable_list.rs:71-75); draws [R, 3]: (pick, u1, u2)."""
    n_active = torch.clamp(torch.sum(scene.light_mask), min=1.0)
    # active lights lead the table (SceneBuilder invariant)
    pick = torch.minimum((draws[:, 0] * n_active).to(torch.int64),
                         (n_active - 1).to(torch.int64))
    u1, u2 = draws[:, 1], draws[:, 2]
    # quad: q + u1 u + u2 v - p (quad.rs:104-107)
    quad_dir = (scene.light_q[pick] + u1[:, None] * scene.light_u[pick]
                + u2[:, None] * scene.light_v[pick] - p)
    # sphere cone (sphere.rs:117-122)
    to_center = scene.light_center[pick] - p
    dist2 = torch.clamp(dot(to_center, to_center), min=1e-30)
    local = rng.to_sphere(u1, u2, scene.light_radius[pick], dist2)
    bu, bv, bw = rng.onb_from_w(to_center)
    sph_dir = rng.onb_transform(bu, bv, bw, local)
    is_quad = scene.light_kind[pick] == LIGHT_QUAD
    return torch.where(is_quad[:, None], quad_dir, sph_dir)


def trace_mis(draws, o, d, time, scene: Scene, background,
              opts: IntegratorOptions) -> torch.Tensor:
    """Book 3 (the_rest_of_your_life/camera.rs:184-254): o, d [R, 3], time
    [R] -> radiance [R, 3]."""
    R = o.shape[0]
    nm = n_media(scene)
    atten, radiance, alive = _init(o)
    sphere_pdf = torch.full((R,), 1.0 / (4.0 * _PI), dtype=o.dtype,
                            device=o.device)
    for bounce in range(opts.max_depth):
        u = draws(bounce, 8 + nm)
        rec = closest_hit(o, d, time, scene, u[:, 8:])
        bg = _background(d, background, opts.bg_mode)
        radiance = radiance + torch.where((alive & ~rec.valid)[:, None],
                                          atten * bg, 0.0)
        mat = gather_mat(scene, rec)
        sc = scatter(d, rec, mat, u[:, 0:3], emit_front_only=True,
                     metal_absorb=False)
        radiance = radiance + torch.where((alive & rec.valid)[:, None],
                                          atten * sc.emitted, 0.0)
        alive_hit = alive & rec.valid & sc.scattered
        # book-3 roulette: p from the per-hit attenuation, both branches
        p_rr = torch.clamp(torch.amax(sc.attenuation, dim=-1), RR_P_MIN,
                           RR_P_MAX).detach()
        rr_prob = p_rr if bounce >= RR_START_BOUNCE else torch.ones_like(p_rr)
        alive_hit = alive_hit & (u[:, 3] <= rr_prob)
        spec_weight = sc.attenuation / rr_prob[:, None]
        # diffuse: 50/50 mixture of the light pdf and the material pdf
        mat_local = rng.cosine_direction(u[:, 6], u[:, 7])
        bu, bv, bw = rng.onb_from_w(rec.normal)
        cos_dir = rng.onb_transform(bu, bv, bw, mat_local)
        iso_dir = rng.unit_vector(u[:, 6], u[:, 7])
        mat_dir = torch.where(sc.is_lambertian[:, None], cos_dir, iso_dir)
        light_dir = _light_sample(rec.p, scene, u[:, 5:8])
        use_light = u[:, 4] < 0.5  # MixturePdf::generate (pdf.rs:93-99)
        diff_dir = torch.where(use_light[:, None], light_dir, mat_dir)
        unit_diff = diff_dir / torch.clamp(
            sqrt(dot(diff_dir, diff_dir)), min=1e-30)[:, None]
        cos_theta = dot(rec.normal, unit_diff)
        cosine_pdf = torch.clamp(cos_theta, min=0.0) / _PI  # pdf.rs:41-49
        mat_pdf = torch.where(sc.is_lambertian, cosine_pdf, sphere_pdf)
        light_pdf = _light_pdf_value(rec.p, diff_dir, scene)
        # the mixture density samples the direction: detached, while the
        # scattering pdf below stays attached (pdf.rs:88-91)
        pdf_value = (0.5 * light_pdf + 0.5 * mat_pdf).detach()
        # scattering pdf == material pdf (material.rs:63-70, 187-189)
        diff_weight = (sc.attenuation * mat_pdf[:, None]
                       / torch.clamp(pdf_value * rr_prob, min=1e-30)[:, None])
        new_dir = torch.where(sc.specular[:, None], sc.direction, diff_dir)
        weight = torch.where(sc.specular[:, None], spec_weight, diff_weight)
        alive_next = alive_hit & (sc.specular | (pdf_value > 0.0))
        atten = torch.where(alive_next[:, None], atten * weight, atten)
        o = torch.where(alive_next[:, None], rec.p, o)
        d = torch.where(alive_next[:, None], new_dir, d)
        alive = alive_next
    return radiance
