"""Material scattering, every branch computed and the ray's material
selected (counterpart: ``rustraytrace_tpu/ops/materials.py``; the
reference's ``MaterialObject::scatter``, src/books/*/material.rs).

Lambertian ``n + random_unit_vector`` with the near-zero guard; metal
``reflect(unit d, n) + fuzz * ruv``, absorbed below the surface in books
1-2; dielectric Snell with total internal reflection and a stochastic
Schlick choice; diffuse light emits (front faces only in book 3);
isotropic scatters uniformly.
"""

from __future__ import annotations

import dataclasses

import torch

from ..scene import DIELECTRIC, DIFFUSE_LIGHT, LAMBERTIAN, METAL, Scene
from . import rng
from .intersect import HitRecord
from .rng import dot, sqrt
from .textures import texture_value


def reflect(v, n):
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """vec3.rs:205-210; the 1e-12 floor is the JAX package's NaN guard."""
    cos_theta = torch.clamp(dot(-uv, n)[..., None], max=1.0)
    r_out_perp = etai_over_etat * (uv + cos_theta * n)
    r_out_parallel = -sqrt(torch.clamp(
        torch.abs(1.0 - dot(r_out_perp, r_out_perp)[..., None]),
        min=1e-12)) * n
    return r_out_perp + r_out_parallel


def schlick(cosine, ref_idx):
    """material.rs:107-111."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


@dataclasses.dataclass
class ScatterResult:
    direction: torch.Tensor  # [R, 3]
    attenuation: torch.Tensor  # [R, 3]
    emitted: torch.Tensor  # [R, 3]
    scattered: torch.Tensor  # [R] bool: the path goes on
    specular: torch.Tensor  # [R] bool: metal or dielectric (book 3)
    is_lambertian: torch.Tensor  # [R] bool (cosine pdf, for MIS)


@dataclasses.dataclass
class MatRecord:
    """Material of each ray's hit: kind, texture-evaluated albedo (also
    the emission), fuzz, ior."""

    kind: torch.Tensor  # [R] int
    albedo: torch.Tensor  # [R, 3]
    fuzz: torch.Tensor  # [R]
    ior: torch.Tensor  # [R]


def gather_mat(scene: Scene, rec: HitRecord) -> MatRecord:
    """Gather the hit material's parameters and evaluate its texture."""
    m = rec.mat.long()
    return MatRecord(
        kind=scene.mat_kind[m],
        albedo=texture_value(scene.mat_tex[m], rec.u, rec.v, rec.p, scene),
        fuzz=scene.mat_fuzz[m],
        ior=scene.mat_ior[m])


def scatter(d_in: torch.Tensor, rec: HitRecord, mat: MatRecord,
            draws: torch.Tensor, emit_front_only: bool,
            metal_absorb: bool = True) -> ScatterResult:
    """Every material's scatter for rays d_in [R, 3] at hits ``rec``;
    draws [R, 3]: (u1, u2) of the shared random unit vector and the
    dielectric's reflect-or-refract uniform.  ``metal_absorb``: books 1-2
    absorb metal rays scattered below the surface (material.rs:53-64);
    book 3 does not."""
    kind, n, tex = mat.kind, rec.normal, mat.albedo
    ruv = rng.unit_vector(draws[:, 0], draws[:, 1])
    unit_d = rng.normalize(d_in)

    lam_dir = n + ruv
    lam_dir = torch.where((dot(lam_dir, lam_dir) < 1e-16)[:, None], n,
                          lam_dir)

    met_dir = reflect(unit_d, n) + mat.fuzz[:, None] * ruv
    met_ok = dot(met_dir, n) > 0.0

    ri = torch.where(rec.front_face, 1.0 / mat.ior, mat.ior)
    cos_theta = torch.clamp(dot(-unit_d, n), max=1.0)
    sin_theta = sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = ri * sin_theta > 1.0
    p_reflect = torch.where(cannot_refract, 1.0, schlick(cos_theta, ri))
    reflect_choice = p_reflect > draws[:, 2]
    die_dir = torch.where(reflect_choice[:, None], reflect(unit_d, n),
                          refract(unit_d, n, ri[:, None]))
    # the JAX package's likelihood-ratio weight p / detach(p): exactly 1 in
    # value, the probability's derivative for gradients
    p_c = torch.clamp(p_reflect, 1e-3, 1.0 - 1e-3)
    die_w = torch.where(reflect_choice, p_c / p_c.detach(),
                        (1.0 - p_c) / (1.0 - p_c).detach())

    is_light = kind == DIFFUSE_LIGHT
    gate = rec.front_face if emit_front_only else torch.ones_like(
        rec.front_face)
    emitted = torch.where((is_light & gate & rec.valid)[:, None], tex, 0.0)

    is_lam = kind == LAMBERTIAN
    is_met = kind == METAL
    is_die = kind == DIELECTRIC
    direction = torch.where(is_lam[:, None], lam_dir, ruv)  # isotropic: ruv
    direction = torch.where(is_met[:, None], met_dir, direction)
    direction = torch.where(is_die[:, None], die_dir, direction)
    attenuation = torch.where(is_die[:, None], die_w[:, None], tex)
    scattered = rec.valid & ~is_light
    if metal_absorb:
        scattered = scattered & (~is_met | met_ok)
    return ScatterResult(direction=direction, attenuation=attenuation,
                         emitted=emitted, scattered=scattered,
                         specular=is_met | is_die, is_lambertian=is_lam)
