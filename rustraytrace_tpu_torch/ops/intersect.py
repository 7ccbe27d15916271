"""Closest hit over every primitive class, as broadcast tensor ops
(counterpart: ``rustraytrace_tpu/ops/intersect.py``).

Every ray tests every primitive of a class ([R, N] tensors), classes are
merged by a running minimum, and the winner's record is built with one
gather per field: the reference's ``Hittable::hit`` dispatch
(``src/books/*/hittable.rs``) recast as the reference GPU megakernel's
brute force (renderer.wgsl:108-155), with quads, boxes and constant media.
Semantics are the reference's f32 path: t in (1e-3, 1e9), the half-b
quadric.  Sums over three components are written out in x, y, z order
(``rng.dot``), so a ray's result does not depend on the batch it is in.
"""

from __future__ import annotations

import dataclasses

import torch

from ..scene import Scene
from .rng import cross, dot, sqrt

T_MIN = 1.0e-3
T_MAX = 1.0e9
_PI = 3.14159265358979

# class tags of the merged winner
CLS_NONE = 0
CLS_SPHERE = 1
CLS_QUAD = 2
CLS_MEDIUM = 3
CLS_BOX = 4


@dataclasses.dataclass
class HitRecord:
    """Per-ray hit record (the_next_week/hittable.rs:15-23)."""

    valid: torch.Tensor  # [R] bool: any hit
    t: torch.Tensor  # [R]
    p: torch.Tensor  # [R, 3]
    normal: torch.Tensor  # [R, 3] unit, against the ray
    front_face: torch.Tensor  # [R] bool
    mat: torch.Tensor  # [R] int64
    u: torch.Tensor  # [R]
    v: torch.Tensor  # [R]


def _full(shape, value, like: torch.Tensor) -> torch.Tensor:
    return torch.full(shape, value, dtype=like.dtype, device=like.device)


def sphere_roots(o, d, center, radius):
    """Both quadric roots (t_near, t_far, has_roots) [R, N] (sphere.rs:
    69-82): o, d [R, 3]; center [R, N, 3] or broadcastable; radius [N] or
    [R, N]."""
    oc = center - o[:, None, :]
    a = dot(d, d)[:, None]
    h = dot(d[:, None, :], oc)
    c = dot(oc, oc) - radius * radius
    disc = h * h - a * c
    has = disc > 0.0
    sqrtd = torch.where(has, sqrt(torch.where(has, disc, 1.0)), 0.0)
    return (h - sqrtd) / a, (h + sqrtd) / a, has


def hit_spheres(o, d, time, scene: Scene, t_min, t_max):
    """Closest sphere: (t [R], idx [R], any [R]).  The expanded quadric of
    the JAX package (its four [R, 3] x [3, N] products, written out here as
    component sums): with cc = center + time cvel, h = d.cc - d.o and
    c = |cc|^2 - 2 o.cc + |o|^2 - r^2."""
    C, V, r = scene.sph_center, scene.sph_cvel, scene.sph_radius

    def prod(x, M):  # [R, 3] x [N, 3]^T -> [R, N]
        return (x[:, 0:1] * M[None, :, 0] + x[:, 1:2] * M[None, :, 1]
                + x[:, 2:3] * M[None, :, 2])

    o2, d_o, a = dot(o, o), dot(d, o), dot(d, d)
    C2 = dot(C, C)
    if "motion" in scene.features:
        tcol = time[:, None]
        h = prod(d, C) + tcol * prod(d, V) - d_o[:, None]
        cc2 = (C2[None, :] + 2.0 * tcol * dot(C, V)[None, :]
               + (tcol * tcol) * dot(V, V)[None, :])
        c = (cc2 - 2.0 * (prod(o, C) + tcol * prod(o, V)) + o2[:, None]
             - (r * r)[None, :])
    else:  # the velocity terms are exact zeros: the same values
        h = prod(d, C) - d_o[:, None]
        c = C2[None, :] - 2.0 * prod(o, C) + o2[:, None] - (r * r)[None, :]
    disc = h * h - a[:, None] * c
    has = disc > 0.0
    sqrtd = torch.where(has, sqrt(torch.where(has, disc, 1.0)), 0.0)
    inv_a = 1.0 / a[:, None]
    t_near = (h - sqrtd) * inv_a
    t_far = (h + sqrtd) * inv_a
    near_ok = (t_near > t_min[:, None]) & (t_near < t_max[:, None])
    root = torch.where(near_ok, t_near, t_far)
    ok = (has & (root > t_min[:, None]) & (root < t_max[:, None])
          & (scene.sph_mask[None, :] > 0))
    # torch.min keeps the first index of the minimum, as jnp.argmin
    best, idx = torch.min(torch.where(ok, root, T_MAX), dim=-1)
    return best, idx, ok.any(dim=-1)


def hit_quads(o, d, scene: Scene, t_min, t_max):
    """Closest quad: (t [R], idx [R], any [R]) (quad.rs:64-87)."""
    w, normal, dplane, _ = scene.quad_frames()
    denom = dot(normal[None, :, :], d[:, None, :])
    safe = torch.where(torch.abs(denom) < 1e-8, 1.0, denom)
    t = (dplane[None, :] - dot(normal[None, :, :], o[:, None, :])) / safe
    rel = o[:, None, :] + t[..., None] * d[:, None, :] - scene.quad_q[None]
    alpha = dot(w[None], cross(rel, scene.quad_v[None]))
    beta = dot(w[None], cross(scene.quad_u[None], rel))
    ok = ((torch.abs(denom) >= 1e-8)
          & (t >= t_min[:, None]) & (t <= t_max[:, None])
          & (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
          & (scene.quad_mask[None, :] > 0))
    best, idx = torch.min(torch.where(ok, t, T_MAX), dim=-1)
    return best, idx, ok.any(dim=-1)


def _safe_inv_dir(d):
    """1/d with zero components nudged to +-1e-20, sign kept."""
    sgn = torch.where(d < 0.0, -1e-20, 1e-20)
    return 1.0 / torch.where(torch.abs(d) < 1e-20, sgn, d)


def hit_boxes(o, d, scene: Scene, t_min, t_max):
    """Closest axis-aligned box: (t [R], idx [R], any [R]); the slab test,
    entry face when in (t_min, t_max), else the exit face."""
    inv = _safe_inv_dir(d)[:, None, :]
    ta = (scene.box_lo[None] - o[:, None, :]) * inv
    tb = (scene.box_hi[None] - o[:, None, :]) * inv
    t1 = torch.amax(torch.minimum(ta, tb), dim=-1)
    t2 = torch.amin(torch.maximum(ta, tb), dim=-1)
    near_ok = (t1 > t_min[:, None]) & (t1 < t_max[:, None])
    root = torch.where(near_ok, t1, t2)
    ok = ((t1 < t2) & (root > t_min[:, None]) & (root < t_max[:, None])
          & (scene.box_mask[None, :] > 0))
    best, idx = torch.min(torch.where(ok, root, T_MAX), dim=-1)
    return best, idx, ok.any(dim=-1)


def box_outward_normal(o, d, t, lo, hi):
    """Outward unit normal of the face of box (lo, hi) [R, 3] hit at t:
    the entry face is the argmax of the per-axis entry times, the exit
    face (a ray from inside) the argmin of the exit times."""
    inv = _safe_inv_dir(d)
    ta = (lo - o) * inv
    tb = (hi - o) * inv
    tn = torch.minimum(ta, tb)
    tf = torch.maximum(ta, tb)
    t1 = torch.amax(tn, dim=-1)
    is_entry = torch.abs(t - t1) <= 1e-3 * (1.0 + torch.abs(t1))
    axis = torch.where(is_entry, torch.argmax(tn, dim=-1),
                       torch.argmin(tf, dim=-1))
    sgn_d = torch.where(d >= 0.0, 1.0, -1.0)
    face = torch.where(is_entry, -1.0, 1.0)[:, None] * sgn_d
    return face * torch.nn.functional.one_hot(axis, 3).to(o.dtype)


def _medium_freeflight(t1, t2, inside_ok, neg_inv_density, dir_len, u, t_min,
                       t_best):
    """Free-flight sampling in a constant medium (constant_medium.rs:40-79)
    between boundary roots t1 < t2: (t_hit, hit)."""
    t1c = torch.maximum(t1, t_min)
    t2c = torch.minimum(t2, t_best)
    ok = inside_ok & (t1c < t2c)
    t1c = torch.clamp(t1c, min=0.0)
    distance_inside = (t2c - t1c) * dir_len
    hit_distance = neg_inv_density * torch.log(torch.clamp(u, min=1e-12))
    ok = ok & (hit_distance <= distance_inside)
    t_hit = t1c + hit_distance / dir_len
    return torch.where(ok, t_hit, T_MAX), ok


def hit_media(o, d, scene: Scene, t_min, t_best, u_media):
    """Constant-medium hits in scene order, each medium's window clipped by
    the running closest hit (hittable_list.rs:42-54).  u_media: [R, K + B]
    uniforms.  Returns (t [R], mat [R], hit [R])."""
    R = o.shape[0]
    dir_len = sqrt(dot(d, d))
    t = _full((R,), T_MAX, o)
    mat = torch.zeros(R, dtype=torch.int64, device=o.device)
    hit = torch.zeros(R, dtype=torch.bool, device=o.device)
    t_run = t_best
    col = 0
    for k in range(scene.msph_center.shape[0]):
        center = scene.msph_center[k].expand(R, 1, 3)
        t_near, t_far, has = sphere_roots(o, d, center,
                                          scene.msph_radius[k][None, None])
        th, ok = _medium_freeflight(
            t_near[:, 0], t_far[:, 0], has[:, 0] & (scene.msph_mask[k] > 0),
            scene.msph_neg_inv_density[k], dir_len, u_media[:, col], t_min,
            t_run)
        take = ok & (th < t_run)
        t = torch.where(take, th, t)
        mat = torch.where(take, scene.msph_mat[k].long(), mat)
        hit = hit | take
        t_run = torch.minimum(t_run, t)
        col += 1
    for b in range(scene.mbox_cos.shape[0]):
        # world -> local: subtract the offset, rotate by -theta about y
        # (Translate hittable.rs:87-93, RotateY hittable.rs:143-156)
        c, s = scene.mbox_cos[b], scene.mbox_sin[b]
        off = scene.mbox_offset[b]
        ox = c * (o[:, 0] - off[0]) - s * (o[:, 2] - off[2])
        oy = o[:, 1] - off[1]
        oz = s * (o[:, 0] - off[0]) + c * (o[:, 2] - off[2])
        dl = torch.stack([c * d[:, 0] - s * d[:, 2], d[:, 1],
                          s * d[:, 0] + c * d[:, 2]], dim=-1)
        ol = torch.stack([ox, oy, oz], dim=-1)
        inv = 1.0 / dl
        ta = (scene.mbox_lo[b][None, :] - ol) * inv
        tb = (scene.mbox_hi[b][None, :] - ol) * inv
        t1 = torch.amax(torch.minimum(ta, tb), dim=-1)
        t2 = torch.amin(torch.maximum(ta, tb), dim=-1)
        th, ok = _medium_freeflight(
            t1, t2, (t1 < t2) & (scene.mbox_mask[b] > 0),
            scene.mbox_neg_inv_density[b], dir_len, u_media[:, col], t_min,
            t_run)
        take = ok & (th < t_run)
        t = torch.where(take, th, t)
        mat = torch.where(take, scene.mbox_mat[b].long(), mat)
        hit = hit | take
        t_run = torch.minimum(t_run, t)
        col += 1
    return t, mat, hit


def refine_sphere_t(o, d, ctr, rad, t, valid):
    """One Newton step on |o + t d - c|^2 - r^2 (oc subtracted first):
    restores ~1e-6 relative accuracy after the expanded quadric."""
    oc = o + t[:, None] * d - ctr
    f = dot(oc, oc) - rad * rad
    fp = 2.0 * dot(d, oc)
    safe = valid & (torch.abs(fp) > 1e-12)
    return torch.where(safe, t - f / torch.where(safe, fp, 1.0), t)


def sphere_uv(outward: torch.Tensor):
    """Spherical (u, v) of the outward unit normal (sphere.rs:47-53), with
    the poles and out-of-range lanes at their exact values."""
    y = torch.clamp(-outward[:, 1], -1.0, 1.0)
    safe = torch.abs(y) < 1.0 - 1e-6
    theta = torch.acos(torch.where(safe, y, 0.0))
    theta = torch.where(safe, theta, torch.where(y > 0.0, 0.0, _PI))
    x, z = outward[:, 0], outward[:, 2]
    deg = (torch.abs(x) < 1e-12) & (torch.abs(z) < 1e-12)
    phi = torch.atan2(torch.where(deg, 0.0, -z),
                      torch.where(deg, 1.0, x)) + _PI
    return phi / (2.0 * _PI), theta / _PI


def closest_hit(o, d, time, scene: Scene, u_media, t_min=None,
                t_max=None) -> HitRecord:
    """Closest hit over spheres, quads, boxes and media: o, d [R, 3], time
    [R], u_media [R, n_media] free-flight uniforms."""
    R = o.shape[0]
    if t_min is None:
        t_min = _full((R,), T_MIN, o)
    if t_max is None:
        t_max = _full((R,), T_MAX, o)
    has_boxes = "boxes" in scene.features

    ts, is_, anys = hit_spheres(o, d, time, scene, t_min, t_max)
    tq, iq, anyq = hit_quads(o, d, scene, t_min, t_max)
    t_geo = torch.where(anys, ts, T_MAX)
    cls = torch.where(anys, CLS_SPHERE, CLS_NONE)
    better_q = anyq & (tq < t_geo)
    t_geo = torch.where(better_q, tq, t_geo)
    cls = torch.where(better_q, CLS_QUAD, cls)
    if has_boxes:
        tbx, ib, anyb = hit_boxes(o, d, scene, t_min, t_max)
        better_b = anyb & (tbx < t_geo)
        t_geo = torch.where(better_b, tbx, t_geo)
        cls = torch.where(better_b, CLS_BOX, cls)
    tm, mmat, anym = hit_media(o, d, scene, t_min, t_geo, u_media)
    better_m = anym & (tm < t_geo)
    t = torch.where(better_m, tm, t_geo)
    cls = torch.where(better_m, CLS_MEDIUM, cls)
    valid = cls != CLS_NONE

    # sphere record
    ctr = scene.sph_center[is_] + time[:, None] * scene.sph_cvel[is_]
    rad = scene.sph_radius[is_]
    is_sphere = cls == CLS_SPHERE
    t = refine_sphere_t(o, d, ctr, rad, t, is_sphere)
    p = o + torch.where(valid, t, 1.0)[:, None] * d
    outward_s = (p - ctr) / torch.clamp(rad, min=1e-30)[:, None]
    us, vs = sphere_uv(outward_s)

    # quad record
    w_all, n_all, _, _ = scene.quad_frames()
    rel = p - scene.quad_q[iq]
    uq = dot(w_all[iq], cross(rel, scene.quad_v[iq]))
    vq = dot(w_all[iq], cross(scene.quad_u[iq], rel))

    is_quad = cls == CLS_QUAD
    is_medium = cls == CLS_MEDIUM
    outward = torch.where(is_sphere[:, None], outward_s, n_all[iq])
    if has_boxes:
        is_box = cls == CLS_BOX
        bn = box_outward_normal(o, d, t, scene.box_lo[ib], scene.box_hi[ib])
        outward = torch.where(is_box[:, None], bn, outward)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=o.dtype, device=o.device)
    outward = torch.where(is_medium[:, None], x_axis, outward)
    # set_face_normal (hittable.rs:48-51); media: front face, fixed normal
    # (constant_medium.rs:70-78)
    front = (dot(d, outward) < 0.0) | is_medium
    normal = torch.where(front[:, None], outward, -outward)

    mat = torch.where(is_sphere, scene.sph_mat[is_].long(),
                      torch.where(is_quad, scene.quad_mat[iq].long(), mmat))
    u = torch.where(is_sphere, us, torch.where(is_quad, uq, 0.0))
    v = torch.where(is_sphere, vs, torch.where(is_quad, vq, 0.0))
    if has_boxes:
        # boxes carry no UVs (image-textured boxes are baked to quads)
        mat = torch.where(is_box, scene.box_mat[ib].long(), mat)
        u = torch.where(is_box, 0.0, u)
        v = torch.where(is_box, 0.0, v)
    return HitRecord(valid=valid, t=t, p=p, normal=normal, front_face=front,
                     mat=mat, u=u, v=v)
