"""Warped-area reparameterization: silhouette (visibility) gradients
(counterpart: ``rustraytrace_tpu/ops/warp.py``).

Interior autodiff differentiates radiance through hit points, normals and
attenuations, but a sphere silhouette's movement under a parameter change
(the boundary term of the pixel integral) has zero interior gradient.  The
sub-pixel jitter u is replaced by a warp T(u, theta) = u + W(u, theta) with

    W = - sum_i  k(phi_d_i) * (phi_i(theta) - phi_i(theta_d)) * n_d_i ,

where phi_i is sphere i's ray-quadric discriminant normalized by its
u-gradient (its zero set in u-space is the silhouette), n_d_i the u-space
silhouette normal, k a bump that is exactly 1 on the silhouette, and the
subscript d marks evaluation with detached sphere centers, velocities and
radii (u stays attached).  W is 0 and det(dT/du) is 1 in value, so the
forward render is bit-identical; at a silhouette dT/dtheta is the
boundary's u-velocity, so the change of variables
integral f(T) |det dT/du| du = integral f du differentiates to the full
gradient, boundary term included (Loubet et al. 2019, Bangaru et al.
2020).  Scope as in the JAX package: sphere silhouettes of primary rays.

The JAX package takes ``jax.jvp`` of W in u twice; here each u-derivative
is a forward-mode pass of ``torch.autograd.forward_ad`` (a dual jitter with
the unit tangent), and the gradient in theta of ``det`` and ``u_w`` is
reverse mode through those passes' tangents (backward over forward).  The
products of ``_disc_terms`` are written out as multiply-adds over the
three components, so no matmul runs at a reduced (TF32) precision on the
card, as the JAX package's dots run at HIGHEST.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.autograd.forward_ad as fwAD

from ..scene import Scene
from .rng import dot, in_unit_disk, sqrt

_SIGMA = 0.5  # bump width in sub-pixel (jitter) units


def splat_weights(u: torch.Tensor):
    """Bilinear (tent-filter) splat of a jitter position u [R, 2] in
    [-0.5, 0.5]^2 onto the sample's 2x2 pixel neighborhood.

    Returns (dx [R], dy [R], w00, w10, w01, w11): (dx, dy) in {-1, +1} are
    the offsets of the second column and row, and the four weights, which
    sum to 1, belong to the offsets (0, 0), (dx, 0), (0, dy), (dx, dy)."""
    ax = torch.abs(u[:, 0])
    ay = torch.abs(u[:, 1])
    one = torch.ones_like(u[:, 0], dtype=torch.int64)
    dx = torch.where(u[:, 0] >= 0.0, one, -one)
    dy = torch.where(u[:, 1] >= 0.0, one, -one)
    bx0 = 1.0 - ax
    by0 = 1.0 - ay
    return (dx, dy, bx0 * by0, ax * by0, bx0 * ay, ax * ay)


def _rows(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[R, 3] x [N, 3]^T -> [R, N] as x, y, z multiply-adds."""
    return (x[:, 0:1] * m[None, :, 0] + x[:, 1:2] * m[None, :, 1]
            + x[:, 2:3] * m[None, :, 2])


def _disc_terms(u, base, du, dv, o, time, C, V, r):
    """Discriminant and its analytic u-gradient for every (ray, sphere).

    u: [R, 2] jitter; base [R, 3], du/dv [3]: the ray direction's affine
    frame; o: [R, 3] origins; time: [R]; C/V/r: the sphere arrays.
    Returns (disc [R, N], gx [R, N], gy [R, N])."""
    d = base + u[:, 0:1] * du[None, :] + u[:, 1:2] * dv[None, :]  # [R, 3]
    tcol = time[:, None]

    d_C = _rows(d, C)
    d_V = _rows(d, V)
    o_C = _rows(o, C)
    o_V = _rows(o, V)
    C2 = dot(C, C)
    CV = dot(C, V)
    V2 = dot(V, V)
    o2 = dot(o, o)
    d_o = dot(d, o)
    a = dot(d, d)

    h = d_C + tcol * d_V - d_o[:, None]  # [R, N]
    cc2 = C2[None, :] + 2.0 * tcol * CV[None, :] + (tcol * tcol) * V2[None, :]
    c0 = cc2 - 2.0 * (o_C + tcol * o_V) + o2[:, None] - (r * r)[None, :]
    disc = h * h - a[:, None] * c0

    # analytic u-gradients: dd/du_x = du, dh/du_x = du.cc - du.o,
    # da/du_x = 2 d.du; c0 does not depend on u
    du_C = _rows(du[None, :], C)[0]  # [N]
    du_V = _rows(du[None, :], V)[0]
    dv_C = _rows(dv[None, :], C)[0]
    dv_V = _rows(dv[None, :], V)[0]
    du_o = dot(o, du[None, :])  # [R]
    dv_o = dot(o, dv[None, :])
    h_x = du_C[None, :] + tcol * du_V[None, :] - du_o[:, None]
    h_y = dv_C[None, :] + tcol * dv_V[None, :] - dv_o[:, None]
    a_x = 2.0 * dot(d, du[None, :])  # [R]
    a_y = 2.0 * dot(d, dv[None, :])
    gx = 2.0 * h * h_x - a_x[:, None] * c0
    gy = 2.0 * h * h_y - a_y[:, None] * c0
    return disc, gx, gy


def _warp_field(u, base, du, dv, o, time, scene: Scene, scene_d: Scene):
    """W(u) [R, 2]: the zero-valued warp carrying the silhouette
    theta-derivative."""
    # attached-theta and detached-theta discriminants: the detached pass
    # sets the warp's geometry (normals, bump weights) and stays
    # differentiable in u
    disc_a, _, _ = _disc_terms(u, base, du, dv, o, time, scene.sph_center,
                               scene.sph_cvel, scene.sph_radius)
    disc_d, gx, gy = _disc_terms(u, base, du, dv, o, time,
                                 scene_d.sph_center, scene_d.sph_cvel,
                                 scene_d.sph_radius)
    # +1e-30 keeps sqrt differentiable where the u-gradient vanishes (a
    # zero-radius padding sphere seen from the origin: disc == gx == gy ==
    # 0, and sqrt'(0) = inf would NaN every gradient through 0 * inf)
    gnorm = sqrt(gx * gx + gy * gy + 1e-30)
    # normalize by the silhouette scale, with a soft floor where the
    # u-gradient degenerates (a ray through a sphere's center, grazing)
    scale = torch.maximum(gnorm, 1e-3 * (torch.abs(disc_d) + 1e-12))
    phi_a = disc_a / scale
    phi_d = disc_d / scale
    delta = phi_a - phi_d  # 0 in value; its theta-derivative is phi's
    k = torch.exp(-(phi_d / _SIGMA) ** 2) * scene.sph_mask[None, :]
    nx = gx / scale
    ny = gy / scale
    wx = -torch.sum(k * delta * nx, dim=-1)  # [R]
    wy = -torch.sum(k * delta * ny, dim=-1)
    return torch.stack([wx, wy], dim=-1)


def _jvp(fn, u: torch.Tensor, tangent: torch.Tensor):
    """(fn(u), d fn(u) . tangent) in one forward-mode pass; the tangent
    keeps its reverse-mode graph to every attached tensor fn reads."""
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(u, tangent))
        primal, tan = fwAD.unpack_dual(out)
    if tan is None:  # fn does not depend on u
        tan = torch.zeros_like(primal)
    return primal, tan


def warped_primary_rays(scene: Scene, cam, px, py, draws, strat=None,
                        warp: bool = True):
    """Primary rays of the differentiable path: box-jittered rays and, with
    ``warp=True``, the silhouette warp applied to the jitter.

    px, py: [R] pixel coordinates (float32); draws: [R, 5] uniforms
    (jitter x, y, disk u1, u2, time); strat: None or ``camera.strata(...)``.
    Returns (origin [R, 3], direction [R, 3], time [R], det [R], u_w
    [R, 2]): ``det`` (1 in value) multiplies the sample's radiance and
    ``u_w`` (u in value) is the jitter the caller splats with
    (``splat_weights``): the tent splat makes a sample's image
    contribution continuous in its position, so the warp's flux through
    pixel edges cancels between neighbors for any loss (the pixel-filter
    note of the JAX package's ``warped_primary_rays``).  ``warp=False``
    gives the same rays (bit-identical values, det 1) without the warp."""
    if strat is None:
        ox = draws[:, 0] - 0.5
        oy = draws[:, 1] - 0.5
    else:
        s_i, s_j, sqrt_spp = strat
        recip = 1.0 / sqrt_spp
        ox = (s_i + draws[:, 0]) * recip - 0.5
        oy = (s_j + draws[:, 1]) * recip - 0.5
    u = torch.stack([ox, oy], dim=-1)  # [R, 2]

    if cam.lens_radius_gt0:
        disk = in_unit_disk(draws[:, 2], draws[:, 3])
        origin = (cam.center[None, :]
                  + disk[:, 0:1] * cam.defocus_disk_u[None, :]
                  + disk[:, 1:2] * cam.defocus_disk_v[None, :])
    else:
        origin = cam.center[None, :].expand(px.shape[0], 3)
    time = draws[:, 4]

    if not warp:
        pixel_sample = (cam.pixel00[None, :]
                        + (px + u[:, 0])[:, None] * cam.pixel_delta_u[None, :]
                        + (py + u[:, 1])[:, None] * cam.pixel_delta_v[None, :])
        return origin, pixel_sample - origin, time, torch.ones_like(time), u

    base = (cam.pixel00[None, :]
            + px[:, None] * cam.pixel_delta_u[None, :]
            + py[:, None] * cam.pixel_delta_v[None, :]
            - origin)
    scene_d = dataclasses.replace(
        scene, sph_center=scene.sph_center.detach(),
        sph_cvel=scene.sph_cvel.detach(),
        sph_radius=scene.sph_radius.detach())
    o_d, time_d = origin.detach(), time.detach()

    def W(uu):
        return _warp_field(uu, base, cam.pixel_delta_u, cam.pixel_delta_v,
                           o_d, time_d, scene, scene_d)

    w_val, j1 = _jvp(W, u, torch.stack(
        [torch.ones_like(ox), torch.zeros_like(ox)], dim=-1))  # dW/du_x
    _, j2 = _jvp(W, u, torch.stack(
        [torch.zeros_like(ox), torch.ones_like(ox)], dim=-1))  # dW/du_y
    det = (1.0 + j1[:, 0]) * (1.0 + j2[:, 1]) - j1[:, 1] * j2[:, 0]

    u_w = u + w_val  # u in value; its derivative tracks the silhouette
    pixel_sample = (cam.pixel00[None, :]
                    + (px + u_w[:, 0])[:, None] * cam.pixel_delta_u[None, :]
                    + (py + u_w[:, 1])[:, None] * cam.pixel_delta_v[None, :])
    return origin, pixel_sample - origin, time, det, u_w
