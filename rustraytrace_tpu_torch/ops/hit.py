"""K1: closest hit over spheres then quads (counterpart:
``rustraytrace_tpu/ops/pallas_hit.py``).

``sphere_hit`` launches the CUDA kernel ``csrc/sphere_hit.cu`` for CUDA
tensors and runs ``sphere_hit_plain`` for CPU tensors.  Both implement the
semantics of the JAX kernel (pallas_hit.py:68-159): the half-b quadric with
``oc`` subtracted first, the near root unless it is outside (1e-3, 1e9),
optional motion ``c + time * v``, then quads, with a strict ``<`` in table
order; quad winners are encoded as ``n_spheres + qi`` and a miss returns
``(T_MAX, -1)``.  K1 is the closest-hit step of the sphere_kernel route
(``closest_hit_spheres``, every bounce of ``integrator.trace_path``), and
the exact check of the sphere quadric and the quad test that the path
tracer's kernels share (``csrc/rtt_common.cuh``; ``quad_hits`` is the
plain twin of the quad test).
"""

from __future__ import annotations

import functools

import torch

from ..scene import Scene
from . import _cuda

T_MIN = 1.0e-3
T_MAX = 1.0e9
_BIG = 1.0e30

# sphere table columns
S_CX, S_CY, S_CZ = 0, 1, 2
S_R2 = 3
S_VX, S_VY, S_VZ = 4, 5, 6
S_COLS = 8

# quad table columns (pallas_megakernel.py:98-112)
Q_QX, Q_QY, Q_QZ = 0, 1, 2
Q_UX, Q_UY, Q_UZ = 3, 4, 5
Q_VX, Q_VY, Q_VZ = 6, 7, 8
Q_NX, Q_NY, Q_NZ = 9, 10, 11
Q_DP = 12
Q_WX, Q_WY, Q_WZ = 13, 14, 15
Q_KIND = 16
Q_AR, Q_AG, Q_AB = 17, 18, 19
Q_FUZZ = 20
Q_IOR = 21
Q_TEXK = 22
Q_C2R, Q_C2G, Q_C2B = 23, 24, 25
Q_INVS = 26
Q_IMG = 27
Q_COLS = 32


def pack_sphere_table(scene: Scene) -> torch.Tensor:
    """[N, 8] float32; padding rows get r^2 = -BIG (never hit)."""
    r = scene.sph_radius
    tab = torch.zeros((r.shape[0], S_COLS), dtype=torch.float32,
                      device=r.device)
    tab[:, S_CX:S_CZ + 1] = scene.sph_center
    tab[:, S_R2] = torch.where(scene.sph_mask > 0, r * r,
                               torch.full_like(r, -_BIG))
    tab[:, S_VX:S_VZ + 1] = scene.sph_cvel
    return tab


def pack_quad_table(scene: Scene) -> torch.Tensor:
    """[Q, 32] float32 quad frames + materials (pallas_megakernel.py:164);
    masked quads get a zero normal, which every ray rejects."""
    q, u, v = scene.quad_q, scene.quad_u, scene.quad_v
    mask = scene.quad_mask > 0
    n = torch.linalg.cross(u, v)
    nn = torch.clamp(torch.sum(n * n, dim=-1, keepdim=True), min=1e-30)
    w = n / nn
    # sqrt in float64, rounded once to float32: the correctly rounded f32
    # square root on every device (the CPU build's float32 sqrt is not
    # for every input, and the JAX package's table has the correct one)
    norm = torch.sqrt(nn.to(torch.float64)).to(torch.float32)
    normal = torch.where(mask[:, None], n / norm, torch.zeros_like(n))
    dp = torch.sum(normal * q, dim=-1)
    mat = scene.quad_mat.long()
    mtex = scene.mat_tex.long()[mat]
    tk = scene.tex_kind[mtex]
    tab = torch.zeros((q.shape[0], Q_COLS), dtype=torch.float32,
                      device=q.device)
    tab[:, Q_QX:Q_QZ + 1] = q
    tab[:, Q_UX:Q_UZ + 1] = u
    tab[:, Q_VX:Q_VZ + 1] = v
    tab[:, Q_NX:Q_NZ + 1] = normal
    tab[:, Q_DP] = dp
    tab[:, Q_WX:Q_WZ + 1] = w
    tab[:, Q_KIND] = scene.mat_kind[mat].float()
    tab[:, Q_AR:Q_AB + 1] = scene.tex_color1[mtex]
    tab[:, Q_FUZZ] = scene.mat_fuzz[mat]
    tab[:, Q_IOR] = scene.mat_ior[mat]
    tab[:, Q_TEXK] = tk.float()
    tab[:, Q_C2R:Q_C2B + 1] = scene.tex_color2[mtex]
    tab[:, Q_INVS] = torch.where(tk == 3, scene.tex_noise_scale[mtex],
                                 scene.tex_inv_scale[mtex])
    tab[:, Q_IMG] = scene.tex_image[mtex].float()
    return tab


def quad_hits(quad_tab: torch.Tensor, ox, oy, oz, dx, dy, dz):
    """(t [n, Q], valid [n, Q]) of rays against every quad row: plane hit
    and planar-coordinate interior test (quad.rs:59-88; qbody,
    pallas_megakernel.py:883-916; csrc/rtt_common.cuh ``quad_hit``).  Ray
    components are [n, 1] columns; a zero normal (masked quad) is
    rejected by ``|denom|``."""
    q = quad_tab[None]
    nqx, nqy, nqz = q[..., Q_NX], q[..., Q_NY], q[..., Q_NZ]
    denom = dx * nqx + dy * nqy + dz * nqz
    safe = torch.where(torch.abs(denom) < 1e-8, 1.0, denom)
    tq = (q[..., Q_DP] - (ox * nqx + oy * nqy + oz * nqz)) / safe
    relx = ox + tq * dx - q[..., Q_QX]
    rely = oy + tq * dy - q[..., Q_QY]
    relz = oz + tq * dz - q[..., Q_QZ]
    ux, uy, uz = q[..., Q_UX], q[..., Q_UY], q[..., Q_UZ]
    vx, vy, vz = q[..., Q_VX], q[..., Q_VY], q[..., Q_VZ]
    wx, wy, wz = q[..., Q_WX], q[..., Q_WY], q[..., Q_WZ]
    alpha = (wx * (rely * vz - relz * vy)
             + wy * (relz * vx - relx * vz)
             + wz * (relx * vy - rely * vx))
    beta = (wx * (uy * relz - uz * rely)
            + wy * (uz * relx - ux * relz)
            + wz * (ux * rely - uy * relx))
    ok = ((torch.abs(denom) >= 1e-8) & (tq > T_MIN) & (tq < T_MAX)
          & (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0))
    return tq, ok


def sphere_hit_plain(o, d, time, sph_tab, quad_tab, moving: bool,
                     chunk: int = 8192):
    """Vectorised twin of the K1 kernel: all spheres and quads of a chunk of
    rays at once.  ``torch.min`` returns the first index of the minimum,
    which is what a scan in table order with a strict ``<`` keeps."""
    R = o.shape[0]
    n_sph = sph_tab.shape[0]
    t_out = torch.empty(R, dtype=torch.float32, device=o.device)
    i_out = torch.empty(R, dtype=torch.int32, device=o.device)
    for lo in range(0, R, chunk):
        hi = min(R, lo + chunk)
        ox, oy, oz = (o[lo:hi, k:k + 1] for k in range(3))
        dx, dy, dz = (d[lo:hi, k:k + 1] for k in range(3))
        a = dx * dx + dy * dy + dz * dz
        inv_a = 1.0 / a
        cx, cy, cz, r2 = (sph_tab[None, :, k] for k in range(4))
        if moving:
            tm = time[lo:hi, None]
            cx = cx + tm * sph_tab[None, :, S_VX]
            cy = cy + tm * sph_tab[None, :, S_VY]
            cz = cz + tm * sph_tab[None, :, S_VZ]
        ocx = cx - ox
        ocy = cy - oy
        ocz = cz - oz
        h = dx * ocx + dy * ocy + dz * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r2
        disc = h * h - a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        tn = (h - sq) * inv_a
        tf = (h + sq) * inv_a
        root = torch.where((tn > T_MIN) & (tn < T_MAX), tn, tf)
        ok = (disc > 0.0) & (root > T_MIN) & (root < T_MAX)
        best_t, best_i = torch.min(torch.where(ok, root, _BIG), dim=1)
        best_i = torch.where(best_t < _BIG, best_i, -1)
        if quad_tab.shape[0]:
            tq, okq = quad_hits(quad_tab, ox, oy, oz, dx, dy, dz)
            qt, qi = torch.min(torch.where(okq, tq, _BIG), dim=1)
            take = qt < best_t
            best_t = torch.where(take, qt, best_t)
            best_i = torch.where(take, qi + n_sph, best_i)
        t_out[lo:hi] = torch.where(best_i >= 0, best_t, T_MAX)
        i_out[lo:hi] = best_i.to(torch.int32)
    return t_out, i_out


def sphere_table_f4(sph_tab: torch.Tensor) -> torch.Tensor:
    """float32 [2, N, 4]: the float4 planes K1 streams through shared
    memory, the centers and r^2 (columns 0-3 of ``pack_sphere_table``),
    then the velocities and a zero (columns 4-6, 0)."""
    f4 = torch.zeros((2, sph_tab.shape[0], 4), dtype=torch.float32,
                     device=sph_tab.device)
    f4[0] = sph_tab[:, S_CX:S_R2 + 1]
    f4[1, :, :3] = sph_tab[:, S_VX:S_VZ + 1]
    return f4


def check_hit_args(o, d, time, sph_tab, quad_tab) -> None:
    """Raise unless the arguments have K1's types and shapes: o, d float32
    [R, 3], time float32 [R], sph_tab float32 [N, 8], quad_tab float32
    [Q, 32]."""
    R = o.shape[0]
    for t, name, shape in ((o, "o", (R, 3)), (d, "d", (R, 3)),
                           (time, "time", (R,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32 of shape {shape}, "
                             f"got {t.dtype} of shape {tuple(t.shape)}")
    for t, name, cols in ((sph_tab, "sph_tab", S_COLS),
                          (quad_tab, "quad_tab", Q_COLS)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != cols:
            raise ValueError(f"{name}: expected float32 of shape (n, "
                             f"{cols}), got {t.dtype} of shape "
                             f"{tuple(t.shape)}")


def sphere_hit(o: torch.Tensor, d: torch.Tensor, time: torch.Tensor,
               sph_tab: torch.Tensor, quad_tab: torch.Tensor,
               moving: bool, f4: torch.Tensor | None = None):
    """Closest hit of rays o, d [R, 3] (time [R]) over sph_tab [N, 8] and
    quad_tab [Q, 32] (Q may be 0).  Returns (t [R] f32, idx [R] i32).
    CUDA tensors launch the kernel, which reads the rays and writes its
    results as float4s (16-byte aligned tensors); CPU tensors run the plain
    version.  ``f4`` is ``sphere_table_f4(sph_tab)``, built here when not
    given: a caller that scans one table many times builds it once."""
    check_hit_args(o, d, time, sph_tab, quad_tab)
    if o.device.type == "cpu":
        return sphere_hit_plain(o, d, time, sph_tab, quad_tab, moving)
    R = o.shape[0]
    _cuda.require(o, "o", torch.float32, (R, 3))
    _cuda.require(d, "d", torch.float32, (R, 3))
    _cuda.require(time, "time", torch.float32, (R,))
    _cuda.require(sph_tab, "sph_tab", torch.float32, (None, S_COLS))
    _cuda.require(quad_tab, "quad_tab", torch.float32, (None, Q_COLS))
    for t, name in ((o, "o"), (d, "d"), (time, "time")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: K1 reads float4s; need 16-byte "
                             "alignment")
    if f4 is None:
        f4 = sphere_table_f4(sph_tab)
    _cuda.require(f4, "f4", torch.float32, (2, sph_tab.shape[0], 4))
    t = torch.empty(R, dtype=torch.float32, device=o.device)
    idx = torch.empty(R, dtype=torch.int32, device=o.device)
    _cuda.launch("sphere_hit", o.data_ptr(), d.data_ptr(), time.data_ptr(),
                 f4.data_ptr(), sph_tab.shape[0], quad_tab.data_ptr(),
                 quad_tab.shape[0], int(bool(moving)), t.data_ptr(),
                 idx.data_ptr(), R)
    return t, idx


# ---- the sphere_kernel route's closest hit (pallas_hit.py:191-314) ----


def sphere_kernel_eligible(scene: Scene) -> bool:
    """The sphere_kernel route covers spheres and quads in K1 (at most 256
    quads, the JAX kernel's SMEM table), constant media through
    ``intersect.hit_media`` and every texture outside the kernel; scenes
    with box primitives take another route (pallas_hit.py:191-199)."""
    return ("boxes" not in scene.features
            and ("quads" not in scene.features
                 or scene.quad_q.shape[0] <= 256))


def sphere_kernel_tables(scene: Scene):
    """(sphere table [N, 8], quad table [Q, 32], the sphere table's float4
    planes ``sphere_table_f4``) that K1 reads on the sphere_kernel route,
    built once for every bounce; Q is 0 for a scene without quads."""
    sph = pack_sphere_table(scene)
    quad = (pack_quad_table(scene) if "quads" in scene.features
            else torch.zeros((0, Q_COLS), dtype=torch.float32,
                             device=sph.device))
    return sph, quad, sphere_table_f4(sph)


def closest_hit_spheres(o, d, time, scene: Scene, *, u_media=None,
                        tables=None, hit_fn=None):
    """Closest hit and material of rays o, d [R, 3] (time [R]) on the
    sphere_kernel route (closest_hit_spheres_pallas, pallas_hit.py:
    202-314): spheres and quads through K1 (``hit_fn``, by default
    ``sphere_hit``: the kernel on CUDA tensors, its twin on CPU tensors;
    ``sphere_hit_plain`` runs the twin on any device), constant media
    composed on top with ``intersect.hit_media`` (``u_media`` [R,
    n_media]), records and textures assembled from the winner index.
    ``tables`` are ``sphere_kernel_tables(scene)``, packed here when not
    given.  Returns (HitRecord, MatRecord)."""
    from .intersect import HitRecord, hit_media, sphere_uv
    from .materials import MatRecord
    from .rng import cross, dot, sqrt
    from .textures import texture_value

    sph_tab, quad_tab, f4 = tables if tables is not None else (
        sphere_kernel_tables(scene))
    if hit_fn is None:
        hit_fn = functools.partial(sphere_hit, f4=f4)
    t, idx = hit_fn(o.contiguous(), d.contiguous(), time.contiguous(),
                    sph_tab, quad_tab, "motion" in scene.features)
    S = sph_tab.shape[0]
    idx = idx.long()
    hit = idx >= 0
    is_quad = idx >= S
    iw = torch.where(hit & ~is_quad, idx, 0)
    qw = torch.where(is_quad, idx - S, 0)
    p = o + torch.where(hit, t, 1.0)[:, None] * d

    ctr = scene.sph_center[iw] + time[:, None] * scene.sph_cvel[iw]
    rad = scene.sph_radius[iw]
    outward = (p - ctr) / torch.clamp(rad, min=1e-30)[:, None]
    u, v = sphere_uv(outward)
    mat_id = scene.sph_mat[iw].long()
    if quad_tab.shape[0]:
        qn = cross(scene.quad_u, scene.quad_v)
        qnn = torch.clamp(dot(qn, qn), min=1e-30)[:, None]
        rel = p - scene.quad_q[qw]
        w = (qn / qnn)[qw]
        uq = dot(w, cross(rel, scene.quad_v[qw]))
        vq = dot(w, cross(scene.quad_u[qw], rel))
        outward = torch.where(is_quad[:, None], (qn / sqrt(qnn))[qw],
                              outward)
        u = torch.where(is_quad, uq, u)
        v = torch.where(is_quad, vq, v)
        mat_id = torch.where(is_quad, scene.quad_mat[qw].long(), mat_id)
    front = dot(d, outward) < 0.0
    t_full = torch.where(hit, t, T_MAX)

    if "media" in scene.features:
        if u_media is None:
            raise ValueError("a scene with media needs u_media draws")
        t_min = torch.full_like(t_full, T_MIN)
        tm, mmat, anym = hit_media(o, d, scene, t_min, t_full, u_media)
        better = anym & (tm < t_full)
        t_full = torch.where(better, tm, t_full)
        hit = hit | better
        p = torch.where(better[:, None], o + t_full[:, None] * d, p)
        x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=o.dtype,
                              device=o.device)
        outward = torch.where(better[:, None], x_axis, outward)
        front = front | better
        mat_id = torch.where(better, mmat, mat_id)
        u = torch.where(better, 0.0, u)
        v = torch.where(better, 0.0, v)

    normal = torch.where(front[:, None], outward, -outward)
    rec = HitRecord(valid=hit, t=t_full, p=p, normal=normal,
                    front_face=front, mat=mat_id, u=u, v=v)
    mat = MatRecord(
        kind=scene.mat_kind[mat_id],
        albedo=texture_value(scene.mat_tex[mat_id], u, v, p, scene),
        fuzz=scene.mat_fuzz[mat_id],
        ior=scene.mat_ior[mat_id])
    return rec, mat
