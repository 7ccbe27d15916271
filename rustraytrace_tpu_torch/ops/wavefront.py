"""The persist path tracer's launch loop, K2, the per-bounce segment loop,
K5, and the plain twin of the shading that every path kernel shares
(counterparts: ``rustraytrace_tpu/ops/pallas_wavefront.py`` and
``_make_kernel`` in ``pallas_megakernel.py``: intersect :714-1200,
bounce_body :1202-1771, the segment branch :1773-1815, spawn_rays :1817,
the persist branch :1856-1991).

``render_pass_wavefront`` routes as the JAX package does: image-textured
scenes take the image route (the persist launch loop at the image route's
tile height and launch bound, sorted with per-tile adaptive bounds on
scenes of >= 256 primitives); other scenes on ``sorted_persist_route``
(>= 256 primitives, at most 2 Mi slot lanes) run the sorted persist launch
loop; every other scene goes to the respawn megakernel K3
(``ops/megakernel.py``).  With ``per_bounce_segments`` an image scene runs
the segment loop instead: one K5 launch per bounce of every live lane,
which also banks and respawns the lanes that die in it, and a host sync
only once per chunk of launches.  The JAX image
route froze a lane on an image hit and resolved its texel in XLA between
launches; here the kernels fetch texels themselves, so the image route is
the same loop without freezes.

A pass keeps one lane per pixel slot (32x32 screen-block swizzle).  Each
launch of ``persist_step`` advances every lane through up to
``persist_iters`` iterations of: bank a finished path, respawn the lane's
next camera ray, one bounce.  Between launches the loop re-sorts the lanes
by a Morton code of their ray origin and direction octant, and at the end it
scatters the banked sums back to slot order and unswizzles them to pixels.

Lane state: a float32 ``[20, R]`` tensor with the JAX layout's rows — 0 time,
1-3 origin, 4-6 direction, 7-9 attenuation, 10-12 radiance, 13 alive,
14 bounce, 15 samples done, 16-18 banked sums, 19 mid-sample — plus an int32
``[R]`` slot tensor (the lane's pixel identity, which travels with it
through the sort).  ``persist_step`` updates the state in place.

Every draw comes from Philox keyed by (slot, absolute sample index, bounce,
stream) — never by launch — so a lane's path does not depend on which
launch, sorted position or kernel runs it: renders are bitwise invariant to
the sort and to ``persist_iters``, and K3 equals the unsorted loop.

Intersection: the CUDA kernels cull spheres with the two-level SAH cluster
hierarchy per thread (a slab test against the thread's own best t), and
boxes with their own clusters; the plain twin runs the same culls,
vectorised over lanes.  Both take the first strict minimum in table order,
spheres, then boxes, then quads, then constant media, so they pick the same
winner.  The cull is not exactly a full scan: see ``_sphere_hits_plain``.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..scene import (DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC, LIGHT_QUAD, METAL,
                     TEX_CHECKER, TEX_IMAGE, TEX_NOISE, Scene)
from . import _cuda
from .hit import (_BIG, Q_AB, Q_AG, Q_AR, Q_C2B, Q_C2G, Q_C2R, Q_DP, Q_FUZZ,
                  Q_IMG, Q_INVS, Q_IOR, Q_KIND, Q_NX, Q_NY, Q_NZ, Q_QX, Q_QY,
                  Q_QZ, Q_TEXK, Q_UX, Q_UY, Q_UZ, Q_VX, Q_VY, Q_VZ, Q_WX,
                  Q_WY, Q_WZ, T_MAX, T_MIN, quad_hits)
from .megakernel import (BA_AB, BA_AG, BA_AR, BA_C2B, BA_C2G, BA_C2R,
                         BA_FUZZ, BA_INVS, BA_IOR, BA_KIND, BA_TEXK, J_AB,
                         J_AG, J_AR, J_C2B, J_C2G, J_C2R, J_FUZZ, J_IMG,
                         J_INVR, J_INVS, J_IOR, J_KIND, J_TEXK, J_VX, J_VY,
                         J_VZ, L_AREA, L_CX, L_CY, L_CZ, L_DP, L_KIND, L_NX,
                         L_NY, L_NZ, L_QX, L_QY, L_QZ, L_RAD, L_UX, L_UY,
                         L_UZ, L_VX, L_VY, L_VZ, L_WX, L_WY, L_WZ, M_AB, M_AG,
                         M_AR, M_COS, M_CX, M_CY, M_CZ, M_HIZ, M_KIND, M_LOX,
                         M_NID, M_R2, M_SIN, TILE_LANES, Prepared, _BLK, _np,
                         active_primitive_count, check_tables, cluster_cull,
                         path_params,
                         prepare_megakernel_cached, render_pass_megakernel,
                         respawn_pass, respawn_tile_rows,
                         unswizzle_index_on)
from .rng import (STREAM_BOUNCE, STREAM_CAMERA, STREAM_MEDIA, STREAM_MIS_A,
                  STREAM_MIS_B, STREAM_TIME, seed_key, uniforms4)

_TWO_PI = 6.283185307179586
_INV_PI = 0.3183098861837907
# sphere UV constants as the JAX XLA sphere_uv rounds them to f32
_UV_PI = float(np.float32(3.14159265358979))
_UV_TWO_PI = float(np.float32(2.0 * 3.14159265358979))
RR_START_BOUNCE = 5
RR_P_MIN = 0.05
RR_P_MAX = 0.95
N_STATE = 20
N_SEG = 15  # rows of the segment kernel's state: the first 15 of N_STATE

# state rows read by the launch loops and the sort
R_OX, R_DX, R_RX, R_ALIVE, R_DONE, R_SX, R_MID = 1, 4, 10, 13, 15, 16, 19

# rays x table rows per chunk of the plain intersector's row scans
_PLAIN_CHUNK_ELEMS = 1 << 22


# ---------------------------------------------------------------- routing


def persist_plain_iters(spp: int) -> int:
    """Iterations per persist launch for non-image scenes (~spp/4, in
    [16, 128]; the JAX package's starting point, not yet retuned here)."""
    return max(16, min(spp // 4, 128))


def persist_sort_every(persist_iters: int) -> int:
    """Sort cadence: every launch boundary unless launches are short."""
    return 8 if persist_iters <= 8 else 1


# Iterations per launch on the image route (pallas_wavefront.py:86-91):
# image-sparse scenes, image-dense ones, and sorted ones.  The JAX
# package's starting points, tuned on the TPU, not yet on this card.
PERSIST_SPARSE_ITERS = 4
PERSIST_DENSE_ITERS = 8
PERSIST_SORT_ITERS = 8


def persist_adaptive_bounds(persist_iters: int) -> tuple:
    """Per-tile launch bounds (short, long, rel) for short-bound launches
    (pallas_wavefront.py:122-133): a tile whose live lanes span more than
    ``rel`` of the live lanes' extent gets the short bound in the next
    launch.  Long-bound launches keep uniform bounds (an empty tuple)."""
    return (4, 8, 0.25) if persist_iters <= 8 else ()


def texel_gate_heuristic(scene: Scene) -> bool:
    """True when image-textured primitives are a sliver of the scene
    (pallas_wavefront.py:199-218).  The JAX package gated its texel resolve
    on it; here it only picks the image route's launch bound."""
    img_mat = (_np(scene.tex_kind)[_np(scene.mat_tex)] == TEX_IMAGE)
    n_img = 0
    for mats, mask in ((scene.sph_mat, scene.sph_mask),
                       (scene.quad_mat, scene.quad_mask),
                       (scene.box_mat, scene.box_mask)):
        n_img += int(np.sum((_np(mask) > 0) & img_mat[_np(mats)]))
    return active_primitive_count(scene) > 8 * max(n_img, 1)


def wavefront_tile_rows(scene: Scene) -> int:
    """Rows of 128 lanes per tile on the image route
    (pallas_wavefront.py:958-970): 128 for scenes of at most 4 primitives,
    else 32.  It sets the lane padding and the per-tile bounds' tiles."""
    return 128 if active_primitive_count(scene) <= 4 else 32


def image_route_iters(scene: Scene, sort: bool) -> int:
    """Launch bound of the image route (pallas_wavefront.py:1063-1065)."""
    if sort:
        return PERSIST_SORT_ITERS
    return (PERSIST_SPARSE_ITERS if texel_gate_heuristic(scene)
            else PERSIST_DENSE_ITERS)


RAY_SORT_MAX_LANES = 1 << 21


def ray_sort_heuristic(scene: Scene, n_lanes: int = 0) -> bool:
    """Sort lanes between launches on primitive-heavy scenes (>= 256
    active primitives) of at most RAY_SORT_MAX_LANES lanes
    (pallas_wavefront.py:234-265).  ``RTT_SORT_RAYS=1`` forces the sort on
    below 2^24 lanes (where float32 slot ids stay exact), ``0`` forces it
    off.  The choice changes no table, so the prep cache does not key
    it."""
    env = os.environ.get("RTT_SORT_RAYS")
    if env is not None:
        return env not in ("0", "") and n_lanes < (1 << 24)
    if n_lanes > RAY_SORT_MAX_LANES:
        return False
    return active_primitive_count(scene) >= 256


def slot_lane_count(width: int, height: int) -> int:
    """Lanes of the swizzled slot space for an H x W framebuffer."""
    tiles_x = -(-width // _BLK)
    tiles_y = -(-height // _BLK)
    return tiles_x * tiles_y * _BLK * _BLK


def sorted_persist_route(scene: Scene, width: int, height: int) -> bool:
    """Non-image scene that takes the ray-sorted persist loop."""
    return ("image" not in scene.features
            and ray_sort_heuristic(scene, slot_lane_count(width, height)))


# ------------------------------------------------------------------- sort


def _morton8(q: torch.Tensor) -> torch.Tensor:
    """Spread each 8-bit int to every 3rd bit (Morton component)."""
    q = (q | (q << 16)) & 0x030000FF
    q = (q | (q << 8)) & 0x0300F00F
    q = (q | (q << 4)) & 0x030C30C3
    q = (q | (q << 2)) & 0x09249249
    return q


def _persist_sort_perm(state: torch.Tensor, slot: torch.Tensor,
                       spp: int) -> torch.Tensor:
    """Stable permutation that sorts lanes by key (pallas_wavefront.py:517):
    mid-sample lanes by 24-bit Morton code of the origin over the live
    lanes' bounding box, then direction octant; idle lanes with samples left
    at 2<<28 + slot; finished lanes last at 3<<28."""
    mid = state[R_MID]
    done = state[R_DONE]
    act = mid > 0.0
    big = 3e38

    def qaxis(v):
        mn = torch.min(torch.where(act, v, big))
        mx = torch.max(torch.where(act, v, -big))
        scale = 255.999 / torch.clamp(mx - mn, min=1e-20)
        return torch.clamp((v - mn) * scale, 0.0, 255.0).to(torch.int32)

    morton = (_morton8(qaxis(state[R_OX]))
              | (_morton8(qaxis(state[R_OX + 1])) << 1)
              | (_morton8(qaxis(state[R_OX + 2])) << 2))
    octant = ((state[R_DX] > 0).to(torch.int32)
              + 2 * (state[R_DX + 1] > 0).to(torch.int32)
              + 4 * (state[R_DX + 2] > 0).to(torch.int32))
    key_mid = (morton << 3) | octant
    finished = ~act & (done >= float(spp))
    key = torch.where(act, key_mid,
                      torch.where(finished, 3 << 28, (2 << 28) + slot))
    return torch.argsort(key, stable=True)


# ------------------------------------------------------------- plain step


def _slot_pixels(width: int, height: int, tile_rows: int):
    """Per-slot pixel coordinates (float32 numpy) under the 32x32
    swizzle, and the padded row count (pallas_wavefront.py:788)."""
    tiles_x = -(-width // _BLK)
    tiles_y = -(-height // _BLK)
    n_slots = tiles_x * tiles_y * _BLK * _BLK
    tile_r = tile_rows * TILE_LANES
    rows = (-(-n_slots // tile_r)) * tile_rows
    slot = np.arange(rows * TILE_LANES)
    px, py = _slot_xy(slot, width, height)
    return px.astype(np.float32), py.astype(np.float32), rows


def _slot_xy(slot, width: int, height: int):
    """Clamped pixel coordinates of slot ids (numpy or torch integers)."""
    tiles_x = -(-width // _BLK)
    blk = slot // (_BLK * _BLK)
    within = slot % (_BLK * _BLK)
    pxi = (blk % tiles_x) * _BLK + within % _BLK
    pyi = (blk // tiles_x) * _BLK + within // _BLK
    if isinstance(slot, torch.Tensor):
        return pxi.clamp(max=width - 1), pyi.clamp(max=height - 1)
    return np.minimum(pxi, width - 1), np.minimum(pyi, height - 1)


def spawn_rays(cam_u: torch.Tensor, px, py, u1, u2, u3, u4,
               defocus: bool, sample=None, sqrt_spp: int = 0):
    """Camera rays from pixel coordinates and four uniforms per lane
    (spawn_rays, pallas_megakernel.py:1817; Camera::get_ray,
    camera.rs:152-180).  With ``sqrt_spp`` > 0 the jitter is stratified by
    the absolute sample index ``sample`` (int64): its stratum is taken in
    integers, ``s % n^2`` and then ``% n`` and ``// n``, as the JAX
    package's XLA ``_strat_tuple`` does; its Pallas kernel takes it in f32
    with ``floor(s * (1 / n^2))``.  Returns (origin [3], direction [3]) row
    lists."""
    if sqrt_spp > 0:
        s_w = sample % (sqrt_spp * sqrt_spp)
        s_i = (s_w % sqrt_spp).to(torch.float32)
        s_j = (s_w // sqrt_spp).to(torch.float32)
        recip = _recip(sqrt_spp)
        jx = px + ((s_i + u1) * recip - 0.5)
        jy = py + ((s_j + u2) * recip - 0.5)
    else:
        jx = px + (u1 - 0.5)
        jy = py + (u2 - 0.5)
    ps = [cam_u[3 + k] + jx * cam_u[6 + k] + jy * cam_u[9 + k]
          for k in range(3)]
    if defocus:
        dr = torch.sqrt(u3)
        dth = u4 * _TWO_PI
        ddx = dr * torch.cos(dth)
        ddy = dr * torch.sin(dth)
        o = [cam_u[k] + ddx * cam_u[12 + k] + ddy * cam_u[15 + k]
             for k in range(3)]
    else:
        o = [cam_u[k] + torch.zeros_like(jx) for k in range(3)]
    return o, [ps[k] - o[k] for k in range(3)]


def _recip(n: int) -> float:
    """1/n rounded once to float32, as the kernel's ``1.0f / (float)n``."""
    return float(np.float32(1.0) / np.float32(n))


def _sphere_rows_min(geom: torch.Tensor, ox, oy, oz, dx, dy, dz, a, inv_a,
                     vel: torch.Tensor | None = None, tm=None):
    """(least valid root [n], first row at it [n]) of rays against the
    sphere rows ``geom`` [M, 4]: the sequential strict-``<`` scan of
    csrc/path.cuh ``scan_spheres``, with the centers moved to the rays'
    times ``tm`` by ``vel`` [M, 4] when given.  ``_BIG`` where no row is
    hit."""
    n = ox.shape[0]
    M = geom.shape[0]
    cx0, cy0, cz0, r2 = (geom[None, :, k] for k in range(4))
    bt = torch.empty_like(ox)
    bi = torch.empty(n, dtype=torch.int64, device=ox.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(M, 1))
    for lo in range(0, n, step):
        s = slice(lo, min(n, lo + step))
        cx, cy, cz = cx0, cy0, cz0
        if vel is not None:
            # center at the ray's time (sphere.rs:30-35)
            t = tm[s, None]
            cx = cx + t * vel[None, :, 0]
            cy = cy + t * vel[None, :, 1]
            cz = cz + t * vel[None, :, 2]
        ocx = cx - ox[s, None]
        ocy = cy - oy[s, None]
        ocz = cz - oz[s, None]
        h = dx[s, None] * ocx + dy[s, None] * ocy + dz[s, None] * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r2
        disc = h * h - a[s, None] * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        tn = (h - sq) * inv_a[s, None]
        tf = (h + sq) * inv_a[s, None]
        root = torch.where((tn > T_MIN) & (tn < T_MAX), tn, tf)
        ok = (disc > 0.0) & (root > T_MIN) & (root < T_MAX)
        bt[s], bi[s] = torch.min(torch.where(ok, root, _BIG), dim=1)
    return bt, bi


def _safe_inv(d):
    """1 / d with |d| raised to 1e-20 (csrc/path.cuh ``safe_inv``)."""
    sg = torch.where(d < 0.0, -1e-20, 1e-20)
    return 1.0 / torch.where(torch.abs(d) < 1e-20, sg, d)


def _slab(b, ox, oy, oz, ivx, ivy, ivz):
    """Slab entry and exit (t1, t2) of the box b = (lo3, hi3) (csrc/path.cuh
    ``slab``); b's entries broadcast against the rays."""
    tx1, tx2 = (b[0] - ox) * ivx, (b[3] - ox) * ivx
    ty1, ty2 = (b[1] - oy) * ivy, (b[4] - oy) * ivy
    tz1, tz2 = (b[2] - oz) * ivz, (b[5] - oz) * ivz
    mn, mx = torch.minimum, torch.maximum
    return (mx(mx(mn(tx1, tx2), mn(ty1, ty2)), mn(tz1, tz2)),
            mn(mn(mx(tx1, tx2), mx(ty1, ty2)), mx(tz1, tz2)))


def _box_hit(b, ox, oy, oz, ivx, ivy, ivz, bt):
    """Slab test of the box b = (lo3, hi3) against rays, entry before ``bt``
    (csrc/path.cuh ``box_hit``; pallas_megakernel.py:797)."""
    t1, t2 = _slab(b, ox, oy, oz, ivx, ivy, ivz)
    return (t1 <= t2) & (t2 > T_MIN) & (t1 < bt)


def _culled_min(bt, bi, clusters, rows_min, ox, oy, oz, iv):
    """Walk ``clusters`` [(box, lo, hi)] in order: the lanes whose ray
    enters a cluster's box before their best t so far scan its rows
    ``rows_min(lo, hi, lane index)`` -> (t, row), and keep a strictly
    smaller t.  Updates ``bt`` and ``bi`` in place."""
    for box, lo, hi in clusters:
        sel = _box_hit(box, ox, oy, oz, *iv, bt).nonzero().squeeze(1)
        if sel.numel() == 0:
            continue
        t, i = rows_min(lo, hi, sel)
        take = t < bt[sel]
        bt[sel] = torch.where(take, t, bt[sel])
        bi[sel] = torch.where(take, i + lo, bi[sel])


def _sphere_hits_plain(prep: Prepared, ox, oy, oz, dx, dy, dz, a, inv_a,
                       tm=None):
    """(best t [n], sphere winner row [n]) through the kernels' per-thread
    cull: super-cluster and cluster boxes in table order, each slab-tested
    against the ray's best t so far, then the rows of each cluster it
    enters.  The cull is what the kernels compute, not a brute-force scan:
    where an f32 root lies past its cluster's box (a ray leaving the
    r = 1000 ground sphere just under its surface, whose root carries the
    rounding of |oc|^2 - r^2), the box test drops the hit in both.

    A moving scene moves every center to the ray's time: the kernels skip
    the velocity reads on static super-clusters, whose zero velocities
    leave the centers unchanged."""
    vel = prep.gvel if prep.moving else None
    if prep.n_clusters == 0:
        return _sphere_rows_min(prep.geom, ox, oy, oz, dx, dy, dz, a, inv_a,
                                vel, tm)
    n = ox.shape[0]
    bt = torch.full_like(ox, _BIG)
    bi = torch.zeros(n, dtype=torch.int64, device=ox.device)
    iv = [_safe_inv(x) for x in (dx, dy, dz)]
    clb = prep.clb.tolist()
    starts = [int(v) * prep.unroll for v in prep.cls.tolist()]
    if prep.n_sclusters > 1:
        sclb, scls = prep.sclb.tolist(), prep.scls.tolist()
        groups = [(sclb[g], range(scls[g], scls[g + 1]))
                  for g in range(prep.n_sclusters)]
    else:
        groups = [(None, range(prep.n_clusters))]
    ray = (ox, oy, oz, dx, dy, dz, a, inv_a)

    def rows_min(lo, hi, sel):
        return _sphere_rows_min(
            prep.geom[lo:hi], *(x[sel] for x in ray),
            None if vel is None else vel[lo:hi],
            None if vel is None else tm[sel])

    for sbox, clusters in groups:
        sub = (torch.arange(n, device=ox.device) if sbox is None
               else _box_hit(sbox, ox, oy, oz, *iv, bt).nonzero().squeeze(1))
        if sub.numel() == 0:
            continue
        # the lanes that entered the super-cluster, as one sub-problem
        bt_s, bi_s = bt[sub], bi[sub]
        _culled_min(
            bt_s, bi_s, [(clb[c], starts[c], starts[c + 1]) for c in clusters],
            lambda lo, hi, sel: rows_min(lo, hi, sub[sel]),
            *(x[sub] for x in (ox, oy, oz)), [x[sub] for x in iv])
        bt[sub], bi[sub] = bt_s, bi_s
    return bt, bi


def _box_rows_min(btab: torch.Tensor, ox, oy, oz, ivx, ivy, ivz):
    """(least valid root [n], first row at it [n]) of rays against the box
    rows ``btab`` [M, 8]: the entry face if its t is in (T_MIN, T_MAX), else
    the exit face (csrc/path.cuh ``scan_boxes``).  ``_BIG`` where none."""
    n, M = ox.shape[0], btab.shape[0]
    bt = torch.empty_like(ox)
    bi = torch.empty(n, dtype=torch.int64, device=ox.device)
    b = [btab[None, :, k] for k in range(6)]
    step = max(1, _PLAIN_CHUNK_ELEMS // max(M, 1))
    for lo in range(0, n, step):
        s = slice(lo, min(n, lo + step))
        t1, t2 = _slab(b, *(x[s, None] for x in (ox, oy, oz, ivx, ivy, ivz)))
        near_ok = (t1 > T_MIN) & (t1 < T_MAX)
        root = torch.where(near_ok, t1, t2)
        ok = (t1 < t2) & (root > T_MIN) & (root < T_MAX)
        bt[s], bi[s] = torch.min(torch.where(ok, root, _BIG), dim=1)
    return bt, bi


def _box_hits_plain(prep: Prepared, ox, oy, oz, iv, bt):
    """Box winner row [n] or -1 after the spheres, through the box-cluster
    cull (one flat scan when there is a single cluster); lowers ``bt`` in
    place where a box is strictly closer."""
    boxi = torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
    if prep.n_bclusters <= 1:
        t, i = _box_rows_min(prep.btab[:prep.n_boxes], ox, oy, oz, *iv)
        take = t < bt
        bt.copy_(torch.where(take, t, bt))
        return torch.where(take, i, boxi)
    U = prep.b_unroll
    bclb = prep.bclb.tolist()
    starts = [int(v) * U for v in prep.bcls.tolist()]
    _culled_min(
        bt, boxi, [(bclb[c], starts[c], starts[c + 1])
                   for c in range(prep.n_bclusters)],
        lambda lo, hi, sel: _box_rows_min(
            prep.btab[lo:hi], *(x[sel] for x in (ox, oy, oz, *iv))),
        ox, oy, oz, iv)
    return boxi


def _media_hits_plain(prep: Prepared, ox, oy, oz, dx, dy, dz, a, inv_a, bt,
                      u_media):
    """Medium winner [n] or -1: each constant medium in table order samples
    a free flight inside its boundary, clipped by the running closest hit
    (pallas_megakernel.py:1100-1199; csrc/path.cuh ``intersect``);
    ``u_media`` holds one uniform per medium.  Lowers ``bt`` in place."""
    mi = torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
    kinds = prep.mtab[:prep.n_media, M_KIND].tolist()
    inv_len_m = 1.0 / torch.sqrt(a)
    dlen = a * inv_len_m
    for m in range(prep.n_media):
        mr = prep.mtab[m]
        if kinds[m] < 0.5:
            # sphere boundary roots over (-inf, inf)
            ocx = mr[M_CX] - ox
            ocy = mr[M_CY] - oy
            ocz = mr[M_CZ] - oz
            hh = dx * ocx + dy * ocy + dz * ocz
            cc = ocx * ocx + ocy * ocy + ocz * ocz - mr[M_R2]
            disc = hh * hh - a * cc
            sqd = torch.sqrt(torch.clamp(disc, min=0.0))
            t1 = (hh - sqd) * inv_a
            t2 = (hh + sqd) * inv_a
            in_ok = disc > 0.0
        else:
            # oriented box: world -> local (offset, then rotate by -theta)
            cth, sth = mr[M_COS], mr[M_SIN]
            rox = ox - mr[M_CX]
            roz = oz - mr[M_CZ]
            lo3 = (cth * rox - sth * roz, oy - mr[M_CY], sth * rox + cth * roz)
            il = (_safe_inv(cth * dx - sth * dz), _safe_inv(dy),
                  _safe_inv(sth * dx + cth * dz))
            t1, t2 = _slab(mr[M_LOX:M_HIZ + 1], *lo3, *il)
            in_ok = t1 < t2
        t1c = torch.clamp(t1, min=T_MIN)
        t2c = torch.minimum(t2, bt)
        ok = in_ok & (t1c < t2c)
        t1c = torch.clamp(t1c, min=0.0)
        dist_inside = (t2c - t1c) * dlen
        hitd = mr[M_NID] * torch.log(torch.clamp(u_media[m], min=1e-12))
        ok = ok & (hitd <= dist_inside)
        t_med = t1c + hitd * inv_len_m
        take = ok & (t_med < bt)
        bt.copy_(torch.where(take, t_med, bt))
        mi = torch.where(take, m, mi)
    return mi


def _quad_rows_min(qtab: torch.Tensor, ox, oy, oz, dx, dy, dz):
    """(least hit t [n], first row at it [n]) of rays against the quad rows
    ``qtab`` [M, 32] (csrc/path.cuh ``scan_quads``); ``_BIG`` where none."""
    tq, okq = quad_hits(qtab, *(x[:, None] for x in (ox, oy, oz, dx, dy, dz)))
    return torch.min(torch.where(okq, tq, _BIG), dim=1)


def _intersect_plain(prep: Prepared, ox, oy, oz, dx, dy, dz, a, inv_a,
                     tm=None, u_media=None):
    """(best t, sphere row, quad row, box row, medium) [n] each, -1 where
    that class did not set the best t: spheres through the kernels' cluster
    cull, then the boxes through theirs, then the quads (through their
    cluster cull when there are two or more quad clusters), then the constant
    media (``u_media``: a uniform per medium), each with a strict ``<`` in
    table order, so an earlier class wins a tie.  The last class that set
    its row is the winner."""
    bt, bi = _sphere_hits_plain(prep, ox, oy, oz, dx, dy, dz, a, inv_a, tm)
    neg = torch.full_like(bi, -1)
    boxi = neg
    if prep.n_boxes:
        iv = [_safe_inv(x) for x in (dx, dy, dz)]
        boxi = _box_hits_plain(prep, ox, oy, oz, iv, bt)
    qi = neg
    if prep.n_qclusters > 1:
        qi = neg.clone()
        meta = prep.qtab[prep.n_quads:].tolist()
        _culled_min(
            bt, qi, [(m[:6], int(m[6]), int(m[7])) for m in meta],
            lambda lo, hi, sel: _quad_rows_min(
                prep.qtab[lo:hi], *(x[sel] for x in (ox, oy, oz, dx, dy, dz))),
            ox, oy, oz, [_safe_inv(x) for x in (dx, dy, dz)])
    elif prep.n_quads:
        qt, qbest = _quad_rows_min(prep.qtab[:prep.n_quads], ox, oy, oz, dx,
                                   dy, dz)
        take = qt < bt
        bt = torch.where(take, qt, bt)
        qi = torch.where(take, qbest, qi)
    mi = neg
    if prep.n_media:
        mi = _media_hits_plain(prep, ox, oy, oz, dx, dy, dz, a, inv_a, bt,
                               u_media)
    return bt, bi, qi, boxi, mi


def _onb(wx, wy, wz):
    """Orthonormal (u, v) around unit w (csrc/path.cuh onb;
    pallas_megakernel.py:1590-1606)."""
    big = torch.abs(wx) > 0.9
    hx = torch.where(big, 0.0, 1.0)
    hy = torch.where(big, 1.0, 0.0)
    cx = -wz * hy
    cy = wz * hx
    cz = wx * hy - wy * hx
    inv = 1.0 / torch.sqrt(torch.clamp(cx * cx + cy * cy + cz * cz,
                                       min=1e-30))
    vx, vy, vz = cx * inv, cy * inv, cz * inv
    return (wy * vz - wz * vy, wz * vx - wx * vz, wx * vy - wy * vx,
            vx, vy, vz)


def _light_samples(prep: Prepared, px_, py_, pz_, u7, u8):
    """Per-light sampled directions (HittableList::random,
    hittable_list.rs:71-75): quad points q + u7 u + u8 v - p, and uniform
    directions in the cone a sphere light subtends (sphere.rs:55-65)."""
    out = []
    for lt, kind in zip(prep.ltab, _light_kinds(prep)):
        if kind == LIGHT_QUAD:
            out.append((lt[L_QX] + u7 * lt[L_UX] + u8 * lt[L_VX] - px_,
                        lt[L_QY] + u7 * lt[L_UY] + u8 * lt[L_VY] - py_,
                        lt[L_QZ] + u7 * lt[L_UZ] + u8 * lt[L_VZ] - pz_))
            continue
        tcx = lt[L_CX] - px_
        tcy = lt[L_CY] - py_
        tcz = lt[L_CZ] - pz_
        d2 = torch.clamp(tcx * tcx + tcy * tcy + tcz * tcz, min=1e-30)
        rl = lt[L_RAD]
        cmax = torch.sqrt(torch.clamp(1.0 - rl * rl / d2, min=0.0))
        zc = 1.0 + u8 * (cmax - 1.0)
        phl = _TWO_PI * u7
        sc = torch.sqrt(torch.clamp(1.0 - zc * zc, min=0.0))
        idl = 1.0 / torch.sqrt(d2)
        w2x, w2y, w2z = tcx * idl, tcy * idl, tcz * idl
        sux, suy, suz, svx, svy, svz = _onb(w2x, w2y, w2z)
        csl = torch.cos(phl) * sc
        snl = torch.sin(phl) * sc
        out.append((csl * sux + snl * svx + zc * w2x,
                    csl * suy + snl * svy + zc * w2y,
                    csl * suz + snl * svz + zc * w2z))
    return out


def _light_kinds(prep: Prepared) -> list:
    return [int(k) for k in prep.ltab[:prep.n_lights, L_KIND].tolist()]


def light_pdf(prep: Prepared, px_, py_, pz_, gdx, gdy, gdz, g2, ginv):
    """Mean over the NEE lights of each light's pdf of direction g from p
    (hittable_list.rs:60-69): quad area pdf (quad.rs:92-102), sphere
    solid-angle pdf (sphere.rs:102-115).  ``g2 = max(|g|^2, 1e-30)``,
    ``ginv = 1 / sqrt(g2)``."""
    lp = torch.zeros_like(px_)
    for lt, kind in zip(prep.ltab, _light_kinds(prep)):
        if kind == LIGHT_QUAD:
            lnx, lny, lnz = lt[L_NX], lt[L_NY], lt[L_NZ]
            dn = lnx * gdx + lny * gdy + lnz * gdz
            safe = torch.where(torch.abs(dn) < 1e-8, 1.0, dn)
            ndp = lnx * px_ + lny * py_ + lnz * pz_
            tq = (lt[L_DP] - ndp) / safe
            hx = px_ + tq * gdx - lt[L_QX]
            hy = py_ + tq * gdy - lt[L_QY]
            hz = pz_ + tq * gdz - lt[L_QZ]
            lux, luy, luz = lt[L_UX], lt[L_UY], lt[L_UZ]
            lvx, lvy, lvz = lt[L_VX], lt[L_VY], lt[L_VZ]
            lwx, lwy, lwz = lt[L_WX], lt[L_WY], lt[L_WZ]
            alp = (lwx * (hy * lvz - hz * lvy) + lwy * (hz * lvx - hx * lvz)
                   + lwz * (hx * lvy - hy * lvx))
            bet = (lwx * (luy * hz - luz * hy) + lwy * (luz * hx - lux * hz)
                   + lwz * (lux * hy - luy * hx))
            okq = ((torch.abs(dn) >= 1e-8) & (tq > T_MIN) & (tq < T_MAX)
                   & (alp >= 0.0) & (alp <= 1.0) & (bet >= 0.0)
                   & (bet <= 1.0))
            cosq = torch.abs(dn) * ginv
            pdf = torch.where(okq, tq * tq * g2 / torch.clamp(
                cosq * lt[L_AREA], min=1e-30), 0.0)
        else:
            ocx = lt[L_CX] - px_
            ocy = lt[L_CY] - py_
            ocz = lt[L_CZ] - pz_
            hq = gdx * ocx + gdy * ocy + gdz * ocz
            rl = lt[L_RAD]
            cq = ocx * ocx + ocy * ocy + ocz * ocz - rl * rl
            disc = hq * hq - g2 * cq
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            inv_g2 = 1.0 / g2
            tn = (hq - sq) * inv_g2
            tf = (hq + sq) * inv_g2
            rt = torch.where((tn > T_MIN) & (tn < T_MAX), tn, tf)
            oks = (disc > 0.0) & (rt > T_MIN) & (rt < T_MAX)
            d2 = torch.clamp(ocx * ocx + ocy * ocy + ocz * ocz, min=1e-30)
            cmax = torch.sqrt(torch.clamp(1.0 - rl * rl / d2, min=0.0))
            sang = _TWO_PI * (1.0 - cmax)
            pdf = torch.where(oks, 1.0 / torch.clamp(sang, min=1e-30), 0.0)
        lp = lp + pdf
    return lp * _recip(prep.n_lights)


def _box_normal(bb, ox, oy, oz, dx, dy, dz):
    """Outward normal of the box face a ray enters, or leaves from inside
    (csrc/path.cuh ``bounce``; pallas_megakernel.py:996-1036): entry -> the
    last slab entry, exit -> the first slab exit, with its >= / <= tie
    breaks.  ``bb`` [n, 8] holds the winning boxes' lo3, hi3."""
    ivx, ivy, ivz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    tx1 = (bb[:, 0] - ox) * ivx
    tx2 = (bb[:, 3] - ox) * ivx
    ty1 = (bb[:, 1] - oy) * ivy
    ty2 = (bb[:, 4] - oy) * ivy
    tz1 = (bb[:, 2] - oz) * ivz
    tz2 = (bb[:, 5] - oz) * ivz
    mn, mx = torch.minimum, torch.maximum
    txn, txf = mn(tx1, tx2), mx(tx1, tx2)
    tyn, tyf = mn(ty1, ty2), mx(ty1, ty2)
    tzn, tzf = mn(tz1, tz2), mx(tz1, tz2)
    t1b = mx(mx(txn, tyn), tzn)
    entry = (t1b > T_MIN) & (t1b < T_MAX)
    ex_ = (txn >= tyn) & (txn >= tzn)
    ey_ = ~ex_ & (tyn >= tzn)
    xx_ = (txf <= tyf) & (txf <= tzf)
    xy_ = ~xx_ & (tyf <= tzf)
    usex = (entry & ex_) | (~entry & xx_)
    usey = (entry & ey_) | (~entry & xy_)
    s_e = torch.where(entry, -1.0, 1.0)

    def sgn(d):
        return s_e * torch.where(d >= 0.0, 1.0, -1.0)

    return (torch.where(usex, sgn(dx), 0.0), torch.where(usey, sgn(dy), 0.0),
            torch.where(usex | usey, 0.0, sgn(dz)))


def _noise_at(prep: Prepared, qx, qy, qz):
    """Perlin lattice noise (perlin.rs:25-98; csrc/path.cuh ``noise_at``):
    Hermite-smoothed blend of the 8 corner gradients, corner indices xor-
    combined from the three permutations with ``& 255`` wrapping (two's
    complement for negative floors)."""
    fx, fy, fz = torch.floor(qx), torch.floor(qy), torch.floor(qz)
    ux, uy, uz = qx - fx, qy - fy, qz - fz
    iq, jq, kq = (f.to(torch.int32) for f in (fx, fy, fz))
    sx = ux * ux * (3.0 - 2.0 * ux)
    sy = uy * uy * (3.0 - 2.0 * uy)
    sz = uz * uz * (3.0 - 2.0 * uz)
    perm = prep.perm.long()
    acc = torch.zeros_like(qx)
    for di in range(2):
        pi = perm[0][((iq + di) & 255).long()]
        wxf = sx if di else (1.0 - sx)
        for dj in range(2):
            pj = perm[1][((jq + dj) & 255).long()]
            wyf = sy if dj else (1.0 - sy)
            for dk in range(2):
                pk = perm[2][((kq + dk) & 255).long()]
                c = prep.randvec[pi ^ pj ^ pk]
                dot = (c[:, 0] * (ux - float(di)) + c[:, 1] * (uy - float(dj))
                       + c[:, 2] * (uz - float(dk)))
                wzf = sz if dk else (1.0 - sz)
                acc = acc + wxf * wyf * wzf * dot
    return acc


def _marble(prep: Prepared, scale, px, py, pz):
    """0.5 (1 + sin(scale z + 10 turb(p, 7))) (texture.rs:122-126,
    perlin.rs:50-62; csrc/path.cuh ``marble``)."""
    tacc = torch.zeros_like(px)
    wgt, qx, qy, qz = 1.0, px, py, pz
    for _ in range(7):
        tacc = tacc + wgt * _noise_at(prep, qx, qy, qz)
        wgt = wgt * 0.5
        qx, qy, qz = qx * 2.0, qy * 2.0, qz * 2.0
    return 0.5 * (1.0 + torch.sin(scale * pz + 10.0 * torch.abs(tacc)))


def sphere_uv(owx, owy, owz):
    """Sphere (u, v) from the pre-flip outward normal, with the XLA
    sphere_uv's pole guards (ops/intersect.py:309-328 there; sphere.rs:47-53;
    csrc/path.cuh ``sphere_uv``)."""
    y = torch.clamp(-owy, -1.0, 1.0)
    safe = torch.abs(y) < 0.999999
    theta = torch.acos(torch.where(safe, y, 0.0))
    theta = torch.where(safe, theta, torch.where(y > 0.0, 0.0, _UV_PI))
    deg = (torch.abs(owx) < 1e-12) & (torch.abs(owz) < 1e-12)
    phi = torch.atan2(torch.where(deg, 0.0, -owz),
                      torch.where(deg, 1.0, owx)) + _UV_PI
    return phi / _UV_TWO_PI, theta / _UV_PI


def _quad_uv(q, ox, oy, oz, dx, dy, dz):
    """A quad's (u, v) at the hit: its planar coordinates alpha, beta, in
    the order of ``hit.quad_hits`` (quad.rs:84-86); ``q`` [n, 32] holds the
    winning rows."""
    nqx, nqy, nqz = q[:, Q_NX], q[:, Q_NY], q[:, Q_NZ]
    denom = dx * nqx + dy * nqy + dz * nqz
    safe = torch.where(torch.abs(denom) < 1e-8, 1.0, denom)
    tq = (q[:, Q_DP] - (ox * nqx + oy * nqy + oz * nqz)) / safe
    relx = ox + tq * dx - q[:, Q_QX]
    rely = oy + tq * dy - q[:, Q_QY]
    relz = oz + tq * dz - q[:, Q_QZ]
    ux, uy, uz = q[:, Q_UX], q[:, Q_UY], q[:, Q_UZ]
    vx, vy, vz = q[:, Q_VX], q[:, Q_VY], q[:, Q_VZ]
    wx, wy, wz = q[:, Q_WX], q[:, Q_WY], q[:, Q_WZ]
    return (wx * (rely * vz - relz * vy) + wy * (relz * vx - relx * vz)
            + wz * (relx * vy - rely * vx),
            wx * (uy * relz - uz * rely) + wy * (uz * relx - ux * relz)
            + wz * (ux * rely - uy * relx))


def image_texel(prep: Prepared, img, u, v):
    """Nearest texel of image ``img`` at clamped (u, v), v flipped
    (texture.rs:89-109; ops/textures.py image_texel there; csrc/path.cuh
    ``image_texel``): (r, g, b) [n] each."""
    meta = prep.img_meta.long()
    k = torch.clamp(img.to(torch.int64), 0, meta.shape[0] - 1)
    base, w, h = meta[k, 0], meta[k, 1], meta[k, 2]
    uc = torch.clamp(u, 0.0, 1.0)
    vc = 1.0 - torch.clamp(v, 0.0, 1.0)
    i = torch.minimum((uc * w.to(torch.float32)).to(torch.int64), w - 1)
    j = torch.minimum((vc * h.to(torch.float32)).to(torch.int64), h - 1)
    tx = prep.texels[base + j * w + i]
    return tx[:, 0], tx[:, 1], tx[:, 2]


def _apply_textures(prep: Prepared, alb, tex, qwin, qrow, ray, ow, p):
    """The winner's texture replaces its albedo (TEX_CHECKER, TEX_NOISE,
    TEX_IMAGE; csrc/path.cuh ``bounce``).  Each is evaluated on the lanes
    that need it only."""
    car, cag, cab = alb
    tk, c2r, c2g, c2b, ivs, img = tex
    px_, py_, pz_ = p

    def put(sel, vals):
        nonlocal car, cag, cab
        car, cag, cab = (x.index_put((sel,), y)
                         for x, y in zip((car, cag, cab), vals))

    if prep.has_checker:
        sel = (tk == float(TEX_CHECKER)).nonzero().squeeze(1)
        if sel.numel():
            # 3-D lattice parity: odd cells take the second color
            s = ivs[sel]
            csum = (torch.floor(s * px_[sel]).to(torch.int32)
                    + torch.floor(s * py_[sel]).to(torch.int32)
                    + torch.floor(s * pz_[sel]).to(torch.int32))
            odd = csum % 2 != 0
            put(sel, (torch.where(odd, c[sel], x[sel]) for c, x in
                      zip((c2r, c2g, c2b), (car, cag, cab))))
    if prep.has_noise:
        sel = (tk == float(TEX_NOISE)).nonzero().squeeze(1)
        if sel.numel():
            mv = _marble(prep, ivs[sel], px_[sel], py_[sel], pz_[sel])
            put(sel, (mv, mv, mv))
    if prep.has_image:
        sel = (tk == float(TEX_IMAGE)).nonzero().squeeze(1)
        if sel.numel():
            su, sv = sphere_uv(*(x[sel] for x in ow))
            qu, qv = _quad_uv(qrow[sel], *(x[sel] for x in ray))
            qs = qwin[sel]
            put(sel, image_texel(prep, img[sel], torch.where(qs, qu, su),
                                 torch.where(qs, qv, sv)))
    return car, cag, cab


def _bounce_plain(prep: Prepared, v: dict, u, u_mis, u_media,
                  max_depth: int) -> None:
    """One bounce of live lanes (bounce_body, pallas_megakernel.py:1202-1771:
    spheres, moving or not, boxes, quads and constant media; solid, checker,
    Perlin-marble and image albedos; the path integrator, or with
    ``prep.mis`` the NEE/MIS estimator),
    updating ``v`` in place.  ``u_mis`` holds u5-u10, ``u_media`` a uniform
    per medium.  Expression order matches csrc/path.cuh, which is built
    without contracted multiply-adds, so the two round identically."""
    ox, oy, oz, dx, dy, dz = (v[k] for k in ("ox", "oy", "oz",
                                             "dx", "dy", "dz"))
    ax, ay, az, rx, ry, rz = (v[k] for k in ("ax", "ay", "az",
                                             "rx", "ry", "rz"))
    alive, b, tm = v["alive"], v["b"], v["tm"]
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    t, bi, qi, boxi, mi = _intersect_plain(prep, ox, oy, oz, dx, dy, dz, a,
                                           inv_a, tm, u_media)
    hit = t < _BIG
    # the final winner: the last class that set its row
    mwin = mi >= 0
    qwin = ~mwin & (qi >= 0)
    bwin = ~mwin & ~qwin & (boxi >= 0)
    swin = ~(mwin | qwin | bwin)
    row = prep.tab[torch.where(hit & swin, bi, 0)]
    qrow = prep.qtab[torch.where(qwin, qi, 0)]
    brow = prep.batt[torch.where(bwin, boxi, 0)]
    mrow = prep.mtab[torch.where(mwin, mi, 0)]

    def pick(qcol, bcol, scol, mval):
        """The winner's column: quad, box, sphere, or the medium's value."""
        out = torch.where(qwin, qrow[:, qcol], torch.where(
            bwin, brow[:, bcol], row[:, scol]))
        return torch.where(mwin, mval, out)

    kind = pick(Q_KIND, BA_KIND, J_KIND, float(ISOTROPIC))
    kind = torch.where(hit, kind, 0.0)
    car = pick(Q_AR, BA_AR, J_AR, mrow[:, M_AR])
    cag = pick(Q_AG, BA_AG, J_AG, mrow[:, M_AG])
    cab = pick(Q_AB, BA_AB, J_AB, mrow[:, M_AB])
    fz = pick(Q_FUZZ, BA_FUZZ, J_FUZZ, 0.0)
    io = pick(Q_IOR, BA_IOR, J_IOR, 1.0)
    invr = row[:, J_INVR]
    cxw, cyw, czw = row[:, 0], row[:, 1], row[:, 2]
    if prep.moving:
        cxw = cxw + tm * row[:, J_VX]
        cyw = cyw + tm * row[:, J_VY]
        czw = czw + tm * row[:, J_VZ]
    sow = (torch.where(hit, (t * dx - (cxw - ox)) * invr, 0.0),
           torch.where(hit, (t * dy - (cyw - oy)) * invr, 0.0),
           torch.where(hit, (t * dz - (czw - oz)) * invr, 1.0))
    ow = [torch.where(qwin, qrow[:, c], s)
          for c, s in zip((Q_NX, Q_NY, Q_NZ), sow)]
    if prep.n_boxes:
        bn = _box_normal(prep.btab[torch.where(bwin, boxi, 0)], ox, oy, oz,
                         dx, dy, dz)
        ow = [torch.where(bwin, n_, o_) for n_, o_ in zip(bn, ow)]
    # a medium scatters isotropically with a fixed normal
    # (constant_medium.rs:70-78)
    owx, owy, owz = (torch.where(mwin, m_, o_)
                     for m_, o_ in zip((1.0, 0.0, 0.0), ow))

    # background on a miss (renderer.wgsl:233-239)
    inv_len = 1.0 / torch.sqrt(a)
    if prep.sky_bg:
        sa = 0.5 * (dy * inv_len + 1.0)
        bgr = (1.0 - sa) + sa * 0.5
        bgg = (1.0 - sa) + sa * 0.7
        bgb = (1.0 - sa) + sa * 1.0
    else:
        bgr, bgg, bgb = prep.bg[0], prep.bg[1], prep.bg[2]
    missf = alive * torch.where(hit, 0.0, 1.0)
    rx = rx + missf * ax * bgr
    ry = ry + missf * ay * bgg
    rz = rz + missf * az * bgb
    alive = alive * torch.where(hit, 1.0, 0.0)
    px_ = ox + t * dx
    py_ = oy + t * dy
    pz_ = oz + t * dz

    if prep.has_checker or prep.has_noise or prep.has_image:
        # the winner's texture: kind, second color, scale and image (a
        # medium's is solid; a box carries no image)
        tex = (torch.where(hit, pick(Q_TEXK, BA_TEXK, J_TEXK, 0.0), 0.0),
               pick(Q_C2R, BA_C2R, J_C2R, 0.0),
               pick(Q_C2G, BA_C2G, J_C2G, 0.0),
               pick(Q_C2B, BA_C2B, J_C2B, 0.0),
               pick(Q_INVS, BA_INVS, J_INVS, 0.0),
               torch.where(qwin, qrow[:, Q_IMG], torch.where(
                   hit & swin, row[:, J_IMG], 0.0)))
        car, cag, cab = _apply_textures(
            prep, (car, cag, cab), tex, qwin, qrow, (ox, oy, oz, dx, dy, dz),
            (owx, owy, owz), (px_, py_, pz_))

    d_dot_ow = dx * owx + dy * owy + dz * owz
    front = d_dot_ow < 0.0
    sgn = torch.where(front, 1.0, -1.0)
    nx = sgn * owx
    ny = sgn * owy
    nz = sgn * owz

    # emission (DiffuseLight adds, then dies); book 3 counts the front face
    # only (the_rest_of_your_life/material.rs:154-161)
    is_light = kind == float(DIFFUSE_LIGHT)
    emit = is_light & front if prep.mis else is_light
    lf = alive * torch.where(emit, 1.0, 0.0)
    rx = rx + lf * ax * car
    ry = ry + lf * ay * cag
    rz = rz + lf * az * cab
    alive = alive * torch.where(is_light, 0.0, 1.0)

    u1, u2, u3, u4 = u
    # shared random unit vector (renderer.wgsl:78-83)
    rz_ = u2 * 2.0 - 1.0
    rr_ = torch.sqrt(torch.clamp(1.0 - rz_ * rz_, min=0.0))
    phi = u1 * _TWO_PI
    rvx = rr_ * torch.cos(phi)
    rvy = rr_ * torch.sin(phi)
    rvz = rz_
    # lambertian: n + ruv with degenerate guard
    lx = nx + rvx
    ly = ny + rvy
    lz = nz + rvz
    near0 = (lx * lx + ly * ly + lz * lz) < 1e-16
    lx = torch.where(near0, nx, lx)
    ly = torch.where(near0, ny, ly)
    lz = torch.where(near0, nz, lz)
    # metal: reflect(unit d, n) + fuzz * ruv
    ux = dx * inv_len
    uy = dy * inv_len
    uz = dz * inv_len
    udn = ux * nx + uy * ny + uz * nz
    mx = ux - 2.0 * udn * nx + fz * rvx
    my = uy - 2.0 * udn * ny + fz * rvy
    mz = uz - 2.0 * udn * nz + fz * rvz
    met_ok = (mx * nx + my * ny + mz * nz) > 0.0
    # dielectric: Snell / total internal reflection / Schlick choice
    ri = torch.where(front, 1.0 / io, io)
    cos_t = torch.clamp(-udn, max=1.0)
    sin2 = torch.clamp(1.0 - cos_t * cos_t, min=0.0)
    cannot = ri * ri * sin2 > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    one_m = 1.0 - cos_t
    om2 = one_m * one_m
    schl = r0 + (1.0 - r0) * om2 * om2 * one_m
    refl_choice = cannot | (schl > u3)
    ppx = ri * (ux + cos_t * nx)
    ppy = ri * (uy + cos_t * ny)
    ppz = ri * (uz + cos_t * nz)
    pp2 = ppx * ppx + ppy * ppy + ppz * ppz
    par = -torch.sqrt(torch.clamp(torch.abs(1.0 - pp2), min=1e-12))
    ex = torch.where(refl_choice, ux - 2.0 * udn * nx, ppx + par * nx)
    ey = torch.where(refl_choice, uy - 2.0 * udn * ny, ppy + par * ny)
    ez = torch.where(refl_choice, uz - 2.0 * udn * nz, ppz + par * nz)

    is_met = kind == float(METAL)
    is_die = kind == float(DIELECTRIC)
    is_iso = kind == float(ISOTROPIC)
    if not prep.mis:
        ndx = torch.where(is_met, mx, torch.where(
            is_die, ex, torch.where(is_iso, rvx, lx)))
        ndy = torch.where(is_met, my, torch.where(
            is_die, ey, torch.where(is_iso, rvy, ly)))
        ndz = torch.where(is_met, mz, torch.where(
            is_die, ez, torch.where(is_iso, rvz, lz)))
        atr = torch.where(is_die, 1.0, car)
        atg = torch.where(is_die, 1.0, cag)
        atb = torch.where(is_die, 1.0, cab)
        alive = alive * torch.where(is_met & ~met_ok, 0.0, 1.0)
        live = alive > 0.0
        ax = ax * torch.where(live, atr, 1.0)
        ay = ay * torch.where(live, atg, 1.0)
        az = az * torch.where(live, atb, 1.0)
        # Russian roulette from bounce 5 (renderer.wgsl:225-231)
        if max_depth > RR_START_BOUNCE:
            do_rr = b >= RR_START_BOUNCE
            pmax = torch.maximum(ax, torch.maximum(ay, az))
            p = torch.clamp(pmax, RR_P_MIN, RR_P_MAX)
            killed = do_rr & ~(u4 <= p)
            alive = alive * torch.where(killed, 0.0, 1.0)
            scale = torch.where(do_rr & (alive > 0.0), 1.0 / p, 1.0)
            ax = ax * scale
            ay = ay * scale
            az = az * scale
    else:
        # Russian roulette from the per-hit albedo, folded into both
        # branches' weights (camera.rs:223-237)
        rr_prob = torch.ones_like(alive)
        if max_depth > RR_START_BOUNCE:
            do_rr = b >= RR_START_BOUNCE
            pmax = torch.maximum(car, torch.maximum(cag, cab))
            prr = torch.clamp(pmax, RR_P_MIN, RR_P_MAX)
            rr_prob = torch.where(do_rr, prr, 1.0)
            alive = alive * torch.where(do_rr & (u4 > prr), 0.0, 1.0)
        spec = is_met | is_die
        sdx = torch.where(is_met, mx, ex)
        sdy = torch.where(is_met, my, ey)
        sdz = torch.where(is_met, mz, ez)
        inv_rr = 1.0 / rr_prob
        swr = torch.where(is_die, 1.0, car) * inv_rr
        swg = torch.where(is_die, 1.0, cag) * inv_rr
        swb = torch.where(is_die, 1.0, cab) * inv_rr
        u5, u6, u7, u8, u9, u10 = u_mis
        # cosine-weighted material direction (vec3.rs:212-221)
        bux, buy, buz, bvx, bvy, bvz = _onb(nx, ny, nz)
        phi2 = _TWO_PI * u5
        cph, sph = torch.cos(phi2), torch.sin(phi2)
        sq6 = torch.sqrt(u6)
        clx = cph * sq6
        cly = sph * sq6
        clz = torch.sqrt(torch.clamp(1.0 - u6, min=0.0))
        # isotropic lanes: the uniform sphere from the same u5, u6
        # (material.rs:177-190, pdf.rs:19-29)
        z_i = u6 * 2.0 - 1.0
        r_i = torch.sqrt(torch.clamp(1.0 - z_i * z_i, min=0.0))
        mdx = torch.where(is_iso, cph * r_i, clx * bux + cly * bvx + clz * nx)
        mdy = torch.where(is_iso, sph * r_i, clx * buy + cly * bvy + clz * ny)
        mdz = torch.where(is_iso, z_i, clx * buz + cly * bvz + clz * nz)
        # the picked light's direction: light l when u9 * n >= l
        dirs = _light_samples(prep, px_, py_, pz_, u7, u8)
        ldx, ldy, ldz = dirs[0]
        for l in range(1, prep.n_lights):
            pk = u9 * prep.n_lights >= l
            ldx = torch.where(pk, dirs[l][0], ldx)
            ldy = torch.where(pk, dirs[l][1], ldy)
            ldz = torch.where(pk, dirs[l][2], ldz)
        # 50/50 mixture (MixturePdf::generate, pdf.rs:93-99)
        use_l = u10 < 0.5
        gdx = torch.where(use_l, ldx, mdx)
        gdy = torch.where(use_l, ldy, mdy)
        gdz = torch.where(use_l, ldz, mdz)
        g2 = torch.clamp(gdx * gdx + gdy * gdy + gdz * gdz, min=1e-30)
        ginv = 1.0 / torch.sqrt(g2)
        cos_th = (nx * gdx + ny * gdy + nz * gdz) * ginv
        # cosine pdf (pdf.rs:41-49); an isotropic lane's mixture and
        # scattering pdf are both the uniform sphere's 1/4pi
        cpdf = torch.where(is_iso, 0.25 * _INV_PI,
                           torch.clamp(cos_th, min=0.0) * _INV_PI)
        lp = light_pdf(prep, px_, py_, pz_, gdx, gdy, gdz, g2, ginv)
        pdfv = 0.5 * lp + 0.5 * cpdf  # pdf.rs:88-91
        ok_diff = pdfv > 0.0
        # weight = albedo * scattering pdf / (pdf * rr)  (camera.rs:248-253)
        dw_den = 1.0 / torch.clamp(pdfv * rr_prob, min=1e-30)
        dwr = car * cpdf * dw_den
        dwg = cag * cpdf * dw_den
        dwb = cab * cpdf * dw_den
        ndx = torch.where(spec, sdx, gdx)
        ndy = torch.where(spec, sdy, gdy)
        ndz = torch.where(spec, sdz, gdz)
        alive = alive * torch.where(spec | ok_diff, 1.0, 0.0)
        live = alive > 0.0
        ax = ax * torch.where(live, torch.where(spec, swr, dwr), 1.0)
        ay = ay * torch.where(live, torch.where(spec, swg, dwg), 1.0)
        az = az * torch.where(live, torch.where(spec, swb, dwb), 1.0)
    live = alive > 0.0
    b = b + 1.0
    v.update(
        ox=torch.where(live, px_, ox), oy=torch.where(live, py_, oy),
        oz=torch.where(live, pz_, oz), dx=torch.where(live, ndx, dx),
        dy=torch.where(live, ndy, dy), dz=torch.where(live, ndz, dz),
        ax=ax, ay=ay, az=az, rx=rx, ry=ry, rz=rz, b=b,
        alive=torch.where(b < float(max_depth), alive, 0.0))


_NAMES = ("tm", "ox", "oy", "oz", "dx", "dy", "dz", "ax", "ay", "az",
          "rx", "ry", "rz", "alive", "b", "done", "sx", "sy", "sz", "mid")
# the rows one bounce reads and writes: the segment kernel's state
_SEG_NAMES = _NAMES[:N_SEG]


def spawn_lanes(prep: Prepared, slot: torch.Tensor, sample: torch.Tensor,
                key) -> dict:
    """The camera rays of absolute samples ``sample`` in slots ``slot``
    (int64 [n] each; spawn_rays, pallas_megakernel.py:1817-1854), as every
    path kernel spawns them: the rows of ``_SEG_NAMES`` but the radiance,
    with unit attenuation, bounce count 0, alive."""
    px, py = _slot_xy(slot, prep.width, prep.height)
    u = uniforms4(slot, sample, 0, STREAM_CAMERA, key)
    o, d = spawn_rays(prep.cam_u, px.to(torch.float32), py.to(torch.float32),
                      *u, prep.defocus, sample=sample, sqrt_spp=prep.sqrt_spp)
    zero = torch.zeros_like(o[0])
    one = torch.ones_like(o[0])
    # the ray's time of a moving scene (the_next_week/camera.rs:160-162)
    tm = (uniforms4(slot, sample, 0, STREAM_TIME, key)[0] if prep.moving
          else zero)
    return dict(tm=tm, ox=o[0], oy=o[1], oz=o[2], dx=d[0], dy=d[1], dz=d[2],
                ax=one, ay=one, az=one, alive=one, b=zero)


def bounce_live(prep: Prepared, v: dict, slot: torch.Tensor,
                sample: torch.Tensor, key, max_depth: int) -> bool:
    """One bounce of the lanes of ``v`` (rows ``_SEG_NAMES``) that are
    alive, keyed by their ``slot`` and ``sample`` (int64 [n] each);
    updates ``v`` in place.  Returns whether any lane was alive."""
    live = (v["alive"] > 0.0).nonzero().squeeze(1)
    if live.numel() == 0:
        return False
    sub = {k: v[k][live] for k in _SEG_NAMES}
    counter = (slot[live], sample[live], sub["b"].to(torch.int64))
    u = uniforms4(*counter, STREAM_BOUNCE, key)
    u_mis = None
    if prep.mis:
        u_mis = (uniforms4(*counter, STREAM_MIS_A, key)
                 + uniforms4(*counter, STREAM_MIS_B, key)[:2])
    # medium m's uniform: word m % 4 of stream STREAM_MEDIA + m // 4
    u_media = [w for g in range(-(-prep.n_media // 4))
               for w in uniforms4(*counter, STREAM_MEDIA + g, key)]
    _bounce_plain(prep, sub, u, u_mis, u_media, max_depth)
    for k in _SEG_NAMES:
        v[k] = v[k].index_put((live,), sub[k])
    return True


def _iteration_plain(prep: Prepared, st: torch.Tensor, slot: torch.Tensor,
                     key, *, spp: int, max_depth: int,
                     sample_offset: int) -> torch.Tensor:
    """One persist iteration (pbody, pallas_megakernel.py:1904-1962) of the
    lanes in ``st`` [20, n]; returns the new [20, n] state."""
    v = dict(zip(_NAMES, st.unbind(0)))
    slot = slot.to(torch.int64)
    # 1) bank dead unbanked paths
    fin = (v["mid"] > 0.0) & (v["alive"] <= 0.0)
    for r, s in (("rx", "sx"), ("ry", "sy"), ("rz", "sz")):
        v[s] = v[s] + torch.where(fin, v[r], 0.0)
    v["done"] = v["done"] + torch.where(fin, 1.0, 0.0)
    v["mid"] = torch.where(fin, 0.0, v["mid"])
    finz = torch.where(fin, 0.0, 1.0)
    for r in ("rx", "ry", "rz"):
        v[r] = v[r] * finz
    # 2) respawn idle lanes with samples left
    sample = v["done"].to(torch.int64) + sample_offset
    spawn_ok = (v["mid"] <= 0.0) & (v["done"] < float(spp))
    if bool(spawn_ok.any()):
        new = spawn_lanes(prep, slot, sample, key)
        new["mid"] = 1.0
        for k, nv in new.items():
            v[k] = torch.where(spawn_ok, nv, v[k])
    # 3) one bounce of the live lanes
    bounce_live(prep, v, slot, sample, key, max_depth)
    return torch.stack([v[k] for k in _NAMES])


def persist_step_plain(state: torch.Tensor, slot: torch.Tensor,
                       tables: Prepared, seed: int, *, persist_iters: int,
                       spp: int, max_depth: int, sample_offset: int = 0,
                       tile_bounds: torch.Tensor | None = None,
                       tile_lanes: int = 0) -> None:
    """Plain twin of the persist kernel, vectorised over lanes: up to
    ``persist_iters`` iterations (with ``tile_bounds``, the bound of the
    lane's tile of ``tile_lanes`` positions) of every lane that still has
    work (a sample in flight or samples left).  Updates ``state`` in
    place."""
    key = seed_key(seed)
    bound = None
    if tile_bounds is not None:
        pos = torch.arange(state.shape[1], device=state.device)
        bound = tile_bounds.long()[pos // tile_lanes]
        persist_iters = int(tile_bounds.max())
    for it in range(persist_iters):
        work = ((state[R_MID] > 0.0) | (state[R_DONE] < float(spp)))
        if bound is not None:
            work = work & (it < bound)
        idx = work.nonzero().squeeze(1)
        if idx.numel() == 0:
            return
        state[:, idx] = _iteration_plain(
            tables, state[:, idx], slot[idx], key, spp=spp,
            max_depth=max_depth, sample_offset=sample_offset)


def check_persist_args(state: torch.Tensor, slot: torch.Tensor,
                       tables: Prepared, tile_bounds: torch.Tensor | None,
                       tile_lanes: int) -> None:
    """Raise unless the launch's arguments have the kernel's types and
    shapes: state float32 [20, R], slot int32 [R], tile_bounds int32
    [R / tile_lanes] with tile_lanes a multiple of 32 dividing R, so that
    every warp's lanes share one bound."""
    R = tables.n_lanes
    for t, name, dtype, shape in ((state, "state", torch.float32,
                                   (N_STATE, R)),
                                  (slot, "slot", torch.int32, (R,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} of shape {shape}, "
                             f"got {t.dtype} of shape {tuple(t.shape)}")
    if tile_bounds is None:
        return
    if tile_lanes <= 0 or tile_lanes % 32 or R % tile_lanes:
        raise ValueError(f"tile_lanes {tile_lanes} must be a multiple of 32 "
                         f"dividing {R} lanes")
    if (tile_bounds.dtype != torch.int32
            or tuple(tile_bounds.shape) != (R // tile_lanes,)):
        raise ValueError(f"tile_bounds: expected int32 of shape "
                         f"({R // tile_lanes},), got {tile_bounds.dtype} of "
                         f"shape {tuple(tile_bounds.shape)}")


def persist_step(state: torch.Tensor, slot: torch.Tensor, tables: Prepared,
                 seed: int, *, persist_iters: int, spp: int, max_depth: int,
                 sample_offset: int = 0,
                 tile_bounds: torch.Tensor | None = None, tile_lanes: int = 0,
                 work: torch.Tensor | None = None) -> None:
    """One bounded persist launch over every lane, in place: each lane runs
    up to ``persist_iters`` iterations, or with ``tile_bounds`` (int32
    [R / tile_lanes]) the bound of its tile of ``tile_lanes`` sorted
    positions.  CUDA tensors launch ``csrc/persist.cu``; CPU tensors run
    ``persist_step_plain``.  ``work`` as in ``megakernel.path_params``
    (CUDA only)."""
    check_persist_args(state, slot, tables, tile_bounds, tile_lanes)
    if state.device.type == "cpu":
        return persist_step_plain(state, slot, tables, seed,
                                  persist_iters=persist_iters, spp=spp,
                                  max_depth=max_depth,
                                  sample_offset=sample_offset,
                                  tile_bounds=tile_bounds,
                                  tile_lanes=tile_lanes)
    R = tables.n_lanes
    _cuda.require(state, "state", torch.float32, (N_STATE, R))
    _cuda.require(slot, "slot", torch.int32, (R,))
    tb_ptr = None
    if tile_bounds is not None:
        _cuda.require(tile_bounds, "tile_bounds", torch.int32,
                      (R // tile_lanes,))
        tb_ptr = tile_bounds.data_ptr()
    check_tables(tables)
    params = path_params(tables, seed, spp=spp, max_depth=max_depth,
                         sample_offset=sample_offset, work=work)
    _cuda.launch("persist", state.data_ptr(), slot.data_ptr(), R,
                 ctypes.addressof(params), persist_iters, int(tables.mis),
                 int(tables.book2), tb_ptr, int(tile_lanes))


def check_segment_args(state: torch.Tensor, sums: torch.Tensor,
                       done: torch.Tensor, sample: torch.Tensor,
                       tables: Prepared) -> None:
    """Raise unless a segment's arguments have the kernel's types and
    shapes (state float32 [15, R], sums float32 [3, R], done float32 [R],
    sample int32 [R]) and R is a multiple of 32, so that every warp is
    full, and the tables are the path integrator's."""
    if tables.mis:
        raise ValueError("the segment kernel runs the path integrator only")
    R = tables.n_lanes
    if R % 32:
        raise ValueError(f"{R} lanes: the segment kernel needs a multiple "
                         "of 32")
    for t, name, dtype, shape in ((state, "state", torch.float32, (N_SEG, R)),
                                  (sums, "sums", torch.float32, (3, R)),
                                  (done, "done", torch.float32, (R,)),
                                  (sample, "sample", torch.int32, (R,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} of shape {shape}, "
                             f"got {t.dtype} of shape {tuple(t.shape)}")


def segment_step_plain(state: torch.Tensor, sums: torch.Tensor,
                       done: torch.Tensor, sample: torch.Tensor,
                       tables: Prepared, seed: int, *, spp: int,
                       max_depth: int, sample_offset: int = 0,
                       alive: torch.Tensor | None = None) -> None:
    """Plain twin of the segment kernel K5, in place: one bounce of the
    live lanes of ``state`` [15, R] (lane = slot), keyed by the absolute
    sample index of each lane's path ``sample`` (int32 [R]); then every
    lane that died in it adds its radiance to ``sums`` [3, R], counts the
    sample in ``done`` [R], takes ``done + sample_offset`` as its sample
    index and, while ``done < spp``, the camera ray of that sample; its
    radiance is multiplied by 0 (JAX's bank and respawn,
    pallas_wavefront.py:927-950).  Lanes that were dead are not touched.
    ``alive`` (int32, one element or more) gets the number of lanes alive
    afterwards added to its first element."""
    key = seed_key(seed)
    v = dict(zip(_SEG_NAMES, state.unbind(0)))
    slot = torch.arange(state.shape[1], dtype=torch.int64,
                        device=state.device)
    was = v["alive"] > 0.0
    bounce_live(tables, v, slot, sample.to(torch.int64), key, max_depth)
    fin = was & (v["alive"] <= 0.0)
    rad = torch.stack([v["rx"], v["ry"], v["rz"]])
    sums.copy_(sums + torch.where(fin, rad, 0.0))
    done.copy_(done + torch.where(fin, 1.0, 0.0))
    sample.copy_(torch.where(fin, done.to(torch.int64) + sample_offset,
                             sample.to(torch.int64)).to(torch.int32))
    finz = torch.where(fin, 0.0, 1.0)
    for r in ("rx", "ry", "rz"):
        v[r] = v[r] * finz
    nxt = (fin & (done < float(spp))).nonzero().squeeze(1)
    if nxt.numel():
        new = spawn_lanes(tables, slot[nxt], sample[nxt].to(torch.int64),
                          key)
        for k, nv in new.items():
            v[k] = v[k].index_put((nxt,), nv)
    state.copy_(torch.stack([v[k] for k in _SEG_NAMES]))
    if alive is not None:
        alive[:1] += (state[R_ALIVE] > 0.0).sum().to(torch.int32)


def _segment_launcher(state: torch.Tensor, sums: torch.Tensor,
                      done: torch.Tensor, sample: torch.Tensor,
                      tables: Prepared, seed: int, *, spp: int,
                      max_depth: int, sample_offset: int = 0,
                      work: torch.Tensor | None = None):
    """Check a pass's segment arguments on the card and build its
    ``rtt::Params`` once; returns ``launch(alive_ptr)``, one K5 launch that
    adds the lanes left alive to the int32 at device address
    ``alive_ptr``."""
    check_segment_args(state, sums, done, sample, tables)
    for t, name in ((state, "state"), (sums, "sums"), (done, "done"),
                    (sample, "sample")):
        _cuda.require(t, name, t.dtype)  # the device and contiguity
    R = tables.n_lanes
    check_tables(tables)
    params = path_params(tables, seed, spp=spp, max_depth=max_depth,
                         sample_offset=sample_offset, work=work)
    args = (state.data_ptr(), sums.data_ptr(), done.data_ptr(),
            sample.data_ptr(), R, ctypes.addressof(params),
            int(tables.book2), int(cluster_cull(tables)))

    def launch(alive_ptr: int) -> None:
        _cuda.launch("segment", *args, alive_ptr)

    launch.params = params  # keeps the struct alive with the closure
    return launch


def segment_step(state: torch.Tensor, sums: torch.Tensor, done: torch.Tensor,
                 sample: torch.Tensor, tables: Prepared, seed: int, *,
                 spp: int, max_depth: int, sample_offset: int = 0,
                 alive: torch.Tensor | None = None,
                 work: torch.Tensor | None = None) -> None:
    """One K5 segment, in place: one bounce of every live lane of
    ``state`` [15, R], keyed by ``sample`` (int32 [R]), and the bank and
    respawn of the lanes that die in it, as ``segment_step_plain``
    describes.  CUDA tensors launch ``csrc/segment.cu`` (the instance
    ``cluster_cull`` picks); CPU tensors run ``segment_step_plain``.  The
    path integrator only.  ``alive`` (int32) gets the lanes alive
    afterwards added to its first element; ``work`` as in
    ``megakernel.path_params`` (CUDA only)."""
    if state.device.type == "cpu":
        check_segment_args(state, sums, done, sample, tables)
        return segment_step_plain(state, sums, done, sample, tables, seed,
                                  spp=spp, max_depth=max_depth,
                                  sample_offset=sample_offset, alive=alive)
    if alive is None:
        alive = torch.zeros(1, dtype=torch.int32, device=state.device)
    _cuda.require(alive, "alive", torch.int32, (None,))
    _segment_launcher(state, sums, done, sample, tables, seed, spp=spp,
                      max_depth=max_depth, sample_offset=sample_offset,
                      work=work)(alive.data_ptr())


# ------------------------------------------------------------ launch loop


def tile_bounds_next(state: torch.Tensor, adaptive_bounds: tuple,
                     n_tiles: int) -> torch.Tensor:
    """Per-tile launch bounds for the next launch (pallas_wavefront.py:
    692-714): a tile whose mid-sample lanes' origins span more than ``rel``
    of all mid-sample lanes' extent (summed over the three axes) has
    decohered and gets the short bound, so it returns to the sort sooner;
    the others get the long one.  Returns int32 [n_tiles]."""
    short_b, long_b, rel = adaptive_bounds
    act = (state[R_MID] > 0.0).reshape(n_tiles, -1)
    big = 3e38
    exts = torch.zeros(n_tiles, dtype=torch.float32, device=state.device)
    gext = torch.zeros((), dtype=torch.float32, device=state.device)
    has = act.any(dim=1)
    for k in (R_OX, R_OX + 1, R_OX + 2):
        v = state[k].reshape(n_tiles, -1)
        lo = torch.where(act, v, big)
        hi = torch.where(act, v, -big)
        exts = exts + torch.where(has, hi.amax(dim=1) - lo.amin(dim=1), 0.0)
        gext = gext + (hi.max() - lo.min())
    deco = exts > rel * torch.clamp(gext, min=1e-20)
    return torch.where(deco, short_b, long_b).to(torch.int32)


def _wavefront_pass_persist(tables: Prepared, seed: int, sample_offset: int,
                            *, spp: int, max_depth: int, persist_iters: int,
                            sort_rays: bool, sort_every: int = 1,
                            adaptive_bounds: tuple = (), step=persist_step,
                            stats: dict | None = None) -> torch.Tensor:
    """Launch loop of one render pass (pallas_wavefront.py:639-785).
    Returns the banked radiance sums [R, 3] in slot order.

    Loops while any lane has work, at most ``spp * max_depth + 2`` launches;
    with ``sort_rays`` it permutes the lane state and slots by
    ``_persist_sort_perm`` after every ``sort_every``-th launch and scatters
    the sums back to slot order at the end.  With ``adaptive_bounds``
    (short, long, rel) each launch bounds every tile of ``tables.tile_rows``
    rows by ``tile_bounds_next`` of the state the previous launch (and its
    sort) left, the first launch by the long bound; otherwise every lane
    runs ``persist_iters``.  ``stats``, when given, receives the launch
    count and (on CUDA) the seconds spent sorting."""
    R = tables.n_lanes
    dev = tables.geom.device
    state = torch.zeros((N_STATE, R), dtype=torch.float32, device=dev)
    slot = torch.arange(R, dtype=torch.int32, device=dev)
    max_launches = spp * max_depth + 2
    timed = stats is not None and dev.type == "cuda"
    events = []
    tile_lanes = tables.tile_rows * TILE_LANES
    n_tiles = R // tile_lanes
    tb = None
    if adaptive_bounds:
        tb = torch.full((n_tiles,), adaptive_bounds[1], dtype=torch.int32,
                        device=dev)
    g = 0
    while g < max_launches and bool(
            ((state[R_MID] > 0.0) | (state[R_DONE] < float(spp))).any()):
        step(state, slot, tables, seed, persist_iters=persist_iters,
             spp=spp, max_depth=max_depth, sample_offset=sample_offset,
             tile_bounds=tb, tile_lanes=tile_lanes)
        if sort_rays and g % sort_every == 0:
            if timed:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            perm = _persist_sort_perm(state, slot, spp)
            state = state[:, perm]
            slot = slot[perm]
            if timed:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        if adaptive_bounds:
            tb = tile_bounds_next(state, adaptive_bounds, n_tiles)
        g += 1
    sums = state[R_SX:R_SX + 3].T.contiguous()
    if sort_rays:
        # lanes are permuted: scatter each lane's sums to its slot
        sums = torch.empty_like(sums).index_copy_(0, slot.long(), sums)
    if stats is not None:
        stats["launches"] = g
        if timed:
            torch.cuda.synchronize()
            stats["sort_seconds"] = sum(
                events[i].elapsed_time(events[i + 1])
                for i in range(0, len(events), 2)) / 1e3
            stats["sorts"] = len(events) // 2
    return sums


def segment_start(tables: Prepared, seed: int, sample_offset: int) -> tuple:
    """The segment loop's state before its first segment: every lane
    spawns sample ``sample_offset``.  Returns (state [15, R], sums [3, R],
    done [R], sample int32 [R])."""
    R = tables.n_lanes
    dev = tables.geom.device
    slot = torch.arange(R, dtype=torch.int64, device=dev)
    sample = torch.full((R,), sample_offset, dtype=torch.int64, device=dev)
    v = spawn_lanes(tables, slot, sample, seed_key(seed))
    zero = torch.zeros(R, dtype=torch.float32, device=dev)
    state = torch.stack([v.get(k, zero) for k in _SEG_NAMES])
    return (state, torch.zeros((3, R), dtype=torch.float32, device=dev),
            zero.clone(), sample.to(torch.int32))


# Segments launched between two reads of their alive counts (one host sync
# a chunk): from the sweep on the H100 (chip_measure.py --segments,
# PERF.md), within 2% of the best chunk on the final scene at 400x400 and
# 800x800; a chunk captured as one CUDA graph (measured there too) was
# slower.
SEGMENT_CHUNK = 32


def _wavefront_pass_segments(tables: Prepared, seed: int, sample_offset: int,
                             *, spp: int, max_depth: int,
                             chunk: int = SEGMENT_CHUNK,
                             stats: dict | None = None) -> torch.Tensor:
    """Per-bounce segment loop of one render pass (_wavefront_pass,
    pallas_wavefront.py:814-955).  Returns the banked radiance sums [R, 3]
    in slot order.

    Every lane spawns sample ``sample_offset``.  Then, while any lane is
    alive and at most ``spp * max_depth + 1`` times, one ``segment_step``
    bounces the live lanes, banks the radiance of those that die and
    respawns those with samples left, all on the device (CPU tensors: the
    plain twin), with the kernels' slot-keyed draws, so the sums equal
    K3's and the unsorted persist loop's bitwise.  Segment g adds the
    lanes left alive to slot g of a per-pass int32 buffer; the host reads
    the slots of ``chunk`` segments at a time, one sync each, and stops
    after the chunk in which a count is 0.  The segments after that one
    find no live lane and change nothing.

    ``stats`` receives ``launches`` (the segments the JAX loop runs: those
    that began with a live lane), ``kernel_launches`` (the segments
    issued, the last chunk's tail included), ``host_syncs`` and
    ``chunk``."""
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    state, sums, done, sample = segment_start(tables, seed, sample_offset)
    dev = state.device
    n_seg = spp * max_depth + 1
    alive = torch.zeros(n_seg, dtype=torch.int32, device=dev)
    kw = dict(spp=spp, max_depth=max_depth, sample_offset=sample_offset)
    if dev.type == "cpu":
        def run(g0: int, n: int) -> torch.Tensor:
            for g in range(g0, g0 + n):
                segment_step_plain(state, sums, done, sample, tables, seed,
                                   alive=alive[g:g + 1], **kw)
            return alive[g0:g0 + n]
    else:
        launch = _segment_launcher(state, sums, done, sample, tables, seed,
                                   **kw)
        base = alive.data_ptr()

        def run(g0: int, n: int) -> torch.Tensor:
            for g in range(g0, g0 + n):
                launch(base + 4 * g)
            return alive[g0:g0 + n]
    g = syncs = 0
    segments = n_seg
    while g < n_seg:
        n = min(chunk, n_seg - g)
        counts = run(g, n).tolist()
        syncs += 1
        g += n
        if 0 in counts:
            segments = g - n + counts.index(0) + 1
            break
    if stats is not None:
        stats.update(launches=segments, kernel_launches=g, host_syncs=syncs,
                     chunk=chunk)
    return sums.T.contiguous()


def render_pass_wavefront(scene: Scene, cam, seed: int, *, width: int,
                          height: int, spp: int, max_depth: int,
                          sample_offset: int = 0, mis: bool = False,
                          stratified: bool = False, sqrt_spp: int = 0,
                          per_bounce_segments: bool = False,
                          step=persist_step, respawn_step=respawn_pass,
                          device="cuda", stats: dict | None = None
                          ) -> torch.Tensor:
    """Whole-image render pass (pallas_wavefront.py:973-1073); returns the
    radiance SUM [H, W, 3] (the render.render_pass contract).

    Image-textured scenes take the image route: the persist launch loop at
    ``wavefront_tile_rows``, sorted with per-tile adaptive bounds when
    ``ray_sort_heuristic`` holds, else unsorted at the uniform bound of
    ``image_route_iters``.  Other scenes on ``sorted_persist_route`` run the
    sorted persist loop at ``persist_plain_iters``.  In both, ``step`` is
    the launch (``persist_step``, or ``persist_step_plain`` on any device
    for comparisons with the kernel), and ``stats`` receives the loop's
    counts.  The rest go to the respawn megakernel K3
    (``render_pass_megakernel``) with ``respawn_step`` as its pass.

    ``per_bounce_segments`` (pallas_wavefront.py:983, 1074-1085) sends an
    image scene through the per-bounce segment loop (K5) at
    ``wavefront_tile_rows`` instead, and raises ``ValueError`` with
    ``mis``; a non-image scene then skips the
    sorted route and goes to K3."""
    image = "image" in scene.features
    if image and per_bounce_segments and mis:
        raise ValueError("per_bounce_segments does not drive MIS; use the "
                         "persist route")
    if not image and (per_bounce_segments
                      or not sorted_persist_route(scene, width, height)):
        return render_pass_megakernel(
            scene, cam, seed, width=width, height=height, spp=spp,
            max_depth=max_depth, sample_offset=sample_offset, mis=mis,
            stratified=stratified, sqrt_spp=sqrt_spp, respawn=True,
            device=device, step=respawn_step)
    if image:
        tile_rows = wavefront_tile_rows(scene)
        sort = ray_sort_heuristic(scene, slot_lane_count(width, height))
        iters = image_route_iters(scene, sort)
        sort_every = persist_sort_every(PERSIST_SORT_ITERS if sort else 1)
        adaptive = persist_adaptive_bounds(PERSIST_SORT_ITERS) if sort else ()
    else:
        tile_rows = respawn_tile_rows(scene)
        sort, iters = True, persist_plain_iters(spp)
        sort_every, adaptive = persist_sort_every(iters), ()
    tables = prepare_megakernel_cached(
        scene, cam, width=width, height=height, tile_rows=tile_rows, mis=mis,
        stratified=stratified, sqrt_spp=sqrt_spp, device=device)
    if per_bounce_segments:
        sums = _wavefront_pass_segments(
            tables, seed, sample_offset, spp=spp, max_depth=max_depth,
            stats=stats)
    else:
        sums = _wavefront_pass_persist(
            tables, seed, sample_offset, spp=spp, max_depth=max_depth,
            persist_iters=iters, sort_rays=sort, sort_every=sort_every,
            adaptive_bounds=adaptive, step=step, stats=stats)
    idx = unswizzle_index_on(width, height, sums.device)
    return sums[idx].reshape(height, width, 3)
