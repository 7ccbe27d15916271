"""The path tracer's tables and the megakernels K3 and K4 (counterpart:
``rustraytrace_tpu/ops/pallas_megakernel.py``: the host functions, and
``render_pass_megakernel`` with ``respawn=True`` and ``False``).

Host half: ``prepare_megakernel`` builds what the path kernels (persist
K2, the megakernels K3 and K4, the segment kernel K5) and their plain
twins read: the sphere table in SAH cluster order (static and moving
spheres clustered apart when a moving scene has a static majority),
cluster ranges padded to the sphere-loop unroll with unhittable
``r2 = -BIG`` sentinel rows, the cluster and super-cluster AABBs, the
SAH-clustered box table and its winner attributes, the quad table
(SAH-clustered from QUAD_CLUSTER_MIN quads), the constant-media table, the
Perlin lattice, the image texels, the NEE light table and the camera
uniforms.  Row order and values are the JAX
package's, so the tables are bit-equal to ``prepare_megakernel(...,
segment=True)`` there.  What is not carried over are the layouts that exist
for Mosaic: the column-major SMEM geometry table and the 128-lane attribute
slabs become a row-major ``[N, 4]`` geometry table (plus ``[N, 4]``
velocities) and row-major attribute tables; the Perlin lattice stays
``perm [3, 256]`` and ``randvec [256, 3]`` instead of 128-lane halves; the
image table is flat texels ``[sum h*w, 3]`` with an int32 ``(base, w, h)``
row per image instead of (8, 128)-tiled RGBA blocks.

Device half: ``respawn_pass`` launches K3 (``csrc/megakernel.cu``), one
launch per render pass, in which a lane walks a slot's ``spp`` samples back
to back, respawning on its own, then takes the next slot from a device
queue; ``mono_pass`` launches K4 (``csrc/mono.cu``), in which a warp runs
its 32 slots' samples one after another and meets at each sample
boundary.  Both launch one resident wave of blocks (``megakernel_grid``)
fed by a zeroed slot counter (``slot_queue``), in the instance
``cluster_cull`` picks from the tables.  CPU tensors run their
plain twins ``respawn_pass_plain`` and ``mono_pass_plain``.
``render_pass_megakernel`` prepares the tables, runs one pass (K4 unless
``respawn``) and unswizzles the sums to pixels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np
import torch

from ..config import BG_SKY, CameraParams
from ..scene import TEX_IMAGE, TEX_NOISE, Scene
from . import _cuda
from .hit import Q_COLS, Q_QX, Q_UX, Q_VX, pack_quad_table
from .rng import seed_key

_BIG = 1.0e30
TILE_ROWS = 32  # rows of 128 lanes the slot space is padded to (JAX tiles)
TILE_LANES = 128
_BLK = 32  # screen-space swizzle block (32x32 pixels = 1024 slots)

# the JAX package's loop shapes (pallas_megakernel.py:70-80), kept so the
# tables are bit-equal; tuned on the TPU, not yet on this card
SPHERE_UNROLL = 4
BOX_UNROLL = 4
SPHERE_MAX_LEAF = 64
SPHERE_MAX_LEAF_BIG = 32
SPHERE_BIG_N = 4096
BOX_MAX_LEAF = 32

# work counters of the kernels' COUNT instances (path_params ``work``);
# ``warp_sphere_rows`` counts the sphere rows a warp issues (a cluster's
# rows once for the lanes that scan it together), so sphere_rows /
# (32 x warp_sphere_rows) is the leaf scans' SIMT efficiency; the
# megakernels count ``lane_steps``, the iterations in which a lane had
# work, and ``warp_iters``, the iterations their warps ran, so lane_steps /
# (32 x warp_iters) is their lane-use share
WORK_NAMES = ("bounces", "sphere_rows", "cluster_boxes", "box_rows",
              "media_tests", "noise_evals", "texel_fetches", "quad_rows",
              "warp_sphere_rows", "lane_steps", "warp_iters")

# joined sphere+material table columns (pallas_megakernel.py:83-94)
J_CX, J_CY, J_CZ, J_R2 = 0, 1, 2, 3
J_VX, J_VY, J_VZ = 4, 5, 6
J_INVR = 7
J_KIND = 8
J_AR, J_AG, J_AB = 9, 10, 11
J_FUZZ = 12
J_IOR = 13
J_TEXK = 14
J_C2R, J_C2G, J_C2B = 15, 16, 17
J_INVS = 18
J_IMG = 19
J_COLS = 24

# winner attributes the kernel reads for spheres + solid albedo (the JAX
# atab rows of a scene without motion or textures, in the same order)
ACOLS = (J_KIND, J_AR, J_AG, J_AB, J_FUZZ, J_IOR, J_CX, J_CY, J_CZ, J_INVR)

# light table columns (pallas_megakernel.py:391-401)
L_KIND = 0  # 0 quad / 1 sphere
L_QX, L_QY, L_QZ = 1, 2, 3
L_UX, L_UY, L_UZ = 4, 5, 6
L_VX, L_VY, L_VZ = 7, 8, 9
L_WX, L_WY, L_WZ = 10, 11, 12
L_NX, L_NY, L_NZ = 13, 14, 15
L_DP = 16
L_AREA = 17
L_CX, L_CY, L_CZ = 18, 19, 20
L_RAD = 21
L_COLS = 24

# at this many quads the quad table is SAH-clustered, at most
# QUAD_MAX_LEAF quads a cluster (pallas_megakernel.py:200-206)
QUAD_CLUSTER_MIN = 32
QUAD_MAX_LEAF = 32

# box slab table columns (pallas_megakernel.py:270-272) and the box winner
# attributes, row-major (the JAX batab rows 0-5 and 12-16)
B_COLS = 8
BA_KIND = 0
BA_AR, BA_AG, BA_AB = 1, 2, 3
BA_FUZZ = 4
BA_IOR = 5
BA_TEXK = 6
BA_C2R, BA_C2G, BA_C2B = 7, 8, 9
BA_INVS = 10
BA_COLS = 12

# constant-media table columns (pallas_megakernel.py:341-349)
M_KIND = 0  # 0 sphere / 1 oriented box
M_CX, M_CY, M_CZ = 1, 2, 3  # center (sphere) / offset (box)
M_R2 = 4
M_NID = 5  # neg_inv_density
M_AR, M_AG, M_AB = 6, 7, 8  # isotropic phase albedo
M_COS, M_SIN = 9, 10
M_LOX, M_LOY, M_LOZ = 11, 12, 13
M_HIX, M_HIY, M_HIZ = 14, 15, 16
M_COLS = 24


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def kernel_gap(scene: Scene, integrator: str = "path"):
    """None when the ported kernels cover the scene: spheres (moving or
    not), quads (SAH-clustered from QUAD_CLUSTER_MIN), boxes, constant
    media, solid, checker, Perlin-marble and image albedos, sky or flat
    background, the path integrator or (with ``mis_lights_ok``) the NEE/MIS
    one, isotropic media and materials included.  Otherwise what is not
    covered, as a message: image-textured constant media, which the JAX
    package renders only on its XLA path, and ``mis`` without 1 to 16 NEE
    lights.  Decided from the scene's features and tables alone."""
    if integrator not in ("path", "mis"):
        raise ValueError(f"unknown integrator {integrator!r}")
    feats = scene.features
    if "media" in feats and "image" in feats:
        media_mats = np.concatenate([
            _np(scene.msph_mat)[_np(scene.msph_mask) > 0],
            _np(scene.mbox_mat)[_np(scene.mbox_mask) > 0]])
        if np.any(_np(scene.tex_kind)[_np(scene.mat_tex)[media_mats]]
                  == TEX_IMAGE):
            return ("image-textured constant media run only on the "
                    "reference routes (sphere_kernel, reference), as on the "
                    "JAX package's XLA path")
    if integrator == "mis" and not mis_lights_ok(scene):
        return ("integrator 'mis' runs in-kernel with 1 to 16 NEE lights; "
                f"the scene has {int(_np(scene.light_mask).sum())}")
    return None


def megakernel_eligible(scene: Scene, integrator: str = "path") -> bool:
    """True when the ported kernels cover the scene (``kernel_gap`` is
    None); raises ``NotImplementedError`` naming the gap otherwise."""
    gap = kernel_gap(scene, integrator)
    if gap is not None:
        raise NotImplementedError(gap)
    return True


def pack_box_tables(scene: Scene, max_leaf: int = BOX_MAX_LEAF,
                    pad_to: int = 1):
    """(btab [NB, 8] f32, order [NB], cl_start [C+1] i32, cl_bounds [C, 8]
    f32) of the active boxes in SAH cluster order (pallas_megakernel.py:
    301-337): each cluster's range padded to a multiple of ``pad_to`` with
    degenerate lo == hi rows far away, which the strict ``t1 < t2`` slab
    test rejects."""
    from ..native import build_aabb_clusters

    mask = _np(scene.box_mask) > 0
    lo = _np(scene.box_lo).astype(np.float32)[mask]
    hi = _np(scene.box_hi).astype(np.float32)[mask]
    n = lo.shape[0]
    if n == 0:
        return (np.zeros((1, B_COLS), np.float32), np.zeros(1, np.int32),
                np.zeros(2, np.int32), np.zeros((1, 8), np.float32))
    if n > max_leaf:
        order, cl_start, cl_min, cl_max = build_aabb_clusters(
            lo, hi, max_leaf=max_leaf)
    else:
        order = np.arange(n, dtype=np.int32)
        cl_start = np.asarray([0, n], np.int32)
        cl_min = lo.min(axis=0, keepdims=True)
        cl_max = hi.max(axis=0, keepdims=True)
    order, cl_start = _pad_cluster_ranges(order, cl_start, pad_to)
    dead = order < 0
    lo = np.where(dead[:, None], 1e28, lo[np.maximum(order, 0)])
    hi = np.where(dead[:, None], 1e28, hi[np.maximum(order, 0)])
    btab = np.zeros((order.shape[0], B_COLS), np.float32)
    btab[:, 0:3] = lo
    btab[:, 3:6] = hi
    clb = np.concatenate(
        [cl_min, cl_max, np.zeros((cl_min.shape[0], 2), np.float32)], axis=1)
    return btab, order, cl_start.astype(np.int32), clb


def pack_box_attrs(scene: Scene, order: np.ndarray) -> np.ndarray:
    """[NB, 12] f32 winner attributes of the box rows in ``order`` (kind,
    albedo, fuzz, ior, texture kind, second color, scale); padded rows
    borrow row 0's, which can never win (pallas_megakernel.py:2232-2255)."""
    bmat = _np(scene.box_mat)[_np(scene.box_mask) > 0][np.maximum(order, 0)]
    mtex = _np(scene.mat_tex)[bmat]
    tk = _np(scene.tex_kind)[mtex]
    att = np.zeros((order.shape[0], BA_COLS), np.float32)
    att[:, BA_KIND] = _np(scene.mat_kind)[bmat]
    att[:, BA_AR:BA_AB + 1] = _np(scene.tex_color1)[mtex]
    att[:, BA_FUZZ] = _np(scene.mat_fuzz)[bmat]
    att[:, BA_IOR] = _np(scene.mat_ior)[bmat]
    att[:, BA_TEXK] = tk
    att[:, BA_C2R:BA_C2B + 1] = _np(scene.tex_color2)[mtex]
    att[:, BA_INVS] = np.where(tk == TEX_NOISE,
                               _np(scene.tex_noise_scale)[mtex],
                               _np(scene.tex_inv_scale)[mtex])
    return att


def cluster_quad_table(scene: Scene, qtab: np.ndarray):
    """(qtab', n_quads, n_qclusters): the quad table ``qtab`` [Q, 32]
    SAH-clustered over the quads' corner AABBs once the scene has
    QUAD_CLUSTER_MIN quads (pallas_megakernel.py:209-265).  The rows are
    permuted cluster-contiguous, padding quads last in a cluster of their
    own whose bounds (about 3.2e38) no ray enters before its best t, and a
    metadata row [lo3, hi3, start, end] per cluster is appended after the
    quad rows; ``n_quads`` counts the quad rows only.  Below the threshold
    the table is returned untouched (the linear scan)."""
    from ..native import build_aabb_clusters

    n_rows = qtab.shape[0]
    if "quads" not in scene.features:
        return qtab, 0, 0
    mask = _np(scene.quad_mask) > 0
    if int(mask.sum()) < QUAD_CLUSTER_MIN:
        return qtab, n_rows, 0
    act = np.where(mask)[0]
    pad = np.where(~mask)[0]
    q = qtab[act, Q_QX:Q_QX + 3]
    u = qtab[act, Q_UX:Q_UX + 3]
    v = qtab[act, Q_VX:Q_VX + 3]
    corners = [q, q + u, q + v, q + u + v]
    lo = np.minimum.reduce(corners) - 1e-4
    hi = np.maximum.reduce(corners) + 1e-4
    order, cl_start, cl_min, cl_max = build_aabb_clusters(
        lo.astype(np.float32), hi.astype(np.float32), max_leaf=QUAD_MAX_LEAF)
    perm = np.concatenate([act[np.asarray(order)], pad]).astype(np.int64)
    starts = np.asarray(cl_start, np.int64).tolist()
    mins, maxs = list(cl_min), list(cl_max)
    if pad.size:
        starts.append(starts[-1] + int(pad.size))
        mins.append(np.full(3, 3.2e38, np.float32))
        maxs.append(np.full(3, 3.3e38, np.float32))
    n_qc = len(starts) - 1
    meta = np.zeros((n_qc, Q_COLS), np.float32)
    meta[:, 0:3] = mins
    meta[:, 3:6] = maxs
    meta[:, 6] = starts[:-1]
    meta[:, 7] = starts[1:]
    return (np.concatenate([qtab[perm], meta]).astype(np.float32), n_rows,
            n_qc)


def pack_media_table(scene: Scene):
    """([max(M, 1), 24] f32 table, M) of the active constant media, spheres
    then oriented boxes (pallas_megakernel.py:352-387)."""
    rows = []
    tex1 = _np(scene.tex_color1)
    mat_tex = _np(scene.mat_tex)
    for k in np.nonzero(_np(scene.msph_mask) > 0)[0]:
        r = np.zeros(M_COLS, np.float32)
        r[M_CX:M_CZ + 1] = _np(scene.msph_center)[k]
        rad = float(_np(scene.msph_radius)[k])
        r[M_R2] = rad * rad
        r[M_NID] = float(_np(scene.msph_neg_inv_density)[k])
        r[M_AR:M_AB + 1] = tex1[int(mat_tex[int(_np(scene.msph_mat)[k])])]
        rows.append(r)
    for b in np.nonzero(_np(scene.mbox_mask) > 0)[0]:
        r = np.zeros(M_COLS, np.float32)
        r[M_KIND] = 1.0
        r[M_CX:M_CZ + 1] = _np(scene.mbox_offset)[b]
        r[M_COS] = float(_np(scene.mbox_cos)[b])
        r[M_SIN] = float(_np(scene.mbox_sin)[b])
        r[M_LOX:M_LOZ + 1] = _np(scene.mbox_lo)[b]
        r[M_HIX:M_HIZ + 1] = _np(scene.mbox_hi)[b]
        r[M_NID] = float(_np(scene.mbox_neg_inv_density)[b])
        r[M_AR:M_AB + 1] = tex1[int(mat_tex[int(_np(scene.mbox_mat)[b])])]
        rows.append(r)
    n = len(rows)
    return (np.stack(rows) if rows else np.zeros((1, M_COLS), np.float32)), n


def pack_perlin_tables(scene: Scene):
    """(perm int32 [3, 256], randvec f32 [256, 3]): the Perlin lattice
    (perlin.rs:25-98) as the scene holds it, row-major."""
    return (_np(scene.perlin_perm).astype(np.int32),
            _np(scene.perlin_randvec).astype(np.float32))


def pack_image_table(scene: Scene):
    """(texels f32 [max(T, 1), 3], meta int32 [NI, 3]): every image's
    h x w texels flattened image-major, and a (base, w, h) row per image
    for the in-kernel nearest-texel fetch (texture.rs:89-109)."""
    imgs = _np(scene.images)
    hw = _np(scene.image_hw)
    meta, chunks, base = [], [], 0
    for k in range(imgs.shape[0]):
        h, w = int(hw[k, 0]), int(hw[k, 1])
        chunks.append(imgs[k, :h, :w, :].reshape(-1, 3).astype(np.float32))
        meta.append((base, w, h))
        base += h * w
    texels = np.concatenate(chunks) if base else np.zeros((1, 3), np.float32)
    return texels, np.asarray(meta, np.int32).reshape(-1, 3)


def noise_dominant(scene: Scene) -> bool:
    """Perlin-marble spheres are the scene (book2_perlin_spheres), not one
    object among many (book2_final_scene): the JAX package then scans its
    sphere and box loops without unrolling (pallas_megakernel.py:499-515)."""
    if "noise" not in scene.features:
        return False
    noise_mat = _np(scene.tex_kind)[_np(scene.mat_tex)] == TEX_NOISE
    n_noise = int(np.sum((_np(scene.sph_mask) > 0)
                         & noise_mat[_np(scene.sph_mat)]))
    return active_primitive_count(scene) <= 8 * n_noise


def pack_light_table(scene: Scene):
    """([max(L, 1), 24] float32 table, L) of the book-3 NEE light list
    (pallas_megakernel.py:404-434; the_rest_of_your_life/mod.rs:128-140)."""
    mask = _np(scene.light_mask) > 0
    kinds = _np(scene.light_kind)[mask]
    q = _np(scene.light_q)[mask]
    u = _np(scene.light_u)[mask]
    v = _np(scene.light_v)[mask]
    c = _np(scene.light_center)[mask]
    r = _np(scene.light_radius)[mask]
    L = kinds.shape[0]
    tab = np.zeros((max(L, 1), L_COLS), np.float32)
    if L:
        n = np.cross(u, v)
        nn = np.maximum((n * n).sum(-1, keepdims=True), 1e-30)
        w = n / nn
        area = np.sqrt(nn[:, 0])
        nhat = n / np.sqrt(nn)
        tab[:L, L_KIND] = kinds
        tab[:L, L_QX:L_QZ + 1] = q
        tab[:L, L_UX:L_UZ + 1] = u
        tab[:L, L_VX:L_VZ + 1] = v
        tab[:L, L_WX:L_WZ + 1] = w
        tab[:L, L_NX:L_NZ + 1] = nhat
        tab[:L, L_DP] = (nhat * q).sum(-1)
        tab[:L, L_AREA] = area
        tab[:L, L_CX:L_CZ + 1] = c
        tab[:L, L_RAD] = r
    return tab, L


def mis_lights_ok(scene: Scene) -> bool:
    """The in-kernel NEE/MIS estimator takes 1 to 16 lights
    (pallas_megakernel.py:437-452)."""
    return 1 <= int(_np(scene.light_mask).sum()) <= 16


def megakernel_mis_eligible(scene: Scene) -> bool:
    """A covered scene with 1 to 16 NEE lights (pallas_megakernel.py:455);
    raises as ``megakernel_eligible`` does for what is not ported."""
    return megakernel_eligible(scene, "mis")


def pack_joined_table(scene: Scene) -> np.ndarray:
    """[N, 24] float32 sphere+material table (pallas_megakernel.py:139)."""
    f = np.float32
    C = _np(scene.sph_center)
    N = C.shape[0]
    r = _np(scene.sph_radius)
    mat = _np(scene.sph_mat)
    mtex = _np(scene.mat_tex)[mat]
    tk = _np(scene.tex_kind)[mtex]
    tab = np.zeros((N, J_COLS), f)
    tab[:, J_CX:J_CZ + 1] = C
    tab[:, J_R2] = np.where(_np(scene.sph_mask) > 0, r * r, f(-_BIG))
    tab[:, J_VX:J_VZ + 1] = _np(scene.sph_cvel)
    tab[:, J_INVR] = f(1.0) / np.maximum(r, f(1e-30))
    tab[:, J_KIND] = _np(scene.mat_kind)[mat].astype(f)
    tab[:, J_AR:J_AB + 1] = _np(scene.tex_color1)[mtex]
    tab[:, J_FUZZ] = _np(scene.mat_fuzz)[mat]
    tab[:, J_IOR] = _np(scene.mat_ior)[mat]
    tab[:, J_TEXK] = tk.astype(f)
    tab[:, J_C2R:J_C2B + 1] = _np(scene.tex_color2)[mtex]
    tab[:, J_INVS] = np.where(tk == 3, _np(scene.tex_noise_scale)[mtex],
                              _np(scene.tex_inv_scale)[mtex])
    tab[:, J_IMG] = _np(scene.tex_image)[mtex].astype(f)
    return tab


def _pad_cluster_ranges(order, cl_start, u: int):
    """Pad every [start, end) range of ``order`` to a multiple of ``u``
    with -1 sentinels (unhittable rows)."""
    order = np.asarray(order, np.int32)
    cl_start = np.asarray(cl_start, np.int32)
    if u <= 1:
        return order, cl_start
    segs, starts, tot = [], [0], 0
    for c in range(cl_start.shape[0] - 1):
        seg = order[cl_start[c]:cl_start[c + 1]]
        pad = (-seg.shape[0]) % u
        if pad:
            seg = np.concatenate([seg, np.full(pad, -1, np.int32)])
        segs.append(seg)
        tot += seg.shape[0]
        starts.append(tot)
    return (np.concatenate(segs).astype(np.int32),
            np.asarray(starts, np.int32))


def active_primitive_count(scene: Scene) -> int:
    """Total active primitives (spheres + quads + boxes + media)."""
    return int(sum(float(_np(m).sum()) for m in (
        scene.sph_mask, scene.quad_mask, scene.box_mask,
        scene.msph_mask, scene.mbox_mask)))


def respawn_tile_rows(scene: Scene) -> int:
    """Rows of 128 slots the lane space is padded to (the JAX tile
    height; kept so the lane count R matches the JAX package's)."""
    return 32


_slot_cache: dict = {}


def _unswizzle_index(width: int, height: int) -> np.ndarray:
    """[H*W] slot index of each pixel under the 32x32 block swizzle."""
    key = (width, height)
    if key not in _slot_cache:
        tiles_x = -(-width // _BLK)
        py, px = np.mgrid[0:height, 0:width]
        slot = (((py // _BLK) * tiles_x + px // _BLK) * (_BLK * _BLK)
                + (py % _BLK) * _BLK + (px % _BLK))
        _slot_cache[key] = slot.reshape(-1).astype(np.int32)
    return _slot_cache[key]


_slot_dev_cache: dict = {}  # (width, height, device) -> int64 tensor
_SLOT_DEV_CACHE_MAX = 4


def unswizzle_index_on(width: int, height: int, device) -> torch.Tensor:
    """``_unswizzle_index`` as an int64 tensor on ``device``, kept for the
    next pass (a 4K image's index is 67 MB to copy)."""
    key = (width, height, str(device))
    if key not in _slot_dev_cache:
        _slot_dev_cache[key] = torch.as_tensor(
            _unswizzle_index(width, height).astype(np.int64), device=device)
        if len(_slot_dev_cache) > _SLOT_DEV_CACHE_MAX:
            _slot_dev_cache.pop(next(iter(_slot_dev_cache)))
    return _slot_dev_cache[key]


@dataclasses.dataclass
class Prepared:
    """Everything a persist launch reads besides the lane state."""

    geom: torch.Tensor  # [N, 4] f32: cx, cy, cz, r2 (cluster order)
    gvel: torch.Tensor  # [N, 4] f32: vx, vy, vz, 0 (same order)
    tab: torch.Tensor  # [N, 24] f32: joined table, same row order
    clb: torch.Tensor  # [C, 8] f32: cluster lo3, hi3, 0, 0
    cls: torch.Tensor  # [C+1] i32: cluster starts, divided by unroll
    sclb: torch.Tensor  # [S, 8] f32: super-cluster bounds
    scls: torch.Tensor  # [S+1] i32: super-cluster starts (in clusters)
    qtab: torch.Tensor  # [max(Q, 1) + QC, 32] f32: quads, cluster rows
    ltab: torch.Tensor  # [max(L, 1), 24] f32: NEE lights (zeros unless mis)
    btab: torch.Tensor  # [NB, 8] f32: box lo3, hi3 (box cluster order)
    batt: torch.Tensor  # [NB, 12] f32: box winner attributes
    bclb: torch.Tensor  # [CB, 8] f32: box cluster bounds
    bcls: torch.Tensor  # [CB+1] i32: box cluster starts, divided by b_unroll
    mtab: torch.Tensor  # [max(M, 1), 24] f32: constant media
    perm: torch.Tensor  # [3, 256] i32: Perlin permutations
    randvec: torch.Tensor  # [256, 3] f32: Perlin lattice vectors
    texels: torch.Tensor  # [T, 3] f32: image texels, image-major
    img_meta: torch.Tensor  # [NI, 3] i32: base, w, h of each image
    cam_u: torch.Tensor  # [20] f32: center, pixel00, du, dv, disk u, v, 0, 0
    bg: torch.Tensor  # [4] f32: flat background color, 0
    n_clusters: int
    n_sclusters: int
    n_ssc_static: int  # leading super-clusters of static spheres (split)
    unroll: int
    n_quads: int  # quad rows the kernels scan (0 without quads)
    n_qclusters: int  # quad clusters (metadata rows after the quads), or 0
    n_lights: int  # NEE lights (0 unless mis)
    n_boxes: int  # box rows (0 without boxes)
    n_bclusters: int
    b_unroll: int
    n_media: int
    rows: int
    tile_rows: int
    width: int
    height: int
    sky_bg: bool
    defocus: bool
    mis: bool
    stratified: bool
    sqrt_spp: int
    moving: bool
    has_checker: bool
    has_noise: bool
    has_image: bool

    @property
    def n_lanes(self) -> int:
        return self.rows * TILE_LANES

    @property
    def book2(self) -> bool:
        """The tables need the kernels' Book-2 instance (motion, boxes,
        media or a checker, Perlin or image texture)."""
        return bool(self.moving or self.n_boxes or self.n_media
                    or self.has_checker or self.has_noise or self.has_image)


def _cluster_spheres(scene: Scene, max_leaf: int):
    """(order, cl_start, cl_min, cl_max, s_start, s_min, s_max,
    n_ssc_static) of the active spheres' clusters over their motion-swept
    bounds (pallas_megakernel.py:2276-2377): the C++ SAH cut, or the
    sphere grid of ``bvh.cluster_spheres_spatial`` with
    ``RTT_SPHERE_GRID=1`` (then ``order`` lists a sphere once for every
    cell it overlaps).  Clusters are permuted super-cluster-contiguous once
    there are 16 of them.  A moving scene with at least 64 static spheres
    clusters its static and moving spheres apart, static first, each under
    its own super-clusters, and ``n_ssc_static`` counts the static ones;
    ``s_start`` is None without super-clusters."""
    from ..native import build_aabb_clusters, build_sphere_clusters
    from .bvh import cluster_spheres_spatial

    def cluster(c, r):
        return cluster_spheres_spatial(c, r, max_leaf=max_leaf,
                                       build_sah=build_sphere_clusters)

    mask = _np(scene.sph_mask) > 0
    cen = _np(scene.sph_center).astype(np.float32)
    vel = _np(scene.sph_cvel).astype(np.float32)
    rad = np.abs(_np(scene.sph_radius).astype(np.float32))
    rad = np.where(mask, rad, 0.0)
    cmid = cen + 0.5 * vel
    rswept = rad + 0.5 * np.linalg.norm(vel, axis=-1)

    def supers(order, cl_start, cl_min, cl_max, force: bool):
        n_cl = cl_start.shape[0] - 1
        if n_cl >= 16:
            sorder, s_start, s_min, s_max = build_aabb_clusters(
                cl_min, cl_max, max_leaf=16)
            order = np.concatenate(
                [order[cl_start[c]:cl_start[c + 1]] for c in sorder])
            sizes = (cl_start[1:] - cl_start[:-1])[sorder]
            cl_start = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
            return (order, cl_start, cl_min[sorder], cl_max[sorder],
                    np.asarray(s_start, np.int32), s_min, s_max)
        if force:  # identity super-clusters, so the split loop always runs
            return (order, cl_start, cl_min, cl_max,
                    np.arange(n_cl + 1, dtype=np.int32), cl_min, cl_max)
        return order, cl_start, cl_min, cl_max, None, None, None

    moving_p = (np.abs(vel).max(axis=-1) > 0) & mask
    n_static = int((~moving_p & mask).sum())
    if "motion" in scene.features and moving_p.any() and n_static >= 64:
        parts = []
        for idx in (np.where(~moving_p)[0], np.where(moving_p)[0]):
            o, cs, mn, mx = cluster(cmid[idx], rswept[idx])
            parts.append(supers(idx[np.asarray(o)], np.asarray(cs, np.int32),
                                mn, mx, force=True))
        (o1, cs1, mn1, mx1, ss1, smn1, smx1), (o2, cs2, mn2, mx2, ss2, smn2,
                                               smx2) = parts
        return (np.concatenate([o1, o2]).astype(np.int32),
                np.concatenate([cs1, cs2[1:] + cs1[-1]]).astype(np.int32),
                np.concatenate([mn1, mn2]), np.concatenate([mx1, mx2]),
                np.concatenate([ss1, ss2[1:] + (cs1.shape[0] - 1)]
                               ).astype(np.int32),
                np.concatenate([smn1, smn2]), np.concatenate([smx1, smx2]),
                ss1.shape[0] - 1)
    order, cl_start, cl_min, cl_max = cluster(cmid, rswept)
    return (*supers(order, cl_start, cl_min, cl_max, force=False), 0)


def _upload(tables: dict, device) -> dict:
    """{name: (array, np.float32 or np.int32)} -> {name: tensor} in one
    host-to-device copy: a flat 32-bit buffer (int32 tables copied bit for
    bit), each table at a 16-byte aligned offset, returned as contiguous
    views of it."""
    flat = {k: np.asarray(a, dt).reshape(-1) for k, (a, dt) in tables.items()}
    offs, off = {}, 0
    for k, a in flat.items():
        offs[k] = off
        off += a.size + (-a.size) % 4
    host = np.zeros(off, np.float32)
    for k, a in flat.items():
        host[offs[k]:offs[k] + a.size] = a.view(np.float32)
    buf = torch.as_tensor(host, device=device)
    ibuf = buf.view(torch.int32)
    return {k: (ibuf if dt == np.int32 else buf)[
        offs[k]:offs[k] + flat[k].size].view(np.shape(a))
        for k, (a, dt) in tables.items()}


def prepare_megakernel(scene: Scene, cam: CameraParams, *, width: int,
                       height: int, device="cuda", tile_rows: int = TILE_ROWS,
                       mis: bool = False, stratified: bool = False,
                       sqrt_spp: int = 0) -> Prepared:
    """SAH clustering + table packing (pallas_megakernel.py:2175-2511), on
    ``device`` (``"cuda"`` raises without a card).  The sphere and box loops
    are unrolled by 4 unless Perlin marble dominates the scene or the
    integrator is MIS, as in the JAX package."""
    device = _cuda.device(device)
    megakernel_eligible(scene, "mis" if mis else "path")
    if stratified and sqrt_spp < 1:
        raise ValueError("stratified sampling needs sqrt_spp >= 1")
    unroll = 1 if (noise_dominant(scene) or mis) else SPHERE_UNROLL
    b_unroll = 1 if (noise_dominant(scene) or mis) else BOX_UNROLL
    mask = _np(scene.sph_mask)
    sphere_max_leaf = (SPHERE_MAX_LEAF_BIG if int(mask.sum()) >= SPHERE_BIG_N
                       else SPHERE_MAX_LEAF)
    tiles_x = -(-width // _BLK)
    tiles_y = -(-height // _BLK)
    n_slots = tiles_x * tiles_y * _BLK * _BLK
    tile_r = tile_rows * TILE_LANES
    rows = (-(-n_slots // tile_r)) * tile_rows

    tab = pack_joined_table(scene)
    n_spheres = tab.shape[0]
    sclb = np.zeros((1, 8), np.float32)
    scls = np.zeros(2, np.int32)
    n_sclusters = n_ssc_static = 0
    if n_spheres >= 64:
        (order, cl_start, cl_min, cl_max, s_start, s_min, s_max,
         n_ssc_static) = _cluster_spheres(scene, sphere_max_leaf)
        if s_start is not None:
            n_sclusters = s_start.shape[0] - 1
            sclb = np.concatenate(
                [s_min, s_max, np.zeros((n_sclusters, 2), np.float32)],
                axis=1)
            scls = np.asarray(s_start, np.int32)
        n_clusters = cl_start.shape[0] - 1
        order, cl_start = _pad_cluster_ranges(order, cl_start, unroll)
        dead = order < 0
        tab = tab[np.maximum(order, 0)]
        tab[dead, J_R2] = np.float32(-_BIG)
        clb = np.concatenate(
            [cl_min, cl_max, np.zeros((n_clusters, 2), np.float32)], axis=1)
        cls = (cl_start // unroll).astype(np.int32)
    else:
        n_clusters = 0
        clb = np.zeros((1, 8), np.float32)
        cls = np.zeros(2, np.int32)
        if unroll > 1 and n_spheres % unroll:
            # flat scan: pad the table itself to a multiple of unroll
            padrow = tab[:1].copy()
            padrow[:, J_R2] = np.float32(-_BIG)
            tab = np.concatenate(
                [tab] + [padrow] * ((-n_spheres) % unroll))

    if "boxes" in scene.features:
        btab, border, bcls, bclb = pack_box_tables(
            scene, max_leaf=BOX_MAX_LEAF, pad_to=b_unroll)
        batt = pack_box_attrs(scene, border)
        n_boxes, n_bclusters = btab.shape[0], bcls.shape[0] - 1
        bcls = (bcls // b_unroll).astype(np.int32)
    else:
        btab, bclb = np.zeros((1, B_COLS), np.float32), np.zeros((1, 8),
                                                                 np.float32)
        batt = np.zeros((1, BA_COLS), np.float32)
        bcls = np.zeros(2, np.int32)
        n_boxes = n_bclusters = 0
    mtab, n_media = (pack_media_table(scene) if "media" in scene.features
                     else (np.zeros((1, M_COLS), np.float32), 0))
    # the Perlin lattice and the texels only where a texture reads them
    perm, randvec = (pack_perlin_tables(scene) if "noise" in scene.features
                     else (np.zeros((3, 256), np.int32),
                           np.zeros((256, 3), np.float32)))
    texels, img_meta = (pack_image_table(scene) if "image" in scene.features
                        else (np.zeros((1, 3), np.float32),
                              np.zeros((1, 3), np.int32)))

    qtab, n_quads, n_qclusters = cluster_quad_table(
        scene, _np(pack_quad_table(scene)))
    ltab, n_lights = (pack_light_table(scene) if mis
                      else (np.zeros((1, L_COLS), np.float32), 0))

    cam_u = np.concatenate([
        _np(cam.center), _np(cam.pixel00), _np(cam.pixel_delta_u),
        _np(cam.pixel_delta_v), _np(cam.defocus_disk_u),
        _np(cam.defocus_disk_v), np.zeros(2, np.float32),
    ]).astype(np.float32)
    bg = np.concatenate([_np(cam.background).astype(np.float32),
                         np.zeros(1, np.float32)])
    gvel = np.zeros((tab.shape[0], 4), np.float32)
    gvel[:, :3] = tab[:, J_VX:J_VZ + 1]

    f32, i32 = np.float32, np.int32
    feats = scene.features
    return Prepared(
        **_upload(dict(
            geom=(tab[:, [J_CX, J_CY, J_CZ, J_R2]], f32), gvel=(gvel, f32),
            tab=(tab, f32), clb=(clb, f32), cls=(cls, i32), sclb=(sclb, f32),
            scls=(scls, i32), qtab=(qtab, f32), ltab=(ltab, f32),
            btab=(btab, f32), batt=(batt, f32), bclb=(bclb, f32),
            bcls=(bcls, i32), mtab=(mtab, f32), perm=(perm, i32),
            randvec=(randvec, f32), texels=(texels, f32),
            img_meta=(img_meta, i32), cam_u=(cam_u, f32), bg=(bg, f32)),
            device),
        n_clusters=n_clusters, n_sclusters=n_sclusters,
        n_ssc_static=int(n_ssc_static), unroll=unroll,
        n_quads=n_quads, n_qclusters=n_qclusters, n_lights=n_lights,
        n_boxes=n_boxes,
        n_bclusters=n_bclusters, b_unroll=b_unroll, n_media=n_media,
        rows=rows, tile_rows=tile_rows, width=width, height=height,
        sky_bg=cam.bg_mode == BG_SKY, defocus=bool(cam.lens_radius_gt0),
        mis=bool(mis), stratified=bool(stratified),
        sqrt_spp=int(sqrt_spp) if stratified else 0,
        moving="motion" in feats, has_checker="checker" in feats,
        has_noise="noise" in feats, has_image="image" in feats)


_PREP_CACHE: list = []  # [(scene, (camera key, keywords), prepared)]
_PREP_CACHE_MAX = 4


def prep_knobs() -> tuple:
    """The environment knobs the tables depend on, keyed as the JAX
    package keys its cache (pallas_megakernel.py:2531-2536):
    ``RTT_SPHERE_GRID`` by whether it is set, ``RTT_GRID_RES`` and
    ``RTT_GRID_FILL`` by value."""
    env = os.environ
    return (bool(env.get("RTT_SPHERE_GRID")), env.get("RTT_GRID_RES"),
            env.get("RTT_GRID_FILL"))


def prepare_megakernel_cached(scene: Scene, cam: CameraParams,
                              **kw) -> Prepared:
    """prepare_megakernel with a tiny cache: the passes and repeated renders
    of one scene share their tables.  Entries hold strong references and
    are matched with ``is`` on the scene (so a reused id() can never alias
    a stale entry), by value on the camera (``CameraParams.key``), on the
    keywords and on the environment knobs (``prep_knobs``), so a toggled
    knob never returns stale tables."""
    key = (cam.key, tuple(sorted((k, str(v)) for k, v in kw.items())),
           prep_knobs())
    for ent in _PREP_CACHE:
        if ent[0] is scene and ent[1] == key:
            return ent[2]
    prep = prepare_megakernel(scene, cam, **kw)
    _PREP_CACHE.append((scene, key, prep))
    if len(_PREP_CACHE) > _PREP_CACHE_MAX:
        _PREP_CACHE.pop(0)
    return prep


# ------------------------------------------------------------- device half


def check_tables(tables: Prepared) -> None:
    """Raise unless every table is a contiguous CUDA tensor of the kernels'
    type and the float4-read rows are 16-byte aligned."""
    for name in ("geom", "gvel", "tab", "clb", "sclb", "btab", "batt",
                 "bclb", "mtab", "randvec", "texels", "cam_u", "bg"):
        _cuda.require(getattr(tables, name), name, torch.float32)
    for name in ("cls", "scls", "bcls", "perm", "img_meta"):
        _cuda.require(getattr(tables, name), name, torch.int32)
    _cuda.require(tables.qtab, "qtab", torch.float32, (None, Q_COLS))
    _cuda.require(tables.ltab, "ltab", torch.float32, (None, L_COLS))
    _cuda.require(tables.mtab, "mtab", torch.float32, (None, M_COLS))
    _cuda.require(tables.perm, "perm", torch.int32, (3, 256))
    _cuda.require(tables.randvec, "randvec", torch.float32, (256, 3))
    for name in ("geom", "gvel"):
        if getattr(tables, name).data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads float4 rows; need "
                             "16-byte alignment")


def path_params(t: Prepared, seed: int, *, spp: int, max_depth: int,
                sample_offset: int = 0, work: torch.Tensor | None = None,
                warp_times: torch.Tensor | None = None) -> _cuda.PathParams:
    """The C struct ``rtt::Params`` of a launch on ``t``'s tables.  ``work``
    (int64 [11], optional) receives the launch's counts named by
    WORK_NAMES, added to what it holds; it selects the counting instance of
    the kernel, so a timed launch passes none.  ``warp_times`` (int64
    [n, 2] from ``warp_times_buffer``, with ``work`` only) receives each
    warp's start and finish on the device's clock."""
    if work is not None:
        _cuda.require(work, "work", torch.int64, (len(WORK_NAMES),))
    if warp_times is not None:
        if work is None:
            raise ValueError("warp_times needs work: only the counting "
                             "instances record them")
        _cuda.require(warp_times, "warp_times", torch.int64, (None, 2))
    k0, k1 = seed_key(seed)
    return _cuda.PathParams(
        geom=t.geom.data_ptr(), gvel=t.gvel.data_ptr(), tab=t.tab.data_ptr(),
        n_rows=t.geom.shape[0], clb=t.clb.data_ptr(), cls=t.cls.data_ptr(),
        n_clusters=t.n_clusters, sclb=t.sclb.data_ptr(),
        scls=t.scls.data_ptr(), n_sclusters=t.n_sclusters,
        n_ssc_static=t.n_ssc_static, unroll=t.unroll,
        qtab=t.qtab.data_ptr(), n_quads=t.n_quads,
        n_qclusters=t.n_qclusters, ltab=t.ltab.data_ptr(),
        n_lights=t.n_lights, btab=t.btab.data_ptr(), batt=t.batt.data_ptr(),
        bclb=t.bclb.data_ptr(), bcls=t.bcls.data_ptr(), n_boxes=t.n_boxes,
        n_bclusters=t.n_bclusters, b_unroll=t.b_unroll,
        mtab=t.mtab.data_ptr(), n_media=t.n_media, perm=t.perm.data_ptr(),
        randvec=t.randvec.data_ptr(), texels=t.texels.data_ptr(),
        img_meta=t.img_meta.data_ptr(), n_images=t.img_meta.shape[0],
        cam=t.cam_u.data_ptr(), bg=t.bg.data_ptr(),
        sky_bg=int(t.sky_bg), defocus=int(t.defocus), width=t.width,
        height=t.height, spp=spp, max_depth=max_depth,
        stratified=int(t.stratified), sqrt_spp=t.sqrt_spp,
        moving=int(t.moving), has_checker=int(t.has_checker),
        has_noise=int(t.has_noise), has_image=int(t.has_image), k0=k0,
        k1=k1, sample_offset=int(sample_offset),
        work=None if work is None else work.data_ptr(),
        warp_t=None if warp_times is None else warp_times.data_ptr())


def warp_times_buffer(n_lanes: int, device) -> torch.Tensor:
    """The ``warp_times`` record of a megakernel launch over ``n_lanes``
    slots: int64 [n, 2], a row for every warp the launch can have (blocks
    of up to 256 threads), starts at ~0 and finishes at 0, so a warp that
    never ran keeps a finish of 0."""
    n = -(-n_lanes // 256) * 8
    t = torch.zeros((n, 2), dtype=torch.int64, device=device)
    t[:, 0] = -1
    return t


def tail_share(warp_times: torch.Tensor) -> dict:
    """From a ``warp_times`` record: the launch's span (first start to last
    finish, ns) and its tail, the share of the span after the card can no
    longer be kept full: once the last warp has started and a warp has
    finished (a grid of many short blocks fills the card until its last
    block starts, a persistent grid until its first warp runs dry)."""
    t = warp_times.cpu()
    t = t[t[:, 1] > 0]
    start, last_start = int(t[:, 0].min()), int(t[:, 0].max())
    first, last = int(t[:, 1].min()), int(t[:, 1].max())
    span = max(last - start, 1)
    return dict(span_ns=span, warps=int(t.shape[0]),
                last_start_share=(last_start - start) / span,
                first_finish_share=(first - start) / span,
                tail_share=(last - max(last_start, first)) / span)


def respawn_pass_plain(tables: Prepared, seed: int, sample_offset: int,
                       spp: int, max_depth: int) -> torch.Tensor:
    """Plain twin of K3, vectorised over lanes: the lane iteration of the
    persist twin, repeated until no lane has work.  Returns the radiance
    sums [R, 3] in slot order."""
    from . import wavefront as wf

    R = tables.n_lanes
    dev = tables.geom.device
    state = torch.zeros((wf.N_STATE, R), dtype=torch.float32, device=dev)
    slot = torch.arange(R, dtype=torch.int32, device=dev)
    # a sample takes at most max_depth + 1 iterations (its bounces, then
    # the bank), so this bound is never what stops the loop
    wf.persist_step_plain(state, slot, tables, seed,
                          persist_iters=spp * (max_depth + 1) + 1, spp=spp,
                          max_depth=max_depth, sample_offset=sample_offset)
    return state[wf.R_SX:wf.R_SX + 3].T.contiguous()


def mono_pass_plain(tables: Prepared, seed: int, sample_offset: int,
                    spp: int, max_depth: int) -> torch.Tensor:
    """Plain twin of K4, vectorised over lanes: for each sample, spawn
    every lane, bounce the live lanes until none is alive, and add the
    paths' radiance to the sums.  Returns the radiance sums [R, 3] in slot
    order."""
    from . import wavefront as wf

    R = tables.n_lanes
    dev = tables.geom.device
    key = seed_key(seed)
    slot = torch.arange(R, dtype=torch.int64, device=dev)
    sums = torch.zeros((3, R), dtype=torch.float32, device=dev)
    for k in range(spp):
        sample = torch.full((R,), k + sample_offset, dtype=torch.int64,
                            device=dev)
        v = wf.spawn_lanes(tables, slot, sample, key)
        zero = torch.zeros_like(v["b"])
        v.update(rx=zero, ry=zero, rz=zero)
        while wf.bounce_live(tables, v, slot, sample, key, max_depth):
            pass
        sums = sums + torch.stack([v["rx"], v["ry"], v["rz"]])
    return sums.T.contiguous()


# (kernel, template flags, device index) -> (block, resident blocks)
_RESIDENT: dict = {}


def _resident(name: str, flags: tuple, device: torch.device) -> tuple:
    """(threads a block, blocks resident on the card) of the instance of
    megakernel ``name`` with template ``flags``: the SMs times the
    occupancy query's blocks an SM, queried once per instance and
    device."""
    key = (name, flags, device.index)
    if key not in _RESIDENT:
        with torch.cuda.device(device):
            block, per_sm = _cuda.megakernel_shape(name, *flags)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _RESIDENT[key] = (block, sms * per_sm)
    return _RESIDENT[key]


def cluster_cull(tables: Prepared) -> bool:
    """Whether a sphere or box cluster cull runs on ``tables``: the
    megakernels then take their cooperative instance (K2's leaf scan, and
    in K3 32 consecutive slots a warp, whose neighbouring primary rays keep
    it efficient); otherwise the per-lane bounce (and in K3 a slot a lane,
    every lane busy until the queue runs dry)."""
    return tables.n_clusters > 0 or tables.n_bclusters > 1


def megakernel_grid(n_slots: int, block: int, resident: int,
                    max_blocks: int | None = None) -> int:
    """Blocks of a megakernel launch over ``n_slots`` slots: one resident
    wave, never more blocks than the slots need (a slot a thread), nor than
    ``max_blocks``."""
    if max_blocks is not None and max_blocks < 1:
        raise ValueError(f"max_blocks must be at least 1, got {max_blocks}")
    grid = min(resident, -(-n_slots // block))
    return grid if max_blocks is None else min(grid, max_blocks)


def slot_queue(device) -> torch.Tensor:
    """The slot queue of one megakernel launch: a new int32 zero on the
    device, written on the current stream (no host sync), so no launch
    starts from another's count."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _megakernel_launch(name: str, tables: Prepared, seed: int,
                       sample_offset: int, spp: int, max_depth: int,
                       work: torch.Tensor | None,
                       warp_times: torch.Tensor | None,
                       max_blocks: int | None) -> torch.Tensor:
    """One launch of megakernel ``name`` ("megakernel" K3 or "mono" K4)
    over every slot: the radiance sums [R, 3]."""
    check_tables(tables)
    R = tables.n_lanes
    dev = tables.geom.device
    out = torch.empty((R, 3), dtype=torch.float32, device=dev)
    params = path_params(tables, seed, spp=spp, max_depth=max_depth,
                         sample_offset=sample_offset, work=work,
                         warp_times=warp_times)
    coop = cluster_cull(tables)
    block, resident = _resident(
        name, (tables.mis, tables.book2, work is not None, coop), dev)
    queue = slot_queue(dev)
    _cuda.launch(name, out.data_ptr(), R, ctypes.addressof(params),
                 int(tables.mis), int(tables.book2), int(coop),
                 queue.data_ptr(),
                 megakernel_grid(R, block, resident, max_blocks))
    return out


def respawn_pass(tables: Prepared, seed: int, sample_offset: int, spp: int,
                 max_depth: int, work: torch.Tensor | None = None,
                 warp_times: torch.Tensor | None = None,
                 max_blocks: int | None = None) -> torch.Tensor:
    """One K3 launch over every slot: the radiance sums [R, 3] of ``spp``
    samples per slot (absolute indices ``sample_offset + [0, spp)``).  CUDA
    tables launch ``csrc/megakernel.cu`` (the instance ``cluster_cull``
    picks) on one resident wave of blocks, at most ``max_blocks``; CPU
    tables run ``respawn_pass_plain``.  ``work`` and ``warp_times`` as in
    ``path_params``.  The sums do not depend on the grid."""
    if tables.geom.device.type == "cpu":
        return respawn_pass_plain(tables, seed, sample_offset, spp,
                                  max_depth)
    return _megakernel_launch("megakernel", tables, seed, sample_offset, spp,
                              max_depth, work, warp_times, max_blocks)


def mono_pass(tables: Prepared, seed: int, sample_offset: int, spp: int,
              max_depth: int, work: torch.Tensor | None = None,
              warp_times: torch.Tensor | None = None,
              max_blocks: int | None = None) -> torch.Tensor:
    """One K4 launch over every slot: the same sums as ``respawn_pass``,
    bitwise, each warp running its 32 slots' samples one after another in
    lockstep.  CUDA tables launch ``csrc/mono.cu`` (grid as
    ``respawn_pass``); CPU tables run ``mono_pass_plain``."""
    if tables.geom.device.type == "cpu":
        return mono_pass_plain(tables, seed, sample_offset, spp, max_depth)
    return _megakernel_launch("mono", tables, seed, sample_offset, spp,
                              max_depth, work, warp_times, max_blocks)


def render_pass_megakernel(scene: Scene, cam: CameraParams, seed: int, *,
                           width: int, height: int, spp: int, max_depth: int,
                           sample_offset: int = 0, mis: bool = False,
                           stratified: bool = False, sqrt_spp: int = 0,
                           respawn: bool = False, device="cuda",
                           step=None) -> torch.Tensor:
    """Whole-image render pass in one launch (pallas_megakernel.py:
    2547-2594): the monolithic megakernel K4, or with ``respawn`` the
    respawn megakernel K3; returns the radiance SUM [H, W, 3].  ``step``
    replaces the pass (``mono_pass_plain`` or ``respawn_pass_plain`` on any
    device, for comparisons with the kernels).  Image-textured scenes raise
    ``ValueError``: they take the wavefront image route
    (pallas_megakernel.py:2102-2105)."""
    if "image" in scene.features:
        raise ValueError("image textures take the wavefront image route "
                         "(ops/wavefront.py), not the megakernels")
    if step is None:
        step = respawn_pass if respawn else mono_pass
    tables = prepare_megakernel_cached(
        scene, cam, width=width, height=height,
        tile_rows=respawn_tile_rows(scene), mis=mis, stratified=stratified,
        sqrt_spp=sqrt_spp, device=device)
    sums = step(tables, seed, sample_offset, spp, max_depth)
    idx = unswizzle_index_on(width, height, sums.device)
    return sums[idx].reshape(height, width, 3)
