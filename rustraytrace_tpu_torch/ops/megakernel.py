"""The path tracer's tables and the respawn megakernel K3 (counterpart:
``rustraytrace_tpu/ops/pallas_megakernel.py``: the host functions, and
``render_pass_megakernel`` with ``respawn=True``).

Host half: ``prepare_megakernel`` builds what the persist kernel
(``csrc/persist.cu``), the respawn megakernel (``csrc/megakernel.cu``) and
their plain twins read: the sphere table in SAH cluster order, cluster
ranges padded to the sphere-loop unroll with unhittable ``r2 = -BIG``
sentinel rows, the cluster and super-cluster AABBs, the quad table, the NEE
light table and the camera uniforms.  Row order and values are the JAX
package's, so the tables are bit-equal to ``prepare_megakernel(...,
segment=True)`` there.  What is not carried over are the layouts that exist
for Mosaic: the column-major SMEM geometry table and the 128-lane attribute
slabs become a row-major ``[N, 4]`` geometry table and a row-major
``[N, 24]`` attribute table.

Device half: ``respawn_pass`` launches K3, one launch per render pass, in
which every lane walks its ``spp`` samples back to back; CPU tensors run
its plain twin ``respawn_pass_plain``.  ``render_pass_megakernel`` prepares
the tables, runs one pass and unswizzles the sums to pixels.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..config import BG_SKY, CameraParams
from ..scene import ISOTROPIC, Scene
from . import _cuda
from .hit import Q_COLS, pack_quad_table
from .rng import seed_key

_BIG = 1.0e30
TILE_ROWS = 32  # rows of 128 lanes the slot space is padded to (JAX tiles)
TILE_LANES = 128
_BLK = 32  # screen-space swizzle block (32x32 pixels = 1024 slots)

SPHERE_UNROLL = 4
SPHERE_MAX_LEAF = 64
SPHERE_MAX_LEAF_BIG = 32
SPHERE_BIG_N = 4096

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

# at this many quads the JAX package SAH-clusters the quad table
QUAD_CLUSTER_MIN = 32

# feature -> the persist-kernel sub-slice that carries it
_SUB_SLICES = {
    "motion": "K2(b) motion and checker",
    "checker": "K2(b) motion and checker",
    "boxes": "K2(c) boxes, media and Perlin",
    "media": "K2(c) boxes, media and Perlin",
    "noise": "K2(c) boxes, media and Perlin",
    "image": "K2(e) image textures",
}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def megakernel_eligible(scene: Scene, integrator: str = "path") -> bool:
    """True when the ported kernels cover the scene: spheres and fewer than
    QUAD_CLUSTER_MIN quads, sky or flat background, solid albedos, no
    motion, the path integrator or (with ``mis_lights_ok``) the NEE/MIS
    one.  Anything else raises ``NotImplementedError`` naming the sub-slice
    that still has to be ported."""
    if integrator not in ("path", "mis"):
        raise ValueError(f"unknown integrator {integrator!r}")
    for feat in sorted(scene.features):  # any non-solid texture is one
        if feat in _SUB_SLICES:
            raise NotImplementedError(
                f"scene feature {feat!r} needs sub-slice {_SUB_SLICES[feat]},"
                " not ported yet")
    n_quads = int(_np(scene.quad_mask).sum()) if "quads" in scene.features \
        else 0
    if n_quads >= QUAD_CLUSTER_MIN:
        raise NotImplementedError(
            f"{n_quads} quads (>= {QUAD_CLUSTER_MIN}) need sub-slice K2(c) "
            "quad clusters, not ported yet")
    if integrator == "mis":
        if not mis_lights_ok(scene):
            raise NotImplementedError(
                "integrator 'mis' runs in-kernel with 1 to 16 NEE lights; "
                f"the scene has {int(_np(scene.light_mask).sum())}")
        mats = np.concatenate([
            _np(scene.sph_mat)[_np(scene.sph_mask) > 0],
            _np(scene.quad_mat)[_np(scene.quad_mask) > 0]])
        if np.any(_np(scene.mat_kind)[mats] == ISOTROPIC):
            raise NotImplementedError(
                "isotropic materials under 'mis' need sub-slice K2(c) "
                "media, not ported yet")
    return True


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
    tab: torch.Tensor  # [N, 24] f32: joined table, same row order
    clb: torch.Tensor  # [C, 8] f32: cluster lo3, hi3, 0, 0
    cls: torch.Tensor  # [C+1] i32: cluster starts, divided by unroll
    sclb: torch.Tensor  # [S, 8] f32: super-cluster bounds
    scls: torch.Tensor  # [S+1] i32: super-cluster starts (in clusters)
    qtab: torch.Tensor  # [max(Q, 1), 32] f32: quad frames + materials
    ltab: torch.Tensor  # [max(L, 1), 24] f32: NEE lights (zeros unless mis)
    cam_u: torch.Tensor  # [20] f32: center, pixel00, du, dv, disk u, v, 0, 0
    bg: torch.Tensor  # [4] f32: flat background color, 0
    n_clusters: int
    n_sclusters: int
    unroll: int
    n_quads: int  # quad rows the kernels scan (0 without quads)
    n_lights: int  # NEE lights (0 unless mis)
    rows: int
    width: int
    height: int
    sky_bg: bool
    defocus: bool
    mis: bool
    stratified: bool
    sqrt_spp: int

    @property
    def n_lanes(self) -> int:
        return self.rows * TILE_LANES


def prepare_megakernel(scene: Scene, cam: CameraParams, *, width: int,
                       height: int, tile_rows: int = TILE_ROWS,
                       mis: bool = False, stratified: bool = False,
                       sqrt_spp: int = 0, device="cpu") -> Prepared:
    """SAH clustering + table packing, the sphere, quad and light path of
    pallas_megakernel.py:2175-2511 (no static/moving split: motion is not
    ported)."""
    from ..native import build_aabb_clusters, build_sphere_clusters

    megakernel_eligible(scene, "mis" if mis else "path")
    if stratified and sqrt_spp < 1:
        raise ValueError("stratified sampling needs sqrt_spp >= 1")
    # the JAX package scans MIS scenes' spheres without unrolling
    unroll = 1 if mis else SPHERE_UNROLL
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
    n_sclusters = 0
    if n_spheres >= 64:
        cen = _np(scene.sph_center).astype(np.float32)
        vel = _np(scene.sph_cvel).astype(np.float32)
        rad = np.abs(_np(scene.sph_radius).astype(np.float32))
        rad = np.where(mask > 0, rad, 0.0)
        cmid = cen + 0.5 * vel
        rswept = rad + 0.5 * np.linalg.norm(vel, axis=-1)
        order, cl_start, cl_min, cl_max = build_sphere_clusters(
            cmid, rswept, max_leaf=sphere_max_leaf)
        if cl_start.shape[0] - 1 >= 16:
            # 2-level hierarchy: SAH-cluster the cluster AABBs and permute
            # clusters (and spheres beneath) super-cluster-contiguous
            sorder, s_start, s_min, s_max = build_aabb_clusters(
                cl_min, cl_max, max_leaf=16)
            order = np.concatenate(
                [order[cl_start[c]:cl_start[c + 1]] for c in sorder])
            sizes = (cl_start[1:] - cl_start[:-1])[sorder]
            cl_start = np.concatenate(
                [[0], np.cumsum(sizes)]).astype(np.int32)
            cl_min, cl_max = cl_min[sorder], cl_max[sorder]
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

    qtab = _np(pack_quad_table(scene))
    n_quads = qtab.shape[0] if "quads" in scene.features else 0
    ltab, n_lights = (pack_light_table(scene) if mis
                      else (np.zeros((1, L_COLS), np.float32), 0))

    cam_u = np.concatenate([
        _np(cam.center), _np(cam.pixel00), _np(cam.pixel_delta_u),
        _np(cam.pixel_delta_v), _np(cam.defocus_disk_u),
        _np(cam.defocus_disk_v), np.zeros(2, np.float32),
    ]).astype(np.float32)
    bg = np.concatenate([_np(cam.background).astype(np.float32),
                         np.zeros(1, np.float32)])

    def dev(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return Prepared(
        geom=dev(tab[:, [J_CX, J_CY, J_CZ, J_R2]]), tab=dev(tab),
        clb=dev(clb), cls=dev(cls, torch.int32), sclb=dev(sclb),
        scls=dev(scls, torch.int32), qtab=dev(qtab), ltab=dev(ltab),
        cam_u=dev(cam_u), bg=dev(bg),
        n_clusters=n_clusters, n_sclusters=n_sclusters, unroll=unroll,
        n_quads=n_quads, n_lights=n_lights,
        rows=rows, width=width, height=height,
        sky_bg=cam.bg_mode == BG_SKY, defocus=bool(cam.lens_radius_gt0),
        mis=bool(mis), stratified=bool(stratified),
        sqrt_spp=int(sqrt_spp) if stratified else 0)


_PREP_CACHE: list = []  # [(scene, cam, kw_tuple, prepared)]
_PREP_CACHE_MAX = 4


def prepare_megakernel_cached(scene: Scene, cam: CameraParams,
                              **kw) -> Prepared:
    """prepare_megakernel with a tiny identity-keyed cache: the passes of
    one render share their tables.  Entries hold strong references and are
    matched with ``is`` on scene and camera, so a reused id() can never
    alias a stale entry."""
    kw_t = tuple(sorted((k, str(v)) for k, v in kw.items()))
    for ent in _PREP_CACHE:
        if ent[0] is scene and ent[1] is cam and ent[2] == kw_t:
            return ent[3]
    prep = prepare_megakernel(scene, cam, **kw)
    _PREP_CACHE.append((scene, cam, kw_t, prep))
    if len(_PREP_CACHE) > _PREP_CACHE_MAX:
        _PREP_CACHE.pop(0)
    return prep


# ------------------------------------------------------------- device half


def check_tables(tables: Prepared) -> None:
    """Raise unless every table is a contiguous CUDA tensor of the kernels'
    type and the geometry rows are 16-byte aligned (read as float4)."""
    for name in ("geom", "tab", "clb", "sclb", "cam_u", "bg"):
        _cuda.require(getattr(tables, name), name, torch.float32)
    for name in ("cls", "scls"):
        _cuda.require(getattr(tables, name), name, torch.int32)
    _cuda.require(tables.qtab, "qtab", torch.float32, (None, Q_COLS))
    _cuda.require(tables.ltab, "ltab", torch.float32, (None, L_COLS))
    if tables.geom.data_ptr() % 16:
        raise ValueError("geom: the kernel reads float4 rows; need 16-byte "
                         "alignment")


def path_params(t: Prepared, seed: int, *, spp: int, max_depth: int,
                sample_offset: int = 0,
                work: torch.Tensor | None = None) -> _cuda.PathParams:
    """The C struct ``rtt::Params`` of a launch on ``t``'s tables.  ``work``
    (int64 [3], optional) receives the launch's counts of bounces, sphere
    rows tested and cluster boxes tested, added to what it holds; it selects
    the counting instance of the kernel, so a timed launch passes none."""
    if work is not None:
        _cuda.require(work, "work", torch.int64, (3,))
    k0, k1 = seed_key(seed)
    return _cuda.PathParams(
        geom=t.geom.data_ptr(), tab=t.tab.data_ptr(),
        n_rows=t.geom.shape[0], clb=t.clb.data_ptr(), cls=t.cls.data_ptr(),
        n_clusters=t.n_clusters, sclb=t.sclb.data_ptr(),
        scls=t.scls.data_ptr(), n_sclusters=t.n_sclusters, unroll=t.unroll,
        qtab=t.qtab.data_ptr(), n_quads=t.n_quads, ltab=t.ltab.data_ptr(),
        n_lights=t.n_lights, cam=t.cam_u.data_ptr(), bg=t.bg.data_ptr(),
        sky_bg=int(t.sky_bg), defocus=int(t.defocus), width=t.width,
        height=t.height, spp=spp, max_depth=max_depth,
        stratified=int(t.stratified), sqrt_spp=t.sqrt_spp, k0=k0, k1=k1,
        sample_offset=int(sample_offset),
        work=None if work is None else work.data_ptr())


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


def respawn_pass(tables: Prepared, seed: int, sample_offset: int, spp: int,
                 max_depth: int, work: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """One K3 launch over every slot: the radiance sums [R, 3] of ``spp``
    samples per lane (absolute indices ``sample_offset + [0, spp)``).  CUDA
    tables launch ``csrc/megakernel.cu``; CPU tables run
    ``respawn_pass_plain``.  ``work`` as in ``path_params``."""
    if tables.geom.device.type == "cpu":
        return respawn_pass_plain(tables, seed, sample_offset, spp,
                                  max_depth)
    check_tables(tables)
    R = tables.n_lanes
    out = torch.empty((R, 3), dtype=torch.float32, device=tables.geom.device)
    params = path_params(tables, seed, spp=spp, max_depth=max_depth,
                         sample_offset=sample_offset, work=work)
    _cuda.launch("megakernel", out.data_ptr(), R, ctypes.addressof(params),
                 int(tables.mis))
    return out


def render_pass_megakernel(scene: Scene, cam: CameraParams, seed: int, *,
                           width: int, height: int, spp: int, max_depth: int,
                           sample_offset: int = 0, mis: bool = False,
                           stratified: bool = False, sqrt_spp: int = 0,
                           device="cpu", step=respawn_pass) -> torch.Tensor:
    """Whole-image render pass in one K3 launch (pallas_megakernel.py:
    2547-2594); returns the radiance SUM [H, W, 3].  ``step`` is the pass:
    ``respawn_pass``, or ``respawn_pass_plain`` on any device for
    comparisons with the kernel."""
    tables = prepare_megakernel_cached(
        scene, cam, width=width, height=height,
        tile_rows=respawn_tile_rows(scene), mis=mis, stratified=stratified,
        sqrt_spp=sqrt_spp, device=device)
    sums = step(tables, seed, sample_offset, spp, max_depth)
    idx = unswizzle_index_on(width, height, sums.device)
    return sums[idx].reshape(height, width, 3)
