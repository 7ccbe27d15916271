"""SAH BVH build, sphere clustering and the spatial-split sphere grid, in
NumPy (counterpart: ``rustraytrace_tpu/ops/bvh.py``, a copy of its code).

Same algorithm as the reference's BvhNode (src/books/*/bvh.rs:16-156):
binary tree, 12-bucket surface-area heuristic over the centroid bounds'
longest axis (bvh.rs:63-117), sorted-median fallback on degenerate centroids
or non-improving splits (bvh.rs:56-61,118-123,140-145).  Node ids are
assigned preorder so SAH leaves cover contiguous ascending ranges of the
primitive order — the property the cluster cut relies on.

The table prep (``ops/megakernel.py``) clusters its sphere groups through
:func:`cluster_spheres_spatial` with the C++ SAH cut injected
(``native.build_sphere_clusters``), as the JAX package does.  The NumPy SAH
cut is no fallback for it: :func:`grid_bin_spheres` calls
:func:`cluster_spheres_numpy` itself for cells over ``max_leaf`` and for
oversize spheres, so the grid's tables equal the JAX package's only with
this code.  Every float32 cast and loop order is the JAX module's, so
the outputs are bit-equal (``tests/test_torch_bvh.py``).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

_NB = 12  # bvh.rs:66 bucket count


def _area(mn, mx) -> float:
    d = np.maximum(mx - mn, 0.0)
    return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))


def build_bvh_numpy(centers: np.ndarray, radii: np.ndarray, max_leaf: int = 2):
    """The SAH build over the spheres' bounds (centers +- |radii|)."""
    centers = np.asarray(centers, np.float32)
    radii = np.abs(np.asarray(radii, np.float32))
    return build_bvh_aabb_numpy(
        centers - radii[:, None], centers + radii[:, None], max_leaf)


def build_bvh_aabb_numpy(pmin: np.ndarray, pmax: np.ndarray,
                         max_leaf: int = 2):
    """The SAH build over arbitrary primitive AABBs (bucket keys = AABB
    centroids).  Returns (node min [N, 3], node max [N, 3], left [N],
    right [N] (minus the count at a leaf), leaf start [N] (-1 inside),
    primitive order [P]), nodes in preorder."""
    pmin = np.asarray(pmin, np.float32)
    pmax = np.asarray(pmax, np.float32)
    centers = 0.5 * (pmin + pmax)
    n = centers.shape[0]

    order = np.arange(n)
    bmin, bmax, left, right, leaf = [], [], [], [], []

    def new_node():
        bmin.append(None); bmax.append(None)
        left.append(0); right.append(0); leaf.append(0)
        return len(left) - 1

    def build(lo: int, hi: int) -> int:
        node = new_node()
        ids = order[lo:hi]
        box_mn = pmin[ids].min(axis=0)
        box_mx = pmax[ids].max(axis=0)
        bmin[node] = box_mn
        bmax[node] = box_mx
        cnt = hi - lo
        if cnt <= max_leaf:
            left[node] = -1
            right[node] = -cnt
            leaf[node] = lo
            return node

        cen = centers[ids]
        cmin = cen.min(axis=0)
        cmax = cen.max(axis=0)
        axis = int(np.argmax(cmax - cmin))
        mid = -1
        if cmax[axis] - cmin[axis] > 1e-12:
            key = cen[:, axis]
            b = np.minimum(
                ((key - cmin[axis]) * (_NB / (cmax[axis] - cmin[axis])))
                .astype(np.int32), _NB - 1)
            best_cost, best_split = np.inf, -1
            for s in range(1, _NB):
                lsel = b < s
                lc = int(lsel.sum()); rc = cnt - lc
                if not lc or not rc:
                    continue
                la = _area(pmin[ids[lsel]].min(axis=0), pmax[ids[lsel]].max(axis=0))
                ra = _area(pmin[ids[~lsel]].min(axis=0), pmax[ids[~lsel]].max(axis=0))
                cost = lc * la + rc * ra
                if cost < best_cost:
                    best_cost, best_split = cost, s
            if best_split > 0 and best_cost < cnt * _area(box_mn, box_mx):
                pivot = cmin[axis] + best_split * (cmax[axis] - cmin[axis]) / _NB
                lsel = cen[:, axis] < pivot
                if 0 < lsel.sum() < cnt:
                    order[lo:hi] = np.concatenate([ids[lsel], ids[~lsel]])
                    mid = lo + int(lsel.sum())
        if mid < 0:
            k = np.argsort(cen[:, axis], kind="stable")
            order[lo:hi] = ids[k]
            mid = lo + cnt // 2

        l = build(lo, mid)
        r = build(mid, hi)
        left[node] = l
        right[node] = r
        leaf[node] = -1
        return node

    build(0, n)
    return (np.asarray(bmin, np.float32), np.asarray(bmax, np.float32),
            np.asarray(left, np.int32), np.asarray(right, np.int32),
            np.asarray(leaf, np.int32), order.astype(np.int32))


def cluster_spheres_numpy(centers, radii, max_leaf: int = 16
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The SAH leaves over the spheres' bounds as clusters of at most
    ``max_leaf``: (order [N], cluster_start [C+1], cl_min [C, 3],
    cl_max [C, 3])."""
    centers = np.asarray(centers, np.float32)
    radii = np.abs(np.asarray(radii, np.float32))
    return cluster_aabbs_numpy(
        centers - radii[:, None], centers + radii[:, None], max_leaf)


def cluster_aabbs_numpy(pmin, pmax, max_leaf: int = 16
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The same cut over arbitrary primitive AABBs."""
    bmin, bmax, left, right, leaf, order = build_bvh_aabb_numpy(
        pmin, pmax, max_leaf)
    is_leaf = leaf >= 0
    starts = leaf[is_leaf]
    counts = -right[is_leaf]
    assert np.all(starts == np.concatenate([[0], np.cumsum(counts)[:-1]]))
    cluster_start = np.concatenate([starts, [starts[-1] + counts[-1]]]).astype(np.int32)
    return order, cluster_start, bmin[is_leaf], bmax[is_leaf]


# ---------------------------------------------------------------------------
# Spatial-split grid binning: de-overlapping dense sphere clouds
# ---------------------------------------------------------------------------


def sphere_fill_fraction(centers, radii) -> float:
    """Total sphere volume / volume of the population's AABB, the density
    test of the grid dispatch.  Dense clouds, where SAH cluster boxes must
    overlap (the Book-2 final scene's 1000 r=10 spheres in a 165-cube:
    about 0.93), score high; spread fields (the flagship's random spheres,
    about 0.001) score low."""
    centers = np.asarray(centers, np.float32)
    radii = np.abs(np.asarray(radii, np.float32))
    lo = (centers - radii[:, None]).min(axis=0)
    hi = (centers + radii[:, None]).max(axis=0)
    vol = float(np.prod(np.maximum(hi - lo, 1e-6)))
    return float((4.0 / 3.0 * np.pi * radii ** 3).sum() / vol)


def grid_bin_spheres(centers, radii, max_leaf: int = 32, res: int = 8,
                     cell_r_mult: float = 4.0, dup_cap: float = 8.0):
    """Uniform-grid spatial binning with sphere duplication: each small
    sphere is listed in every cell its AABB overlaps, and each cluster's
    box is the cell CLIPPED to the union of its members' boxes, so cells
    do not overlap.  A cell of more than ``max_leaf`` spheres is cut by
    :func:`cluster_spheres_numpy` (each part's box clipped to the cell).
    Cells are emitted in sorted (ix, iy, iz) order.

    A sphere's full quadric is tested in every cell that lists it; its
    copies give identical roots and the same winner attributes (the prep
    permutes the attribute table by the duplicated order), so a hit point
    inside any listing cell's box is found.  Oversize spheres (diameter
    above ``cell_r_mult`` median radii) are SAH-clustered after the cells,
    unclipped.

    Returns (order [S >= N, with duplicates], cluster_start [C+1],
    cl_min [C, 3], cl_max [C, 3]) like :func:`cluster_spheres_numpy`, or
    None when the binning does not apply (fewer than 64 small spheres, or
    duplication past ``dup_cap`` times)."""
    centers = np.asarray(centers, np.float32)
    radii = np.abs(np.asarray(radii, np.float32))
    n = centers.shape[0]
    pmin_s = centers - radii[:, None]
    pmax_s = centers + radii[:, None]

    r_med = float(np.median(radii))
    small = (2.0 * radii) <= max(cell_r_mult * r_med, 1e-6)
    n_small = int(small.sum())
    if n_small < 64:
        return None
    sm_idx = np.where(small)[0]
    bb_lo = pmin_s[sm_idx].min(axis=0)
    bb_hi = pmax_s[sm_idx].max(axis=0)
    extent = np.maximum(bb_hi - bb_lo, 1e-6)
    cell = max(cell_r_mult * r_med, float(extent.max()) / res)
    ncell = np.maximum(np.ceil(extent / cell).astype(int), 1)

    # overlapped integer cell ranges per small sphere
    lo_i = np.clip(np.floor((pmin_s[sm_idx] - bb_lo) / cell).astype(int),
                   0, ncell - 1)
    hi_i = np.clip(np.floor((pmax_s[sm_idx] - bb_lo) / cell).astype(int),
                   0, ncell - 1)
    n_dup = int(np.prod(hi_i - lo_i + 1, axis=1).sum())
    if n_dup > dup_cap * n_small:
        return None

    members: dict = {}
    for k in range(n_small):
        i = sm_idx[k]
        for ix in range(lo_i[k, 0], hi_i[k, 0] + 1):
            for iy in range(lo_i[k, 1], hi_i[k, 1] + 1):
                for iz in range(lo_i[k, 2], hi_i[k, 2] + 1):
                    members.setdefault((ix, iy, iz), []).append(i)

    order_parts, starts, mins, maxs = [], [0], [], []

    def _emit(idx_list, clip_lo, clip_hi):
        idx = np.asarray(idx_list, np.int32)
        if idx.shape[0] > max_leaf:
            o, cs, mn, mx = cluster_spheres_numpy(
                centers[idx], radii[idx], max_leaf)
            for c in range(cs.shape[0] - 1):
                sub = idx[o[cs[c]:cs[c + 1]]]
                order_parts.append(sub)
                starts.append(starts[-1] + sub.shape[0])
                mins.append(np.maximum(mn[c], clip_lo))
                maxs.append(np.minimum(mx[c], clip_hi))
        else:
            order_parts.append(idx)
            starts.append(starts[-1] + idx.shape[0])
            mins.append(np.maximum(pmin_s[idx].min(axis=0), clip_lo))
            maxs.append(np.minimum(pmax_s[idx].max(axis=0), clip_hi))

    for (ix, iy, iz), idx_list in sorted(members.items()):
        c_lo = bb_lo + cell * np.asarray([ix, iy, iz], np.float32)
        _emit(idx_list, c_lo, c_lo + cell)

    big_idx = np.where(~small)[0]
    if big_idx.shape[0] > 0:
        o, cs, mn, mx = cluster_spheres_numpy(
            centers[big_idx], radii[big_idx], max_leaf)
        for c in range(cs.shape[0] - 1):
            sub = big_idx[o[cs[c]:cs[c + 1]]].astype(np.int32)
            order_parts.append(sub)
            starts.append(starts[-1] + sub.shape[0])
            mins.append(mn[c])
            maxs.append(mx[c])

    order = np.concatenate(order_parts).astype(np.int32)
    return (order, np.asarray(starts, np.int32),
            np.asarray(mins, np.float32), np.asarray(maxs, np.float32))


def cluster_spheres_spatial(centers, radii, max_leaf: int = 32,
                            build_sah=None):
    """The sphere clustering of the table prep: the SAH cut
    (``build_sah(centers, radii, max_leaf)``, default
    :func:`cluster_spheres_numpy`), or with ``RTT_SPHERE_GRID=1`` set the
    grid of :func:`grid_bin_spheres` for a group of at least 64 spheres
    whose small spheres (diameter at most 4 median radii) number at least
    64 and fill more than ``RTT_GRID_FILL`` (default 0.3) of their box;
    ``RTT_GRID_RES`` (default 8) caps the cells an axis.  A grid that
    :func:`grid_bin_spheres` declines gives the SAH cut.

    The grid is off by default, as in the JAX package, whose TPU kernels
    admit a cluster for a whole tile when any lane needs it; there it lost
    to SAH on the final scene.  The port's kernels cull per thread, so
    whether it pays on the GPU is measured (``chip_smoke.py`` phase 19),
    not assumed.  The knobs are part of
    ``ops/megakernel.prepare_megakernel_cached``'s key."""
    sah = build_sah if build_sah is not None else cluster_spheres_numpy
    if (not os.environ.get("RTT_SPHERE_GRID")
            or centers.shape[0] < 64):
        return sah(centers, radii, max_leaf)
    # trigger on the small-sphere sub-population's fill (the big spheres a
    # mixed group carries would dilute a whole-group fill measurement)
    radii_a = np.abs(np.asarray(radii, np.float32))
    r_med = float(np.median(radii_a))
    small = (2.0 * radii_a) <= max(4.0 * r_med, 1e-6)
    thresh = float(os.environ.get("RTT_GRID_FILL", "0.3"))
    if (small.sum() < 64 or sphere_fill_fraction(
            np.asarray(centers)[small], radii_a[small]) <= thresh):
        return sah(centers, radii, max_leaf)
    res = int(os.environ.get("RTT_GRID_RES", "8"))
    g = grid_bin_spheres(centers, radii, max_leaf, res=res)
    return g if g is not None else sah(centers, radii, max_leaf)
