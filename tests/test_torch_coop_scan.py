"""The persist kernel K2's warp-level design, on the CPU: the invariant
its cooperative leaf scan relies on, and the wrapper's argument checks.
The kernel itself is held against its plain twin on the card
(test_torch_cuda.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

from rustraytrace_tpu_torch import models  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import megakernel as mk  # noqa: E402
from rustraytrace_tpu_torch.ops import wavefront as wf  # noqa: E402

BIG = float(np.float32(1.0e30))  # the kernels' "no hit yet", in float32
WARP = 32


def _table_order_scan(t, bt=BIG, bi=-1):
    """csrc/path.cuh scan_spheres / scan_boxes: strict "<" in table order,
    from the running best (bt, bi)."""
    for k, tk in enumerate(t):
        if tk < bt:
            bt, bi = tk, k
    return bt, bi


def _lex_min(pairs):
    best = (BIG, np.iinfo(np.int32).max)
    for p in pairs:
        if p[0] < best[0] or (p[0] == best[0] and p[1] < best[1]):
            best = p
    return best


def _warp_scan(t, lo, hi, bt, bi):
    """csrc/path.cuh scan_spheres_warp for one needing lane: lane k keeps
    the first strict minimum of rows lo + k, lo + k + 32, ...; the xor
    butterfly takes the lexicographic minimum of (t, row); the lane takes
    it if it is below its best t."""
    lanes = []
    for k in range(WARP):
        best, row = BIG, np.iinfo(np.int32).max
        for s in range(lo + k, hi, WARP):
            if t[s] < best:
                best, row = t[s], s
        lanes.append((best, row))
    for off in (16, 8, 4, 2, 1):
        lanes = [_lex_min([lanes[k], lanes[k ^ off]]) for k in range(WARP)]
    assert len(set(lanes)) == 1  # every lane holds the same minimum
    best, row = lanes[0]
    return (best, row) if best < bt else (bt, bi)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)) + np.asarray([13.0, 2.0, 3.0])
    d = rng.uniform(-4, 4, (n, 3)) - o
    d[: n // 8] = -d[: n // 8]  # an eighth points away: misses
    return [torch.from_numpy(np.ascontiguousarray(x.astype(np.float32)))
            for x in (*o.T, *d.T)]


def _row_roots(kind, table, ray):
    """Per row, per ray: the twin's own row function on that row alone
    (``_sphere_rows_min`` / ``_box_rows_min``), BIG where it misses."""
    ox, oy, oz, dx, dy, dz = ray
    if kind == "spheres":
        a = dx * dx + dy * dy + dz * dz
        cols = [wf._sphere_rows_min(table[k:k + 1], ox, oy, oz, dx, dy, dz,
                                    a, 1.0 / a)[0]
                for k in range(table.shape[0])]
    else:
        iv = [wf._safe_inv(x) for x in (dx, dy, dz)]
        cols = [wf._box_rows_min(table[k:k + 1], ox, oy, oz, *iv)[0]
                for k in range(table.shape[0])]
    return torch.stack(cols, dim=1).tolist()


def _tables(kind):
    """Rows of the flagship's spheres or the final scene's boxes, with
    rows duplicated at later indices (exact ties), one across the
    boundary of two clusters [0, 40) and [40, n)."""
    if kind == "spheres":
        scene, cfg, _ = models.book1_random_spheres()
        tab = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"),
                                    width=64, height=36, device="cpu").geom
    else:
        scene, cfg, _ = models.book2_final_scene()
        tab = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"),
                                    width=16, height=16, device="cpu").btab
    rows = tab[:70].clone()
    rows[45] = rows[3]    # a tie across the cluster boundary
    rows[60] = rows[50]   # a tie inside the second cluster
    rows[69] = rows[10]
    return rows


@pytest.mark.parametrize("kind", ["spheres", "boxes"])
def test_cooperative_scan_equals_the_table_order_scan(kind):
    rows = _tables(kind)
    ray = _rays(256, 3)
    roots = _row_roots(kind, rows, ray)
    rng = np.random.default_rng(5)
    ties = hits = misses = 0
    for t in roots:
        want = _table_order_scan(t)
        # any visiting order: the lexicographic minimum is the first
        # strict minimum in table order
        perm = rng.permutation(len(t))
        lex = _lex_min([(t[k], int(k)) for k in perm])
        if want[1] < 0:
            misses += 1
            assert lex[0] == BIG
        else:
            hits += 1
            assert lex == want
        # the warp's scan over two clusters, the best t carried across
        bt, bi = _warp_scan(t, 0, 40, BIG, -1)
        bt, bi = _warp_scan(t, 40, len(t), bt, bi)
        assert (bt, bi) == want
        # the same with a running best from earlier rows: a tie with it
        # keeps the earlier row, as the strict "<" does
        got = _warp_scan(t, 40, len(t), *_table_order_scan(t[:40]))
        assert got == want
        ties += sum(t[k] == t[j] < BIG for k, j in ((3, 45), (50, 60),
                                                     (10, 69)))
    assert hits > 20 and misses > 20 and ties > 0
    # the twin's vectorised scan (torch.min: the first index of the
    # minimum) agrees with the table-order scan row for row
    if kind == "spheres":
        ox, oy, oz, dx, dy, dz = ray
        a = dx * dx + dy * dy + dz * dz
        bt, bi = wf._sphere_rows_min(rows, ox, oy, oz, dx, dy, dz, a, 1.0 / a)
        for t, b, i in zip(roots, bt.tolist(), bi.tolist()):
            want = _table_order_scan(t)
            assert b == want[0] and (want[1] < 0 or i == want[1])


def test_persist_step_rejects_bad_arguments():
    scene, cfg, _ = models.book1_random_spheres(dict(image_width=64))
    tables = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=64,
                                   height=36, tile_rows=1, device="cpu")
    R = tables.n_lanes
    state = torch.zeros((wf.N_STATE, R))
    slot = torch.arange(R, dtype=torch.int32)
    kw = dict(persist_iters=1, spp=1, max_depth=2)
    wf.persist_step(state, slot, tables, 1, tile_bounds=torch.ones(
        R // 128, dtype=torch.int32), tile_lanes=128, **kw)
    bad = [dict(tile_bounds=torch.ones(R // 16, dtype=torch.int32),
                tile_lanes=16),
           dict(tile_bounds=torch.ones(R // 8, dtype=torch.int32),
                tile_lanes=8),
           dict(tile_bounds=torch.ones(1, dtype=torch.int32),
                tile_lanes=R + 32),
           dict(tile_bounds=torch.ones(R // 128, dtype=torch.int64),
                tile_lanes=128),
           dict(tile_bounds=torch.ones(3, dtype=torch.int32),
                tile_lanes=128)]
    for b in bad:
        with pytest.raises(ValueError):
            wf.persist_step(state, slot, tables, 1, **b, **kw)
    for st, sl in ((state.double(), slot), (state[:19], slot),
                   (state, slot.long()), (state, slot[:-1])):
        with pytest.raises(ValueError):
            wf.persist_step(st, sl, tables, 1, **kw)
