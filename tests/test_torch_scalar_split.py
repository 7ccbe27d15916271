"""S1b's split scan: the scalar closest-hit kernel runs ``split`` lanes a
ray, each over a strided share of the sphere table, and takes the least
(t, index) over them.  ``_split_scan`` computes that form in plain
PyTorch; here it equals ``scalar_hit_plain`` bitwise for every split on
the spike's inputs (512 spheres), on engineered ties (one sphere copied
into rows of different shares) and on rays that hit nothing, and agrees
with the JAX spike's scalar kernel (interpret mode) as
``scalar_hit_plain`` does.  The CUDA kernel is held against
``scalar_hit_plain`` at every split in test_torch_cuda.py."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from rustraytrace_tpu_torch.ops import dense_hit as dh  # noqa: E402
from rustraytrace_tpu_torch.scripts import spike_dense_mxu as tspike  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = 512


def _inputs(ns=NS, seed=0):
    _, stab, o, d = tspike.spike_inputs(ns, seed)
    rays = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (o[0], o[1], o[2], d[0], d[1], d[2])]
    return stab, rays


def _split_scan(tab, ox, oy, oz, dx, dy, dz, split):
    """The scalar kernel's split form, one scan: lane p of ``split`` scans
    spheres p, p + split, ... with ``scalar_hit_plain``'s arithmetic and
    keeps its first strict minimum; then the least (t, index) over the
    lanes, the lower index on equal t (no hit is (BIG, -1), and any hit's
    t is below BIG)."""
    ns = tab.shape[1]
    bt = bi = None
    for p in range(split):
        rows = torch.arange(min(p, ns), ns, split, dtype=torch.int32)
        t, i = dh.scalar_hit_plain(tab[:, rows], ox, oy, oz, dx, dy, dz)
        if rows.numel():  # the table's row of each share's winner
            i = torch.where(i >= 0, rows[i.long().clamp(min=0)], i)
        if bt is None:
            bt, bi = t, i
            continue
        take = (t < bt) | ((t == bt) & (i < bi))
        bt, bi = torch.where(take, t, bt), torch.where(take, i, bi)
    return bt, bi


def _equal(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("split", [1, 2, 4, 32])
def test_split_scan_equals_the_twin_on_the_spike(split):
    stab, rays = _inputs()
    ref = dh.scalar_hit_plain(torch.from_numpy(stab), *rays)
    got = _split_scan(torch.from_numpy(stab), *rays, split)
    _equal(got, ref)
    hit = ref[1] >= 0
    assert 0.1 < hit.float().mean().item() < 1.0


@pytest.mark.parametrize("split", [1, 2, 4, 32])
def test_split_scan_keeps_the_first_index_of_a_tie(split):
    """A winning sphere copied to rows that other lanes scan (row k + 1
    and the last row): the same root at several rows, the first wins."""
    stab, rays = _inputs()
    _, first = dh.scalar_hit_plain(torch.from_numpy(stab), *rays)
    wins = np.bincount(first.numpy()[first.numpy() >= 0].ravel(),
                       minlength=NS)
    k = int(np.argmax(wins[:NS - 2]))
    for row in (k + 1, NS - 1):
        stab[:, row] = stab[:, k]
    tab = torch.from_numpy(stab)
    ref = dh.scalar_hit_plain(tab, *rays)
    got = _split_scan(tab, *rays, split)
    _equal(got, ref)
    idx = got[1].numpy()
    assert (idx == k).sum() == wins[k] > 0
    assert not np.isin(idx, [k + 1, NS - 1]).any()


@pytest.mark.parametrize("split", [1, 4, 32])
def test_split_scan_misses_keep_big_and_minus_one(split):
    """Rays aimed away from every sphere (and a table with fewer rows
    than lanes a ray) hit nothing: (BIG, -1), as the twin."""
    stab, rays = _inputs()
    o = [r for r in rays[:3]]
    away = [torch.sign(r) for r in o]  # outward from the field's centre
    rays = o + away
    for tab in (torch.from_numpy(stab), torch.from_numpy(stab[:, :7])):
        ref = dh.scalar_hit_plain(tab, *rays)
        got = _split_scan(tab, *rays, split)
        _equal(got, ref)
    miss = got[1] < 0
    assert miss.any()
    assert torch.all(got[0][miss] == np.float32(dh.BIG))


def test_split_scan_agrees_with_the_jax_spike_kernel():
    """The split form against the spike's make_scalar in interpret mode:
    winners and hit mask on >= 99.9% of rays, |dt| <= 1e-2 where both hit
    (test_torch_dense_hit.py's tolerances)."""
    path = os.path.join(REPO, "scripts", "spike_dense_mxu.py")
    spec = importlib.util.spec_from_file_location("spike_dense_mxu", path)
    sp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sp)
    _, stab, o, d = tspike.spike_inputs(NS)
    outs = (jax.ShapeDtypeStruct((sp.T, sp.L), jnp.float32),
            jax.ShapeDtypeStruct((sp.T, sp.L), jnp.int32))
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    scal = pl.pallas_call(sp.make_scalar(NS, 1), out_shape=outs,
                          in_specs=[smem] + [vmem] * 6,
                          out_specs=(vmem, vmem), interpret=True)
    bt, bi = (np.asarray(x) for x in scal(
        jnp.asarray(stab), *(jnp.asarray(x) for x in (*o, *d))))
    _, rays = _inputs()
    t, i = (x.numpy() for x in _split_scan(
        torch.from_numpy(stab), *rays, 32))
    hit, hit_ref = i >= 0, bi >= 0
    assert (hit == hit_ref).mean() >= 0.999 and (i == bi).mean() >= 0.999
    both = hit & hit_ref
    assert np.abs(t - bt)[both].max() <= 1e-2


def test_split_is_checked_and_ignored_on_the_cpu():
    stab, rays = _inputs()
    tab = torch.from_numpy(stab)
    ref = dh.scalar_hit_plain(tab, *rays)
    _equal(dh.scalar_hit(tab, *rays, iters=2, split=32), ref)
    for bad in (0, 3, 64):
        with pytest.raises(ValueError, match="split"):
            dh.scalar_hit(tab, *rays, split=bad)
