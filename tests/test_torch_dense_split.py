"""S1a's split scan: the dense closest-hit kernel cuts the sphere axis into
``split`` contiguous ranges (``ops/dense_hit.py`` ``dense_ranges``), each
keeping its first strict minimum in index order, and merges them by the
least (t, index).  ``_split_min`` models that form in plain PyTorch over
the per-pair keys of ``dense_hit_plain``'s arithmetic (``dense_keys``),
computed once, so that the split and the whole scan reduce the same keys:
bitwise equal for every split on the spike's inputs (512 spheres), on an
engineered tie (one sphere copied into other ranges) and on rays that hit
nothing.  Skipping the root where disc <= 0 leaves every key, and so (t,
index), bitwise unchanged; the kernel's miss test hh > ac is disc > 0.
``dense_hit(split=k)`` on CPU tensors checks k and returns the twin's
result, and the split form agrees with the JAX spike's ``make_dense``
(interpret mode) within ``test_torch_dense_hit.py``'s tolerances.  The
CUDA kernel is held against ``dense_hit_plain`` at every split in
test_torch_cuda.py."""

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
SPLITS = [1, 2, 4, 16, 64]


def _inputs(ns=NS, seed=0):
    dtab, _, o, d = tspike.spike_inputs(ns, seed)
    rays = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (o[0], o[1], o[2], d[0], d[1], d[2])]
    return dtab, rays


def _first_min(key):
    """(t, index) of the least key over dim 0, the first index on a tie;
    (BIG, -1) where every key is BIG (no hit)."""
    t, i = torch.min(key, dim=0)
    return t, torch.where(t < dh.BIG, i, -1).to(torch.int32)


def _split_min(key, split):
    """The kernel's split form: each of ``dense_ranges`` keeps its first
    strict minimum, then the ranges merge in order by a strict '<' on t,
    which is the least (t, index) since every index of a range is below
    the next range's."""
    bt = bi = None
    for lo, hi in dh.dense_ranges(key.shape[0], split):
        if hi > lo:
            t, i = _first_min(key[lo:hi])
            i = torch.where(i >= 0, i + lo, i)
        else:  # an empty range: no hit
            t = torch.full(key.shape[1:], dh.BIG, dtype=key.dtype)
            i = torch.full(key.shape[1:], -1, dtype=torch.int32)
        if bt is None:
            bt, bi = t, i
            continue
        take = t < bt
        bt, bi = torch.where(take, t, bt), torch.where(take, i, bi)
    return bt, bi


def _equal(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("split", SPLITS)
def test_split_min_equals_the_whole_scan_on_the_spike(split):
    dtab, rays = _inputs()
    key, _ = dh.dense_keys(torch.from_numpy(dtab), *rays)
    whole = _first_min(key)
    _equal(_split_min(key, split), whole)
    t, i = dh.dense_hit_plain(torch.from_numpy(dtab), *rays)
    _equal((t.reshape(-1), i.reshape(-1)), whole)
    hit = whole[1] >= 0
    assert 0.1 < hit.float().mean().item() < 1.0


@pytest.mark.parametrize("split", SPLITS)
def test_split_min_keeps_the_first_index_of_a_tie(split):
    """A winning sphere k copied to row k + 1 (its own range at most
    splits) and to the last row (the last range): the same key at several
    rows and ranges, and the first one wins."""
    dtab, rays = _inputs()
    key, _ = dh.dense_keys(torch.from_numpy(dtab), *rays)
    _, first = _first_min(key)
    wins = np.bincount(first.numpy()[first.numpy() >= 0], minlength=NS)
    k = int(np.argmax(wins[:NS // 2]))
    for row in (k + 1, NS - 1):
        dtab[:, row] = dtab[:, k]
    key, _ = dh.dense_keys(torch.from_numpy(dtab), *rays)
    assert torch.equal(key[k], key[k + 1]) and torch.equal(key[k], key[-1])
    got = _split_min(key, split)
    _equal(got, _first_min(key))
    idx = got[1].numpy()
    assert (idx == k).sum() == wins[k] > 0
    assert not np.isin(idx, [k + 1, NS - 1]).any()


@pytest.mark.parametrize("split", SPLITS)
def test_split_min_misses_keep_big_and_minus_one(split):
    """Rays aimed away from every sphere hit nothing, with the spike's
    table and with a table of 16 rows, whose ranges past the first are
    empty at any split above 1."""
    dtab, rays = _inputs()
    rays = rays[:3] + [torch.sign(r) for r in rays[:3]]  # outward
    for tab in (dtab, dtab[:, :16]):
        key, _ = dh.dense_keys(torch.from_numpy(np.ascontiguousarray(tab)),
                               *rays)
        got = _split_min(key, split)
        _equal(got, _first_min(key))
        miss = got[1] < 0
        assert miss.float().mean().item() > 0.9
        assert torch.all(got[0][miss] == np.float32(dh.BIG))


def test_skipping_the_root_where_disc_is_not_positive_changes_nothing():
    """The kernel takes the root only where disc > 0, which it tests as
    h*h > a*c0 (no subtraction): that test is disc > 0 on every pair, and
    the key of every other pair is BIG whatever its root, so (t, index) is
    bitwise the same.  c0 = |o|^2 - 2m is also what one fused multiply-add
    gives (2m is exact, so one rounding either way)."""
    for precision in dh.PRECISIONS:
        dtab, rays = _inputs()
        tab = torch.from_numpy(dtab)
        key, disc = dh.dense_keys(tab, *rays, precision=precision)
        skip = torch.where(disc > 0.0, key, torch.tensor(dh.BIG))
        assert torch.equal(skip, key)
        _equal(_first_min(skip), _first_min(key))
        # the kernel's terms, in the twin's order
        ct = dh._dense_ct(tab, precision)
        x, y, z, ddx, ddy, ddz = (r.reshape(-1) for r in rays)
        D = torch.stack([ddx, ddy, ddz, torch.zeros_like(ddx)])
        O = torch.stack([x, y, z, -torch.ones_like(x)])
        if precision == "default":
            D, O = dh.round_tf32(D), dh.round_tf32(O)
        dC, m = ct @ D, ct @ O
        h = dC - (ddx * x + ddy * y + ddz * z)
        o2 = x * x + y * y + z * z
        c0 = o2 - 2.0 * m
        assert torch.equal(c0, (o2.double() - 2.0 * m.double()).float())
        hh, ac = h * h, (ddx * ddx + ddy * ddy + ddz * ddz) * c0
        assert torch.equal(hh - ac, disc)
        assert torch.equal(hh > ac, disc > 0.0)
        assert 0.0 < (disc > 0.0).float().mean().item() < 0.05


def test_dense_hit_split_is_checked_and_ignored_on_the_cpu():
    dtab, rays = _inputs()
    tab = torch.from_numpy(dtab)
    for precision in dh.PRECISIONS:
        ref = dh.dense_hit_plain(tab, *rays, precision=precision)
        for split in dh.DENSE_SPLITS:
            _equal(dh.dense_hit(tab, *rays, iters=2, precision=precision,
                                split=split), ref)
    for bad in (0, 3, 128):
        with pytest.raises(ValueError, match="split"):
            dh.dense_hit(tab, *rays, split=bad)


def test_ranges_and_the_default_split():
    """Ranges are contiguous, cover the table once and start at multiples
    of 16 (ragged NS too); the default split is the least power of two
    whose grid covers one resident wave, capped at NS / DENSE_N."""
    for ns in (16, 512, 1024, 1040):
        for split in dh.DENSE_SPLITS:
            r = dh.dense_ranges(ns, split)
            assert len(r) == split and r[0][0] == 0 and r[-1][1] == ns
            assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
            assert all(lo % dh.DENSE_ALIGN == 0 and lo <= hi
                       for lo, hi in r)
    wave = 132 * 4 * 128  # 4 blocks of 128 rays on each of 132 SMs
    assert dh.default_split(4096, 1024, wave) == 32
    assert dh.default_split(1 << 20, 1024, wave) == 1
    assert dh.default_split(65536, 1024, wave) == 2
    assert dh.default_split(4096, 64, wave) == 64 // dh.DENSE_N
    assert dh.default_split(4096, 16, wave) == 1


def test_split_form_agrees_with_the_jax_spike_kernel():
    """The split form (16 ranges) against the spike's make_dense in
    interpret mode: winners and hit mask on >= 99.9% of rays, |dt| <= 1e-2
    where both hit (test_torch_dense_hit.py's tolerances)."""
    path = os.path.join(REPO, "scripts", "spike_dense_mxu.py")
    spec = importlib.util.spec_from_file_location("spike_dense_mxu", path)
    sp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sp)
    dtab, _, o, d = tspike.spike_inputs(NS)
    outs = (jax.ShapeDtypeStruct((sp.T, sp.L), jnp.float32),
            jax.ShapeDtypeStruct((sp.T, sp.L), jnp.int32))
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    dense = pl.pallas_call(sp.make_dense(NS, 1), out_shape=outs,
                           in_specs=[vmem] * 7, out_specs=(vmem, vmem),
                           interpret=True)
    bt, bi = (np.asarray(x).reshape(-1) for x in dense(
        jnp.asarray(dtab), *(jnp.asarray(x) for x in (*o, *d))))
    _, rays = _inputs()
    key, _ = dh.dense_keys(torch.from_numpy(dtab), *rays)
    t, i = (x.numpy() for x in _split_min(key, 16))
    hit, hit_ref = i >= 0, bi >= 0
    assert (hit == hit_ref).mean() >= 0.999 and (i == bi).mean() >= 0.999
    both = hit & hit_ref
    assert both.mean() > 0.1
    assert np.abs(t - bt)[both].max() <= 1e-2
