"""S1, the dense closest-sphere spike: the port's plain twins
(``ops/dense_hit.py``) against the spike's two Pallas kernels
(``scripts/spike_dense_mxu.py``, loaded by path and run through
``pl.pallas_call(..., interpret=True)`` with the spike's own BlockSpecs),
on the spike's tables and rays, at 512 and 1,024 spheres, one iteration.

Tolerances: winner index and hit mask equal on >= 99.9% of rays; |dt| <=
1e-2 where both hit (measured here: <= 2.3e-3; the rays start up to 100
units out, so h*h - a*c and |o|^2 - 2m cancel); the first index on a tie.
"""

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


def _spike():
    path = os.path.join(REPO, "scripts", "spike_dense_mxu.py")
    spec = importlib.util.spec_from_file_location("spike_dense_mxu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_kernels(ns, dtab, stab, o, d):
    """Both spike kernels in interpret mode, as its main() builds them."""
    sp = _spike()
    outs = (jax.ShapeDtypeStruct((sp.T, sp.L), jnp.float32),
            jax.ShapeDtypeStruct((sp.T, sp.L), jnp.int32))
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    args = [jnp.asarray(x) for x in (o[0], o[1], o[2], d[0], d[1], d[2])]
    dense = pl.pallas_call(sp.make_dense(ns, 1), out_shape=outs,
                           in_specs=[vmem] * 7, out_specs=(vmem, vmem),
                           interpret=True)
    scal = pl.pallas_call(sp.make_scalar(ns, 1), out_shape=outs,
                          in_specs=[smem] + [vmem] * 6,
                          out_specs=(vmem, vmem), interpret=True)
    return ([np.asarray(x) for x in dense(jnp.asarray(dtab), *args)],
            [np.asarray(x) for x in scal(jnp.asarray(stab), *args)])


def _rays_t(o, d):
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (o[0], o[1], o[2], d[0], d[1], d[2])]


def _agree(t, i, t_ref, i_ref):
    hit, hit_ref = i >= 0, i_ref >= 0
    assert (hit == hit_ref).mean() >= 0.999
    assert (i == i_ref).mean() >= 0.999
    both = hit & hit_ref
    assert both.mean() > 0.1
    assert np.abs(t - t_ref)[both].max() <= 1e-2


@pytest.mark.parametrize("ns", [512, 1024])
def test_twins_match_the_spike_kernels(ns):
    dtab, stab, o, d = tspike.spike_inputs(ns)
    (bt_d, bi_d), (bt_s, bi_s) = _jax_kernels(ns, dtab, stab, o, d)
    rays = _rays_t(o, d)
    td, id_ = dh.dense_hit(torch.from_numpy(dtab), *rays)
    ts, is_ = dh.scalar_hit(torch.from_numpy(stab), *rays)
    assert td.shape == (32, 128) and id_.dtype == torch.int32
    _agree(td.numpy(), id_.numpy(), bt_d, bi_d)
    _agree(ts.numpy(), is_.numpy(), bt_s, bi_s)
    # misses keep the spike's (BIG, -1)
    miss = is_.numpy() < 0
    assert miss.any() and np.all(ts.numpy()[miss] == np.float32(dh.BIG))


def test_first_index_wins_a_tie():
    """Two copies of one sphere: both twins return the lower index, as the
    spike's block argmin (min of where(key == best, index, 1 << 30)) and
    strict '<' across blocks do."""
    dtab, stab, o, d = tspike.spike_inputs(1024)
    rays = _rays_t(o, d)
    _, first = dh.scalar_hit(torch.from_numpy(stab), *rays)
    wins = np.bincount(first.numpy()[first.numpy() >= 0], minlength=1024)
    k = int(np.argmax(wins[:900]))  # a sphere that wins many rays
    for tab in (dtab, stab):
        tab[:, 1000] = tab[:, k]
    (_, bi_d), (_, bi_s) = _jax_kernels(1024, dtab, stab, o, d)
    for fn, tab, ref in ((dh.dense_hit, dtab, bi_d),
                         (dh.scalar_hit, stab, bi_s)):
        _, idx = fn(torch.from_numpy(tab), *rays)
        idx = idx.numpy()
        assert (idx == k).sum() == wins[k] and (idx == 1000).sum() == 0
        np.testing.assert_array_equal(idx == k, ref == k)


def test_default_precision_rounds_operands_to_tf32():
    """'default' is one TF32 pass: operands rounded to 10 mantissa bits,
    nearest with ties away (cvt.rna); its winners still agree with
    'highest' on >= 99% of rays."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 3.0e-3], dtype=torch.float32)
    r = dh.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2 ** -10
    assert r[2] == 1.0 + 2 ** -9 and r[3] == -(1.0 + 2 ** -10)
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
    dtab, _, o, d = tspike.spike_inputs(512)
    rays = _rays_t(o, d)
    _, hi = dh.dense_hit(torch.from_numpy(dtab), *rays)
    _, lo = dh.dense_hit(torch.from_numpy(dtab), *rays, precision="default")
    assert (hi == lo).float().mean().item() >= 0.99


def test_spike_script_runs_on_the_cpu(capsys):
    assert tspike.main(["512", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("hit-mask agreement 1.000000, winner-idx "
                             "agreement 1.000000")
    assert "Gpairs/s" in out[1] and "Gpairs/s" in out[2]
    assert out[3].startswith("dense/scalar speedup")


def test_wrappers_reject_bad_shapes():
    dtab, stab, o, d = tspike.spike_inputs(512)
    rays = _rays_t(o, d)
    with pytest.raises(ValueError, match="multiple of 128"):
        dh.scalar_hit(torch.from_numpy(stab), *[r[:1, :100] for r in rays])
    with pytest.raises(ValueError, match=r"\[8, NS\]"):
        dh.dense_hit(torch.from_numpy(stab), *rays)
    with pytest.raises(ValueError, match="multiple of 16"):
        dh.dense_hit(torch.from_numpy(dtab[:, :500]), *rays)
    with pytest.raises(ValueError, match="precision"):
        dh.dense_hit(torch.from_numpy(dtab), *rays, precision="bf16")
