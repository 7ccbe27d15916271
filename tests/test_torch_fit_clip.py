"""The config-4 fit's gradient chain (``scripts/inverse_rendering.py``
``masked_clip``) against the example's optax chain
(``examples/inverse_rendering.py``): ``optax.zero_nans()``, then
``optax.clip_by_global_norm(1.0)``, then the row mask, on the same NumPy
gradients.  Cases: a global norm of about 13 (clipped to 1), one of about
0.04 (the fit's start; left as it is), and one holding NaNs, whose norm
is taken after the zeroing.  Tolerance rtol 1e-6; the NaN-step count is
held too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from rustraytrace_tpu_torch.scripts.inverse_rendering import (  # noqa: E402
    masked_clip)


def _grads(case: str) -> dict:
    r = np.random.default_rng(11)
    g = {"sph_center": r.normal(size=(3, 4)).astype(np.float32),
         "tex_color1": r.normal(size=(3, 3)).astype(np.float32)}
    norm = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                       for v in g.values()))
    want = 0.04 if case == "small" else 13.0
    g = {k: (v * (want / norm)).astype(np.float32) for k, v in g.items()}
    if case == "nan":
        g["sph_center"][1, 2] = np.nan
        g["tex_color1"][0, 0] = np.nan
    return g


def _masks() -> dict:
    m = {"sph_center": np.zeros((3, 4), np.float32),
         "tex_color1": np.zeros((3, 3), np.float32)}
    m["sph_center"][1, 0:3] = 1.0
    m["tex_color1"][1] = 1.0
    m["sph_center"][0, 0] = 1.0  # a row of the ones NaN did not touch
    return m


def _optax_chain(grads: dict, masks: dict) -> dict:
    jm = {k: jnp.asarray(v) for k, v in masks.items()}

    def row_mask():
        def update(updates, state, params=None):
            return {k: u * jm[k] for k, u in updates.items()}, state
        return optax.GradientTransformation(
            lambda p: optax.EmptyState(), update)

    chain = optax.chain(optax.zero_nans(), optax.clip_by_global_norm(1.0),
                        row_mask())
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    out, _ = chain.update(jg, chain.init(jg))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("case", ["large", "small", "nan"])
def test_masked_clip_equals_the_optax_chain(case):
    grads, masks = _grads(case), _masks()
    want = _optax_chain(grads, masks)
    nan_steps = []
    clip = masked_clip({k: torch.from_numpy(v) for k, v in masks.items()},
                       nan_steps=nan_steps)
    got = clip({k: torch.from_numpy(v.copy()) for k, v in grads.items()})
    for k in grads:
        assert np.all(np.isfinite(got[k].numpy())), k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                   atol=0, err_msg=k)
    assert nan_steps == [int(case == "nan")]
    # the clip acts on the zeroed gradients' global norm, before the mask
    zeroed = {k: np.nan_to_num(v, nan=0.0) for k, v in grads.items()}
    norm = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                       for v in zeroed.values()))
    scale = min(1.0, 1.0 / norm)
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(),
                                   zeroed[k] * scale * masks[k], rtol=1e-6,
                                   atol=1e-12, err_msg=k)
