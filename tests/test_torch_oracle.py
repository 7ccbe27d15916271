"""The port's renders against the independent NumPy oracle
(``tests/oracle.py``) on the CPU: its Book-1 three-sphere scene through the
reference route and through the plain twin of the persist kernel K2,
compared on sample means within Monte-Carlo tolerance, as
``tests/test_integrator.py`` holds the JAX package (the oracle draws its
own random numbers, so only means compare): channel means within 0.015;
95% of per-pixel errors below 0.1 and their mean below 0.03."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

from rustraytrace_tpu_torch import models, render  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import megakernel as mk  # noqa: E402
from rustraytrace_tpu_torch.ops import wavefront as wf  # noqa: E402
from tests.oracle import OracleSphere, render_oracle  # noqa: E402

W, H = 24, 14
SPP = 400
DEPTH = 16


@pytest.fixture(scope="module")
def oracle_mean():
    spheres = [
        OracleSphere((0, -100.5, -1), 100.0, "lam", (0.8, 0.8, 0.0)),
        OracleSphere((0, 0, -1.2), 0.5, "lam", (0.1, 0.2, 0.5)),
        OracleSphere((-1, 0, -1), 0.5, "diel", ior=1.5),
        OracleSphere((1, 0, -1), 0.5, "metal", (0.8, 0.6, 0.2), fuzz=0.0),
    ]
    return render_oracle(spheres, W, H, SPP, DEPTH, vfov=90.0,
                         lookfrom=(0, 0, 0), lookat=(0, 0, -1),
                         focus_dist=1.0)


def _scene():
    return models.book1_three_spheres(
        {"image_width": W, "aspect_ratio": W / H, "samples_per_pixel": SPP,
         "max_depth": DEPTH, "spp_per_pass": 100})


def _reference_mean():
    scene, cfg, integ = _scene()
    _, state = render.render_image(scene, cfg, integrator=integ,
                                   backend="reference", chunk=512,
                                   device="cpu")
    return state["accum"] / state["spp_done"]


def _persist_twin_mean():
    """The persist launch loop with the plain twin of K2 as its launch,
    unsorted, at the flagship route's launch bound."""
    scene, cfg, _ = _scene()
    assert (cfg.image_width, cfg.image_height) == (W, H)
    tables = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=W,
                                   height=H, device="cpu")
    sums = wf._wavefront_pass_persist(
        tables, cfg.seed, 0, spp=SPP, max_depth=DEPTH,
        persist_iters=wf.persist_plain_iters(SPP), sort_rays=False,
        step=wf.persist_step_plain)
    idx = mk.unswizzle_index_on(W, H, sums.device)
    return (sums[idx].reshape(H, W, 3) / SPP).numpy()


@pytest.mark.parametrize("route", ["reference", "persist_twin"])
def test_port_matches_oracle(oracle_mean, route):
    mean = _reference_mean() if route == "reference" else _persist_twin_mean()
    assert mean.shape == oracle_mean.shape == (H, W, 3)
    # aggregate means agree tightly (their Monte-Carlo error is tiny)
    np.testing.assert_allclose(mean.mean(axis=(0, 1)),
                               oracle_mean.mean(axis=(0, 1)), atol=0.015)
    err = np.abs(mean - oracle_mean)
    # per-pixel MC std at 400 spp is ~0.025; 6 sigma plus bias slack
    assert np.quantile(err, 0.95) < 0.1
    assert err.mean() < 0.03
