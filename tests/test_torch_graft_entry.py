"""The port's entry points of ``rustraytrace_tpu_torch/graft_entry.py``
on the CPU against their counterparts in ``__graft_entry__.py``: the
forward step equals ``render.render_pass``; the dry run's training step
on two gloo ranks equals the one-rank step (loss and updated parameters),
and its image and loss agree with JAX's ``make_train_step`` on a 2-device
mesh block-wise and within 5 standard errors over seeds (independent
random streams); several ranks on the card without a process group
raise."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rustraytrace_tpu import models as jmodels  # noqa: E402
from rustraytrace_tpu.config import derive_camera as jax_derive_camera  # noqa: E402
from rustraytrace_tpu.diff import apply_params as jax_apply_params  # noqa: E402
from rustraytrace_tpu.diff import make_train_step as jax_make_train_step  # noqa: E402
from rustraytrace_tpu.diff import render_mean as jax_render_mean  # noqa: E402
from rustraytrace_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from rustraytrace_tpu_torch import graft_entry, models, render  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.diff import (apply_params, params_from_numpy,  # noqa: E402
                                         render_mean)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_reference import _block_agreement  # noqa: E402

N_SEEDS = 8


def test_entry_is_the_flagship_render_pass():
    """``fn(*args)`` is one 192-wide, 1-spp, depth-8 pass of the flagship,
    bitwise the same ``render_pass`` call."""
    fn, args = graft_entry.entry(device="cpu")
    scene, cam, seed = args
    got = fn(*args)
    assert got.shape == (108, 192, 3) and bool(torch.isfinite(got).all())
    want = render.render_pass(scene, cam, seed, width=192, height=108,
                              spp=1, max_depth=8, integrator="path",
                              chunk=16384, device="cpu")
    assert torch.equal(got, want)
    assert scene.sph_center.shape[0] == jmodels.book1_random_spheres(
        dict(image_width=192))[0].sph_center.shape[0]


def test_dryrun_two_gloo_ranks_equal_one_and_jax():
    """Two gloo ranks (spp_shards 2) give the one-rank step's loss and
    updated parameters to 1e-6; the substitute pass's sum over the mesh is
    the sum of the ranks' passes.  Against JAX, from the same parameters:
    the step's image (``render_mean``, whose loss is the step's) over
    ``N_SEEDS`` seeds agrees with JAX's on its 2-device mesh block-wise
    (``_block_agreement``), and the mean loss within 5 standard errors of
    the seeds' spread (independent random streams)."""
    one = graft_entry.dryrun_multichip(1, device="cpu")
    two = graft_entry.dryrun_multichip(2, device="cpu")
    assert two["mesh"] == (1, 2) and one["mesh"] == (1, 1)
    assert np.isfinite(two["loss"])
    assert abs(two["loss"] - one["loss"]) <= 1e-6 * abs(one["loss"])
    assert set(two["params"]) == set(graft_entry.PARAMS)
    for k in graft_entry.PARAMS:
        np.testing.assert_allclose(two["params"][k], one["params"][k],
                                   rtol=1e-6, atol=1e-6)
    base = [np.random.default_rng([7, off]).random((8, 8, 3), np.float32)
            for off in (0, 4)]
    np.testing.assert_allclose(two["wiring"], base[0] + base[1] + 32.0,
                               rtol=1e-6)

    over = dict(image_width=32, samples_per_pixel=2, max_depth=3)
    jscene, jcfg, _ = jmodels.book1_three_spheres(over)
    jcfg = jcfg.replace(aspect_ratio=2.0)
    target = jnp.zeros((jcfg.image_height, jcfg.image_width, 3), jnp.float32)
    jmesh = jax_make_mesh(jax.devices()[:2], spp_shards=2)
    step, jparams, opt_state = jax_make_train_step(
        jscene, list(graft_entry.PARAMS), target, jcfg, mesh=jmesh, spp=2,
        chunk=256)
    _, _, jloss = step(jparams, opt_state, jax.random.key(0))
    scene, cfg, _ = models.book1_three_spheres(over)
    cfg = cfg.replace(aspect_ratio=2.0)
    params = params_from_numpy({k: np.asarray(v) for k, v in
                                jparams.items()})
    kw = dict(width=32, height=16, spp=2, max_depth=3, chunk=256)
    jscene_p = jax_apply_params(jscene, jparams)
    jimgs = np.stack([np.asarray(jax_render_mean(
        jscene_p, jax_derive_camera(jcfg), jax.random.key(s), mesh=jmesh,
        **kw)) for s in range(N_SEEDS)])
    scene_p = apply_params(scene, params)
    imgs = np.stack([render_mean(
        scene_p, derive_camera(cfg, "cpu"), s, device="cpu",
        **kw).detach().numpy() for s in range(N_SEEDS)])
    # seed 0's images are the two steps' forwards
    assert abs(float(np.mean(jimgs[0] ** 2)) - float(jloss)) <= 1e-6
    assert abs(float(np.mean(imgs[0] ** 2)) - one["loss"]) <= 1e-6
    assert np.all(np.isfinite(imgs))
    _block_agreement(imgs.mean(axis=0), jimgs.mean(axis=0))
    lp = (imgs ** 2).mean(axis=(1, 2, 3))
    lj = (jimgs ** 2).mean(axis=(1, 2, 3))
    se = np.sqrt((lp.var(ddof=1) + lj.var(ddof=1)) / N_SEEDS)
    assert abs(lp.mean() - lj.mean()) < 5 * se, (lp.mean(), lj.mean(), se)


def test_dryrun_cuda_ranks_without_a_group_raise():
    """Several ranks on the card with no process group up: a ValueError
    that names torchrun, before any rank starts."""
    with pytest.raises(ValueError, match="torchrun"):
        graft_entry.dryrun_multichip(2, device="cuda")
