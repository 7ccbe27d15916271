"""The port's differentiable and inverse rendering (``diff``, BASELINE
config 4) on the CPU: the twins of ``tests/test_diff.py``.

Finite differences use the same seed on both sides (the same draws), so
the estimator is a fixed smooth function of the parameters almost
everywhere and FD measures the derivative autograd computes.  The
port's draws are its own Philox, so where no JAX twin of a number applies
(renders, fits) the check is FD or recovery, with the JAX tests' steps and
bands; ``value_and_grad_loss`` is held to plain autograd of ``image_loss``
(loss within rtol 1e-6, gradients within rtol 2e-4 / atol 1e-7, the JAX
test's tolerance).
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rustraytrace_tpu_torch import RenderConfig, SceneBuilder, diff  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.diff import (apply_params, extract_params,  # noqa: E402
                                         fit, image_loss, make_train_step,
                                         render_mean, value_and_grad_loss)


def _lambertian_scene(albedo=(0.7, 0.3, 0.2), center=(0.0, 0.0, -1.2)):
    b = SceneBuilder()
    ground = b.lambertian((0.5, 0.5, 0.5))
    ball = b.lambertian(albedo)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.add_sphere(center, 0.5, ball)
    return b.build()


def _dielectric_scene(ior=1.5):
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    b.add_sphere((0.0, 0.0, -1.2), 0.5, b.dielectric(ior))
    return b.build()


CFG = RenderConfig(aspect_ratio=2.0, image_width=24, samples_per_pixel=4,
                   max_depth=3, vfov=90.0, lookfrom=(0, 0, 0),
                   lookat=(0, 0, -1), seed=11)
CAM = derive_camera(CFG, "cpu")
KW = dict(width=24, height=12, spp=4, max_depth=3, chunk=256, device="cpu")


def _grad(scene, name, target, seed, **kw):
    p = getattr(scene, name).clone().requires_grad_(True)
    loss = image_loss(dataclasses.replace(scene, **{name: p}), target, CAM,
                      seed, **{**KW, **kw})
    g, = torch.autograd.grad(loss, p)
    return g


def _loss(scene, name, value, target, seed, **kw):
    with torch.no_grad():
        return float(image_loss(dataclasses.replace(scene, **{name: value}),
                                target, CAM, seed, **{**KW, **kw}))


def test_grad_nonzero_and_finite():
    g = _grad(_lambertian_scene(), "sph_center", torch.zeros(12, 24, 3), 0)
    assert torch.all(torch.isfinite(g))
    assert g.abs().max() > 0


def test_fd_matches_autodiff_albedo():
    scene = _lambertian_scene()
    target = torch.full((12, 24, 3), 0.25)
    g = _grad(scene, "tex_color1", target, 5)
    eps = 1e-3
    tc = scene.tex_color1
    for ti, ch in [(1, 0), (1, 2), (0, 1)]:
        up, dn = tc.clone(), tc.clone()
        up[ti, ch] += eps
        dn[ti, ch] -= eps
        fd = (_loss(scene, "tex_color1", up, target, 5)
              - _loss(scene, "tex_color1", dn, target, 5)) / (2 * eps)
        assert fd == pytest.approx(float(g[ti, ch]), rel=0.05, abs=1e-5), (
            ti, ch)


def test_fd_matches_autodiff_mis_albedo():
    """The MIS estimator's gradient, which the JAX package never held to
    finite differences: the red wall's albedo of a 16-px Book-3 Cornell
    box (NEE to the light quad and the glass sphere), depth 4, the JAX
    albedo test's step and band.  (Its geometry gradient is NaN, in the
    JAX package too: test_torch_diff_grad.py.)"""
    from rustraytrace_tpu_torch import models

    scene, cfg, _ = models.book3_cornell_box(dict(image_width=16))
    cam = derive_camera(cfg, "cpu")
    kw = dict(width=16, height=16, spp=4, max_depth=4, chunk=256,
              integrator="mis", device="cpu")
    target = torch.full((16, 16, 3), 0.1)
    p = scene.tex_color1.clone().requires_grad_(True)
    loss = image_loss(dataclasses.replace(scene, tex_color1=p), target, cam,
                      3, **kw)
    g, = torch.autograd.grad(loss, p)
    eps = 1e-3
    for ti, ch in [(0, 0), (1, 1)]:
        up, dn = scene.tex_color1.clone(), scene.tex_color1.clone()
        up[ti, ch] += eps
        dn[ti, ch] -= eps
        with torch.no_grad():
            fd = (float(image_loss(dataclasses.replace(scene, tex_color1=up),
                                   target, cam, 3, **kw))
                  - float(image_loss(dataclasses.replace(scene,
                                                         tex_color1=dn),
                                     target, cam, 3, **kw))) / (2 * eps)
        assert abs(float(g[ti, ch])) > 1e-6, (ti, ch)
        assert fd == pytest.approx(float(g[ti, ch]), rel=0.05, abs=1e-5), (
            ti, ch, fd, float(g[ti, ch]))


def test_fd_matches_autodiff_geometry():
    """A view-filling Perlin-textured quad moved along its normal: only
    smooth dependence (hit point -> marble albedo), no silhouette.  The
    marble's turbulence sums |noise| over octaves, whose kinks put a
    first-order error on a realization's central difference: with the
    port's draws at seed 9 it is 43% at eps 1e-3, 8.6% at 1e-4 and 3.2% at
    3e-5, falling with eps toward AD (the JAX test's key measured 0.18% at
    1e-4).  So this checks that FD converges to AD; the gradient itself is
    held to the JAX package's with the same draws in
    test_torch_diff_grad.py."""
    b = SceneBuilder()
    wall = b.lambertian(tex=b.noise(0.7))
    b.add_quad((-60.0, -60.0, -3.0), (120.0, 0.0, 0.0), (0.0, 120.0, 0.0),
               wall)
    scene = b.build()
    target = torch.zeros(12, 24, 3)
    g = float(_grad(scene, "quad_q", target, 9)[0, 2])
    assert np.isfinite(g) and abs(g) > 1e-6
    errs = []
    for eps in (1e-3, 1e-4):
        up, dn = scene.quad_q.clone(), scene.quad_q.clone()
        up[0, 2] += eps
        dn[0, 2] -= eps
        fd = (_loss(scene, "quad_q", up, target, 9)
              - _loss(scene, "quad_q", dn, target, 9)) / (2 * eps)
        errs.append(abs(fd - g) / abs(g))
    assert errs[1] < errs[0] and errs[1] < 0.1, errs


def test_fit_recovers_albedo():
    true_scene = _lambertian_scene(albedo=(0.8, 0.2, 0.2))
    with torch.no_grad():
        target = render_mean(true_scene, CAM, 1, **KW)
    tc = true_scene.tex_color1.clone()
    tc[1] = torch.tensor([0.3, 0.6, 0.6])
    wrong = dataclasses.replace(true_scene, tex_color1=tc)
    fitted, hist = fit(wrong, ["tex_color1"], target, CFG, steps=60,
                       learning_rate=0.05, spp=4, chunk=256, device="cpu")
    assert len(hist) == 60 and all(np.isfinite(hist))
    loss_wrong = _loss(wrong, "tex_color1", wrong.tex_color1, target, 1)
    loss_fit = _loss(fitted, "tex_color1", fitted.tex_color1, target, 1)
    assert loss_fit < loss_wrong * 0.25
    err = (fitted.tex_color1[1] - true_scene.tex_color1[1]).abs().max()
    assert float(err) < 0.15


def test_make_train_step_runs():
    scene = _lambertian_scene()
    target = torch.zeros(CFG.image_height, CFG.image_width, 3)
    step, params, opt = make_train_step(
        scene, ["sph_center", "tex_color1"], target, CFG, spp=2, chunk=256,
        device="cpu")
    before = {k: v.detach().clone() for k, v in params.items()}
    loss = step(0)
    assert np.isfinite(float(loss))
    assert isinstance(opt, torch.optim.Adam)
    assert not torch.equal(before["tex_color1"], params["tex_color1"])


def test_fit_checkpoint_resume(tmp_path):
    """A fit checkpointed at step 2, killed and resumed, ends where the
    unbroken fit ends (params, Adam state and seed counter round-trip)."""
    scene = _lambertian_scene(albedo=(0.3, 0.6, 0.2))
    target = torch.full((CFG.image_height, CFG.image_width, 3), 0.25)
    ckdir = str(tmp_path / "ck")
    kw = dict(steps=4, learning_rate=5e-2, spp=2, chunk=256, device="cpu")
    full, hist_full = fit(scene, ["tex_color1"], target, CFG, **kw)
    fit(scene, ["tex_color1"], target, CFG, checkpoint_dir=ckdir,
        checkpoint_every=2, **{**kw, "steps": 2})
    resumed, hist_res = fit(scene, ["tex_color1"], target, CFG,
                            checkpoint_dir=ckdir, checkpoint_every=2,
                            resume=True, **kw)
    assert hist_res == hist_full[2:]
    np.testing.assert_allclose(resumed.tex_color1.numpy(),
                               full.tex_color1.numpy(), atol=1e-6)


def test_step_seeds_are_fresh_and_deterministic():
    seeds = [diff.step_seed(12, s) for s in range(64)]
    assert len(set(seeds)) == 64
    assert seeds == [diff.step_seed(12, s) for s in range(64)]
    assert diff.step_seed(13, 0) != seeds[0]
    assert all(0 <= s < 2 ** 64 for s in seeds)


def test_attached_ratio_unbiased_toy():
    """The dielectric's choice is a detached sampling decision whose
    probability depends on the IOR; the weight p / detach(p) of
    ``ops/materials.py`` carries the probability's derivative: for X = A
    if U < p(t) else B, dE[X]/dt = p'(t) (A - B)."""
    A, B = 3.0, 1.0
    u = torch.from_numpy(np.random.default_rng(0).uniform(
        size=200_000).astype(np.float32))
    t = torch.tensor(0.3, requires_grad=True)
    p = 0.3 + 0.4 * torch.sigmoid(t)
    choice = p > u
    w = torch.where(choice, p / p.detach(), (1.0 - p) / (1.0 - p).detach())
    est = torch.mean(torch.where(choice, A, B) * w)
    g, = torch.autograd.grad(est, t)
    s = torch.sigmoid(torch.tensor(0.3))
    expect = float(0.4 * s * (1 - s)) * (A - B)
    assert abs(float(g) - expect) < 0.02 * abs(expect), (float(g), expect)


def test_ior_gradient_points_to_truth():
    """With the likelihood-ratio weight, the loss gradient in the IOR pulls
    toward the true 1.5 from both sides (mean over 4 seeds)."""
    scene = _dielectric_scene(1.5)
    with torch.no_grad():
        target = render_mean(scene, CAM, 9, **{**KW, "spp": 64})

    def g(ior, seed):
        m = scene.mat_ior.clone()
        m[1] = ior
        return float(_grad(dataclasses.replace(scene, mat_ior=m), "mat_ior",
                           target, seed, spp=32)[1])

    g_lo = np.mean([g(1.30, k) for k in range(4)])
    g_hi = np.mean([g(1.75, k) for k in range(4)])
    assert g_lo < 0.0 < g_hi, (g_lo, g_hi)


@pytest.mark.parametrize("warp", [True, False])
def test_value_and_grad_loss_equals_autograd_of_image_loss(warp):
    """The one backward path (a forward without a graph for the loss and
    cotangent, the contraction's per-unit backward for the gradient)
    equals plain autograd of ``image_loss`` at the same seed; with the
    warp off the box forward pairs with the box contraction."""
    with torch.no_grad():
        target = render_mean(_lambertian_scene(), CAM, 9, **KW)
    wrong = _lambertian_scene(albedo=(0.3, 0.6, 0.4),
                              center=(0.1, 0.05, -1.1))
    params = extract_params(wrong, ["sph_center", "tex_color1"])
    loss_s, g_s = value_and_grad_loss(wrong, params, target, CAM, 5,
                                      warp_primary=warp, **KW)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss_f = image_loss(apply_params(wrong, leaves), target, CAM, 5,
                        warp_primary=warp, **KW)
    g_f = torch.autograd.grad(loss_f, list(leaves.values()))
    np.testing.assert_allclose(float(loss_s), float(loss_f), rtol=1e-6)
    for k, gf in zip(leaves, g_f):
        assert torch.any(g_s[k] != 0), k
        np.testing.assert_allclose(g_s[k].numpy(), gf.numpy(), rtol=2e-4,
                                   atol=1e-7, err_msg=k)


def test_value_and_grad_loss_kernel_forward():
    """forward="kernel" on the CPU: the plain twins of K2/K3 give the loss
    and cotangent (an independent stream, the box filter), the gradient
    contraction is unchanged: finite, the same scale and direction as the
    exact one at matched spp."""
    kw = dict(KW, spp=64)
    with torch.no_grad():
        target = render_mean(_lambertian_scene(), CAM, 9, **kw)
    wrong = _lambertian_scene(albedo=(0.3, 0.6, 0.4),
                              center=(0.1, 0.05, -1.1))
    params = extract_params(wrong, ["sph_center", "tex_color1"])
    loss_k, g_k = value_and_grad_loss(wrong, params, target, CAM, 5,
                                      forward="kernel", **kw)
    loss_t, g_t = value_and_grad_loss(wrong, params, target, CAM, 5, **kw)
    assert np.isfinite(float(loss_k))
    np.testing.assert_allclose(float(loss_k), float(loss_t), rtol=0.25)
    for k in g_k:
        a, b = g_k[k].numpy().ravel(), g_t[k].numpy().ravel()
        assert np.all(np.isfinite(a))
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))
        assert cos > 0.9, (k, cos)
        ratio = np.linalg.norm(a) / (np.linalg.norm(b) + 1e-30)
        assert 0.5 < ratio < 2.0, (k, ratio)


def test_value_and_grad_loss_rejects_an_unknown_forward():
    scene = _lambertian_scene()
    with pytest.raises(ValueError, match="forward"):
        value_and_grad_loss(scene, extract_params(scene, ["tex_color1"]),
                            torch.zeros(12, 24, 3), CAM, 0, forward="bogus",
                            **KW)


def test_params_from_numpy_carries_jax_params():
    """The JAX package's parameters, as NumPy arrays, become the port's
    tensors with the Scene's dtypes and exact values."""
    jax = pytest.importorskip("jax")
    from rustraytrace_tpu.diff import extract_params as jextract
    from rustraytrace_tpu.scene import SceneBuilder as JaxSceneBuilder

    b = JaxSceneBuilder()
    b.add_sphere((0.1, 0.2, -1.3), 0.5, b.lambertian((0.3, 0.6, 0.4)))
    jp = jextract(b.build(), ["sph_center", "tex_color1", "sph_mat"])
    got = diff.params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    for k, v in jp.items():
        assert got[k].dtype == (torch.int32 if k == "sph_mat"
                                else torch.float32)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    assert jax is not None


def test_training_path_never_imports_jax():
    code = (
        "import sys, torch\n"
        "import rustraytrace_tpu_torch.diff, rustraytrace_tpu_torch.parallel\n"
        "import rustraytrace_tpu_torch.ops.warp\n"
        "import rustraytrace_tpu_torch.utils.checkpoint\n"
        "import rustraytrace_tpu_torch.scripts.inverse_rendering as ir\n"
        "r = ir.run(steps=1, spp=1, width=16, device='cpu')\n"
        "assert r['steps'] == 1\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rustraytrace_tpu' or m.startswith('rustraytrace_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
