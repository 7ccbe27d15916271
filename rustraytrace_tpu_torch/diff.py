"""Differentiable rendering and inverse rendering (BASELINE config 4;
counterpart: ``rustraytrace_tpu/diff.py``).

The Scene's tensors are the parameters, and the reference route's sharded
pass (``parallel.render.render_pass_sharded``) is differentiable by plain
autograd.  The integrators detach their sampling decisions (Russian
roulette, the mixture pdf; the dielectric's choice keeps its
likelihood-ratio weight), so gradients flow through hit points, normals,
attenuations, Schlick and texture lookups; the silhouette warp
(``ops/warp.py``) adds the primary rays' boundary term, and the
differentiable estimator tent-splats each sample onto its 2x2 pixel
neighborhood.

``value_and_grad_loss`` is the one backward path: a forward without a
graph gives the loss and the MSE cotangent, then the contraction's
backward, one unit of pixels x samples at a time, gives the gradient.  It
equals plain autograd of ``image_loss`` at the same seed (the same draws;
the chain rule through a fixed cotangent).  The JAX package splits its step
in two programs for a TPU compiler fault; here the split is what keeps a
backward's memory at one unit's graph.

``fit`` runs ``torch.optim`` (Adam by default) over any named subset of
Scene tensors against a target image, with a fresh seed per step from a
seed counter, and train-state checkpoints.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import CameraParams, RenderConfig, derive_camera
from .ops._cuda import device as _device
from .parallel.mesh import Mesh, make_mesh
from .parallel.render import (render_contract_sharded, render_pass_sharded,
                              spp_traced)
from .render import _scene_on
from .scene import _INT_FIELDS, Scene

FORWARDS = ("trace", "kernel")


def render_mean(scene: Scene, cam: CameraParams, seed: int, *, width: int,
                height: int, spp: int, max_depth: int,
                mesh: Optional[Mesh] = None, integrator: str = "path",
                chunk: int = 65536, warp_primary=True,
                device="cuda") -> torch.Tensor:
    """Differentiable MEAN-radiance render [H, W, 3] (linear).
    ``warp_primary`` (on by default here) adds the silhouette warp: values
    unchanged, and the gradient gains the sphere-visibility boundary term
    (without it sphere centers and radii get interior gradients only)."""
    mesh = make_mesh() if mesh is None else mesh
    acc = render_pass_sharded(
        scene, cam, seed, width=width, height=height, spp=spp,
        max_depth=max_depth, mesh=mesh, integrator=integrator, chunk=chunk,
        remat=True, warp_primary=warp_primary, device=device)
    return acc / spp_traced(spp, mesh)


def image_loss(scene: Scene, target, cam: CameraParams, seed: int,
               **render_kw) -> torch.Tensor:
    """Mean squared error between the linear-radiance render and target."""
    img = render_mean(scene, cam, seed, **render_kw)
    target = torch.as_tensor(target, dtype=torch.float32, device=img.device)
    return torch.mean((img - target) ** 2)


def extract_params(scene: Scene, names: Sequence[str]) -> Dict[str,
                                                              torch.Tensor]:
    return {n: getattr(scene, n) for n in names}


def apply_params(scene: Scene, params: Dict[str, torch.Tensor]) -> Scene:
    return dataclasses.replace(scene, **params)


def params_from_numpy(arrays: dict, device=None) -> Dict[str, torch.Tensor]:
    """Parameters from NumPy arrays keyed by Scene field (e.g. the JAX
    package's params, ``np.asarray`` of each), in the Scene's dtypes."""
    return {k: torch.as_tensor(
        np.array(v, np.int32 if k in _INT_FIELDS else np.float32),
        device=device or "cpu") for k, v in arrays.items()}


def _mse_and_ct(img: torch.Tensor, target: torch.Tensor, total_spp: int):
    """The MSE and its cotangent with respect to the radiance SUM
    (img * total_spp)."""
    diff = img - target
    loss = torch.mean(diff * diff)
    ct = 2.0 * diff / (diff.numel() * total_spp)
    return loss, ct


def value_and_grad_loss(scene: Scene, params: Dict[str, torch.Tensor],
                        target, cam: CameraParams, seed: int, *, width: int,
                        height: int, spp: int, max_depth: int,
                        mesh: Optional[Mesh] = None,
                        integrator: str = "path", chunk: int = 65536,
                        warp_primary=True, forward: str = "trace",
                        device="cuda") -> Tuple[torch.Tensor,
                                                Dict[str, torch.Tensor]]:
    """``(image_loss, d image_loss / d params)`` of ``apply_params(scene,
    params)`` at ``seed``.

    ``forward="trace"``: the loss and its cotangent come from the tent
    forward without a graph (value-identical to the warped render: the
    same draws, the same tent splat), and the gradient from the
    contraction's per-unit backward over the same draws, so the pair is
    exactly autograd of ``image_loss``.  ``forward="kernel"``: the loss and
    cotangent come from ``render.render_pass`` on the auto route (K2/K3 on
    the card, their plain twins on the CPU): an independent sample stream
    and the box filter, so the gradient is a consistent descent direction
    but not the exact one (the JAX package's ``forward="kernel"``).  Any
    other ``forward`` raises ``ValueError``."""
    if forward not in FORWARDS:
        raise ValueError(f"forward must be one of {FORWARDS}; got "
                         f"{forward!r}")
    mesh = make_mesh() if mesh is None else mesh
    dev = _device(device)
    scene = _scene_on(scene, dev)
    total = spp_traced(spp, mesh)
    leaves = {k: v.detach().to(dev).requires_grad_(True)
              for k, v in params.items()}
    with torch.no_grad():
        scene_p = apply_params(scene, {k: v.detach()
                                       for k, v in leaves.items()})
        if forward == "kernel":
            from .render import render_pass

            acc = render_pass(
                scene_p, cam, seed, width=width, height=height, spp=total,
                max_depth=max_depth, integrator=integrator,
                chunk=min(chunk, width * height), device=dev)
        else:
            acc = render_pass_sharded(
                scene_p, cam, seed, width=width, height=height, spp=spp,
                max_depth=max_depth, mesh=mesh, integrator=integrator,
                chunk=chunk, warp_primary="tent" if warp_primary else False,
                device=dev)
        target = torch.as_tensor(target, dtype=torch.float32, device=dev)
        loss, ct = _mse_and_ct(acc / total, target, total)
    _, grads = render_contract_sharded(
        apply_params(scene, leaves), cam, seed, ct, width=width,
        height=height, spp=spp, max_depth=max_depth, mesh=mesh,
        integrator=integrator, chunk=chunk, warp_primary=warp_primary,
        wrt=leaves, device=dev)
    return loss, grads


def step_seed(base: int, step: int) -> int:
    """The render seed of step ``step`` of a fit seeded ``base``: 64 bits
    from NumPy's SeedSequence of (base, step), a pure function of the
    pair, so a resumed fit draws what the unbroken one drew."""
    lo, hi = np.random.SeedSequence([base, step]).generate_state(2)
    return int(lo) | (int(hi) << 32)


def make_train_step(scene: Scene, param_names: Sequence[str], target,
                    cfg: RenderConfig, *, mesh: Optional[Mesh] = None,
                    integrator: str = "path", spp: int = 4,
                    learning_rate: float = 1e-2, chunk: int = 65536,
                    optimizer: Optional[Callable[
                        [dict], torch.optim.Optimizer]] = None,
                    grad_transform: Optional[Callable[[dict], dict]] = None,
                    forward: str = "trace", device="cuda"):
    """(train_step, params, optimizer) for external loops:
    ``train_step(seed) -> loss`` is one update, the sharded
    differentiable render's loss and gradient (``value_and_grad_loss``,
    summed over the mesh) and an optimizer step of ``params``, the dict of
    parameter tensors ``param_names`` (on the device).  ``optimizer`` is a
    factory ``params -> torch.optim.Optimizer`` (default:
    ``torch.optim.Adam`` at ``learning_rate``); ``grad_transform`` maps
    the gradient dict before each optimizer step (the transforms an optax
    chain puts before its optimizer); ``forward`` is
    ``value_and_grad_loss``'s."""
    dev = _device(device)
    mesh = make_mesh() if mesh is None else mesh
    cam = derive_camera(cfg, device=dev)
    scene = _scene_on(scene, dev)
    params = {n: getattr(scene, n).detach().clone().requires_grad_(True)
              for n in param_names}
    make_opt = optimizer or (lambda p: torch.optim.Adam(
        list(p.values()), lr=learning_rate))
    opt = make_opt(params)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    render_kw = dict(width=cfg.image_width, height=cfg.image_height, spp=spp,
                     max_depth=cfg.max_depth, mesh=mesh,
                     integrator=integrator, chunk=chunk, forward=forward,
                     device=dev)

    def train_step(seed: int) -> torch.Tensor:
        loss, grads = value_and_grad_loss(scene, params, target, cam, seed,
                                          **render_kw)
        if grad_transform is not None:
            grads = grad_transform(grads)
        for n, p in params.items():
            p.grad = grads[n]
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss

    return train_step, params, opt


def fit(scene: Scene, param_names: Sequence[str], target,
        cfg: RenderConfig, *, steps: int = 100, learning_rate: float = 1e-2,
        mesh: Optional[Mesh] = None, integrator: str = "path", spp: int = 4,
        chunk: int = 65536, progress=None,
        optimizer: Optional[Callable[[dict], torch.optim.Optimizer]] = None,
        grad_transform: Optional[Callable[[dict], dict]] = None,
        checkpoint_dir: Optional[str] = None, checkpoint_every: int = 25,
        resume: bool = False, forward: str = "trace",
        device="cuda") -> Tuple[Scene, list]:
    """Gradient-descent recovery of Scene tensors ``param_names`` from a
    target image.  Returns (fitted scene, per-step loss history).

    Each step is ``make_train_step``'s (which takes ``optimizer``,
    ``grad_transform`` and ``forward``), rendered with a fresh seed,
    ``step_seed(cfg.seed + 1, step)``.  ``checkpoint_dir`` keeps the train
    state (step, params, optimizer state, seed counter) every
    ``checkpoint_every`` steps, and ``resume=True`` continues from it.
    ``progress(step, loss)`` is called after each step."""
    from .utils.checkpoint import (has_train_checkpoint,
                                   load_train_checkpoint,
                                   save_train_checkpoint)

    dev = _device(device)
    train_step, params, opt = make_train_step(
        scene, param_names, target, cfg, mesh=mesh, integrator=integrator,
        spp=spp, learning_rate=learning_rate, chunk=chunk,
        optimizer=optimizer, grad_transform=grad_transform, forward=forward,
        device=dev)
    base = cfg.seed + 1
    step0 = 0
    if checkpoint_dir is not None and resume and has_train_checkpoint(
            checkpoint_dir):
        step0, saved, opt_state, rng = load_train_checkpoint(checkpoint_dir)
        if rng["base"] != base:
            raise ValueError(f"checkpoint {checkpoint_dir} was seeded "
                             f"{rng['base']}, this fit {base}")
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(saved[n])
        opt.load_state_dict(opt_state)
    history = []
    for step in range(step0, steps):
        history.append(float(train_step(step_seed(base, step))))
        if progress is not None:
            progress(step, history[-1])
        if checkpoint_dir is not None and (step + 1) % checkpoint_every == 0:
            save_train_checkpoint(checkpoint_dir, step=step + 1,
                                  params=params, opt_state=opt.state_dict(),
                                  rng={"base": base, "step": step + 1})
    fitted = apply_params(_scene_on(scene, dev),
                          {n: p.detach() for n, p in params.items()})
    return fitted, history
