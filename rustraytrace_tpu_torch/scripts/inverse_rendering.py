"""Inverse rendering, BASELINE config 4 (counterpart:
``examples/inverse_rendering.py``): recover a sphere's albedo and its full
3-D center from a rendered target image by gradient descent through the
differentiable renderer (``diff``).

A target is rendered from the true scene, the sphere's albedo and center
are perturbed (the wrong sphere overlaps the target on screen, so the
silhouette warp has a boundary to act on), and Adam runs on the MSE in
linear radiance.  Each step, as the example's optax chain orders it:
NaN gradients are zeroed, all gradients are clipped to a global norm of
1, row masks keep the other spheres and textures fixed, and Adam steps
texture 1's color at 0.03 and sphere 1's center at 0.004.  The exit code
gates both recoveries: center within 0.08 world units (radius 0.5),
albedo within 0.2 per channel.

    python -m rustraytrace_tpu_torch.scripts.inverse_rendering \\
        [--steps 250] [--spp 16] [--width 64] [--out-dir DIR] \\
        [--checkpoint-dir DIR [--resume]] [--forward trace|kernel] \\
        [--device cuda|cpu]

It prints the loss every 20 steps, then a JSON report (the losses before
and after, the recovered values and errors, the median step time, the
steps whose gradient held a NaN), and
writes ``inverse_{target,initial,fitted}.png`` to ``--out-dir`` (default:
the temporary directory).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..config import RenderConfig, derive_camera
from ..diff import fit, image_loss, render_mean
from ..ops._cuda import device as _device
from ..render import finalize_image
from ..scene import SceneBuilder
from ..utils import image_io

TRUE_ALBEDO = (0.75, 0.25, 0.15)
TRUE_CENTER = (-0.1, 0.05, -1.2)
START_ALBEDO = (0.2, 0.5, 0.7)
START_CENTER = (0.12, -0.1, -1.25)
PARAMS = ("sph_center", "tex_color1")
CENTER_TOL = 0.08
ALBEDO_TOL = 0.2


def build_scene(albedo, center):
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.6, 0.6, 0.6)))
    b.add_sphere(center, 0.5, b.lambertian(albedo))
    b.add_sphere((1.2, 0.0, -1.4), 0.4, b.metal((0.8, 0.8, 0.8), 0.1))
    return b.build()


def config(width: int = 64, spp: int = 16) -> RenderConfig:
    return RenderConfig(aspect_ratio=16 / 9, image_width=width,
                        samples_per_pixel=spp, max_depth=4, vfov=60.0,
                        lookfrom=(0, 0.3, 0.6), lookat=(0, 0, -1), seed=3)


def adam_two_groups(params: dict) -> torch.optim.Optimizer:
    """Geometry takes a much smaller step than color: Adam's normalized
    updates would otherwise random-walk the center through the noisy
    landscape at the color's speed."""
    return torch.optim.Adam([
        {"params": [params["tex_color1"]], "lr": 0.03},
        {"params": [params["sph_center"]], "lr": 0.004}])


def masked_clip(masks: dict, max_norm: float = 1.0, nan_steps=None):
    """The optax chain's transforms before Adam: zero NaN gradients, clip
    all of them to a global norm (the L2 norm over every entry, taken
    after the zeroing), then apply the row masks.  Each step whose
    gradient held a NaN appends 1 to ``nan_steps`` (a list), 0
    otherwise."""
    def transform(grads: dict) -> dict:
        if nan_steps is not None:
            nan_steps.append(int(any(bool(torch.isnan(g).any())
                                     for g in grads.values())))
        grads = {k: torch.where(torch.isnan(g), 0.0, g)
                 for k, g in grads.items()}
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        # optax.clip_by_global_norm's select, on the device (no host sync)
        grads = {k: torch.where(norm < max_norm, g, g / norm * max_norm)
                 for k, g in grads.items()}
        return {k: g * masks[k] for k, g in grads.items()}
    return transform


def run(*, steps: int = 250, spp: int = 16, width: int = 64,
        forward: str = "trace", device="cuda", checkpoint_dir=None,
        resume: bool = False, out_dir=None, progress=None) -> dict:
    """The whole fit; returns the report.  ``progress(step, loss)`` is
    called after every step."""
    dev = _device(device)
    cfg = config(width, spp)
    cam = derive_camera(cfg, device=dev)
    kw = dict(width=cfg.image_width, height=cfg.image_height, spp=spp,
              max_depth=4, chunk=4096, device=dev)
    true_scene = build_scene(TRUE_ALBEDO, TRUE_CENTER)
    with torch.no_grad():
        target = render_mean(true_scene, cam, 42, **kw)
    wrong = build_scene(START_ALBEDO, START_CENTER)
    with torch.no_grad():
        loss0 = float(image_loss(wrong, target, cam, 1, **kw))

    # only sphere 1's center (all three coordinates: the warp's silhouette
    # gradients make depth recoverable from apparent size) and texture 1's
    # color are unknown; the ground and the metal sphere are known
    masks = {n: torch.zeros_like(getattr(wrong, n), device=dev)
             for n in PARAMS}
    masks["sph_center"][1, 0:3] = 1.0
    masks["tex_color1"][1] = 1.0
    times, nan_steps = [], []
    last = [time.perf_counter()]

    def step_done(step, loss):
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now
        if step % 20 == 0:
            print(f"step {step:4d}  loss {loss:.3e}", flush=True)
        if progress is not None:
            progress(step, loss)

    fitted, hist = fit(
        wrong, list(PARAMS), target, cfg, steps=steps, spp=spp, chunk=4096,
        progress=step_done, optimizer=adam_two_groups,
        grad_transform=masked_clip(masks, nan_steps=nan_steps),
        checkpoint_dir=checkpoint_dir,
        resume=resume, forward=forward, device=dev)
    with torch.no_grad():
        loss1 = float(image_loss(fitted, target, cam, 1, **kw))
    rec_center = fitted.sph_center[1].cpu().numpy()
    rec_albedo = fitted.tex_color1[1].cpu().numpy()
    report = {
        "loss_before": loss0, "loss_after": loss1,
        "center_true": list(TRUE_CENTER),
        "center_recovered": [round(float(v), 4) for v in rec_center],
        "center_err": round(float(np.abs(
            rec_center - np.asarray(TRUE_CENTER)).max()), 4),
        "albedo_true": list(TRUE_ALBEDO),
        "albedo_recovered": [round(float(v), 4) for v in rec_albedo],
        "albedo_err": round(float(np.abs(
            rec_albedo - np.asarray(TRUE_ALBEDO)).max()), 4),
        "steps": len(hist), "forward": forward,
        "median_step_s": float(np.median(times)) if times else None,
        "nan_grad_steps": int(sum(nan_steps)),
    }
    report["ok"] = bool(report["albedo_err"] < ALBEDO_TOL
                        and report["center_err"] < CENTER_TOL)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        for name, sc in (("target", true_scene), ("initial", wrong),
                         ("fitted", fitted)):
            with torch.no_grad():
                img = render_mean(sc, cam, 42, **kw)
            image_io.write_image(finalize_image(img.cpu().numpy(), 1),
                                 os.path.join(out_dir,
                                              f"inverse_{name}.png"))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--out-dir", default=tempfile.gettempdir())
    ap.add_argument("--checkpoint-dir", default=None,
                    help="train-state checkpoint directory; with --resume, "
                         "continue a killed run")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--forward", default="trace", choices=("trace", "kernel"),
                    help="the loss and cotangent forward of each step: "
                         "'trace' (exact) or 'kernel' (the CUDA kernels' "
                         "render, an independent stream)")
    args = ap.parse_args(argv)
    report = run(steps=args.steps, spp=args.spp, width=args.width,
                 forward=args.forward, device=args.device,
                 checkpoint_dir=args.checkpoint_dir, resume=args.resume,
                 out_dir=args.out_dir)
    print(json.dumps(report, indent=2))
    print(f"images written to {args.out_dir}/inverse_*.png")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
