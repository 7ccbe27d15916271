"""BASELINE.md's configurations at their stated sizes (counterpart:
``scripts/baseline_matrix.py``).

Each configuration renders end to end through ``render.render_image`` on
the "auto" route, and one JSON line per configuration gives its
throughput and wall time:

  1  ``book1_three_spheres``, 400x225, 100 spp, depth 50, one pass
  2  the flagship (``book1_random_spheres``), 1200x675, 500 spp, depth 50,
     125 spp a pass
  3  ``book2_earth``, 800x450, 500 spp, depth 50, 125 spp a pass
  5  the flagship at 3840x2160, 1000 spp, depth 50, 50 spp a pass, on one
     card (its multi-card run is ``scaling_bench --backend megakernel``)

Configuration 4 is the inverse-rendering fit:
``python -m rustraytrace_tpu_torch.scripts.inverse_rendering``.

Before timing, one pass at the effective pass size
(``render.effective_spp_per_pass``) and one at the tail warm the kernels
and the tables, and one untimed ``render_image`` runs; then the best of 2
(one above 2e8 paths) is kept.  A failed build or launch raises.

    python -m rustraytrace_tpu_torch.scripts.baseline_matrix [1 2 3 5] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np

CONFIGS = {
    1: ("book1_three_spheres",
        dict(image_width=400, samples_per_pixel=100, max_depth=50,
             spp_per_pass=100)),
    2: ("book1_random_spheres",
        dict(image_width=1200, samples_per_pixel=500, max_depth=50,
             spp_per_pass=125)),
    3: ("book2_earth",
        dict(image_width=800, samples_per_pixel=500, max_depth=50,
             spp_per_pass=125)),
    5: ("book1_random_spheres",
        dict(image_width=3840, samples_per_pixel=1000, max_depth=50,
             spp_per_pass=50)),
}


def config_scene(config: int):
    """(scene, cfg, integrator) of a BASELINE configuration."""
    from .. import models

    if config not in CONFIGS:
        raise SystemExit(f"config {config}: run "
                         "rustraytrace_tpu_torch.scripts.inverse_rendering")
    name, over = CONFIGS[config]
    scene, cfg, integ = getattr(models, name)(dict(over))
    if config == 5:
        cfg = cfg.replace(aspect_ratio=16.0 / 9.0)  # 3840x2160
    return scene, cfg, integ


def run(config: int, device="cuda") -> dict:
    """Render configuration ``config`` and print its JSON line."""
    from .. import render
    from ..config import derive_camera
    from ..ops._cuda import device as _device
    from ..utils.metrics import device_fence, time_best

    scene, cfg, integ = config_scene(config)
    dev = _device(device)
    w, h = cfg.image_width, cfg.image_height
    backend = render.resolve_backend(scene, integ, "auto", dev)
    cam = derive_camera(cfg, device=dev)
    spp_total = render.samples_total(cfg)
    eff = render.effective_spp_per_pass(cfg, backend, spp_total, w * h)
    for spp in {min(eff, spp_total), spp_total % eff} - {0}:
        device_fence(render.render_pass(
            scene, cam, cfg.seed, width=w, height=h, spp=spp,
            max_depth=cfg.max_depth, integrator=integ, backend=backend,
            device=dev))
    out = {}

    def go():
        out["img"], out["state"] = render.render_image(
            scene, cfg, integrator=integ, backend=backend, device=dev)
        return out["img"]

    go()  # the first render_image: the rest of the set-up
    repeats = 2 if w * h * cfg.samples_per_pixel <= 2e8 else 1
    el = time_best(go, repeats=repeats)
    spp = out["state"]["spp_done"]
    rec = {"config": config,
           "scene": f"{w}x{h}@{spp}spp d{cfg.max_depth}",
           "backend": backend, "paths_per_s": w * h * spp / el,
           "wall_s": el, "mean_u8": float(np.asarray(out["img"]).mean())}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", type=int, nargs="*", default=[1, 2, 3, 5])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for c in args.configs:
        run(c, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
