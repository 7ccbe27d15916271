"""Per-scene throughput of one ``render.render_pass`` each (counterpart:
``scripts/bench_scenes.py``, with the same eleven cases, shapes and
backends).

Each case prints one JSON line {case, backend, paths_per_s, elapsed_s,
shape}: the best of 2 timed passes (``utils.metrics.time_best``, fenced
with a device synchronisation) after one warm-up pass, which builds the
kernels and the tables.  A failed warm-up raises: nothing is retried.

    python -m rustraytrace_tpu_torch.scripts.bench_scenes [case ...] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

# case -> (model, overrides dict, integrator, spp, depth, backend)
CASES = {
    "flagship": ("book1_random_spheres",
                 dict(image_width=1200, samples_per_pixel=128, max_depth=50),
                 "path", 128, 50, "auto"),
    "flagship_wf": ("book1_random_spheres",
                    dict(image_width=1200, samples_per_pixel=128,
                         max_depth=50),
                    "path", 128, 50, "wavefront"),
    "final": ("book2_final_scene",
              dict(image_width=800, samples_per_pixel=64, max_depth=40),
              "path", 64, 40, "auto"),
    "earth": ("book2_earth",
              dict(image_width=800, samples_per_pixel=1024, max_depth=50),
              "path", 1024, 50, "auto"),
    "bouncing": ("book2_bouncing_spheres",
                 dict(image_width=400, samples_per_pixel=1024, max_depth=50),
                 "path", 1024, 50, "auto"),
    "quads": ("book2_quads",
              dict(image_width=400, samples_per_pixel=8192, max_depth=10),
              "path", 8192, 10, "auto"),
    "cornell": ("book2_cornell_box",
                dict(image_width=400, samples_per_pixel=4096, max_depth=20),
                "path", 4096, 20, "auto"),
    "smoke": ("book2_cornell_smoke",
              dict(image_width=400, samples_per_pixel=4096, max_depth=50),
              "path", 4096, 50, "auto"),
    "perlin": ("book2_perlin_spheres",
               dict(image_width=400, samples_per_pixel=4096, max_depth=50),
               "path", 4096, 50, "auto"),
    "cornell_mis": ("book3_cornell_box",
                    dict(image_width=600, samples_per_pixel=1024,
                         max_depth=50),
                    "mis", 1024, 50, "auto"),
    "field10k": ("sphere_field_10k",
                 dict(image_width=1200, samples_per_pixel=64, max_depth=50),
                 "path", 64, 50, "auto"),
}


def run_case(name: str, device="cuda") -> dict:
    """Time case ``name`` and print its JSON line."""
    from .. import models
    from ..config import derive_camera
    from ..ops._cuda import device as _device
    from ..render import render_pass, resolve_backend
    from ..utils.metrics import device_fence, time_best

    dev = _device(device)
    model, ov, integ, spp, depth, backend = CASES[name]
    scene, cfg, _ = getattr(models, model)(dict(ov))
    cam = derive_camera(cfg, device=dev)
    w, h = cfg.image_width, cfg.image_height
    backend = resolve_backend(scene, integ, backend, dev)

    def go():
        return render_pass(
            scene, cam, 0, width=w, height=h, spp=spp, max_depth=depth,
            integrator=integ, chunk=min(131072, w * h), backend=backend,
            device=dev)

    device_fence(go())
    elapsed = time_best(go)
    rec = {"case": name, "backend": backend,
           "paths_per_s": w * h * spp / elapsed, "elapsed_s": elapsed,
           "shape": f"{w}x{h}@{spp}spp d{depth}"}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="*", help=", ".join(CASES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = set(args.cases) - set(CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}")
    for c in args.cases or list(CASES):
        run_case(c, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
