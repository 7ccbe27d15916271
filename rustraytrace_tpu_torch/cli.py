"""Command-line renderer (counterpart: ``rustraytrace_tpu/cli.py``, the
analog of the reference's ``src/main.rs``).

The JAX package's parser, with the same scene/book dispatch (``the_next_week``
scenes 1-9, ``the_next_week/mod.rs:68-81``), the same runtime flags in
place of the reference's compile-time ``OVERRIDES`` (``src/config.rs:50-62``)
and the same ``--backend`` choices, plus ``--device``.  The render runs on
the card unless ``--device cpu`` asks for the CPU (the plain twins of the
kernels); ``--device cuda`` without a card raises, and nothing renders on
the CPU in its place.

Examples:
    python -m rustraytrace_tpu_torch in_one_weekend --width 400 --spp 64 -o out.png
    python -m rustraytrace_tpu_torch the_next_week 7 --spp 200
    python -m rustraytrace_tpu_torch book3_cornell_box --spp 100 > image.ppm
    python -m rustraytrace_tpu_torch book1_three_spheres --spp 16 --device cpu -o out.ppm
    torchrun --standalone --nproc_per_node=1 -m rustraytrace_tpu_torch \\
        the_rest_of_your_life --sharded -o box.ppm
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    from .models.scenes import SCENES

    p = argparse.ArgumentParser(
        prog="rustraytrace_tpu_torch",
        description="CUDA path tracer for one NVIDIA GPU "
                    "(Ray Tracing in One Weekend trilogy feature set)",
    )
    p.add_argument("scene", help="book or scene name: " + ", ".join(
        ["the_next_week"] + sorted(SCENES)))
    p.add_argument("scene_num", nargs="?", type=int, default=None,
                   help="scene number for the_next_week (1-9)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "sphere_kernel", "megakernel",
                            "wavefront"],
                   help="execution backend (auto picks the fastest valid "
                        "one; xla is the reference route)")
    p.add_argument("--sharded", action="store_true",
                   help="shard pixels/spp across the ranks of the job")
    p.add_argument("--spp-shards", type=int, default=None,
                   help="ranks on the spp mesh axis (with --sharded)")
    p.add_argument("--width", type=int, default=None, help="image width")
    p.add_argument("--spp", type=int, default=None, help="samples per pixel")
    p.add_argument("--depth", type=int, default=None, help="max bounces")
    p.add_argument("--spp-per-pass", type=int, default=None)
    p.add_argument("--chunk", type=int, default=65536,
                   help="pixels per chunk on the reference routes")
    p.add_argument("--seed", type=int, default=None, help="RNG seed")
    p.add_argument("-o", "--output", default=None,
                   help="output file (.png/.ppm); default: PPM P3 on stdout")
    p.add_argument("--checkpoint", default=None,
                   help="write a resumable .npz accumulation state here "
                        "after every pass")
    p.add_argument("--resume", default=None,
                   help="resume accumulation from a checkpoint .npz")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--debug-mode", choices=["gradient", "param"],
                   default=None,
                   help="plumbing sanity renders matching the reference's "
                        "compile-time DEBUG_GRADIENT / DEBUG_PARAM WGSL "
                        "switches (gpu/renderer.wgsl:48-49,258-278): "
                        "'gradient' shades each pixel with the sky gradient "
                        "of its primary ray (camera/ray-gen check), 'param' "
                        "fills a flat width/height-derived color")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to render (default: the card; raises "
                        "without one)")
    return p


def debug_render(cfg, mode: str, device="cuda"):
    """The reference's WGSL debug modes as one-shot renders.

    gradient (renderer.wgsl:258-269): center-of-pixel primary ray (every
    camera draw 0.5), sky gradient of its unit direction.  param
    (renderer.wgsl:271-277): constant (width/1024, height/1024, 0) fill.
    Both return u8 [H, W, 3] without gamma (the reference writes the raw
    accumulated color)."""
    import numpy as np
    import torch

    from .config import derive_camera
    from .ops._cuda import device as _device

    h, w = cfg.image_height, cfg.image_width
    if mode == "param":
        color = np.clip([w / 1024.0, h / 1024.0, 0.0], 0.0, 1.0)
        img = np.broadcast_to(color, (h, w, 3))
    else:
        from .camera import generate_rays

        dev = _device(device)
        cam = derive_camera(cfg, device=dev)
        yy, xx = np.mgrid[0:h, 0:w]
        px = torch.as_tensor(xx.reshape(-1), dtype=torch.float32, device=dev)
        py = torch.as_tensor(yy.reshape(-1), dtype=torch.float32, device=dev)
        draws = torch.full((h * w, 5), 0.5, dtype=torch.float32, device=dev)
        _, d, _ = generate_rays(cam, px, py, draws, None)
        unit = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        t = 0.5 * (unit[:, 1] + 1.0)
        sky = ((1.0 - t)[:, None] * torch.ones(3, device=dev)
               + t[:, None] * torch.tensor([0.5, 0.7, 1.0], device=dev))
        img = sky.cpu().numpy().reshape(h, w, 3)
    return (np.clip(img, 0.0, 0.999) * 256).astype(np.uint8)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from . import models, render
    from .ops._cuda import device as _device
    from .utils import image_io
    from .utils.checkpoint import load_checkpoint, save_checkpoint

    overrides = {}
    if args.width is not None:
        overrides["image_width"] = args.width
    if args.spp is not None:
        overrides["samples_per_pixel"] = args.spp
    if args.depth is not None:
        overrides["max_depth"] = args.depth
    if args.spp_per_pass is not None:
        overrides["spp_per_pass"] = args.spp_per_pass
    if args.seed is not None:
        overrides["seed"] = args.seed

    try:
        scene, cfg, integrator = models.get_scene(
            args.scene, overrides or None, args.scene_num)
    except KeyError:
        print(f"unknown scene {args.scene!r}; available: "
              + ", ".join(sorted(models.SCENES)), file=sys.stderr)
        return 2
    if args.sharded and args.backend == "sphere_kernel":
        print("--backend sphere_kernel is not supported with --sharded "
              "(use auto, xla, megakernel or wavefront)", file=sys.stderr)
        return 2
    dev = _device(args.device)

    if args.debug_mode:
        img = debug_render(cfg, args.debug_mode, device=dev)
        image_io.write_image(img, args.output)
        return 0

    # with --sharded every rank renders and holds the summed framebuffer;
    # rank 0 alone writes the image, the checkpoints and the meter lines
    mesh, lead = None, True
    if args.sharded:
        from .parallel import initialize, make_mesh

        initialize(device=dev)
        mesh = make_mesh(spp_shards=args.spp_shards)
        lead = mesh.rank == 0
        if lead and not args.quiet:
            print(f"mesh: {mesh.shape}", file=sys.stderr)

    accum_state = None
    if args.resume:
        accum_state = load_checkpoint(args.resume, cfg, scene)
        if lead:
            print(f"resumed at {accum_state['spp_done']} spp",
                  file=sys.stderr)

    from .utils.metrics import RenderMeter

    n_pix = cfg.image_width * cfg.image_height
    meter = RenderMeter(n_pixels=n_pix).start()
    prev = {"done": accum_state["spp_done"] if accum_state else 0}

    def progress(done, total):
        # one JSON line a pass, the structured analog of the reference's
        # "pass/total (%) elapsed eta" stderr line (src/gpu/mod.rs:469-480)
        meter.lap(done - prev["done"])
        prev["done"] = done
        if not args.quiet:
            eta = (total - done) * n_pix / max(meter.paths_per_sec, 1e-9)
            print(meter.json_line(pass_spp=done, total_spp=total,
                                  eta_s=round(eta, 1)),
                  file=sys.stderr, flush=True)

    def on_pass(state):
        save_checkpoint(args.checkpoint, state, cfg, scene)

    render_kw = dict(integrator=integrator,
                     progress=progress if lead else None,
                     accum_state=accum_state, backend=args.backend,
                     chunk=args.chunk,
                     on_pass=on_pass if lead and args.checkpoint else None,
                     device=dev)
    if args.sharded:
        from .parallel import render_image_sharded

        img, state = render_image_sharded(scene, cfg, mesh=mesh, **render_kw)
    else:
        img, state = render.render_image(scene, cfg, **render_kw)

    if not lead:
        return 0
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state, cfg, scene)
    image_io.write_image(img, args.output)
    if not args.quiet:
        print(meter.json_line(done_spp=state["spp_done"]), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
