#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``rustraytrace_tpu_torch``) on one
NVIDIA GPU: builds the CUDA kernels from ``rustraytrace_tpu_torch/csrc``,
holds each against its plain PyTorch version, and drives the port's main
paths on the card:

* the flagship (Book-1 random spheres, 1200x675, depth 50, 1024 spp in one
  pass) through ``render.render_pass`` on the sorted persist kernel K2;
* the Book-3 Cornell box (600x600, 100 spp stratified 10x10, depth 50,
  NEE/MIS) through ``render.render_image`` on the respawn megakernel K3;
* the Book-2 final scene (``get_scene("the_next_week")``: 400x400, 250 spp,
  depth 4, motion, 400 boxes, two constant media, Perlin marble, the
  earthmap globe, a 1000-sphere cloud) through ``render.render_image`` on
  the image route: sorted K2 with per-tile launch bounds;
* the Book-3 Cornell box again through ``render_pass_megakernel`` on the
  monolithic megakernel K4 (``respawn=False``, the JAX default);
* the final scene again through ``render_pass_wavefront`` with
  ``per_bounce_segments=True`` on the per-bounce segment kernel K5, which
  banks and respawns on the device;
* the flagship at 16 spp through ``render.render_image`` on the
  sphere_kernel route, whose closest hit is K1 at every bounce;
* the spike script ``rustraytrace_tpu_torch.scripts.spike_dense_mxu`` on
  S1's two kernels;
* BASELINE config 4's inverse-rendering fit
  (``rustraytrace_tpu_torch.scripts.inverse_rendering``: 64x36, 16 spp,
  depth 4, 250 Adam steps) through ``diff.fit``, with the trace forward
  and with the kernel forward (K3);
* the command line (``cli.main``, ``python -m rustraytrace_tpu_torch``,
  ``torchrun``) on the flagship, the Book-3 box and the final scene, and
  the sharded image loop (``parallel.render_image_sharded``,
  ``render_image_multihost``) on a one-rank NCCL group, each bitwise
  equal to ``render.render_image`` with the same kernel launches;
* the entry points of ``graft_entry``, the final scene with the sphere grid
  (``RTT_SPHERE_GRID=1``, ``ops/bvh.py``) through ``render_image``, and the
  measurement scripts ``scripts.baseline_matrix`` (BASELINE configs 1, 2,
  3 and 5 at their stated sizes), ``scripts.scaling_bench`` (world size 1)
  and ``scripts.bench_scenes`` (``flagship``, ``final``);

then the other routes, each also held bitwise against the plain twin at
its full lane count.  Phases: 1 env, 2 build (registers of every kernel
instance), 3 K1, 3b K1 on a table of ten ring tiles, moving spheres,
quads, ragged ray counts and exact ties, 4 K2 launch, 4b K2 launch with
MIS and quads, 4c K2 at the flagship's third 128-iteration launch (timed
from copies of the loop state, its bound and SIMT efficiency, 8
iterations vs the twin), 5 sort invariance, 6 flagship (and
``render_image``'s ``on_pass`` getting a host copy), 7 Book-3 Cornell box
on K3 (timed, with the counting instance's bound, lane-use and tail
shares), 8 other K3 routes: the Book-2 Cornell box, the 4K pass (K3 timed,
its bound, SIMT efficiency of the leaf scans, lane-use and tail shares)
and the two-level cluster cull (a one-block grid == the full grid, K3 and
K4), 9 the final scene
(one K2 launch vs the twin, launch 119 of 237 with its tile bounds timed
and vs the twin, sorted with tile bounds == unsorted == K3, the main path,
a 104-spp pass of scene 9), every other Book-2 scene and
``sphere_field_10k`` at its own config (and its third K2 launch; K3 timed
on the three 400x225 scenes of its route), and a
MIS scene with the Book-2 features; 10 K4 (the Book-3 path,
== K3 bitwise at full configuration, == its twin, timed with its
registers and lane-use share, the Cornell smoke); 11
K5 (the final-scene path, == the persist render bitwise, with its
segments, kernel launches and host syncs; six segments vs the twin at full
lanes for both instances, one launch timed; earth); 12 SAH quad clusters
(1,024 quads, camera inside); 13 the MIS isotropic branch (the smoke
scene); 14 the sphere_kernel route (the reference ``trace_path`` with K1
every bounce: the flagship at 16 spp, == the route with K1's twin, vs the
reference route, BASELINE config 1, earth); 15 the reference route (the
Book-3 Cornell box vs K3, and the scenes the kernels do not cover, on
'auto'); 16 S1, the dense spike's
tensor-core and scalar kernels (the port's spike script, then each kernel
against its twin at the spike's shape and at 2^20 rays, the scalar one at
1, 4 and 32 lanes a ray too, the dense one at 1, 4 and 64 ranges of the
sphere axis too, each slower than a floor that proves its work done); 17
the training path (BASELINE config 4, ``scripts/inverse_rendering`` at
64x36, 16 spp, depth 4): the gradient on the card against the CPU port
and against central differences, the whole 250-step fit with the trace
forward (gated on the example's recovery; step time, idle share of a
step), the same fit with the kernel forward (K3 launches counted), and
the sharded pass and contraction on a one-rank NCCL group; 18 the entry
points: the CLI on the flagship (1200x675, 1024 spp, depth 50) ==
``render_image`` bitwise with equal K2 launches, and on a one-rank NCCL
group ``--sharded`` on the flagship, the Book-3 box (one K3 launch), the
final scene (K2's image route) and the stratified reference route, each
== ``render_image`` bitwise, ``render_image_multihost``, ``torchrun`` and
``python -m`` of the package in child processes, and ``--backend
sphere_kernel --sharded`` refused with exit 2; 19 the last ported pieces:
``graft_entry.entry()`` == ``render_pass`` bitwise and
``dryrun_multichip(1)``, the sphere grid on the final scene (its tables
larger than SAH's, K2, K3, K4 and K5 == their twins on them, the
cell-face winner count, ``render_image`` grid vs SAH within 5 SE with
walls and work, the K5 route, and K4's on the cloud without the globe),
``baseline_matrix`` configs 1, 2, 3 and 5, ``scaling_bench``'s three
backends at world size 1 == their routes bitwise, and ``bench_scenes``
``flagship`` and ``final``.
The plain twins run at reduced spp on the card (the line of each
comparison states its size).

    python3 chip_smoke.py

Each phase prints one line; any failure exits non-zero.  The last lines are
the card's name and power limit (as ``nvidia-smi`` prints them), a JSON line
with every kernel's agreement, launch counts, times and bounds, and
``{"ok": true, "device": {...}}``.  Without CUDA it exits 1 and prints no
result.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _cmd(*args: str) -> str:
    res = subprocess.run(list(args), capture_output=True, text=True,
                         timeout=60)
    return res.stdout.strip()


def _cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rays(n: int, seed: int):
    """Seeded rays from around the flagship camera, 70% aimed at the
    sphere field (as tests/test_pallas_hit.py draws them)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)) + np.array([13.0, 2.0, 3.0])
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    to_scene = rng.uniform(-4, 4, (n, 3)) - o
    d = np.where((rng.uniform(size=n) < 0.7)[:, None], to_scene, d)
    t = rng.uniform(size=n)
    return (o.astype(np.float32), d.astype(np.float32),
            t.astype(np.float32))


FLAGSHIP_SPP = 1024  # one pass, as the JAX package's bench.py runs it
# the 400x225 Book-2 scenes whose main path is K3 (timed in phase 9)
K3_CELLS_400 = ("book2_checkered_spheres", "book2_perlin_spheres",
                "book2_simple_light")

# Least-time bounds: the larger of the FP32
# operations over 67 TFLOP/s and the bytes over 3.35 TB/s of an H100 SXM at
# 700 W.  Operations per unit of work are counted from the sources
# (csrc/rtt_common.cuh, csrc/path.cuh): each FP32 add, multiply, compare,
# min/max, select, sqrt, divide, sin and cos counts as one.  The Philox
# integer work and the camera spawns are not counted, so the bounds are low.
PEAK_OPS, PEAK_BYTES = 67e12, 3.35e12
OPS = dict(sphere=30, box=25, quad=61, path_bounce=231, mis_bounce=317,
           light_pick=5, light_sample=(15, 76), light_pdf=(68, 50),
           box_row=30, medium=45, noise=134, texel=27,
           # S1 per (ray, sphere) pair (csrc/dense_hit.cu): the dense
           # epilogue after the two products, 22 where the discriminant is
           # positive and 6 where the kernel skips the root (a fused
           # multiply-add counted as 2), and the scalar loop's test: 32
           # where the discriminant is positive, 18 where the kernel skips
           # the root
           dense_pair=22, dense_miss=6, scalar_pair=32, scalar_miss=18)
# S1's products on the tensor cores: 495 TFLOP/s dense TF32 (H100 SXM)
PEAK_TF32 = 495e12


def _bound(ops: float, nbytes: float):
    """(bound_ms, bound_by) of a function doing ``ops`` operations and
    moving ``nbytes`` bytes."""
    t_ops, t_bytes = 1e3 * ops / PEAK_OPS, 1e3 * nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _path_ops(work, tables) -> float:
    """Operations of a path-tracer launch from its work counters
    (ops/megakernel.py WORK_NAMES: bounces, sphere rows tested, cluster
    boxes tested, box rows tested, media free flights, Perlin noise
    evaluations, texel fetches, quad rows tested; the rest, the sphere
    rows as warps issue them and the lane and warp iterations, measure
    SIMT efficiency, not work) and its tables."""
    (bounces, spheres, boxes, box_rows, media, noise, texels,
     quads) = (int(v) for v in work.tolist()[:8])
    per_bounce = OPS["path_bounce"]
    if tables.mis:
        kinds = [int(k) for k in tables.ltab[:tables.n_lights, 0].tolist()]
        per_bounce += (OPS["mis_bounce"] - OPS["path_bounce"]
                       + OPS["light_pick"] * (len(kinds) - 1)
                       + sum(OPS["light_sample"][k] + OPS["light_pdf"][k]
                             for k in kinds))
    return (bounces * per_bounce + spheres * OPS["sphere"]
            + boxes * OPS["box"] + box_rows * OPS["box_row"]
            + media * OPS["medium"] + noise * OPS["noise"]
            + texels * OPS["texel"] + quads * OPS["quad"])


def _work(work) -> dict:
    """The work counters by name (ops/megakernel.py WORK_NAMES)."""
    from rustraytrace_tpu_torch.ops.megakernel import WORK_NAMES

    return dict(zip(WORK_NAMES, (int(v) for v in work.tolist())))


def _mk_profile(kind: str, tables, seed: int, spp: int, depth: int, *,
                reps: int, **kw) -> dict:
    """K3 (``kind`` "megakernel") or K4 ("mono") on ``tables`` (``kw``:
    the launch's other arguments): device ms of the timed instance over
    ``reps`` launches, then one launch of the counting instance: its work, bound,
    the SIMT efficiency of its leaf scans (sphere_rows / (32 x
    warp_sphere_rows)), its lane-use share (lane_steps / (32 x
    warp_iters)) and, from each warp's start and finish, its tail share
    (``megakernel.tail_share``)."""
    import torch

    from rustraytrace_tpu_torch.ops import megakernel as mk

    fn = mk.respawn_pass if kind == "megakernel" else mk.mono_pass
    ms = _cuda_ms(lambda: fn(tables, seed, 0, spp, depth, **kw), reps)
    dev = tables.geom.device
    work = torch.zeros(len(mk.WORK_NAMES), dtype=torch.int64, device=dev)
    wt = mk.warp_times_buffer(tables.n_lanes, dev)
    fn(tables, seed, 0, spp, depth, work=work, warp_times=wt, **kw)
    w = _work(work)
    bound, by = _bound(_path_ops(work, tables), tables.n_lanes * 3 * 4)
    return dict(ms=ms, bound=bound, by=by, work=w,
                simt=(w["sphere_rows"] / (32 * w["warp_sphere_rows"])
                      if w["warp_sphere_rows"] else None),
                lane_use=w["lane_steps"] / max(32 * w["warp_iters"], 1),
                **mk.tail_share(wt))


def _cuda_ms_once(fn):
    """(fn(), device milliseconds of that one call)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _agreement(img: np.ndarray, ref: np.ndarray):
    """(max |channel-mean diff|, max |z| of 4x4 block means): each block's
    standard error from the spread of its per-pixel differences."""
    h, w = img.shape[:2]
    diff = img - ref
    zs = []
    for by in np.array_split(np.arange(h), 4):
        for bx in np.array_split(np.arange(w), 4):
            blk = diff[by[0]:by[-1] + 1, bx[0]:bx[-1] + 1].reshape(-1, 3)
            se = blk.std(axis=0, ddof=1) / np.sqrt(blk.shape[0])
            zs.append(np.abs(blk.mean(axis=0)) / np.maximum(se, 1e-12))
    return float(np.abs(diff.mean(axis=(0, 1))).max()), float(np.max(zs))


def _field_scene(n: int, seed: int):
    """n small spheres scattered over the flagship's ground sphere."""
    from rustraytrace_tpu_torch import SceneBuilder

    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian((0.5, 0.5, 0.5)))
    mat = b.lambertian((0.4, 0.2, 0.1))
    for x, z, r in zip(rng.uniform(-15, 15, n), rng.uniform(-15, 15, n),
                       rng.uniform(0.1, 0.3, n)):
        b.add_sphere((float(x), float(r), float(z)), float(r), mat)
    return b.build()


def _torch_scenes():
    """The synthetic scenes the port's tests share (tests/torch_scenes.py
    of this checkout), loaded by path: a package named ``tests`` elsewhere
    on the path would shadow the directory."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_scenes.py")
    spec = importlib.util.spec_from_file_location("torch_scenes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _registers(log: str) -> dict:
    """Kernel instance -> 'N regs, S B spill' from the ptxas -v build log.
    The path kernels' instances are named <integrator, features, count>:
    ``path`` or ``mis`` (the segment kernel is ``path`` only); ``book2``
    for the motion, box, media and texture code, ``base`` without it;
    ``count`` for the work-counting instances, which no timed launch
    runs; the megakernels' and the segment kernel's ``coop`` instances
    (``megakernel.cluster_cull``) and the per-lane ``lane`` ones.  The
    scalar S1 kernel's instances are named by their lanes a ray."""
    out, name, spill = {}, None, "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            base = next((k for k in ("persist_kernel", "respawn_kernel",
                                     "mono_kernel", "segment_kernel",
                                     "sphere_hit_kernel", "dense_hit_kernel",
                                     "dense_merge_kernel",
                                     "scalar_hit_kernel") if k in mangled),
                        mangled)
            # template flags: "ILb0ELb1ELb0E" -> [False, True, False]
            flags = [f == "1" for f in re.findall(r"Lb([01])E", mangled)]
            if len(flags) == 1 and base == "sphere_hit_kernel":
                base += "<moving>" if flags[0] else "<static>"
            elif len(flags) == 1:  # dense_hit_kernel<HIGHEST>
                base += "<highest>" if flags[0] else "<default>"
            if base == "segment_kernel":  # <BOOK2, COUNT, COOP>
                flags = [False] + flags
            lanes = re.findall(r"ILi(\d+)E", mangled)
            if base == "scalar_hit_kernel" and lanes:  # <K lanes a ray>
                base += f"<{lanes[0]}>"
            if len(flags) >= 3:  # <MIS, BOOK2, COUNT[, COOP]>
                mis, book2, count = flags[:3]
                coop = "" if len(flags) == 3 else (
                    ", coop" if flags[3] else ", lane")
                base += (f"<{'mis' if mis else 'path'}, "
                         f"{'book2' if book2 else 'base'}"
                         f"{', count' if count else ''}{coop}>")
            name = base
        elif "spill stores" in ln:
            spill = ln.split("bytes spill stores")[0].split(",")[-1].strip()
        elif "registers" in ln and name:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out[name] = f"{regs} regs, {spill} B spill"
            name = None
    return out


def _mis_book2_scene():
    """A small MIS scene with every Book-2 feature the MIS kernels take: a
    checkered ground, a Perlin-marble sphere, a moving sphere, a metal box
    and a quad light that is also the NEE light."""
    from rustraytrace_tpu_torch import RenderConfig, SceneBuilder

    b = SceneBuilder()
    b.add_sphere((0, -1000, 0), 1000, b.lambertian(
        tex=b.checker(0.5, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
    b.add_sphere((0, 1, 0), 1, b.lambertian(tex=b.noise(4.0)))
    b.add_sphere((-2.5, 0.6, 1), 0.6, b.lambertian((0.7, 0.3, 0.1)),
                 center2=(-2.5, 1.1, 1))
    b.add_box((1.5, 0, -1), (2.5, 1.2, 0), b.metal((0.8, 0.8, 0.9), 0.2))
    b.add_quad((-1, 4, -1), (2, 0, 0), (0, 0, 2),
               b.diffuse_light((6, 6, 6)))
    b.add_light_quad((-1, 4, -1), (2, 0, 0), (0, 0, 2))
    cfg = RenderConfig(aspect_ratio=1.0, image_width=320,
                       samples_per_pixel=4, max_depth=12, vfov=40.0,
                       lookfrom=(0, 2, 8), lookat=(0, 0.8, 0),
                       background=(0.1, 0.1, 0.15), stratified=True)
    return b.build(), cfg


def _route_tables(scene, cam, cfg, integ, dev):
    """(tables, route) as ``render_pass_wavefront`` prepares them for a
    render of cfg: route 'image', 'sorted' (both K2) or 'k3'."""
    from rustraytrace_tpu_torch.ops import megakernel as mk
    from rustraytrace_tpu_torch.ops import wavefront as wf

    w, h = cfg.image_width, cfg.image_height
    if "image" in scene.features:
        route, rows = "image", wf.wavefront_tile_rows(scene)
    else:
        route = "sorted" if wf.sorted_persist_route(scene, w, h) else "k3"
        rows = mk.respawn_tile_rows(scene)
    n = int(np.sqrt(cfg.samples_per_pixel)) if cfg.stratified else 0
    return mk.prepare_megakernel(
        scene, cam, width=w, height=h, tile_rows=rows, mis=integ == "mis",
        stratified=cfg.stratified, sqrt_spp=n, device=dev), route


class _Stop(Exception):
    """Ends a pass at the launch ``_k2_main_launch`` takes."""


def _k2_main_launch(scene, cfg, integ, dev, launch, *, spp=None):
    """The input of K2's launch ``launch`` (from 1) in the main path's
    first pass: ``render.render_pass``'s call of
    ``wavefront.render_pass_wavefront`` at the pass's samples (``spp``, by
    default those of ``render_image``'s first pass of ``cfg``), driven with
    a step that runs K2 for the launches before ``launch`` and stops the
    pass there.  Returns (tables, seed, state, slot, launch arguments),
    copies of what the loop hands that launch."""
    from rustraytrace_tpu_torch import render
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import wavefront as wf

    w, h = cfg.image_width, cfg.image_height
    stratified = cfg.stratified
    sqrt_spp = int(np.sqrt(cfg.samples_per_pixel)) if stratified else 0
    if spp is None:
        total = sqrt_spp * sqrt_spp if stratified else cfg.samples_per_pixel
        spp = min(total, render.effective_spp_per_pass(
            cfg, render.resolve_backend(scene, integ, "auto", dev), total,
            w * h))
    got = []

    def step(state, slot, tables, seed, **kw):
        if len(got) + 1 == launch:
            tb = kw["tile_bounds"]
            got.append((tables, seed, state.clone(), slot.clone(), dict(
                kw, tile_bounds=None if tb is None else tb.clone())))
            raise _Stop
        got.append(None)
        wf.persist_step(state, slot, tables, seed, **kw)

    try:
        wf.render_pass_wavefront(
            scene, derive_camera(cfg, device=dev), cfg.seed, width=w,
            height=h, spp=spp, max_depth=cfg.max_depth,
            mis=integ == "mis", stratified=stratified, sqrt_spp=sqrt_spp,
            step=step, device=dev)
    except _Stop:
        return got[-1]
    raise RuntimeError(f"the pass made {len(got)} K2 launches, fewer than "
                       f"{launch}")


def _k2_launch_ms(loop, *, reps) -> float:
    """Mean device ms of the K2 launch ``loop`` (``_k2_main_launch``) over
    ``reps`` launches, each from a fresh copy of the state, after one
    warm-up."""
    import torch

    from rustraytrace_tpu_torch.ops import wavefront as wf

    tables, seed, state, slot, kw = loop
    copies = [state.clone() for _ in range(reps + 1)]
    wf.persist_step(copies[0], slot, tables, seed, **kw)
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for (a, b), st in zip(evs, copies[1:]):
        a.record()
        wf.persist_step(st, slot, tables, seed, **kw)
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / reps


def _k2_launch(loop, *, reps, plain_iters=8):
    """The K2 launch ``loop`` (``_k2_main_launch``): its mean device ms
    over ``reps`` launches, each from a fresh copy of the state; the work
    the COUNT instance counts from the same state, the bound from it and
    the SIMT efficiency of the leaf scans (sphere rows / (32 x the rows
    warps issue)); whether ``plain_iters`` iterations of the kernel equal
    as many of ``persist_step_plain`` bitwise from the same state, and the
    plain twin's ms for them."""
    import torch

    from rustraytrace_tpu_torch.ops import megakernel as mk
    from rustraytrace_tpu_torch.ops import wavefront as wf

    tables, seed, state, slot, kw = loop
    tb = kw["tile_bounds"]
    ms = _k2_launch_ms(loop, reps=reps)
    work = torch.zeros(len(mk.WORK_NAMES), dtype=torch.int64,
                       device=state.device)
    wf.persist_step(state.clone(), slot, tables, seed, work=work, **kw)
    w = _work(work)
    # state read and written once, the slot and the tile bounds read once
    nbytes = state.numel() * 8 + slot.numel() * 4 + (
        0 if tb is None else tb.numel() * 4)
    bound, by = _bound(_path_ops(work, tables), nbytes)
    out = dict(ms=ms, work=w, bound=bound, by=by, simt=w["sphere_rows"] / max(
        32 * w["warp_sphere_rows"], 1))
    k, p = state.clone(), state.clone()
    kwp = dict(kw, persist_iters=plain_iters)
    wf.persist_step(k, slot, tables, seed, **kwp)
    _, out["plain_ms"] = _cuda_ms_once(
        lambda: wf.persist_step_plain(p, slot, tables, seed, **kwp))
    out["equal"] = bool(torch.equal(k, p))
    out["err"] = torch.abs(k - p).max().item()
    return out


def _k1_route_args(dev):
    """The arguments of K1's first launch on the sphere_kernel flagship
    (1200x675, 16 spp in one pass and one chunk): the pass's first-bounce
    rays, 12,960,000 of them padded to the chunk, x 487 spheres."""
    from rustraytrace_tpu_torch import models, render
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import hit

    scene, cfg, _ = models.book1_random_spheres(dict(
        image_width=1200, samples_per_pixel=16, max_depth=50))
    seen = []

    def record(*args):
        seen.append(args)
        return hit.sphere_hit(*args)

    render._render_pass_reference(
        scene, derive_camera(cfg, device=dev), cfg.seed, width=1200,
        height=cfg.image_height, spp=16, max_depth=1, chunk=1 << 20,
        backend="sphere_kernel", hit_fn=record, device=dev)
    return seen[0]


def _k1_cases(dev) -> dict:
    """K1 against its twin on the cases its ring and ray groups must get
    right: a table of ten ring tiles (sphere_field_10k), moving spheres,
    quads, ray counts that are no multiple of a block's 512 rays, and
    exact ties (the flagship table twice: the first copy must win).
    Returns {case: (t and idx bitwise equal, max |dt|)}."""
    import torch

    from rustraytrace_tpu_torch import models
    from rustraytrace_tpu_torch.ops import hit

    out = {}
    flag = hit.pack_sphere_table(models.book1_random_spheres()[0]).to(dev)
    none = torch.zeros((0, hit.Q_COLS), dtype=torch.float32, device=dev)
    for case in ("tiles", "moving", "quads", "ragged", "ties"):
        n = 65537 if case == "ragged" else 1 << 18
        o, d, tm = (torch.from_numpy(x).to(dev) for x in _rays(n, 11))
        sph, quad, moving = flag, none, False
        if case == "tiles":
            sph = hit.pack_sphere_table(
                models.sphere_field_10k()[0]).to(dev)
        elif case == "moving":
            sph = hit.pack_sphere_table(
                models.book2_bouncing_spheres()[0]).to(dev)
            moving = True
        elif case == "quads":
            scene = models.book2_cornell_smoke()[0]
            sph = hit.pack_sphere_table(scene).to(dev)
            quad = hit.pack_quad_table(scene).to(dev)
            rng = np.random.default_rng(11)
            ob = rng.uniform(-50, 50, (n, 3)) + np.array([278, 278, -800])
            db = rng.uniform(0, 555, (n, 3)) - ob
            o, d = (torch.from_numpy(x.astype(np.float32)).to(dev)
                    for x in (ob, db))
        elif case == "ties":
            sph = torch.cat([flag, flag])
        tk, ik = hit.sphere_hit(o, d, tm, sph, quad, moving)
        tp, ip = hit.sphere_hit_plain(o, d, tm, sph, quad, moving)
        eq = bool(torch.equal(tk, tp) and torch.equal(ik, ip))
        if case == "ties":
            eq = eq and int(ik.max()) < flag.shape[0]
        if case == "quads":
            eq = eq and int((ik >= sph.shape[0]).sum()) > 0
        out[case] = (eq, torch.abs(tk - tp).max().item(), n, sph.shape[0],
                     quad.shape[0])
    return out


def _kernel_vs_plain(tables, route, seed, spp, depth, iters=8):
    """(bitwise equal, max |diff|) of the route's kernel and its plain twin
    at the tables' full lanes: one K3 pass of spp, or one K2 launch of
    iters iterations."""
    import torch

    from rustraytrace_tpu_torch.ops import megakernel as mk
    from rustraytrace_tpu_torch.ops import wavefront as wf

    if route == "k3":
        k = mk.respawn_pass(tables, seed, 0, spp, depth)
        p = mk.respawn_pass_plain(tables, seed, 0, spp, depth)
    else:
        dev = tables.geom.device
        R = tables.n_lanes
        k = torch.zeros((wf.N_STATE, R), dtype=torch.float32, device=dev)
        p = k.clone()
        sl = torch.arange(R, dtype=torch.int32, device=dev)
        kw = dict(persist_iters=iters, spp=spp, max_depth=depth)
        wf.persist_step(k, sl, tables, seed, **kw)
        wf.persist_step_plain(p, sl, tables, seed, **kw)
    torch.cuda.synchronize()
    return bool(torch.equal(k, p)), torch.abs(k - p).max().item()


def _phase9(dev) -> dict:
    """The Book-2 slice: the final scene's K2 launch against its twin, the
    launch-loop invariance, the main path through ``render_image``, a
    scene-9 pass, every other new scene at its own config, and a synthetic
    MIS scene with the Book-2 features.  Returns the numbers of the
    kernels line."""
    import torch

    from rustraytrace_tpu_torch import models, render
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import _cuda, megakernel as mk
    from rustraytrace_tpu_torch.ops import wavefront as wf

    img, src = models.earthmap()
    print(f"[9 earthmap] source {src}, image {img.shape}", flush=True)
    s9, c9, i9 = models.get_scene("the_next_week")
    w9, h9, spp9, d9, seed9 = (c9.image_width, c9.image_height,
                               c9.samples_per_pixel, c9.max_depth, c9.seed)
    _check((w9, h9, spp9, d9, i9) == (400, 400, 250, 4, "path"),
           "the_next_week is not the 400x400 250 spp depth-4 final scene")
    cam9 = derive_camera(c9, device=dev)
    tab9, route9 = _route_tables(s9, cam9, c9, i9, dev)
    sort9 = wf.ray_sort_heuristic(s9, wf.slot_lane_count(w9, h9))
    iters9 = wf.image_route_iters(s9, sort9)
    bounds9 = wf.persist_adaptive_bounds(iters9)
    _check(route9 == "image" and sort9 and iters9 == 8
           and bounds9 == (4, 8, 0.25), "the final scene's route")

    # one K2 launch at the main path's full lanes, bounded per tile
    R9, tl9 = tab9.n_lanes, tab9.tile_rows * 128
    sl9 = torch.arange(R9, dtype=torch.int32, device=dev)
    tb9 = torch.full((R9 // tl9,), iters9, dtype=torch.int32, device=dev)
    kw9 = dict(persist_iters=iters9, spp=spp9, max_depth=d9,
               tile_bounds=tb9, tile_lanes=tl9)
    st_k = torch.zeros((wf.N_STATE, R9), dtype=torch.float32, device=dev)
    st_p = st_k.clone()
    wf.persist_step(st_k, sl9, tab9, seed9, **kw9)
    _, k2_plain_ms = _cuda_ms_once(
        lambda: wf.persist_step_plain(st_p, sl9, tab9, seed9, **kw9))
    k2_equal = bool(torch.equal(st_k, st_p))
    k2_err = torch.abs(st_k - st_p).max().item()
    rows = [wf._NAMES[k] for k in range(wf.N_STATE)
            if not torch.equal(st_k[k], st_p[k])]
    k2_ms = _cuda_ms(lambda: wf.persist_step(
        torch.zeros((wf.N_STATE, R9), device=dev), sl9, tab9, seed9, **kw9),
        10)
    work9 = torch.zeros(len(mk.WORK_NAMES), dtype=torch.int64, device=dev)
    wf.persist_step(torch.zeros((wf.N_STATE, R9), device=dev), sl9, tab9,
                    seed9, work=work9, **kw9)
    # state read and written once, the slot and the tile bounds read once
    k2_bound, k2_by = _bound(_path_ops(work9, tab9),
                             R9 * (2 * wf.N_STATE + 1) * 4 + tb9.numel() * 4)
    print(f"[9 K2 launch] the_next_week {R9} lanes x {iters9} iterations "
          f"({tab9.n_sclusters} super-clusters ({tab9.n_ssc_static} static) "
          f"of {tab9.n_clusters} clusters, {tab9.n_boxes} box rows in "
          f"{tab9.n_bclusters} clusters, {tab9.n_quads} quad, "
          f"{tab9.n_media} media): kernel vs plain max |diff| {k2_err:.3g}, "
          f"rows differing {rows}, bitwise equal (required): {k2_equal}; "
          f"kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.1f} ms; work "
          f"{_work(work9)}, bound {k2_bound:.4f} ms ({k2_by})", flush=True)
    _check(k2_equal, "K2 disagrees with its plain step on the final scene")

    # the main path's own launch: launch 119 of 237, from the state and
    # tile bounds of the sorted loop's first 118
    k2m = _k2_launch(_k2_main_launch(s9, c9, i9, dev, 119), reps=10)
    print(f"[9 K2 mid-loop launch] the_next_week launch 119 of 237 with its "
          f"tile bounds: "
          f"kernel {k2m['ms']:.4f} ms; work {k2m['work']}, bound "
          f"{k2m['bound']:.4f} ms ({k2m['by']}), SIMT efficiency "
          f"{k2m['simt']:.4f}; 8 iterations vs plain ({k2m['plain_ms']:.1f} "
          f"ms): max |diff| {k2m['err']:.3g}, bitwise equal (required): "
          f"{k2m['equal']}", flush=True)
    _check(k2m["equal"],
           "K2 disagrees with its plain step mid-loop on the final scene")

    # the launch loop: adaptive sorted == uniform unsorted == K3, 2 spp
    kwa = dict(spp=2, max_depth=d9, persist_iters=iters9)
    adaptive = wf._wavefront_pass_persist(
        tab9, seed9, 0, sort_rays=True, sort_every=wf.persist_sort_every(8),
        adaptive_bounds=bounds9, **kwa)
    uniform = wf._wavefront_pass_persist(tab9, seed9, 0, sort_rays=False,
                                         **kwa)
    k3_final = mk.respawn_pass(tab9, seed9, 0, 2, d9)
    inv_equal = bool(torch.equal(adaptive, uniform)
                     and torch.equal(k3_final, uniform))
    k3f_ms = _cuda_ms(lambda: mk.respawn_pass(tab9, seed9, 0, 2, d9), 5)
    work3 = torch.zeros(len(mk.WORK_NAMES), dtype=torch.int64, device=dev)
    mk.respawn_pass(tab9, seed9, 0, 2, d9, work=work3)
    k3f_bound, k3f_by = _bound(_path_ops(work3, tab9), R9 * 3 * 4)
    print(f"[9 invariance] the_next_week {R9} lanes x 2 spp: sorted with "
          f"tile bounds {bounds9} == unsorted uniform == K3, bitwise "
          f"(required): {inv_equal}; K3 there {k3f_ms:.3f} ms, bound "
          f"{k3f_bound:.4f} ms ({k3f_by})", flush=True)
    _check(inv_equal, "the final scene's sums depend on sort, bounds or "
           "kernel")

    # ---- the main path: render_image on the card
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img9, st9 = render.render_image(s9, c9, integrator=i9, device=dev)
    torch.cuda.synchronize()
    wall9 = time.perf_counter() - t0
    counts9 = _cuda.launch_counts()
    acc9 = st9["accum"] / st9["spp_done"]
    print(f"[9 the_next_week] {w9}x{h9} {spp9} spp depth {d9} through "
          f"render_image (image route, sorted K2, tile bounds {bounds9}): "
          f"{wall9:.3f} s, {w9 * h9 * spp9 / wall9:.6g} paths/s; kernel "
          f"launch counts {counts9}", flush=True)
    _check(counts9["persist"] > 0 and counts9["megakernel"] == 0,
           "the main path did not run the persist kernel alone")
    _check(st9["spp_done"] == spp9 and img9.shape == (h9, w9, 3)
           and bool(np.isfinite(acc9).all()), "the final scene's image")
    stats9: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render.render_pass(s9, cam9, seed9, width=w9, height=h9, spp=spp9,
                       max_depth=d9, device=dev, stats=stats9)
    torch.cuda.synchronize()
    warm9 = time.perf_counter() - t0
    plain9 = render.render_pass(s9, cam9, seed9, width=w9, height=h9, spp=4,
                                max_depth=d9, backend="plain",
                                device=dev).cpu().numpy()
    ch9, z9 = _agreement(acc9, plain9 / 4.0)
    print(f"[9 the_next_week check] warm render_pass {warm9:.3f} s, "
          f"{w9 * h9 * spp9 / warm9:.6g} paths/s, {stats9['launches']} "
          f"launches, {stats9.get('sorts')} sorts; {spp9} spp kernel vs 4 spp "
          f"plain: channel mean |diff| {ch9:.4g}, 4x4 block max |z| "
          f"{z9:.3f} (need < 5)", flush=True)
    _check(z9 < 5.0, "the final scene's image is off")

    # ---- scene 9: one pass of 104 spp at 800x800, depth 40
    sN, cN, _ = models.get_scene("the_next_week", scene_num=9)
    wN, hN = cN.image_width, cN.image_height
    perN = render.effective_spp_per_pass(cN, "wavefront",
                                         cN.samples_per_pixel, wN * hN)
    camN = derive_camera(cN, device=dev)
    _cuda.reset_launch_counts()
    statsN: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    accN = render.render_pass(sN, camN, cN.seed, width=wN, height=hN,
                              spp=perN, max_depth=cN.max_depth, device=dev,
                              stats=statsN)
    torch.cuda.synchronize()
    wallN = time.perf_counter() - t0
    countsN = _cuda.launch_counts()
    print(f"[9 scene 9] {wN}x{hN} one pass of {perN} spp depth "
          f"{cN.max_depth}: {wallN:.3f} s, {wN * hN * perN / wallN:.6g} "
          f"paths/s, {statsN['launches']} launches; kernel launch counts "
          f"{countsN}", flush=True)
    _check(perN == 104 and countsN["persist"] == statsN["launches"] > 0
           and bool(torch.isfinite(accN).all()), "scene 9's pass")

    # ---- every other new scene at its own config, kernel vs plain twin
    errs = {"the_next_week": k2_err}
    k3_cells: dict = {}
    for name in ("book2_bouncing_spheres", "book2_earth",
                 "book2_checkered_spheres", "book2_perlin_spheres",
                 "book2_simple_light", "book2_cornell_smoke",
                 "sphere_field_10k"):
        sc, cf, ig = models.get_scene(name)
        cw, ch = cf.image_width, cf.image_height
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, st = render.render_image(sc, cf, integrator=ig, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cnt = _cuda.launch_counts()
        tab, route = _route_tables(sc, derive_camera(cf, device=dev), cf, ig,
                                   dev)
        spp_chk = 1 if route == "k3" else 2
        iters = 2 if name == "sphere_field_10k" else 8
        eq, err = _kernel_vs_plain(tab, route, cf.seed, spp_chk,
                                   cf.max_depth, iters)
        if name == "sphere_field_10k":
            # 10,001 spheres under the two-level cull, at the main
            # path's third launch
            loop10 = _k2_main_launch(sc, cf, ig, dev, 3)
            it10 = loop10[4]["persist_iters"]
            k10 = _k2_launch(loop10, reps=3, plain_iters=2)
            del loop10
            print(f"[9 sphere_field_10k K2 launch 3] {tab.n_lanes} lanes x "
                  f"{it10} iterations ({tab.n_sclusters} super-clusters of "
                  f"{tab.n_clusters} clusters): kernel {k10['ms']:.3f} "
                  f"ms, bound {k10['bound']:.4f} ms ({k10['by']}), SIMT "
                  f"efficiency {k10['simt']:.4f}; 2 iterations vs plain: "
                  f"bitwise equal (required): {k10['equal']}", flush=True)
            _check(k10["equal"], "K2 on sphere_field_10k's third launch")
            err = max(err, k10["err"])
        errs[name] = err
        if route == "k3" and name in K3_CELLS_400:
            p = _mk_profile("megakernel", tab, cf.seed, cf.samples_per_pixel,
                            cf.max_depth, reps=3)
            k3_cells[name] = {k: p[k] for k in ("ms", "bound", "by",
                                                "lane_use", "tail_share")}
            print(f"[9 {name} K3] {tab.n_lanes} lanes x "
                  f"{cf.samples_per_pixel} spp: kernel {p['ms']:.3f} ms, "
                  f"bound {p['bound']:.4f} ms ({p['by']}), lane-use share "
                  f"{p['lane_use']:.4f}, tail share {p['tail_share']:.4f}",
                  flush=True)
        acc = st["accum"] / st["spp_done"]
        kern = "megakernel" if route == "k3" else "persist"
        what = ("1 spp K3 pass" if route == "k3"
                else f"K2 launch of {iters} iterations at 2 spp")
        print(f"[9 {name}] {cw}x{ch} {st['spp_done']} spp depth "
              f"{cf.max_depth} ({route}): {wall:.3f} s, "
              f"{cw * ch * st['spp_done'] / wall:.6g} paths/s; launch "
              f"counts {cnt}; same-seed {tab.n_lanes} lanes {what}: kernel "
              f"vs plain max |diff| {err:.3g}, bitwise equal (required): "
              f"{eq}", flush=True)
        _check(cnt[kern] > 0 and sum(cnt.values()) == cnt[kern],
               f"{name} did not run its route's kernel alone")
        _check(eq, f"kernel and plain twin differ on {name}")
        _check(bool(np.isfinite(acc).all()) and acc.mean() > 0.01,
               f"{name} image")

    # ---- a synthetic MIS scene with the Book-2 features, K2 and K3
    sm, cm = _mis_book2_scene()
    tabm, _ = _route_tables(sm, derive_camera(cm, device=dev), cm, "mis",
                            dev)
    _check(tabm.book2 and tabm.mis and tabm.moving and tabm.n_boxes > 0
           and tabm.has_checker and tabm.has_noise, "the MIS scene's tables")
    eqm2, errm2 = _kernel_vs_plain(tabm, "sorted", 5, 4, cm.max_depth)
    eqm3, errm3 = _kernel_vs_plain(tabm, "k3", 5, 4, cm.max_depth)
    errs["mis_book2"] = max(errm2, errm3)
    print(f"[9 MIS + Book-2] checker, Perlin, moving sphere, box, quad "
          f"light, {tabm.n_lanes} lanes x 4 spp (2x2 strata): K2 launch and "
          f"K3 pass vs plain max |diff| {errm2:.3g} / {errm3:.3g}, bitwise "
          f"equal (required): {eqm2} / {eqm3}", flush=True)
    _check(eqm2 and eqm3, "kernels and plain twin differ on the MIS scene")
    return dict(k2_launches=counts9["persist"], k2_err=max(errs.values()),
                errs=errs, k2_ms=k2m["ms"], k2_plain_ms=k2m["plain_ms"],
                k2_bound=k2m["bound"], k2_by=k2m["by"], k2_simt=k2m["simt"],
                k2_zero_ms=k2_ms, k2_zero_plain_ms=k2_plain_ms,
                k2_zero_bound=k2_bound, R9=R9, iters9=iters9,
                k3f_ms=k3f_ms, k3f_bound=k3f_bound, k3f_by=k3f_by,
                k3_cells=k3_cells,
                k2_work=k2m["work"], k3f_work=_work(work3),
                paths_per_s=w9 * h9 * spp9 / wall9, scene=s9, cfg=c9,
                cam=cam9, tables=tab9, accum=st9["accum"], plain4=plain9,
                uniform2=uniform, k3_2=k3_final)


def _phase10(dev, p7: dict) -> dict:
    """K4, the monolithic megakernel: the Book-3 Cornell box through
    ``render_pass_megakernel`` at its full configuration, bitwise equal to
    phase 7's K3 render; K4 == K3 at full lanes x 4 spp; K4 == its twin at
    2 spp; the Book-2 instance on the Cornell smoke at its own
    configuration (K4 == K3 at 200 spp, == twin at 1 spp).  Returns the
    numbers of the kernels line."""
    import torch

    from rustraytrace_tpu_torch import models
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import _cuda, megakernel as mk

    s7, c7, cam7, tab = p7["scene"], p7["cfg"], p7["cam"], p7["tables"]
    seed, off, R = c7.seed, p7["off"], tab.n_lanes
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = mk.render_pass_megakernel(
        s7, cam7, seed, width=600, height=600, spp=100, max_depth=50,
        mis=True, stratified=True, sqrt_spp=10, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    img = img.cpu().numpy()
    eq_main = bool(np.array_equal(img, p7["accum"]))
    ch, z = _agreement(img / 100.0, p7["plain4"] / 4.0)
    print(f"[10 K4 book3_cornell_box] 600x600 100 spp (10x10 strata) depth "
          f"50 MIS through render_pass_megakernel (respawn=False): "
          f"{wall:.3f} s, {600 * 600 * 100 / wall:.6g} paths/s; kernel "
          f"launch counts {counts}; image == phase 7's K3 render_image "
          f"bitwise (required): {eq_main}; vs 4 spp plain: channel mean "
          f"|diff| {ch:.4g}, 4x4 block max |z| {z:.3f} (need < 5)",
          flush=True)
    _check(counts["mono"] == 1 and sum(counts.values()) == 1,
           "the Book-3 K4 path did not run one K4 launch alone")
    _check(eq_main and z < 5.0, "K4's Book-3 image differs from K3's")

    k4_4 = mk.mono_pass(tab, seed, off, 4, 50)
    eq_k3 = bool(torch.equal(k4_4, p7["k3_sums"]))
    k4_2 = mk.mono_pass(tab, seed, off, 2, 50)
    p4_2, plain_ms = _cuda_ms_once(
        lambda: mk.mono_pass_plain(tab, seed, off, 2, 50))
    eq_tw = bool(torch.equal(k4_2, p4_2))
    err = torch.abs(k4_2 - p4_2).max().item()
    k4p = _mk_profile("mono", tab, seed, 100, 50, reps=2)
    ms, bound, by = k4p["ms"], k4p["bound"], k4p["by"]
    regs = {k: v for k, v in p7["regs"].items() if k.startswith("mono")}
    print(f"[10 K4 check] {R} lanes: K4 == K3 at 4 spp (samples {off}-"
          f"{off + 3}) bitwise (required): {eq_k3}; K4 vs plain twin at 2 "
          f"spp max |diff| {err:.3g}, bitwise equal (required): {eq_tw}; "
          f"K4 {ms:.2f} ms at 100 spp (K3 {p7['k3_ms']:.2f} ms, ratio "
          f"{ms / p7['k3_ms']:.3f}); plain twin {plain_ms:.1f} ms at 2 spp;"
          f" work {k4p['work']}, bound {bound:.3f} ms ({by}); lane-use "
          f"share {k4p['lane_use']:.4f} (the per-sample lockstep), tail "
          f"share {k4p['tail_share']:.4f}; registers {regs}", flush=True)
    _check(eq_k3 and eq_tw, "K4 differs from K3 or from its plain twin")

    sS, cS, _ = models.book2_cornell_smoke()
    wS, hS, sppS, dS = (cS.image_width, cS.image_height,
                        cS.samples_per_pixel, cS.max_depth)
    tabS = mk.prepare_megakernel_cached(
        sS, derive_camera(cS, device=dev), width=wS, height=hS,
        tile_rows=mk.respawn_tile_rows(sS), device=dev)
    k4S, k4S_ms = _cuda_ms_once(lambda: mk.mono_pass(tabS, cS.seed, 0,
                                                     sppS, dS))
    k3S, k3S_ms = _cuda_ms_once(lambda: mk.respawn_pass(tabS, cS.seed, 0,
                                                        sppS, dS))
    eqS = bool(torch.equal(k4S, k3S))
    k1 = mk.mono_pass(tabS, cS.seed, 0, 1, dS)
    p1 = mk.mono_pass_plain(tabS, cS.seed, 0, 1, dS)
    eqS1, errS = bool(torch.equal(k1, p1)), torch.abs(k1 - p1).max().item()
    print(f"[10 K4 book2_cornell_smoke] {wS}x{hS} {sppS} spp depth {dS} "
          f"(Book-2 instance, {tabS.n_lanes} lanes): K4 {k4S_ms:.2f} ms, "
          f"K3 {k3S_ms:.2f} ms (ratio {k4S_ms / k3S_ms:.3f}); K4 == K3 "
          f"bitwise (required): {eqS}; 1 spp K4 vs plain twin max |diff| "
          f"{errS:.3g}, bitwise equal (required): {eqS1}", flush=True)
    _check(eqS and eqS1, "K4 differs on the Cornell smoke")
    return dict(launches=counts["mono"], err=max(err, errS), ms=ms,
                plain_ms=plain_ms, bound=bound, by=by, work=k4p["work"],
                lane_use=k4p["lane_use"], tail=k4p["tail_share"], regs=regs,
                R=R, smoke_ms=k4S_ms, smoke_k3_ms=k3S_ms,
                paths_per_s=600 * 600 * 100 / wall)


def _queued_ms(launches: list) -> float:
    """Mean device milliseconds of a list of calls, each one kernel
    launch, queued behind a ~0.1 s device sleep so that the host's launch
    overhead does not open gaps between them."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start.record()
    for fn in launches:
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(launches)


def _k5_vs_twin(tab, seed: int, *, spp: int, depth: int, segments: int):
    """K5 against its twin from the start of a pass (every lane at sample
    0), segment by segment: each segment's state, sums, done, sample index
    and alive count bitwise.  Returns (equal, max |diff| over the state
    and sums, plain ms of the first segment, lanes that died in the first
    segment, lanes that respawned, the sum of the banked radiance)."""
    import torch

    from rustraytrace_tpu_torch.ops import wavefront as wf

    kw = dict(spp=spp, max_depth=depth)
    kern = list(wf.segment_start(tab, seed, 0))
    plain = [t.clone() for t in kern]
    eq, err, plain_ms, died = True, 0.0, None, 0
    for g in range(segments):
        ak = torch.zeros(1, dtype=torch.int32, device=kern[0].device)
        ap = ak.clone()
        wf.segment_step(*kern, tab, seed, alive=ak, **kw)
        _, ms = _cuda_ms_once(lambda: wf.segment_step_plain(
            *plain, tab, seed, alive=ap, **kw))
        if g == 0:
            plain_ms, died = ms, int((plain[2] > 0).sum())
        eq = eq and all(torch.equal(k, p) for k, p in zip(kern, plain))
        eq = eq and bool(torch.equal(ak, ap))
        err = max(err, torch.abs(kern[0] - plain[0]).max().item(),
                  torch.abs(kern[1] - plain[1]).max().item())
    return (eq, err, plain_ms, died, int((kern[3] > 0).sum()),
            float(kern[1].sum()))


def _phase11(dev, r9: dict) -> dict:
    """K5, the fused segment kernel (one bounce, then the bank and respawn
    of the lanes that die in it): the final scene through
    ``render_pass_wavefront(per_bounce_segments=True)`` at its full
    configuration, bitwise equal to phase 9's persist-loop render, with
    its segments, kernel launches, host syncs (at most one a chunk, plus
    two) and wall; K5 vs its twin over the first six segments of a pass at
    the main path's lanes (the cooperative instance) and at earth's (the
    per-lane one), bitwise; one K5 launch timed at the first bounce, with
    the counting instance's bound; segmented == unsorted K2 == K3 at 2
    spp; earth at its own configuration, == its image-route pass.  Returns
    the numbers of the kernels line."""
    import torch

    from rustraytrace_tpu_torch import models, render
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import _cuda, megakernel as mk
    from rustraytrace_tpu_torch.ops import wavefront as wf

    s9, c9, cam9, tab = r9["scene"], r9["cfg"], r9["cam"], r9["tables"]
    w9, h9, spp9, d9, seed = (c9.image_width, c9.image_height,
                              c9.samples_per_pixel, c9.max_depth, c9.seed)

    def segmented(scene, cam, cfg):
        stats: dict = {}
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = wf.render_pass_wavefront(
            scene, cam, cfg.seed, width=cfg.image_width,
            height=cfg.image_height, spp=cfg.samples_per_pixel,
            max_depth=cfg.max_depth, per_bounce_segments=True, device=dev,
            stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        n = stats["launches"]
        _check(counts["segment"] == stats["kernel_launches"] >= n > 0
               and sum(counts.values()) == counts["segment"],
               "the segment path did not run K5 alone")
        _check(stats["host_syncs"] <= -(-n // stats["chunk"]) + 2,
               "the segment loop syncs more than once a chunk")
        return out, wall, stats, counts

    img, wall, stats, counts = segmented(s9, cam9, c9)
    img = img.cpu().numpy()
    eq_main = bool(np.array_equal(img, r9["accum"]))
    ch, z = _agreement(img / spp9, r9["plain4"] / 4.0)
    print(f"[11 K5 the_next_week] {w9}x{h9} {spp9} spp depth {d9} through "
          f"render_pass_wavefront(per_bounce_segments=True): {wall:.4f} s, "
          f"{w9 * h9 * spp9 / wall:.6g} paths/s; {stats['launches']} "
          f"segments, {stats['kernel_launches']} kernel launches, "
          f"{stats['host_syncs']} host syncs (chunks of {stats['chunk']}); "
          f"kernel launch counts {counts}; image == phase 9's persist "
          f"render bitwise (required): {eq_main}; vs 4 spp plain: channel "
          f"mean |diff| {ch:.4g}, 4x4 block max |z| {z:.3f} (need < 5)",
          flush=True)
    _check(eq_main and z < 5.0, "the segmented final scene is off")

    R = tab.n_lanes
    coop = mk.cluster_cull(tab)
    eq1, err, plain_ms, died, spawned, banked = _k5_vs_twin(
        tab, seed, spp=spp9, depth=d9, segments=6)
    kw = dict(spp=spp9, max_depth=d9)
    start = wf.segment_start(tab, seed, 0)
    copies = [[t.clone() for t in start] for _ in range(10)]
    alive = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = _queued_ms([lambda c=c: wf.segment_step(*c, tab, seed, alive=alive,
                                                 **kw) for c in copies])
    del copies
    work = torch.zeros(len(mk.WORK_NAMES), dtype=torch.int64, device=dev)
    wf.segment_step(*[t.clone() for t in start], tab, seed, work=work, **kw)
    live = int((start[0][wf.R_ALIVE] > 0).sum())
    # a live lane's 15 state words in and out and its sample index in; a
    # lane that dies its sums and count in and out and its sample index out
    bound, by = _bound(_path_ops(work, tab),
                       4 * (live * (2 * wf.N_SEG + 1) + died * 9))
    seg2 = wf._wavefront_pass_segments(tab, seed, 0, spp=2, max_depth=d9)
    eq2 = bool(torch.equal(seg2, r9["uniform2"])
               and torch.equal(seg2, r9["k3_2"]))
    print(f"[11 K5 check] {R} lanes, {'cooperative' if coop else 'per-lane'}"
          f" instance: six segments from the pass's start (lanes bank and "
          f"respawn: {died} bank in the first, {spawned} respawned after "
          f"six, banked sum {banked:.6g}) vs the twin, state, sums, count, "
          f"sample index and alive counts bitwise equal (required): {eq1}, "
          f"max |diff| {err:.3g}; one launch at the first bounce "
          f"{ms:.4f} ms, plain {plain_ms:.1f} ms; work {_work(work)}, bound "
          f"{bound:.4f} ms ({by}); 2 spp segmented == unsorted K2 == K3 "
          f"bitwise (required): {eq2}", flush=True)
    _check(coop, "the final scene should run K5's cooperative instance")
    _check(eq1 and eq2, "K5 differs from its twin or from K2 / K3")
    _check(died > 0 and spawned > 0 and banked > 0,
           "no lane banked and respawned in K5's six-segment check")

    sE, cE, _ = models.book2_earth()
    wE, hE, sppE, dE = (cE.image_width, cE.image_height,
                        cE.samples_per_pixel, cE.max_depth)
    camE = derive_camera(cE, device=dev)
    segE, wallE, statsE, countsE = segmented(sE, camE, cE)
    t0 = time.perf_counter()
    perE = render.render_pass(sE, camE, cE.seed, width=wE, height=hE,
                              spp=sppE, max_depth=dE, device=dev)
    torch.cuda.synchronize()
    wallP = time.perf_counter() - t0
    eqE = bool(torch.equal(segE, perE))
    tabE = mk.prepare_megakernel_cached(
        sE, camE, width=wE, height=hE, tile_rows=wf.wavefront_tile_rows(sE),
        device=dev)
    eqE1, errE, _, diedE, spawnedE, bankedE = _k5_vs_twin(
        tabE, cE.seed, spp=sppE, depth=dE, segments=6)
    print(f"[11 K5 book2_earth] {wE}x{hE} {sppE} spp depth {dE}: segmented "
          f"{wallE:.4f} s ({statsE['launches']} segments, "
          f"{statsE['kernel_launches']} kernel launches, "
          f"{statsE['host_syncs']} host syncs), image-route persist pass "
          f"{wallP:.4f} s; bitwise equal (required): {eqE}; "
          f"{'cooperative' if mk.cluster_cull(tabE) else 'per-lane'} "
          f"instance at {tabE.n_lanes} lanes, six segments vs the twin "
          f"({diedE} lanes bank in the first, {spawnedE} respawned after "
          f"six, banked sum {bankedE:.6g}) bitwise equal (required): "
          f"{eqE1}, max |diff| {errE:.3g}", flush=True)
    _check(not mk.cluster_cull(tabE), "earth should run the per-lane K5")
    _check(eqE and eqE1, "the segmented earth differs")
    _check(diedE > 0 and spawnedE > 0 and bankedE > 0,
           "no earth lane banked and respawned in K5's six-segment check")
    return dict(launches=counts["segment"], err=max(err, errE), ms=ms,
                plain_ms=plain_ms, bound=bound, by=by, work=_work(work),
                R=R, wall=wall, segments=stats["launches"],
                host_syncs=stats["host_syncs"], chunk=stats["chunk"],
                earth_s=wallE, earth_persist_s=wallP,
                earth_segments=statsE["launches"],
                paths_per_s=w9 * h9 * spp9 / wall)


def _phase12(dev) -> dict:
    """SAH quad clusters: 1,024 random quads with the camera inside the
    field (400x400, 64 spp, depth 8) through ``render.render_pass``; K3
    == the pass, the cull == the linear scan of every quad row, and K3 and
    a K2 launch == the plain twin."""
    import dataclasses

    import torch

    from rustraytrace_tpu_torch import RenderConfig, SceneBuilder, render
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import _cuda, megakernel as mk
    from rustraytrace_tpu_torch.ops import wavefront as wf
    ts = _torch_scenes()
    scene = ts.quad_field(SceneBuilder, 1024)
    cfg = RenderConfig(image_width=400, samples_per_pixel=64, max_depth=8,
                       **ts.FIELD_INSIDE_CFG)
    cam = derive_camera(cfg, device=dev)
    stats: dict = {}
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = render.render_pass(scene, cam, cfg.seed, width=400, height=400,
                             spp=64, max_depth=8, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    tab = mk.prepare_megakernel_cached(
        scene, cam, width=400, height=400,
        tile_rows=mk.respawn_tile_rows(scene), device=dev)
    _check(tab.n_qclusters > 1, "the quad field has no quad clusters")
    k3, k3_ms = _cuda_ms_once(lambda: mk.respawn_pass(tab, cfg.seed, 0, 64,
                                                      8))
    idx = mk.unswizzle_index_on(400, 400, dev)
    eq_pass = bool(torch.equal(k3[idx].reshape(400, 400, 3), acc))
    lin = dataclasses.replace(tab, n_qclusters=0)
    kl, lin_ms = _cuda_ms_once(lambda: mk.respawn_pass(lin, cfg.seed, 0, 64,
                                                       8))
    differ = int((k3 != kl).any(dim=1).sum())
    k1 = mk.respawn_pass(tab, cfg.seed, 0, 1, 8)
    p1, p_ms = _cuda_ms_once(lambda: mk.respawn_pass_plain(tab, cfg.seed, 0,
                                                           1, 8))
    eq_tw = bool(torch.equal(k1, p1))
    R = tab.n_lanes
    st_k = torch.zeros((wf.N_STATE, R), device=dev)
    st_p = st_k.clone()
    sl = torch.arange(R, dtype=torch.int32, device=dev)
    kw = dict(persist_iters=8, spp=64, max_depth=8)
    wf.persist_step(st_k, sl, tab, cfg.seed, **kw)
    wf.persist_step_plain(st_p, sl, tab, cfg.seed, **kw)
    eq_k2 = bool(torch.equal(st_k, st_p))
    print(f"[12 quad clusters] 1024 quads in {tab.n_qclusters} clusters, "
          f"camera inside, 400x400 64 spp depth 8 through render_pass: "
          f"{wall:.3f} s, {400 * 400 * 64 / wall:.6g} paths/s, "
          f"{stats['launches']} launches, kernel launch counts {counts}; "
          f"K3 {k3_ms:.2f} ms with the cull, {lin_ms:.2f} ms scanning every "
          f"quad row (x{lin_ms / k3_ms:.2f}); lanes where the cull and the "
          f"scan differ: {differ} of {R} (need < 0.01%); K3 == the pass "
          f"bitwise (required): {eq_pass}; 1 spp K3 and one 8-iteration "
          f"K2 launch == plain twin bitwise (required): {eq_tw} / {eq_k2} "
          f"(plain K3 {p_ms:.0f} ms)", flush=True)
    _check(counts["persist"] == stats["launches"] > 0,
           "the quad field's pass did not run the persist kernel")
    _check(eq_pass and eq_tw and eq_k2 and differ < 1e-4 * R,
           "the quad-cluster kernels differ")
    return dict(err=max(torch.abs(k1 - p1).max().item(),
                        torch.abs(st_k - st_p).max().item()),
                k3_ms=k3_ms, lin_ms=lin_ms)


def _phase13(dev) -> float:
    """The MIS estimator's isotropic branch: the JAX package's smoke scene
    (black smoke) at 400x400, 64 spp, depth 12 through
    ``render.render_pass`` (K3), held against a 4 spp plain render within
    5 standard errors; K3 and K4 == the twin, bitwise, with black and
    with white smoke."""
    import torch

    from rustraytrace_tpu_torch import RenderConfig, SceneBuilder, render
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import _cuda, megakernel as mk
    ts = _torch_scenes()
    cfg = RenderConfig(image_width=400, samples_per_pixel=64, max_depth=12,
                       **ts.SMOKE_CFG)
    cam = derive_camera(cfg, device=dev)
    errs = []
    for smoke in ((0.0, 0.0, 0.0), (0.73, 0.73, 0.73)):
        scene = ts.smoke_mis_scene(SceneBuilder, smoke)
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = render.render_pass(scene, cam, cfg.seed, width=400, height=400,
                                 spp=64, max_depth=12, integrator="mis",
                                 device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        plain = render.render_pass(
            scene, cam, cfg.seed, width=400, height=400, spp=4,
            max_depth=12, integrator="mis", backend="plain", device=dev)
        ch, z = _agreement(acc.cpu().numpy() / 64.0,
                           plain.cpu().numpy() / 4.0)
        tab = mk.prepare_megakernel_cached(
            scene, cam, width=400, height=400,
            tile_rows=mk.respawn_tile_rows(scene), mis=True,
            stratified=False, sqrt_spp=0, device=dev)
        k3 = mk.respawn_pass(tab, cfg.seed, 0, 2, 12)
        k4 = mk.mono_pass(tab, cfg.seed, 0, 2, 12)
        p = mk.respawn_pass_plain(tab, cfg.seed, 0, 2, 12)
        eq = bool(torch.equal(k3, p) and torch.equal(k4, p))
        print(f"[13 smoke MIS, smoke albedo {smoke[0]}] 400x400 64 spp depth"
              f" 12 through render_pass: {wall:.3f} s, launch counts "
              f"{counts}; vs 4 spp plain: channel mean |diff| {ch:.4g}, 4x4"
              f" block max |z| {z:.3f} (need < 5); 2 spp K3 and K4 == plain"
              f" twin bitwise (required): {eq} (max |diff| "
              f"{torch.abs(k3 - p).max().item():.3g})", flush=True)
        _check(counts["megakernel"] == 1 and z < 5.0 and eq,
               "the smoke MIS scene is off")
        errs.append(max(torch.abs(k3 - p).max().item(),
                        torch.abs(k4 - p).max().item()))
    return max(errs)


def _phase14(dev) -> dict:
    """The sphere_kernel route (the reference ``trace_path`` with K1 as its
    closest-hit step every bounce): the flagship at 1200x675, depth 50,
    one pass of 16 spp in one chunk through ``render_image``, K1 launched
    passes x 50 x chunks times; the same route with K1's twin at 2 spp,
    bitwise; against the reference route at 4 spp within 5 standard
    errors; K1 at the main path's first-bounce rays; BASELINE config 1 and
    ``book2_earth`` on the route.  Returns the numbers of K1's entry."""
    import torch

    from rustraytrace_tpu_torch import models, render
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import _cuda, hit

    scene, cfg, _ = models.book1_random_spheres(dict(
        image_width=1200, samples_per_pixel=16, max_depth=50))
    w, h, spp, seed = cfg.image_width, cfg.image_height, 16, cfg.seed
    chunk = 1 << 20  # one chunk per image
    per = render.effective_spp_per_pass(cfg, "sphere_kernel", spp, w * h)
    passes = -(-spp // per)
    chunks = -(-(w * h) // min(chunk, -(-(w * h) // 256) * 256))
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, st = render.render_image(scene, cfg, backend="sphere_kernel",
                                  chunk=chunk, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    acc = st["accum"] / st["spp_done"]
    want = passes * cfg.max_depth * chunks
    print(f"[14 sphere_kernel flagship] {w}x{h} {spp} spp depth 50 through "
          f"render_image(backend='sphere_kernel'), {passes} pass, {chunks} "
          f"chunk: {wall:.3f} s, {w * h * spp / wall:.6g} paths/s; kernel "
          f"launch counts {counts} (K1 expected {want})", flush=True)
    _check(counts["sphere_hit"] == want > 0
           and sum(counts.values()) == counts["sphere_hit"],
           "the sphere_kernel flagship did not launch K1 passes x depth x "
           "chunks times alone")
    _check(img.shape == (h, w, 3) and bool(np.isfinite(acc).all())
           and acc.mean() > 0.1, "the sphere_kernel flagship image")

    cam = derive_camera(cfg, device=dev)
    kw = dict(width=w, height=h, max_depth=50, chunk=chunk, device=dev)
    k2 = render.render_pass(scene, cam, seed, spp=2,
                            backend="sphere_kernel", **kw)
    p2 = render._render_pass_reference(scene, cam, seed, spp=2,
                                       backend="sphere_kernel",
                                       hit_fn=hit.sphere_hit_plain, **kw)
    eq2 = bool(torch.equal(k2, p2))
    err2 = torch.abs(k2 - p2).max().item()
    # another seed: the two routes share their draws, and the block test
    # needs independent renders.  The reference route refines every sphere
    # root with a Newton step (as the JAX package's XLA route does), the
    # sphere_kernel route keeps K1's direct-form root (as its Pallas route
    # does), which leaves rays from the r = 1000 ground a few more
    # self-hits (tests/test_torch_sphere_kernel.py); so the block test is
    # held against the kernel route K2, which shares K1's quadric, and the
    # reference route against the channel means.
    t0 = time.perf_counter()
    ref4 = render.render_pass(scene, cam, seed + 1, spp=4,
                              backend="reference",
                              **dict(kw, chunk=65536)).cpu().numpy()
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ch, z = _agreement(acc, ref4 / 4.0)
    k2 = render.render_pass(scene, cam, seed + 1, width=w, height=h, spp=spp,
                            max_depth=50, device=dev).cpu().numpy()
    ch_k2, z_k2 = _agreement(acc, k2 / spp)
    print(f"[14 sphere_kernel check] 2 spp with K1 vs with its twin: max "
          f"|diff| {err2:.3g}, image bitwise equal (required): {eq2}; "
          f"{spp} spp vs the kernel route (K2) at {spp} spp, another seed: "
          f"channel mean |diff| {ch_k2:.4g}, 4x4 block max |z| {z_k2:.3f} "
          f"(need < 5); vs the reference route at 4 spp, another seed "
          f"({ref_s:.3f} s): channel mean |diff| {ch:.4g} (need < 0.01), "
          f"4x4 block max |z| {z:.3f}", flush=True)
    _check(eq2 and z_k2 < 5.0 and ch < 0.01, "the sphere_kernel route "
           "differs from its twin, from K2 or from the reference route")

    # K1 at the main path's shape: the first bounce's rays of the pass
    args = _k1_route_args(dev)
    n_rays, n_sph = args[0].shape[0], args[3].shape[0]
    f4 = hit.sphere_table_f4(args[3])  # built once a pass on the route
    ms = _cuda_ms(lambda: hit.sphere_hit(*args, f4=f4), 5)
    (tp, ip), plain_ms = _cuda_ms_once(lambda: hit.sphere_hit_plain(*args))
    tk, ik = hit.sphere_hit(*args)
    eq1 = bool(torch.equal(tk, tp) and torch.equal(ik, ip))
    # every ray tests every sphere; 7 f32 in and 2 words out a ray
    bound, by = _bound(n_rays * (n_sph * OPS["sphere"] + 6), n_rays * 9 * 4)
    print(f"[14 K1 at the main path's shape] {n_rays} first-bounce rays x "
          f"{n_sph} spheres: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"bound {bound:.3f} ms ({by}); t and idx bitwise equal "
          f"(required): {eq1}", flush=True)
    _check(eq1, "K1 disagrees with its twin at the main path's shape")

    # BASELINE config 1 in full, and the image-texture case
    s1, c1, _ = models.book1_three_spheres()
    _check((c1.image_width, c1.image_height, c1.samples_per_pixel,
            c1.max_depth) == (400, 225, 100, 50), "BASELINE config 1")
    walls = {}
    for name, sc, cf in (("book1_three_spheres", s1, c1),
                         ("book2_earth",) + models.book2_earth(dict(
                             image_width=800, samples_per_pixel=16))[:2]):
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, sst = render.render_image(sc, cf, backend="sphere_kernel",
                                     chunk=chunk, device=dev)
        torch.cuda.synchronize()
        wl = time.perf_counter() - t0
        cnt = _cuda.launch_counts()
        sp = sst["spp_done"]
        npass = -(-sp // render.effective_spp_per_pass(
            cf, "sphere_kernel", sp, cf.image_width * cf.image_height))
        sacc = sst["accum"] / sp
        walls[name] = wl
        print(f"[14 {name}] {cf.image_width}x{cf.image_height} {sp} spp "
              f"depth {cf.max_depth} on the sphere_kernel route: {wl:.3f} s, "
              f"{cf.image_width * cf.image_height * sp / wl:.6g} paths/s, "
              f"{npass} passes; launch counts {cnt}; channel means "
              f"{np.round(sacc.mean(axis=(0, 1)), 5).tolist()}", flush=True)
        _check(cnt["sphere_hit"] == npass * cf.max_depth
               and bool(np.isfinite(sacc).all()) and sacc.mean() > 0.05,
               f"{name} on the sphere_kernel route")
    return dict(launches=counts["sphere_hit"], err=err2, ms=ms,
                plain_ms=plain_ms, bound=bound, by=by, n_rays=n_rays,
                n_sph=n_sph, wall=wall, paths_per_s=w * h * spp / wall,
                walls=walls)


def _phase15(dev) -> dict:
    """The reference route: the Book-3 Cornell box at 600x600, 16 spp (4x4
    strata), depth 50, MIS through ``render_image(backend='reference')``
    against K3's ``render_image`` at the same configuration (channel means
    within 0.01, the 4x4 block z printed); the two scenes the kernels do
    not cover on 'auto'."""
    import torch

    from rustraytrace_tpu_torch import RenderConfig, SceneBuilder, models
    from rustraytrace_tpu_torch import render
    from rustraytrace_tpu_torch.ops import _cuda

    s, c, integ = models.book3_cornell_box(dict(samples_per_pixel=16))
    _check((c.image_width, c.image_height, c.max_depth, c.stratified, integ)
           == (600, 600, 50, True, "mis"), "the Book-3 configuration")
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st = render.render_image(s, c, integrator=integ, backend="reference",
                                chunk=131072, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    _, st3 = render.render_image(s, c, integrator=integ, device=dev)
    ch, z = _agreement(st["accum"] / 16.0, st3["accum"] / 16.0)
    # the reference route's expanded quadric (the JAX package's XLA
    # route) leaves rays from the glass sphere more self-hits than K3's
    # direct form (tests/test_torch_sphere_kernel.py), so the block z is
    # reported and the channel means are held
    print(f"[15 reference book3_cornell_box] 600x600 16 spp (4x4 strata) "
          f"depth 50 MIS through render_image(backend='reference'): "
          f"{wall:.3f} s, {600 * 600 * 16 / wall:.6g} paths/s; launch counts "
          f"{counts}; vs K3's render_image at 16 spp: channel mean |diff| "
          f"{ch:.4g} (need < 0.01), 4x4 block max |z| {z:.3f}", flush=True)
    _check(sum(counts.values()) == 0 and ch < 0.01
           and bool(np.isfinite(st["accum"]).all()),
           "the reference route's Cornell box")

    ts = _torch_scenes()
    med = ts.image_medium_scene(SceneBuilder)
    cm = RenderConfig(image_width=200, samples_per_pixel=16, max_depth=20,
                      **ts.IMAGE_MEDIUM_CFG)
    box, cb, _ = models.book2_cornell_box(dict(
        image_width=200, samples_per_pixel=16, max_depth=20))
    for name, sc, cf, ig in (("image-textured medium", med, cm, "path"),
                             ("book2_cornell_box, mis, no NEE light", box,
                              cb, "mis")):
        route = render.resolve_backend(sc, ig, device=dev)
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        _, sst = render.render_image(sc, cf, integrator=ig, device=dev)
        torch.cuda.synchronize()
        wl = time.perf_counter() - t0
        cnt = _cuda.launch_counts()
        sacc = sst["accum"] / sst["spp_done"]
        print(f"[15 auto: {name}] {cf.image_width}x{cf.image_height} "
              f"{sst['spp_done']} spp depth {cf.max_depth}: route {route!r}, "
              f"{wl:.3f} s; launch counts {cnt}; channel means "
              f"{np.round(sacc.mean(axis=(0, 1)), 5).tolist()}", flush=True)
        _check(route == ("sphere_kernel" if ig == "path" else "reference")
               and bool(np.isfinite(sacc).all()) and sacc.mean() > 0.0
               and (cnt["sphere_hit"] > 0) == (ig == "path"),
               f"the {name} did not route and render as the JAX package")
    return dict(wall=wall, paths_per_s=600 * 600 * 16 / wall)


def _dense_exact(dtab, rays):
    """S1's closest hit with the two products exactly rounded (float64,
    rounded once to float32) and the dense epilogue: the least any float32
    product can differ from the twin's, for comparison."""
    import torch

    from rustraytrace_tpu_torch.ops import dense_hit as dh

    ox, oy, oz, dx, dy, dz = rays
    ct = dtab[0:4].t().double()
    bt, bi = [], []
    for lo in range(0, ox.numel(), 65536):
        x, y, z, a_, b_, c_ = (r[lo:lo + 65536] for r in rays)
        D = torch.stack([a_, b_, c_, torch.zeros_like(a_)]).double()
        O = torch.stack([x, y, z, -torch.ones_like(x)]).double()
        dC, m = (ct @ D).float(), (ct @ O).float()
        a = a_ * a_ + b_ * b_ + c_ * c_
        inv_a = 1.0 / a
        hh = dC - (a_ * x + b_ * y + c_ * z)
        disc = hh * hh - a * ((x * x + y * y + z * z) - 2.0 * m)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        tn, tf = (hh - sq) * inv_a, (hh + sq) * inv_a
        root = torch.where((tn > dh.T_MIN) & (tn < dh.T_MAX), tn, tf)
        take = (disc > 0.0) & (root > dh.T_MIN) & (root < dh.T_MAX)
        best, idx = torch.min(torch.where(take, root, dh.BIG), dim=0)
        bt.append(best)
        bi.append(torch.where(best < dh.BIG, idx, -1))
    return torch.cat(bt), torch.cat(bi).to(torch.int32)


def _scalar_ops(stab, rays, iters: int) -> float:
    """Operations of the scalar S1 kernel on these inputs: per scan, 32 a
    pair whose discriminant is positive and 18 a pair whose root the
    kernel skips (its arithmetic, evaluated in chunks of rays)."""
    import torch

    ns = stab.shape[1]
    cx, cy, cz, r2 = (stab[k, None, :] for k in range(4))
    pos = 0
    for lo in range(0, rays[0].numel(), 16384):
        x, y, z, dx, dy, dz = (r.reshape(-1)[lo:lo + 16384, None]
                               for r in rays)
        ocx, ocy, ocz = cx - x, cy - y, cz - z
        h = dx * ocx + dy * ocy + dz * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r2
        disc = h * h - (dx * dx + dy * dy + dz * dz) * c
        pos += int((disc > 0.0).sum())
    miss = rays[0].numel() * ns - pos
    return iters * (pos * OPS["scalar_pair"] + miss * OPS["scalar_miss"])


def _dense_ops(dtab, rays, iters: int) -> float:
    """Operations of the dense S1 kernel on these inputs: per scan, 22 a
    pair whose discriminant is positive and 6 a pair whose root the
    kernel skips, the discriminant from the twin's arithmetic
    ('highest', in chunks of rays)."""
    from rustraytrace_tpu_torch.ops import dense_hit as dh

    n, pos = rays[0].numel(), 0
    for lo in range(0, n, 16384):
        _, disc = dh.dense_keys(dtab, *(r.reshape(-1)[lo:lo + 16384]
                                        for r in rays))
        pos += int((disc > 0.0).sum())
    miss = n * dtab.shape[1] - pos
    return iters * (pos * OPS["dense_pair"] + miss * OPS["dense_miss"])


def _dense_gate(tk, ik, tp, ip, every: bool) -> dict:
    """S1a's gate against its twin: hit mask and winner on >= 99.9% of
    rays, |dt| <= 1e-2 where both hit, on every ray (``every``) or on >=
    99.9% of them."""
    import torch

    both = (ik >= 0) & (ip >= 0)
    dt = torch.abs(tk - tp)[both]
    r = dict(mask=((ik >= 0) == (ip >= 0)).float().mean().item(),
             idx=(ik == ip).float().mean().item(), dt_max=dt.max().item(),
             within=(dt <= 1e-2).float().mean().item())
    r["ok"] = (r["mask"] >= 0.999 and r["idx"] >= 0.999
               and (r["dt_max"] <= 1e-2 if every else r["within"] >= 0.999))
    return r


def _phase16(dev) -> dict:
    """S1: the port's spike script (both precisions), then both kernels
    against their twins at the spike's shape (1,024 spheres, 4,096 rays,
    200 iterations) and at 2^20 rays x 1,024 spheres x 1 iteration:
    scalar bitwise at the split it picks and at 1, 4 and 32 lanes a ray,
    and slower than its counted bound (all the work done); dense
    'highest' winner and hit mask on >= 99.9% of rays and |dt| <= 1e-2
    (every ray at the spike's shape, >= 99.9% at 2^20, where exactly
    rounded products differ from the twin by more on near-tangent rays;
    their max is printed beside) at the split it picks and at 1, 4 and 64
    ranges of the sphere axis, and slower than the tensor cores' time for
    every pair and iteration (all the products done).  Returns the
    numbers of the two entries."""
    import contextlib
    import io

    import torch

    from rustraytrace_tpu_torch.ops import _cuda, dense_hit as dh
    from rustraytrace_tpu_torch.scripts import spike_dense_mxu as spike

    _cuda.library()  # built, so that the build log holds the registers
    regs = {k: v for k, v in _registers(_cuda.build_info["log"]).items()
            if k.startswith(("dense_hit_kernel", "dense_merge_kernel"))}
    launches = {}
    for prec in ("highest", "default"):
        _cuda.reset_launch_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            spike.main(["1024", "200", "--precision", prec])
        torch.cuda.synchronize()
        cnt = _cuda.launch_counts()
        launches[prec] = cnt
        print(f"[16 spike script, {prec}] "
              + " | ".join(out.getvalue().splitlines())
              + f"; launch counts {cnt}", flush=True)
        _check(cnt["dense_hit"] > 0 and cnt["scalar_hit"] > 0,
               "the spike script did not launch both kernels")
        # the dense kernel's ranges are merged by a launch of their own
        merges = cnt["dense_hit"] if dh.default_split(
            4096, 1024, _cuda.dense_wave(prec == "highest")) > 1 else 0
        _check(cnt["dense_merge"] == merges, f"the spike script made "
               f"{cnt['dense_merge']} merge launches, not {merges}")

    res = {}
    for label, ns, n_rays, iters in (("spike", 1024, 4096, 200),
                                     ("2^20", 1024, 1 << 20, 1)):
        dtab_np, stab_np, o, d = spike.spike_inputs(ns)
        if n_rays != o[0].size:
            rng = np.random.default_rng(1)
            o = rng.uniform(-100, 100, (3, n_rays)).astype(np.float32)
            d = rng.normal(size=(3, n_rays)).astype(np.float32)
        rays = [torch.from_numpy(np.ascontiguousarray(x).reshape(-1)).to(dev)
                for x in (*o, *d)]
        dtab = torch.from_numpy(dtab_np).to(dev)
        stab = torch.from_numpy(stab_np).to(dev)
        ts_k, is_k = dh.scalar_hit(stab, *rays, iters=iters)
        ts_p, is_p = dh.scalar_hit_plain(stab, *rays)
        s_plain = _cuda_ms(lambda: dh.scalar_hit_plain(stab, *rays), 1)
        s_eq = bool(torch.equal(ts_k, ts_p) and torch.equal(is_k, is_p))
        s_err = torch.abs(ts_k - ts_p).max().item()
        # the split forced: every one gives the twin's result
        split = _cuda.scalar_split(n_rays)
        s_split_eq = {}
        for k in (1, 4, 32):
            tk, ik = dh.scalar_hit(stab, *rays, iters=iters, split=k)
            s_split_eq[k] = bool(torch.equal(tk, ts_p)
                                 and torch.equal(ik, is_p))
            s_err = max(s_err, torch.abs(tk - ts_p).max().item())
        s_ms = _cuda_ms(lambda: dh.scalar_hit(stab, *rays, iters=iters), 3)
        pairs = n_rays * ns * iters
        row = dict(s_eq=s_eq, s_ms=s_ms, s_plain=s_plain, pairs=pairs,
                   s_err=s_err, split=split, s_split_eq=s_split_eq)
        every = label == "spike"
        for prec in ("highest", "default"):
            td, id_ = dh.dense_hit(dtab, *rays, iters=iters, precision=prec)
            tp, ip = dh.dense_hit_plain(dtab, *rays, precision=prec)
            d_plain = _cuda_ms(
                lambda: dh.dense_hit_plain(dtab, *rays, precision=prec), 1)
            d_ms = _cuda_ms(lambda: dh.dense_hit(dtab, *rays, iters=iters,
                                                 precision=prec), 3)
            hit_d, hit_s = id_ >= 0, is_k >= 0
            vs_scalar = (((hit_d == hit_s).float().mean().item()),
                         (id_ == is_k)[hit_d & hit_s].float().mean().item(),
                         torch.abs(td - ts_k)[hit_d & hit_s].max().item())
            row[prec] = dict(ms=d_ms, plain=d_plain, vs_scalar=vs_scalar,
                             **_dense_gate(td, id_, tp, ip, every))
        te, ie = _dense_exact(dtab, rays)
        tp_h, ip_h = dh.dense_hit_plain(dtab, *rays)
        both = (ie >= 0) & (ip_h >= 0)
        floor = torch.abs(te - tp_h)[both].max().item()
        # the sphere axis split forced: 1, 4, the default, the largest
        d_split = dh.default_split(n_rays, ns, _cuda.dense_wave(True))
        d_splits = {}
        for k in sorted({1, 4, d_split, dh.DENSE_SPLITS[-1]}):
            tk, ik = dh.dense_hit(dtab, *rays, iters=iters, split=k)
            d_splits[k] = _dense_gate(tk, ik, tp_h, ip_h, every)
        mma = pairs * 2 * 4 * 2 * 3  # two K=4 products, 3 TF32 passes
        t_mma = 1e3 * mma / PEAK_TF32
        # table and rays read once, t and idx written once; the FP32
        # epilogue (counted from this run's discriminants) and the
        # tensor-core products can overlap, so the bound is the largest of
        # the three times; beside it the bound of every root taken
        d_bytes = 4 * (8 * ns + 8 * n_rays)
        d_bound, d_by = _bound(_dense_ops(dtab, rays, iters), d_bytes)
        if t_mma > d_bound:
            d_bound, d_by = t_mma, "operations"
        d_bound_all = max(_bound(pairs * OPS["dense_pair"], d_bytes)[0],
                          t_mma)
        s_bytes = 4 * (4 * ns + 8 * n_rays)
        s_bound, s_by = _bound(_scalar_ops(stab, rays, iters), s_bytes)
        # the floor that proves every pair was computed: 32 operations a
        # pair, as if no root were skipped (above the counted bound)
        s_floor, _ = _bound(pairs * OPS["scalar_pair"], s_bytes)
        row.update(floor=floor, d_bound=d_bound, d_by=d_by, t_mma=t_mma,
                   d_bound_all=d_bound_all, d_split=d_split,
                   d_splits=d_splits, d_regs=regs, s_bound=s_bound,
                   s_by=s_by, s_floor=s_floor)
        hi = row["highest"]
        for prec in ("highest", "default"):
            r = row[prec]
            print(f"[16 S1 {label}, {prec}] {n_rays} rays x {ns} spheres x "
                  f"{iters} iterations: dense vs its twin: hit mask "
                  f"{r['mask']:.6f}, winner {r['idx']:.6f}, |dt| <= 1e-2 on "
                  f"{r['within']:.6f} (max {r['dt_max']:.3e}; exactly rounded "
                  f"products vs the twin: {floor:.3e}); dense vs scalar: "
                  f"hit-mask agreement {r['vs_scalar'][0]:.6f}, winner-idx "
                  f"agreement {r['vs_scalar'][1]:.6f}, |t| max delta "
                  f"{r['vs_scalar'][2]:.3e}; dense {r['ms']:.3f} ms = "
                  f"{pairs / r['ms'] / 1e6:.1f} Gpairs/s (twin, one scan, "
                  f"{r['plain']:.1f} ms)", flush=True)
        print(f"[16 S1 {label}, scalar] kernel ({split} lanes a ray) "
              f"{s_ms:.4f} ms = {pairs / s_ms / 1e6:.1f} Gpairs/s, twin "
              f"(one scan) {row['s_plain']:.1f} ms; bitwise equal to the "
              f"twin (required): {s_eq}, with 1 / 4 / 32 lanes a ray: "
              f"{s_split_eq}; bounds: dense {d_bound:.4f} ms ({d_by}; "
              f"tensor cores alone {t_mma:.4f} ms), scalar {s_bound:.4f} ms "
              f"({s_by}, {pairs / s_bound / 1e6:.1f} Gpairs/s), every "
              f"pair at 32 operations {s_floor:.4f} ms (required below the "
              f"kernel's time)", flush=True)
        print(f"[16 S1 {label}, dense] split {d_split} of the sphere "
              f"axis (the least that covers a resident wave); registers "
              f"{regs}; 'highest' at splits "
              + ", ".join(f"{k}: winner {v['idx']:.6f}, mask "
                          f"{v['mask']:.6f}, max |dt| {v['dt_max']:.3e}"
                          for k, v in d_splits.items())
              + f"; bound {d_bound:.4f} ms ({d_by}; every root taken "
              f"{d_bound_all:.4f} ms; tensor cores {t_mma:.4f} ms, "
              f"required below the kernel's time); dense 'highest' "
              f"{hi['ms']:.4f} ms vs scalar {s_ms:.4f} ms: "
              f"{s_ms / hi['ms']:.2f}x", flush=True)
        _check(s_eq and all(s_split_eq.values()),
               f"S1 scalar differs from its twin ({label})")
        _check(all(v["ok"] for v in d_splits.values()),
               f"S1 dense 'highest' disagrees with its twin at a forced "
               f"split ({label})")
        _check(hi["ms"] > t_mma, f"S1 dense ran under the tensor cores' "
               f"time for every pair ({label}): work was skipped")
        _check(s_ms > s_floor, f"S1 scalar ran under the time of every "
               f"pair at 32 operations ({label}): work was skipped")
        _check(hi["mask"] >= 0.999 and hi["idx"] >= 0.999
               and (hi["dt_max"] <= 1e-2 if label == "spike"
                    else hi["within"] >= 0.999),
               f"S1 dense 'highest' disagrees with its twin ({label})")
        res[label] = row
    return dict(res=res, launches=launches)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


class _ProfiledSteps:
    """A fit's ``progress(step, loss)`` hook that runs ``torch.profiler``
    over the fit's own steps ``first`` .. ``first + n - 1``: ``wall`` (s)
    from the end of step ``first - 1`` to the end of the last, ``busy``
    (s) the union of the device's kernel and copy intervals in it (None
    when the profiler recorded none), ``n_dev`` their count.  A step ends
    when ``fit`` reads its loss, which waits for the device."""

    def __init__(self, dev, first: int, n: int):
        self.dev, self.first, self.n = dev, first, n
        self.prof = self.wall = self.busy = None
        self.n_dev = 0

    def __call__(self, step, loss):
        import torch
        from torch.profiler import ProfilerActivity, profile

        if step == self.first - 1:
            acts = [ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            _sync(self.dev)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif step == self.first + self.n - 1:
            _sync(self.dev)
            self.wall = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)
            spans = sorted((e.time_range.start, e.time_range.end)
                           for e in self.prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
            busy, end = 0.0, float("-inf")
            for a, b in spans:
                if b > end:
                    busy += b - max(a, end)
                    end = b
            self.busy = busy * 1e-6 if spans else None
            self.n_dev = len(spans)


def _phase17(dev, steps: int = 250) -> dict:
    """The training path (BASELINE config 4, ``scripts/inverse_rendering``
    at full size: 64x36, 16 spp, depth 4, chunk 4096): (a) the gradient on
    the card against the CPU port, (b) against central differences on the
    card, (c) the whole fit with the trace forward, gated on the script's
    recovery, with its step time and the device's idle share of one step,
    (d) the fit with the kernel forward (K2/K3), (e) the sharded pass and
    contraction on a one-rank process group."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from rustraytrace_tpu_torch import diff, render
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import _cuda
    from rustraytrace_tpu_torch.parallel import (make_mesh,
                                                 render_contract_sharded,
                                                 render_pass_sharded)
    from rustraytrace_tpu_torch.scripts import inverse_rendering as ir

    cpu = torch.device("cpu")
    cfg = ir.config()
    w, h = cfg.image_width, cfg.image_height
    kw = dict(width=w, height=h, spp=cfg.samples_per_pixel, max_depth=4,
              chunk=4096)
    cam = derive_camera(cfg, device=dev)
    wrong = ir.build_scene(ir.START_ALBEDO, ir.START_CENTER)
    with torch.no_grad():
        target = diff.render_mean(ir.build_scene(ir.TRUE_ALBEDO,
                                                 ir.TRUE_CENTER),
                                  cam, 42, device=dev, **kw)
    params = diff.extract_params(wrong, ir.PARAMS)
    out = {}

    # ---- 17a: the gradient on the card vs the CPU port, same draws
    t0 = time.perf_counter()
    loss_d, g_d = diff.value_and_grad_loss(wrong, params, target, cam, 5,
                                           device=dev, **kw)
    _sync(dev)
    vag_s = time.perf_counter() - t0
    loss_c, g_c = diff.value_and_grad_loss(
        wrong, params, target.cpu(), derive_camera(cfg, device=cpu), 5,
        device=cpu, **kw)
    loss_rel = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    grad_rel, ok_a = {}, loss_rel <= 1e-3
    for k in ir.PARAMS:
        gd, gc = g_d[k].cpu(), g_c[k]
        top = gc.abs().max().item()
        grad_rel[k] = (gd - gc).abs().max().item() / top
        ok_a &= bool(torch.all((gd - gc).abs()
                               <= 1e-3 * gc.abs() + 1e-3 * top))
    print(f"[17a gradient, card vs CPU] config 4 {w}x{h} {kw['spp']} spp "
          f"depth 4, seed 5, forward 'trace': loss {float(loss_d):.6e} vs "
          f"{float(loss_c):.6e} (rel {loss_rel:.2e}); max |dgrad| / max "
          f"|grad| {grad_rel}; gate: loss rtol 1e-3, each entry within "
          f"1e-3 of itself plus 1e-3 of the largest: {ok_a}; first call "
          f"{vag_s:.2f} s", flush=True)
    _check(ok_a, "card and CPU gradients disagree")
    out.update(loss_rel=loss_rel, grad_rel=grad_rel)

    # ---- 17b: central differences on the card, same seed both sides
    def loss_at(name, idx, d, seed):
        p = {k: v.clone() for k, v in params.items()}
        p[name][idx] += d
        with torch.no_grad():
            return float(diff.image_loss(diff.apply_params(wrong, p),
                                         target, cam, seed,
                                         warp_primary="tent", device=dev,
                                         **kw))

    g_alb = float(g_d["tex_color1"][1, 0])
    fd_alb = (loss_at("tex_color1", (1, 0), 1e-3, 5)
              - loss_at("tex_color1", (1, 0), -1e-3, 5)) / 2e-3
    ok_alb = abs(fd_alb - g_alb) <= 0.05 * abs(g_alb) + 1e-5
    ads, fds = [], []
    for k in range(8):
        _, g = diff.value_and_grad_loss(wrong, params, target, cam, 100 + k,
                                        device=dev, **kw)
        ads.append(float(g["sph_center"][1, 0]))
        fds.append((loss_at("sph_center", (1, 0), 0.02, 100 + k)
                    - loss_at("sph_center", (1, 0), -0.02, 100 + k)) / 0.04)
    ad, fd = float(np.mean(ads)), float(np.mean(fds))
    ok_ctr = ad * fd > 0 and abs(ad - fd) <= 0.35 * abs(fd)
    print(f"[17b gradient vs central differences] albedo red of sphere 1: "
          f"ad {g_alb:.6e} fd {fd_alb:.6e} (eps 1e-3, rel 0.05 + 1e-5: "
          f"{ok_alb}); center x of sphere 1, the mean over seeds 100-107: "
          f"ad {ad:.6e} fd {fd:.6e} (eps 0.02, sign and 35%: {ok_ctr})",
          flush=True)
    _check(ok_alb and ok_ctr, "gradient disagrees with finite differences")
    out.update(fd_albedo=(g_alb, fd_alb), fd_center=(ad, fd))

    # ---- 17c: the whole fit, trace forward; main path: counts from 0;
    # the profiler runs over ten of the fit's own steps
    first = min(100, steps // 2)
    prof = _ProfiledSteps(dev, first=first, n=min(10, steps - first))
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    rep = ir.run(steps=steps, forward="trace", device=dev, progress=prof)
    fit_s = time.perf_counter() - t0
    launches_c = {k: v for k, v in _cuda.launch_counts().items() if v}
    med, wall, busy = rep["median_step_s"], prof.wall, prof.busy
    idle = None if busy is None else 1.0 - busy / wall
    print(f"[17c fit, forward 'trace'] {rep['steps']} steps in {fit_s:.1f} "
          f"s: loss {rep['loss_before']:.4e} -> {rep['loss_after']:.4e}, "
          f"center {rep['center_recovered']} (err {rep['center_err']}), "
          f"albedo {rep['albedo_recovered']} (err {rep['albedo_err']}), "
          f"NaN-gradient steps {rep['nan_grad_steps']}; median step "
          f"{med * 1e3:.2f} ms; steps {prof.first}-"
          f"{prof.first + prof.n - 1} of the fit under the profiler "
          f"{wall * 1e3:.2f} ms ({wall / prof.n * 1e3:.2f} ms a step), "
          f"device busy "
          f"{'not measured' if busy is None else f'{busy * 1e3:.2f} ms'} "
          f"in {prof.n_dev} device activities, idle share of those steps "
          f"{'not measured' if idle is None else f'{idle:.4f}'}; kernel "
          f"launches {launches_c}; gate: center < {ir.CENTER_TOL}, albedo "
          f"< {ir.ALBEDO_TOL}: {rep['ok']}", flush=True)
    _check(rep["ok"], "the trace-forward fit did not recover the sphere")
    out.update(trace=rep, trace_fit_s=fit_s, profiled_steps=prof.n,
               profiled_wall_s=wall, profiled_busy_s=busy, idle_share=idle,
               device_activities=prof.n_dev)

    # ---- 17d: the same fit, kernel forward (K2/K3 on the card); first
    # its forward, the auto route, against the plain twins on the card
    pkw = dict(width=w, height=h, spp=kw["spp"], max_depth=4, device=dev)
    _cuda.reset_launch_counts()
    kern = render.render_pass(wrong, cam, 5, **pkw)
    cmp_launches = {k: v for k, v in _cuda.launch_counts().items() if v}
    plain = render.render_pass(wrong, cam, 5, backend="plain", **pkw)
    fwd_equal = bool(torch.equal(kern, plain))
    fwd_err = (kern - plain).abs().max().item()
    print(f"[17d forward, kernel vs plain] config 4 {w}x{h} {kw['spp']} spp "
          f"depth 4, seed 5, route "
          f"{render.resolve_backend(wrong, 'path', 'auto', dev)}: launches "
          f"{cmp_launches}, max |diff| {fwd_err:.3g}, bitwise equal "
          f"(required): {fwd_equal}", flush=True)
    _check(fwd_equal and (cmp_launches.get("megakernel", 0)
                          + cmp_launches.get("persist", 0) > 0
                          or dev.type != "cuda"),
           "the kernel forward disagrees with its plain twins")
    _, g_k = diff.value_and_grad_loss(wrong, params, target, cam, 5,
                                      forward="kernel", device=dev, **kw)
    finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    repk = ir.run(steps=steps, forward="kernel", device=dev)
    fitk_s = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    k23 = counts["persist"] + counts["megakernel"]
    ok_d = (finite and repk["nan_grad_steps"] == 0
            and repk["loss_after"] < repk["loss_before"]
            and (k23 > 0 or dev.type != "cuda"))
    print(f"[17d fit, forward 'kernel'] {repk['steps']} steps in "
          f"{fitk_s:.1f} s: loss {repk['loss_before']:.4e} -> "
          f"{repk['loss_after']:.4e}, center {repk['center_recovered']} "
          f"(err {repk['center_err']}), albedo {repk['albedo_recovered']} "
          f"(err {repk['albedo_err']}), recovered by the script's gate: "
          f"{repk['ok']} (not gated); median step "
          f"{repk['median_step_s'] * 1e3:.2f} ms; K2 launches "
          f"{counts['persist']}, K3 launches {counts['megakernel']}; gate: "
          f"finite gradients ({finite}, NaN-gradient steps "
          f"{repk['nan_grad_steps']}), loss lowered, K2/K3 launched: {ok_d}",
          flush=True)
    _check(ok_d, "the kernel-forward fit failed its gates")
    out.update(kernel=repk, kernel_fit_s=fitk_s, kernel_fwd_err=fwd_err,
               kernel_fwd_launches=cmp_launches,
               kernel_launches={"persist": counts["persist"],
                                "megakernel": counts["megakernel"]})

    # ---- 17e: the sharded pass on a one-rank process group
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method="file://" + os.path.join(
            tmp, "pg"), rank=0, world_size=1)
        try:
            mesh = make_mesh()
            ct = torch.randn((h, w, 3), generator=torch.Generator().manual_seed(
                0)).to(dev)
            with torch.no_grad():
                a = render_pass_sharded(wrong, cam, 7, mesh=mesh, device=dev,
                                        **kw)
                b = render.render_pass(wrong, cam, 7, backend="reference",
                                       device=dev, **kw)
                s_box = float(render_contract_sharded(
                    wrong, cam, 7, ct, mesh=mesh, device=dev, **kw))
                img_w = render_pass_sharded(wrong, cam, 7, mesh=mesh,
                                            warp_primary="tent", device=dev,
                                            **kw)
            ref_box = float(torch.sum(a * ct))
            leaves = {k: v.to(dev).requires_grad_(True)
                      for k, v in params.items()}
            s_w, g_mesh = render_contract_sharded(
                diff.apply_params(wrong, leaves), cam, 7, ct, mesh=mesh,
                warp_primary=True, wrt=leaves, device=dev, **kw)
            ref_w = float(torch.sum(img_w * ct))
            _, g_one = render_contract_sharded(
                diff.apply_params(wrong, leaves), cam, 7, ct,
                warp_primary=True, wrt=leaves, device=dev, **kw)
        finally:
            dist.destroy_process_group()
    equal = bool(torch.equal(a, b))
    rel_box = abs(s_box - ref_box) / abs(ref_box)
    rel_w = abs(float(s_w) - ref_w) / abs(ref_w)
    # the backward's scatter-adds (gathers' gradients) run in no fixed
    # order, so two runs of one gradient agree to rounding, not bitwise
    g_rel = max((g_mesh[k] - g_one[k]).abs().max().item()
                / g_one[k].abs().max().item() for k in g_one)
    g_same = g_rel <= 1e-5
    ok_e = equal and rel_box <= 1e-5 and rel_w <= 1e-5 and g_same
    print(f"[17e sharded, one-rank {backend} group] render_pass_sharded == "
          f"render_pass(backend='reference') bitwise (required): {equal}; "
          f"contraction vs sum(image * ct): box rel {rel_box:.2e}, warped "
          f"rel {rel_w:.2e} (rtol 1e-5); its gradient through the group vs "
          f"without one: max |d| / max |g| {g_rel:.2e} (<= 1e-5: {g_same})",
          flush=True)
    _check(ok_e, "the one-rank sharded pass disagrees")
    out.update(sharded_equal=equal, contraction_rel=(rel_box, rel_w),
               group_grad_rel=g_rel)
    return out


def _cli(dev, argv: list) -> tuple:
    """``cli.main(argv + ["--device", dev.type])`` in this process: (exit
    code, wall seconds to a synchronised end, its stderr, the kernels'
    launch counts of the call, counted from 0)."""
    import contextlib
    import io

    from rustraytrace_tpu_torch import cli
    from rustraytrace_tpu_torch.ops import _cuda

    err = io.StringIO()
    _cuda.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv + ["--device", dev.type])
    _sync(dev)
    wall = time.perf_counter() - t0
    return rc, wall, err.getvalue(), _cuda.launch_counts()


def _render_image(dev, name: str, over: dict, **kw) -> tuple:
    """``render.render_image`` of a catalog scene on ``dev``: (image,
    state, wall seconds, launch counts of the call, counted from 0)."""
    from rustraytrace_tpu_torch import models, render
    from rustraytrace_tpu_torch.ops import _cuda

    scene, cfg, integ = models.get_scene(name, over)
    _cuda.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    img, st = render.render_image(scene, cfg, integrator=integ, device=dev,
                                  **kw)
    _sync(dev)
    return (img, st, time.perf_counter() - t0, _cuda.launch_counts())


def _child(cmd: list, cwd: str, timeout: float) -> float:
    """Run ``cmd`` in a session of its own from ``cwd`` (the repo root on
    ``PYTHONPATH``); fails the script on a non-zero exit, and kills the
    whole session at ``timeout``.  Returns its wall seconds."""
    import os
    import signal

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [cwd] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        _, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise SystemExit(f"chip_smoke: FAILED: {cmd[:6]} timed out")
    _check(p.returncode == 0, f"{' '.join(cmd)} exited {p.returncode}: "
           f"{err[-2000:]}")
    return time.perf_counter() - t0


def _phase18(dev, smi: str) -> dict:
    """The port's entry points at full width: (a) the CLI on the flagship
    (1200x675, 1024 spp, depth 50, 'auto': sorted K2) == ``render_image``
    bitwise, with equal K2 launches; inside a one-rank process group (b)
    the same with ``--sharded``, (c) the Book-3 box sharded (one K3
    launch), (d) the final scene sharded (K2's image route), (e) the
    reference route sharded and stratified, (f) ``render_image_multihost``;
    (g) ``torchrun`` and ``python -m`` of the package in child processes;
    (h) ``--backend sphere_kernel --sharded`` exits 2."""
    import os
    import tempfile

    import torch.distributed as dist

    from rustraytrace_tpu_torch import models
    from rustraytrace_tpu_torch.ops import _cuda
    from rustraytrace_tpu_torch.parallel import render_image_multihost
    from rustraytrace_tpu_torch.utils.image_io import read_ppm

    root = os.path.dirname(os.path.abspath(__file__))
    group = "nccl" if dev.type == "cuda" else "gloo"
    out: dict = {}
    flag = ["in_one_weekend", "--spp", "1024", "--depth", "50"]
    flag_over = dict(samples_per_pixel=1024, max_depth=50)
    with tempfile.TemporaryDirectory() as tmp:
        def ppm(name):
            return os.path.join(tmp, f"{name}.ppm")

        # ---- 18a: the CLI on the flagship vs render_image, both warm
        # (the first render_image builds nothing: phase 2 did)
        img_a, _, cold_s, counts_ri = _render_image(dev, "in_one_weekend",
                                                    flag_over)
        cfg_a = models.get_scene("in_one_weekend", flag_over)[1]
        _check((cfg_a.image_width, cfg_a.image_height) == (1200, 675),
               "in_one_weekend is not the 1200x675 flagship")
        rc, cli_s, err, counts = _cli(dev, flag + ["-o", ppm("a")])
        ri_s = _render_image(dev, "in_one_weekend", flag_over)[2]
        eq_a = rc == 0 and bool(np.array_equal(read_ppm(ppm("a")), img_a))
        meter_a = err.strip().splitlines()[-1]
        print(f"[18a cli] in_one_weekend 1200x675 1024 spp depth 50, auto: "
              f"exit {rc}; PPM == render_image bitwise (required): {eq_a}; "
              f"K2 launches {counts['persist']} vs render_image's "
              f"{counts_ri['persist']} (equal, > 0 required); walls: cli "
              f"{cli_s:.4f} s, render_image {ri_s:.4f} s (first "
              f"{cold_s:.4f} s) | {smi}", flush=True)
        print(f"[18a cli meter] {meter_a}", flush=True)
        _check(eq_a, "the CLI's flagship differs from render_image")
        _check(counts["persist"] == counts_ri["persist"] > 0,
               "the CLI's flagship K2 launches differ from render_image's")
        out.update(cli_s=cli_s, ri_s=ri_s, cold_s=cold_s,
                   k2_cli=counts["persist"], meter_a=meter_a)

        # the Book-3 box at its config: 600x600, 100 spp in 10x10 strata
        img_c, st_c, box_s, counts_c_ri = _render_image(
            dev, "the_rest_of_your_life", {})
        dist.init_process_group(group, init_method="file://" + os.path.join(
            tmp, "pg"), rank=0, world_size=1)
        try:
            # ---- 18b: the same command, --sharded, on the group, twice:
            # the group's first all_reduce sets up its communicator
            walls = []
            for _ in range(2):
                rc, shard_s, err, counts = _cli(
                    dev, flag + ["--sharded", "-o", ppm("b")])
                eq_b = rc == 0 and bool(np.array_equal(read_ppm(ppm("b")),
                                                       img_a))
                walls.append(shard_s)
                _check(eq_b, "the sharded CLI's flagship differs from 18a")
                _check(counts["persist"] == out["k2_cli"],
                       "the sharded CLI's K2 launches differ from 18a's")
            meter_b = err.strip().splitlines()[-1]
            print(f"[18b cli --sharded, one-rank {group} group] exit {rc}; "
                  f"{err.splitlines()[0]}; == 18a bitwise (required): "
                  f"{eq_b}; K2 launches {counts['persist']} (== 18a "
                  f"required); walls: first {walls[0]:.4f} s (with the "
                  f"group's first all_reduce), then {walls[1]:.4f} s | "
                  f"{smi}", flush=True)
            print(f"[18b cli meter] {meter_b}", flush=True)
            out.update(shard_s=walls, k2_shard=counts["persist"],
                       meter_b=meter_b)

            # ---- 18c: the Book-3 box, sharded: one K3 launch
            rc, c_s, _, counts = _cli(dev, [
                "the_rest_of_your_life", "--sharded", "-o", ppm("c"),
                "--quiet"])
            img_cc = read_ppm(ppm("c"))
            eq_c = rc == 0 and bool(np.array_equal(img_cc, img_c))
            print(f"[18c cli --sharded the_rest_of_your_life] 600x600 100 "
                  f"spp (10x10 strata) MIS: exit {rc}; == render_image "
                  f"bitwise (required): {eq_c}; K3 launches "
                  f"{counts['megakernel']} (render_image "
                  f"{counts_c_ri['megakernel']}; exactly 1 required), K2 "
                  f"{counts['persist']}; walls: cli {c_s:.4f} s, "
                  f"render_image {box_s:.4f} s | {smi}", flush=True)
            _check(eq_c, "the sharded Book-3 box differs from render_image")
            _check(counts["megakernel"] == 1 and counts["persist"] == 0,
                   "the sharded Book-3 box did not take one K3 launch")
            out.update(box_cli_s=c_s, box_ri_s=box_s,
                       k3_shard=counts["megakernel"])

            # ---- 18d: the final scene, sharded: K2's image route
            img_d, _, fin_s, counts_d_ri = _render_image(
                dev, "the_next_week", {})
            rc, d_s, _, counts = _cli(dev, [
                "the_next_week", "--sharded", "-o", ppm("d"), "--quiet"])
            eq_d = rc == 0 and bool(np.array_equal(read_ppm(ppm("d")),
                                                   img_d))
            print(f"[18d cli --sharded the_next_week] 400x400 250 spp "
                  f"depth 4: exit {rc}; == render_image bitwise "
                  f"(required): {eq_d}; K2 launches {counts['persist']} vs "
                  f"render_image's {counts_d_ri['persist']} (equal, > 0 "
                  f"required); walls: cli {d_s:.4f} s, render_image "
                  f"{fin_s:.4f} s | {smi}", flush=True)
            _check(eq_d, "the sharded final scene differs from render_image")
            _check(counts["persist"] == counts_d_ri["persist"] > 0,
                   "the sharded final scene's K2 launches differ")
            out.update(final_cli_s=d_s, final_ri_s=fin_s,
                       k2_final=counts["persist"])

            # ---- 18e: the reference route sharded, stratified 4x4
            img_e, _, ref_s, _ = _render_image(
                dev, "the_rest_of_your_life",
                dict(image_width=200, samples_per_pixel=16),
                backend="reference")
            rc, e_s, _, counts = _cli(dev, [
                "the_rest_of_your_life", "--width", "200", "--spp", "16",
                "--backend", "xla", "--sharded", "-o", ppm("e"), "--quiet"])
            eq_e = rc == 0 and bool(np.array_equal(read_ppm(ppm("e")),
                                                   img_e))
            print(f"[18e cli --sharded --backend xla] the_rest_of_your_life"
                  f" 200x200 16 spp (4x4 strata): exit {rc}; == render_image"
                  f"(backend='reference') bitwise (required): {eq_e}; kernel"
                  f" launches {sum(counts.values())}; walls: cli {e_s:.4f} "
                  f"s, render_image {ref_s:.4f} s", flush=True)
            _check(eq_e and sum(counts.values()) == 0,
                   "the sharded reference route differs from render_image")

            # ---- 18f: render_image_multihost on the group
            scene, cfg, integ = models.get_scene("the_rest_of_your_life")
            _cuda.reset_launch_counts()
            img_f, st_f = render_image_multihost(scene, cfg,
                                                 integrator=integ,
                                                 device=dev)
            counts = _cuda.launch_counts()
            eq_f = (bool(np.array_equal(img_f, img_cc))
                    and bool(np.array_equal(st_f["accum"], st_c["accum"])))
            print(f"[18f render_image_multihost] Book-3 box on the one-rank "
                  f"group: == 18c (image) and render_image (sums) bitwise "
                  f"(required): {eq_f}; K3 launches {counts['megakernel']}",
                  flush=True)
            _check(eq_f and counts["megakernel"] == 1,
                   "render_image_multihost differs from 18c")
        finally:
            dist.destroy_process_group()

        # ---- 18g: the package's entry points in child processes
        dv = ["--device", dev.type]
        g1_s = _child([sys.executable, "-m", "torch.distributed.run",
                       "--standalone", "--nproc_per_node=1", "-m",
                       "rustraytrace_tpu_torch", "the_rest_of_your_life",
                       "--sharded", "-o", ppm("g"), "--quiet", *dv], root,
                      300)
        eq_g = bool(np.array_equal(read_ppm(ppm("g")), img_cc))
        g2_s = _child([sys.executable, "-m", "rustraytrace_tpu_torch",
                       "book1_three_spheres", "--width", "400", "--spp", "16",
                       "-o", ppm("h"), *dv], root, 300)
        shape_h = read_ppm(ppm("h")).shape
        print(f"[18g children] torchrun --standalone --nproc_per_node=1 -m "
              f"rustraytrace_tpu_torch the_rest_of_your_life --sharded: "
              f"{g1_s:.1f} s, == 18c bitwise (required): {eq_g}; python3 -m "
              f"rustraytrace_tpu_torch book1_three_spheres --width 400 "
              f"--spp 16: {g2_s:.1f} s, image {shape_h}", flush=True)
        _check(eq_g, "the torchrun CLI's image differs from 18c")
        _check(shape_h == (225, 400, 3), "the python -m CLI's image shape")

        # ---- 18h: the sphere_kernel route cannot be sharded
        rc, _, _, counts = _cli(dev, [
            "book1_three_spheres", "--backend", "sphere_kernel", "--sharded",
            "-o", ppm("x"), "--quiet"])
        print(f"[18h cli --backend sphere_kernel --sharded] exit {rc} (2 "
              f"required), image written: {os.path.exists(ppm('x'))}",
              flush=True)
        _check(rc == 2 and not os.path.exists(ppm("x"))
               and sum(counts.values()) == 0,
               "--backend sphere_kernel --sharded was not refused")
    return out


def _face_count(sah, grid, dev) -> tuple:
    """(rays, rays hit, winners that differ) between the SAH and the grid
    tables of the final scene: the plain twin's per-thread cull
    (``wavefront._sphere_hits_plain``) on rays aimed at the grid's cell
    faces and on rays leaving the cloud's spheres; a winner is its t, its
    sphere's center and r^2."""
    import torch

    from rustraytrace_tpu_torch import models
    from rustraytrace_tpu_torch.ops import wavefront as wf

    scene = models.get_scene("the_next_week")[0]
    vel = scene.sph_cvel.numpy()
    mask = scene.sph_mask.numpy() > 0
    static = mask & ~(np.abs(vel).max(axis=-1) > 0)
    c = scene.sph_center.numpy()[static]
    r = np.abs(scene.sph_radius.numpy())[static]
    o, d = _torch_scenes().cell_face_rays(c, r, 1 << 18, seed=19)
    rng = np.random.default_rng(20)
    k = rng.choice(np.where(r < 20)[0], 1 << 17)
    nrm = rng.normal(size=(k.size, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    o = torch.from_numpy(np.concatenate([o, c[k] + r[k, None] * nrm]).astype(
        np.float32)).to(dev)
    d = torch.from_numpy(np.concatenate([d, nrm]).astype(np.float32)).to(dev)
    a = (d * d).sum(dim=1)
    win = []
    for tab in (sah, grid):
        t, i = wf._sphere_hits_plain(tab, *o.unbind(1), *d.unbind(1), a,
                                     1.0 / a, torch.zeros_like(a))
        win.append((t, tab.geom[i]))
    (ts, gs), (tg, gg) = win
    hit = (ts < 1e30) | (tg < 1e30)
    differ = hit & ((ts != tg) | (gs != gg).any(dim=1))
    return o.shape[0], int(hit.sum()), int(differ.sum())


def _cloud_scene():
    """The final scene's 1000-sphere cloud (r = 10 in a 165-cube, turned
    and moved as there) under its quad light, on a ground sphere, without
    the image-textured globe: a dense cloud the megakernels take."""
    from rustraytrace_tpu_torch import SceneBuilder

    rng = np.random.default_rng(5)
    b = SceneBuilder()
    b.add_quad((123, 554, 147), (300, 0, 0), (0, 0, 265),
               b.diffuse_light((7.0, 7.0, 7.0)))
    b.add_sphere((278.0, -1000.0, 278.0), 1000.0,
                 b.lambertian((0.48, 0.83, 0.53)))
    white = b.lambertian((0.73, 0.73, 0.73))
    c, s = np.cos(np.radians(15.0)), np.sin(np.radians(15.0))
    for p in rng.uniform(0.0, 165.0, (1000, 3)):
        b.add_sphere((c * p[0] + s * p[2] - 100.0, p[1] + 270.0,
                      -s * p[0] + c * p[2] + 395.0), 10.0, white)
    return b.build()


def _phase19(dev) -> dict:
    """The last ported pieces: (a) the entry points (``graft_entry``:
    ``entry()``'s pass == ``render_pass`` bitwise, ``dryrun_multichip(1)``);
    (b) the sphere grid (``RTT_SPHERE_GRID=1``, ``ops/bvh.py``) on the final
    scene: its tables larger than SAH's, K2, K3, K4 and K5 == their twins
    on them at full lanes, the cell-face winner count, ``render_image``
    with the grid and with SAH (3 runs each, alternating) within 5 SE, the
    COUNT instance's work on both, the K5 route on the grid, and K4's on
    the cloud without the image-textured globe (grid against SAH);
    (c) ``scripts.baseline_matrix`` configs 1, 2, 3 and 5; (d)
    ``scripts.scaling_bench`` at world size 1 on its three backends, each
    pass == the single-card pass of its route bitwise; (e)
    ``scripts.bench_scenes`` ``flagship`` and ``final``, then ``final``
    with the grid and with SAH, 4 runs each, alternating.  Returns the
    launches and errors for the kernels line."""
    import os

    import torch

    from rustraytrace_tpu_torch import graft_entry, models, render
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import _cuda, megakernel as mk
    from rustraytrace_tpu_torch.ops import wavefront as wf
    from rustraytrace_tpu_torch.parallel import Mesh
    from rustraytrace_tpu_torch.scripts import (baseline_matrix,
                                                bench_scenes, scaling_bench)

    out = dict(launches={}, errs={})

    def counted(fn):
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, _cuda.launch_counts()

    # ---- 19a: graft_entry
    fn, args = graft_entry.entry(device=dev)
    got, wall_a, counts_a = counted(lambda: fn(*args))
    scene_a, cam_a, seed_a = args
    want = render.render_pass(scene_a, cam_a, seed_a, width=192, height=108,
                              spp=1, max_depth=8, integrator="path",
                              chunk=16384, device=dev)
    eq_a = bool(torch.equal(got, want))
    dry = graft_entry.dryrun_multichip(1, device=dev)
    out["launches"]["graft_entry.entry"] = ("persist", counts_a["persist"])
    print(f"[19a graft_entry] entry(): the flagship 192x108 1 spp depth 8 "
          f"in {wall_a:.3f} s, launches {counts_a}; == render_pass bitwise "
          f"(required): {eq_a}; dryrun_multichip(1) on the card: loss "
          f"{dry['loss']:.9g} (finite required), mesh {dry['mesh']}",
          flush=True)
    _check(eq_a and counts_a["persist"] > 0, "entry() is not the flagship's "
           "K2 render_pass")
    _check(bool(np.isfinite(dry["loss"])), "the dry run's loss")

    # ---- 19b: the sphere grid on the final scene
    s9, c9, i9 = models.get_scene("the_next_week")
    w9, h9, spp9, d9, seed9 = (c9.image_width, c9.image_height,
                               c9.samples_per_pixel, c9.max_depth, c9.seed)
    cam9 = derive_camera(c9, device=dev)
    grid_env = os.environ.pop("RTT_SPHERE_GRID", None)
    try:
        sah, _ = _route_tables(s9, cam9, c9, i9, dev)
        os.environ["RTT_SPHERE_GRID"] = "1"
        grid, route = _route_tables(s9, cam9, c9, i9, dev)
        rows_g, rows_s = grid.geom.shape[0], sah.geom.shape[0]
        print(f"[19b grid tables] the_next_week: sphere rows {rows_g} in "
              f"{grid.n_clusters} clusters ({grid.n_sclusters} "
              f"super-clusters) with the grid, {rows_s} in "
              f"{sah.n_clusters} ({sah.n_sclusters}) with SAH; more rows "
              f"(required): {rows_g > rows_s}", flush=True)
        _check(route == "image" and rows_g > rows_s,
               "the grid did not take effect on the final scene")
        eq2, err2 = _kernel_vs_plain(grid, "k2", seed9, spp9, d9, iters=8)
        eq3, err3 = _kernel_vs_plain(grid, "k3", seed9, 2, d9)
        k4 = mk.mono_pass(grid, seed9, 0, 2, d9)
        p4 = mk.mono_pass_plain(grid, seed9, 0, 2, d9)
        eq4, err4 = bool(torch.equal(k4, p4)), torch.abs(k4 - p4).max().item()
        eq5, err5, _, died, respawned, _ = _k5_vs_twin(
            grid, seed9, spp=spp9, depth=d9, segments=6)
        out["errs"] = dict(k2=err2, k3=err3, k4=err4, k5=err5)
        print(f"[19b grid kernels] {grid.n_lanes} lanes, kernel vs twin "
              f"bitwise (required): K2 one launch of 8 iterations {eq2} "
              f"({err2:.3g}), K3 2 spp {eq3} ({err3:.3g}), K4 2 spp {eq4} "
              f"({err4:.3g}), K5 six segments {eq5} ({err5:.3g}; {died} "
              f"lanes banked in the first, {respawned} respawned)",
              flush=True)
        _check(eq2 and eq3 and eq4 and eq5,
               "a kernel disagrees with its twin on the grid's tables")
        n_rays, n_hit, n_diff = _face_count(sah, grid, dev)
        out["face"] = dict(rays=n_rays, hit=n_hit, differ=n_diff)
        print(f"[19b cell faces] {n_rays} rays ({n_hit} hit): winners that "
              f"differ between the grid and SAH tables through the twin's "
              f"cull: {n_diff}", flush=True)
        work = {}
        for name, tab in (("sah", sah), ("grid", grid)):
            wk = torch.zeros(len(mk.WORK_NAMES), dtype=torch.int64,
                             device=dev)
            mk.respawn_pass(tab, seed9, 0, 2, d9, work=wk)
            work[name] = _work(wk)
        out["work"] = work
        g, h = work["grid"], work["sah"]
        print(f"[19b grid work] K3 COUNT instance, 2 spp: sphere rows "
              f"{g['sphere_rows']} (SAH {h['sphere_rows']}), cluster boxes "
              f"{g['cluster_boxes']} (SAH {h['cluster_boxes']}); grid {g}; "
              f"SAH {h}", flush=True)

        walls, accs, k2n = {"sah": [], "grid": []}, {}, {}
        for rep in range(3):
            for name in ("sah", "grid"):
                if name == "grid":
                    os.environ["RTT_SPHERE_GRID"] = "1"
                else:
                    os.environ.pop("RTT_SPHERE_GRID", None)
                (img, st), wall, counts = counted(lambda: render.render_image(
                    s9, c9, integrator=i9, device=dev))
                walls[name].append(wall)
                accs[name] = st["accum"] / st["spp_done"]
                k2n[name] = counts["persist"]
                _check(counts["persist"] > 0 and counts["megakernel"] == 0,
                       f"the final scene's {name} render did not run K2")
        mean_d, z = _agreement(accs["grid"], accs["sah"])
        px = int((accs["grid"] != accs["sah"]).any(axis=-1).sum())
        out["launches"]["the_next_week, sphere grid"] = ("persist",
                                                         k2n["grid"])
        out["render"] = dict(walls=walls, z=z, pixels_differ=px,
                             launches=k2n)
        print(f"[19b grid render_image] the_next_week {w9}x{h9} {spp9} spp "
              f"depth {d9}, alternating: grid walls "
              f"{[round(x, 4) for x in walls['grid']]} s, SAH "
              f"{[round(x, 4) for x in walls['sah']]} s; K2 launches "
              f"{k2n}; max |channel-mean diff| {mean_d:.3g}, max |z| of "
              f"4x4 blocks {z:.3f} (< 5 required), pixels that differ {px} "
              f"of {w9 * h9}", flush=True)
        _check(z < 5.0 and bool(np.isfinite(accs["grid"]).all()),
               "the grid's image disagrees with SAH's")

        # the K5 route on the grid; K4's on the cloud without the image
        # texture (the megakernels take no image scene)
        acc5, wall5, c5 = counted(lambda: wf.render_pass_wavefront(
            s9, cam9, seed9, width=w9, height=h9, spp=spp9, max_depth=d9,
            per_bounce_segments=True, device=dev))
        cloud = _cloud_scene()
        k4 = {}
        for name in ("sah", "grid"):
            if name == "grid":
                os.environ["RTT_SPHERE_GRID"] = "1"
            else:
                os.environ.pop("RTT_SPHERE_GRID", None)
            rows = mk.prepare_megakernel(cloud, cam9, width=w9, height=h9,
                                         device=dev).geom.shape[0]
            acc, wall, counts = counted(lambda: mk.render_pass_megakernel(
                cloud, cam9, seed9, width=w9, height=h9, spp=spp9,
                max_depth=d9, device=dev))
            k4[name] = (rows, acc.cpu().numpy() / spp9, wall, counts["mono"])
        os.environ["RTT_SPHERE_GRID"] = "1"
        _, z4 = _agreement(k4["grid"][1], k4["sah"][1])
        eq4 = bool(np.array_equal(k4["grid"][1], k4["sah"][1]))
        out["launches"]["the_next_week, sphere grid (K5)"] = (
            "segment", c5["segment"])
        out["launches"]["1000-sphere cloud, sphere grid (K4)"] = (
            "mono", k4["grid"][3])
        print(f"[19b grid K5, K4 routes] the_next_week per_bounce_segments "
              f"{wall5:.3f} s ({c5['segment']} K5); the cloud without the "
              f"globe through render_pass_megakernel {w9}x{h9} {spp9} spp: "
              f"grid {k4['grid'][0]} rows, {k4['grid'][2]:.3f} s "
              f"({k4['grid'][3]} K4), SAH {k4['sah'][0]} rows, "
              f"{k4['sah'][2]:.3f} s; max |z| {z4:.3f} (< 5 required), "
              f"bitwise equal {eq4}", flush=True)
        _check(c5["segment"] > 0 and bool(torch.isfinite(acc5).all()),
               "the K5 route on the grid")
        _check(k4["grid"][0] > k4["sah"][0] and k4["grid"][3] == 1
               and z4 < 5.0, "the K4 route on the grid")
    finally:
        os.environ.pop("RTT_SPHERE_GRID", None)
        if grid_env is not None:
            os.environ["RTT_SPHERE_GRID"] = grid_env

    # ---- 19c: BASELINE configs 1, 2, 3 and 5 (one JSON line each)
    out["baseline"] = {}
    for config in (1, 2, 3, 5):
        rec, wall, counts = counted(lambda: baseline_matrix.run(
            config, device=dev))
        rec["launches"] = {k: v for k, v in counts.items() if v}
        out["baseline"][config] = rec
        kern = "persist" if counts["persist"] else "megakernel"
        out["launches"][f"baseline_matrix config {config}"] = (kern,
                                                               counts[kern])
        print(f"[19c baseline_matrix {config}] {wall:.1f} s for the script's "
              f"warm-up and timed renders; launches {rec['launches']}",
              flush=True)
        _check(rec["paths_per_s"] > 0 and counts[kern] > 0,
               f"BASELINE config {config}")

    # ---- 19d: scaling_bench at world size 1
    out["scaling"] = {}
    for backend in ("xla", "megakernel", "wavefront"):
        scene, cfg = scaling_bench.scene_for(backend, 384, 8, 8)
        cam = derive_camera(cfg, device=dev)
        w, h = cfg.image_width, cfg.image_height
        got, _, counts = counted(lambda: scaling_bench.run_pass(
            backend, scene, cam, Mesh(1, 1), width=w, height=h, spp=8,
            depth=8, device=dev))
        kw = dict(width=w, height=h, spp=8, max_depth=8, device=dev)
        if backend == "xla":
            want = render.render_pass(scene, cam, 0, backend="reference",
                                      chunk=16384, **kw)
        elif backend == "megakernel":
            want = mk.render_pass_megakernel(scene, cam, 0, respawn=True,
                                             **kw)
        else:
            want = render.render_pass(scene, cam, 0, **kw)
        eq = bool(torch.equal(got, want))
        scaling_bench.main(["--backend", backend])
        out["scaling"][backend] = {k: v for k, v in counts.items() if v}
        print(f"[19d scaling_bench {backend}] one-rank pass == the "
              f"single-card pass bitwise (required): {eq}; launches "
              f"{out['scaling'][backend]}", flush=True)
        _check(eq, f"scaling_bench {backend} differs from its route")
    out["launches"]["scaling_bench megakernel"] = (
        "megakernel", out["scaling"]["megakernel"].get("megakernel", 0))
    out["launches"]["scaling_bench wavefront"] = (
        "persist", out["scaling"]["wavefront"].get("persist", 0))

    # ---- 19e: bench_scenes flagship and final
    for case in ("flagship", "final"):
        rec, wall, counts = counted(lambda: bench_scenes.run_case(
            case, device=dev))
        kern = "persist" if counts["persist"] else "megakernel"
        out["launches"][f"bench_scenes {case}"] = (kern, counts[kern])
        print(f"[19e bench_scenes {case}] {wall:.1f} s (a warm-up and 2 "
              f"timed passes); launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        _check(rec["paths_per_s"] > 0, f"bench_scenes {case}")

    # the grid against SAH on `final`, alternating in this process: each
    # entry is run_case's best of 2; the rows are the prepared tables'
    grid_env = os.environ.pop("RTT_SPHERE_GRID", None)
    ab, rows = {"sah": [], "grid": []}, {}
    try:
        for rep in range(4):
            for name in ("sah", "grid"):
                if name == "grid":
                    os.environ["RTT_SPHERE_GRID"] = "1"
                else:
                    os.environ.pop("RTT_SPHERE_GRID", None)
                rec = bench_scenes.run_case("final", device=dev)
                ab[name].append(rec["elapsed_s"])
                rows[name] = mk._PREP_CACHE[-1][2].geom.shape[0]
    finally:
        os.environ.pop("RTT_SPHERE_GRID", None)
        if grid_env is not None:
            os.environ["RTT_SPHERE_GRID"] = grid_env
    out["final_ab"] = dict(walls=ab, rows=rows)
    print(f"[19e bench_scenes final, grid against SAH] alternating in one "
          f"process, best of 2 each: grid {ab['grid']} s ({rows['grid']} "
          f"sphere rows), SAH {ab['sah']} s ({rows['sah']} rows); grid "
          f"rows > SAH rows (required): {rows['grid'] > rows['sah']}",
          flush=True)
    _check(rows["grid"] > rows["sah"], "the grid did not take effect on "
           "bench_scenes final")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from rustraytrace_tpu_torch import models, render
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import _cuda, hit, megakernel as mk
    from rustraytrace_tpu_torch.ops import wavefront as wf

    dev = torch.device("cuda")
    smi = _cmd("nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader").splitlines()[0]
    nvcc = _cmd(_cuda._nvcc(), "--version").splitlines()[-1]
    print(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__}"
          f" cuda {torch.version.cuda} | {nvcc} | {smi}", flush=True)

    t_start = t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    regs = _registers(_cuda.build_info["log"])
    print(f"[2 build] {build_s:.2f} s (nvcc {_cuda.build_info['seconds']:.2f}"
          f" s, one process per source) {regs}", flush=True)

    # ---- 3: K1 closest hit vs its plain version, flagship tables
    scene, cfg, _ = models.book1_random_spheres(
        dict(image_width=1200, samples_per_pixel=FLAGSHIP_SPP,
             max_depth=50))
    sph = hit.pack_sphere_table(scene).to(dev)
    quad = torch.zeros((0, hit.Q_COLS), dtype=torch.float32, device=dev)
    o, d, tm = (torch.from_numpy(x).to(dev) for x in _rays(1 << 20, 1))
    t_k, i_k = hit.sphere_hit(o, d, tm, sph, quad, False)
    t_p, i_p = hit.sphere_hit_plain(o, d, tm, sph, quad, False)
    same_i = (i_k == i_p).float().mean().item()
    k1_equal = bool(torch.equal(i_k, i_p) and torch.equal(t_k, t_p))
    k1_err = torch.abs(t_k - t_p).max().item()
    # as on the route: the float4 planes built once for the table
    f4 = hit.sphere_table_f4(sph)
    k1_ms = _cuda_ms(lambda: hit.sphere_hit(o, d, tm, sph, quad, False,
                                            f4=f4), 20)
    k1_plain_ms = _cuda_ms(
        lambda: hit.sphere_hit_plain(o, d, tm, sph, quad, False), 3)
    # full scan: every ray tests every sphere; 7 f32 in and 2 words out
    n_rays = o.shape[0]
    k1_bound, k1_by = _bound(n_rays * (sph.shape[0] * OPS["sphere"] + 6),
                             n_rays * 9 * 4)
    print(f"[3 K1 sphere_hit] 2^20 rays x {sph.shape[0]} spheres: idx equal "
          f"{same_i:.6f}, max |dt| {k1_err:.3g}, t and idx bitwise equal "
          f"(required): {k1_equal}; kernel {k1_ms:.3f} ms, plain "
          f"{k1_plain_ms:.3f} ms, bound {k1_bound:.3f} ms ({k1_by})",
          flush=True)
    _check(k1_equal, "K1 disagrees with plain")
    k1_cases = _k1_cases(dev)
    for case, (eq, err, n, ns, nq) in k1_cases.items():
        print(f"[3b K1 {case}] {n} rays x {ns} spheres, {nq} quads: max "
              f"|dt| {err:.3g}, t and idx bitwise equal (required): {eq}",
              flush=True)
        _check(eq, f"K1 disagrees with plain on {case}")

    # ---- 4: one bounded persist launch, kernel vs plain
    s4, c4, _ = models.book1_random_spheres(dict(image_width=160))
    tab4 = mk.prepare_megakernel(s4, derive_camera(c4, device=dev), width=160,
                                 height=c4.image_height, device=dev)
    R4 = tab4.n_lanes
    st_k = torch.zeros((wf.N_STATE, R4), dtype=torch.float32, device=dev)
    st_p = st_k.clone()
    sl4 = torch.arange(R4, dtype=torch.int32, device=dev)
    kw4 = dict(persist_iters=8, spp=4, max_depth=50, sample_offset=0)
    wf.persist_step(st_k, sl4, tab4, 11, **kw4)
    wf.persist_step_plain(st_p, sl4, tab4, 11, **kw4)
    torch.cuda.synchronize()
    row_frac = (st_k == st_p).float().mean(dim=1)
    p_equal = bool(torch.equal(st_k, st_p))
    p_err = torch.abs(st_k - st_p).max().item()
    # time at the main path's shape: the flagship's 856,064 lanes
    tabF = mk.prepare_megakernel(scene, derive_camera(cfg, device=dev), width=1200,
                                 height=cfg.image_height, device=dev)
    RF = tabF.n_lanes
    slF = torch.arange(RF, dtype=torch.int32, device=dev)
    kwF = dict(persist_iters=8, spp=FLAGSHIP_SPP, max_depth=50)
    p_ms = _cuda_ms(lambda: wf.persist_step(
        torch.zeros((wf.N_STATE, RF), device=dev), slF, tabF, 3, **kwF), 5)
    p_plain_ms = _cuda_ms(lambda: wf.persist_step_plain(
        torch.zeros((wf.N_STATE, RF), device=dev), slF, tabF, 3, **kwF), 1)
    workF = torch.zeros(len(mk.WORK_NAMES), dtype=torch.int64,
                        device=dev)
    wf.persist_step(torch.zeros((wf.N_STATE, RF), device=dev), slF, tabF, 3,
                    work=workF, **kwF)
    # state read and written once, the slot read once
    p_bound, p_by = _bound(_path_ops(workF, tabF), RF * (2 * wf.N_STATE + 1)
                           * 4)
    print(f"[4 persist launch] 160x90 4 spp 8 iters ({R4} lanes): lanes "
          f"bitwise equal per row min {row_frac.min().item():.6f}, max "
          f"|diff| {p_err:.3g}, state bitwise equal (required): {p_equal}; "
          f"at {RF} lanes x 8 iters: kernel {p_ms:.2f} ms, plain "
          f"{p_plain_ms:.2f} ms; work {_work(workF)}, bound "
          f"{p_bound:.3f} ms ({p_by})", flush=True)
    _check(p_equal, "persist kernel disagrees with its plain step")

    # ---- 4b: one bounded persist launch with MIS, quads and strata
    sB, cB, _ = models.book3_cornell_box(dict(image_width=160))
    tabB = mk.prepare_megakernel(sB, derive_camera(cB, device=dev), width=160,
                                 height=160, mis=True, stratified=True,
                                 sqrt_spp=2, device=dev)
    stB_k = torch.zeros((wf.N_STATE, tabB.n_lanes), device=dev)
    stB_p = stB_k.clone()
    slB = torch.arange(tabB.n_lanes, dtype=torch.int32, device=dev)
    kwB = dict(persist_iters=8, spp=4, max_depth=50, sample_offset=0)
    wf.persist_step(stB_k, slB, tabB, 11, **kwB)
    wf.persist_step_plain(stB_p, slB, tabB, 11, **kwB)
    torch.cuda.synchronize()
    b_equal = bool(torch.equal(stB_k, stB_p))
    print(f"[4b persist launch, MIS] book3_cornell_box 160x160 4 spp (2x2 "
          f"strata) 8 iters ({tabB.n_lanes} lanes, {tabB.n_quads} quads, "
          f"{tabB.n_lights} lights): max |diff| "
          f"{torch.abs(stB_k - stB_p).max().item():.3g}, state bitwise "
          f"equal (required): {b_equal}", flush=True)
    _check(b_equal, "MIS persist kernel disagrees with its plain step")

    # ---- 4c: K2 at the flagship's main-path launch: two 128-iteration
    # launches and their sorts, then the third from copies of that state
    loopF = _k2_main_launch(scene, cfg, "path", dev, 3, spp=FLAGSHIP_SPP)
    itF = loopF[4]["persist_iters"]
    k2F = _k2_launch(loopF, reps=5)
    del loopF
    print(f"[4c K2 flagship main-path launch] launch 3 of the sorted loop, "
          f"{RF} lanes x {itF} iterations: kernel {k2F['ms']:.3f} ms; work "
          f"{k2F['work']}, bound {k2F['bound']:.4f} ms ({k2F['by']}), SIMT "
          f"efficiency of the leaf scans {k2F['simt']:.4f}; 8 iterations "
          f"from that state vs plain ({k2F['plain_ms']:.1f} ms): max |diff| "
          f"{k2F['err']:.3g}, bitwise equal (required): {k2F['equal']}",
          flush=True)
    _check(k2F["equal"], "K2 disagrees with its plain step at the "
           "flagship's main-path launch")

    # ---- 5: bitwise invariance of the kernel render to the ray sort
    s5, c5, _ = models.book1_random_spheres(dict(image_width=320))
    tab5 = mk.prepare_megakernel(s5, derive_camera(c5, device=dev), width=320,
                                 height=c5.image_height, device=dev)
    kw5 = dict(spp=16, max_depth=50, persist_iters=wf.persist_plain_iters(16))
    on = wf._wavefront_pass_persist(tab5, 5, 0, sort_rays=True, **kw5)
    off = wf._wavefront_pass_persist(tab5, 5, 0, sort_rays=False, **kw5)
    same = bool(torch.equal(on, off))
    print(f"[5 sort invariance] 320x180 16 spp: sorted == unsorted sums "
          f"bitwise: {same}", flush=True)
    _check(same, "sorted and unsorted renders differ")

    # ---- 6: the flagship through the entry points
    w, h, spp = cfg.image_width, cfg.image_height, FLAGSHIP_SPP
    cam = derive_camera(cfg, device=dev)
    _cuda.reset_launch_counts()
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = render.render_pass(scene, cam, cfg.seed, width=w, height=h,
                             spp=spp, max_depth=50, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    acc_np = acc.cpu().numpy()
    img = render.finalize_image(acc_np, spp)
    pps = w * h * spp / wall
    sort_ms = 1e3 * stats["sort_seconds"] / max(stats["sorts"], 1)
    print(f"[6 flagship] {w}x{h} {spp} spp depth 50: {wall:.3f} s, "
          f"{pps:.6g} paths/s, {stats['launches']} launches, sort+permute "
          f"{sort_ms:.3f} ms/launch; kernel launch counts {counts}",
          flush=True)
    _check(counts["persist"] > 0, "main path never launched the kernel")
    _check(counts["persist"] == stats["launches"],
           "persist launch count differs from the loop's launches")

    # the pass loop of render_image on the card, counted on its own
    _cuda.reset_launch_counts()
    small_cfg = cfg.replace(image_width=320, samples_per_pixel=64,
                            spp_per_pass=16)
    passes_seen = []
    img_small, st_small = render.render_image(
        scene, small_cfg, device=dev, on_pass=lambda st: passes_seen.append(
            (st["accum"].device.type, np.asarray(st["accum"]).shape)))
    small_counts = _cuda.launch_counts()
    print(f"[6 render_image] 320x180 64 spp in passes of 16: done "
          f"{st_small['spp_done']}; kernel launch counts {small_counts}; "
          f"on_pass got {passes_seen}", flush=True)
    _check(small_counts["persist"] > 0 and st_small["spp_done"] == 64,
           "render_image did not run the kernel's pass loop")
    _check(passes_seen == [("cpu", (180, 320, 3))] * 4,
           "on_pass did not get a host copy of each pass's sum")
    _check(bool(np.isfinite(acc_np).all()), "non-finite flagship sums")
    _check(img.shape == (h, w, 3) and img_small.shape == (180, 320, 3),
           "image shapes")

    # the kernel image against the plain version on the same card
    plain8 = render.render_pass(scene, cam, cfg.seed, width=w, height=h,
                                spp=8, max_depth=50, backend="plain",
                                device=dev).cpu().numpy()
    kern8 = render.render_pass(scene, cam, cfg.seed, width=w, height=h,
                               spp=8, max_depth=50,
                               device=dev).cpu().numpy()
    px_equal = np.mean(np.all(kern8 == plain8, axis=-1))
    img_equal = bool(np.array_equal(kern8, plain8))
    img_err = float(np.max(np.abs(kern8 - plain8)))
    ch_err, zmax = _agreement(acc_np / spp, plain8 / 8.0)
    print(f"[6 flagship check] same-seed {w}x{h} 8 spp kernel vs plain: "
          f"pixels bitwise equal {px_equal:.6f}, max |diff| {img_err:.3g}, "
          f"image bitwise equal (required): {img_equal}; {spp} spp kernel "
          f"vs 8 spp plain: channel mean |diff| {ch_err:.4g} (need < "
          f"0.01), 4x4 block max |z| {zmax:.3f} (need < 5)", flush=True)
    _check(img_equal, "kernel and plain flagship renders differ")
    _check(ch_err < 0.01 and zmax < 5.0, "flagship image is off")

    # ---- 7: the Book-3 Cornell box through render_image, one K3 pass
    s7, c7, integ7 = models.book3_cornell_box()
    w7, h7, spp7, seed7 = c7.image_width, c7.image_height, 100, c7.seed
    _check((w7, h7, c7.samples_per_pixel, c7.max_depth, integ7,
            c7.stratified) == (600, 600, spp7, 50, "mis", True),
           "book3_cornell_box is not the 600x600 100 spp MIS config")
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img7, st7 = render.render_image(s7, c7, integrator=integ7, device=dev)
    torch.cuda.synchronize()
    wall7 = time.perf_counter() - t0
    counts7 = _cuda.launch_counts()
    passes7 = -(-spp7 // render.effective_spp_per_pass(
        c7, "megakernel", spp7, w7 * h7))
    acc7 = st7["accum"] / st7["spp_done"]
    print(f"[7 book3_cornell_box] {w7}x{h7} {spp7} spp (10x10 strata) depth "
          f"50 MIS through render_image: {wall7:.3f} s, "
          f"{w7 * h7 * spp7 / wall7:.6g} paths/s, {passes7} pass(es); "
          f"kernel launch counts {counts7}; channel means "
          f"{np.round(acc7.mean(axis=(0, 1)), 5).tolist()}", flush=True)
    _check(counts7["megakernel"] == passes7 > 0,
           "the Cornell box did not run one K3 launch per pass")
    _check(counts7["persist"] == 0, "the Cornell box ran the persist kernel")
    _check(st7["spp_done"] == spp7 and img7.shape == (h7, w7, 3)
           and bool(np.isfinite(acc7).all()), "Cornell box image")

    # K3 on the main path's tables (10x10 strata), same seed, 4 spp from
    # sample 48 (strata (8,4), (9,4), (0,5), (1,5): the row wraps): kernel
    # vs plain twin vs the unsorted persist loop
    cam7 = derive_camera(c7, device=dev)
    tab100 = mk.prepare_megakernel_cached(
        s7, cam7, width=w7, height=h7, tile_rows=mk.respawn_tile_rows(s7),
        mis=True, stratified=True, sqrt_spp=10, device=dev)
    R7, off7 = tab100.n_lanes, 48
    k3_sums = mk.respawn_pass(tab100, seed7, off7, 4, 50)
    p3_sums, k3_plain_ms = _cuda_ms_once(
        lambda: mk.respawn_pass_plain(tab100, seed7, off7, 4, 50))
    k2_sums = wf._wavefront_pass_persist(
        tab100, seed7, off7, spp=4, max_depth=50,
        persist_iters=wf.persist_plain_iters(4), sort_rays=False)
    k3_equal = bool(torch.equal(k3_sums, p3_sums))
    k3_err = torch.abs(k3_sums - p3_sums).max().item()
    k3_k2 = bool(torch.equal(k3_sums, k2_sums))
    # the statistical reference of the 100-spp image: a 4-spp plain render
    # in 2x2 strata through the entry point
    plain4 = render.render_pass(
        s7, cam7, seed7, width=w7, height=h7, spp=4, max_depth=50,
        integrator="mis", stratified=True, sqrt_spp=2, backend="plain",
        device=dev).cpu().numpy()
    ch7, z7 = _agreement(acc7, plain4 / 4.0)
    print(f"[7 K3 check] same-seed {R7} lanes x 4 spp (10x10 strata, samples "
          f"{off7}-{off7 + 3}): kernel vs plain twin max |diff| {k3_err:.3g},"
          f" bitwise equal (required): {k3_equal}; K3 sums == unsorted K2 "
          f"loop sums bitwise (required): {k3_k2}; {spp7} spp kernel vs 4 "
          f"spp (2x2 strata) plain: channel mean |diff| {ch7:.4g} (need < "
          f"0.01), 4x4 block max |z| {z7:.3f} (need < 5)", flush=True)
    _check(k3_equal, "K3 and its plain twin differ")
    _check(k3_k2, "K3 and the unsorted persist loop differ")
    _check(ch7 < 0.01 and z7 < 5.0, "Cornell box image is off")

    # K3 at the main path's shape, 372,736 lanes x 100 spp, and at the plain
    # twin's (4 spp); the work counted by the COUNT instance
    k3p = _mk_profile("megakernel", tab100, seed7, spp7, 50, reps=2)
    k3_ms, k3_bound, k3_by = k3p["ms"], k3p["bound"], k3p["by"]
    k3_ms4 = _cuda_ms(lambda: mk.respawn_pass(tab100, seed7, off7, 4, 50), 3)
    print(f"[7 K3 timing] {R7} lanes: kernel {k3_ms:.2f} ms at {spp7} spp, "
          f"{k3_ms4:.3f} ms at 4 spp; plain twin {k3_plain_ms:.2f} ms at 4 "
          f"spp; work at {spp7} spp {k3p['work']}, "
          f"{k3p['work']['bounces'] / (R7 * spp7):.3f} bounces/path, bound "
          f"{k3_bound:.3f} ms ({k3_by}); lane-use share "
          f"{k3p['lane_use']:.4f}, tail share {k3p['tail_share']:.4f}",
          flush=True)

    # ---- 8: the other K3 routes, each held against the plain twin at its
    # full lane count and reduced spp
    s8, c8, integ8 = models.book2_cornell_box()
    w8, h8 = c8.image_width, c8.image_height
    passes8 = -(-200 // render.effective_spp_per_pass(
        c8, "wavefront", 200, w8 * h8))
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st8 = render.render_image(s8, c8, integrator=integ8, device=dev)
    torch.cuda.synchronize()
    wall8 = time.perf_counter() - t0
    counts8 = _cuda.launch_counts()
    acc8 = st8["accum"] / st8["spp_done"]
    cam8 = derive_camera(c8, device=dev)
    tab8 = mk.prepare_megakernel_cached(
        s8, cam8, width=w8, height=h8, tile_rows=mk.respawn_tile_rows(s8),
        device=dev)
    k8 = mk.respawn_pass(tab8, c8.seed, 0, 4, c8.max_depth)
    p8 = mk.respawn_pass_plain(tab8, c8.seed, 0, 4, c8.max_depth)
    eq8, err8 = bool(torch.equal(k8, p8)), torch.abs(k8 - p8).max().item()
    print(f"[8 book2_cornell_box] {w8}x{h8} {st8['spp_done']} spp depth "
          f"{c8.max_depth} path through render_image: {wall8:.3f} s, "
          f"{w8 * h8 * 200 / wall8:.6g} paths/s, {passes8} passes; kernel "
          f"launch counts {counts8}; same-seed {tab8.n_lanes} lanes x 4 spp "
          f"kernel vs plain twin max |diff| {err8:.3g}, bitwise equal "
          f"(required): {eq8}", flush=True)
    _check(counts8["megakernel"] == passes8 and counts8["persist"] == 0,
           "book2_cornell_box did not run one K3 launch per pass")
    _check(eq8, "K3 and its plain twin differ on book2_cornell_box")
    _check(st8["spp_done"] == 200 and bool(np.isfinite(acc8).all())
           and acc8.mean() > 0.05, "book2_cornell_box image")

    s4k, c4k, _ = models.book1_random_spheres(dict(image_width=3840))
    w4k, h4k = c4k.image_width, c4k.image_height
    cam4k = derive_camera(c4k, device=dev)
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc4k = render.render_pass(s4k, cam4k, c4k.seed, width=w4k, height=h4k,
                               spp=16, max_depth=50, device=dev)
    torch.cuda.synchronize()
    wall4k = time.perf_counter() - t0
    counts4k = _cuda.launch_counts()
    tab4k = mk.prepare_megakernel_cached(
        s4k, cam4k, width=w4k, height=h4k,
        tile_rows=mk.respawn_tile_rows(s4k), mis=False, stratified=False,
        sqrt_spp=0, device=dev)
    k4k = mk.respawn_pass(tab4k, c4k.seed, 0, 1, 50)
    p4k, p4k_ms = _cuda_ms_once(
        lambda: mk.respawn_pass_plain(tab4k, c4k.seed, 0, 1, 50))
    eq4k = bool(torch.equal(k4k, p4k))
    err4k = torch.abs(k4k - p4k).max().item()
    print(f"[8 flagship 4K] {w4k}x{h4k} 16 spp depth 50 through render_pass "
          f"({tab4k.n_lanes} slot lanes > 2 Mi: K3 with the SAH cull over "
          f"{tab4k.n_clusters} clusters): {wall4k:.3f} s, "
          f"{w4k * h4k * 16 / wall4k:.6g} paths/s;"
          f" kernel launch counts {counts4k}; same-seed 1 spp kernel vs plain "
          f"twin ({p4k_ms:.0f} ms) max |diff| {err4k:.3g}, bitwise equal "
          f"(required): {eq4k}", flush=True)
    _check(counts4k["megakernel"] == 1 and counts4k["persist"] == 0,
           "the 4K flagship pass did not run one K3 launch")
    _check(eq4k, "K3 and its plain twin differ on the 4K flagship")
    _check(bool(torch.isfinite(acc4k).all()), "non-finite 4K sums")
    k4kp = _mk_profile("megakernel", tab4k, c4k.seed, 16, 50, reps=2)
    print(f"[8 flagship 4K K3] {tab4k.n_lanes} lanes x 16 spp: kernel "
          f"{k4kp['ms']:.2f} ms, bound {k4kp['bound']:.3f} ms "
          f"({k4kp['by']}); SIMT efficiency of the leaf scans "
          f"{k4kp['simt']:.4f}, lane-use share {k4kp['lane_use']:.4f}, "
          f"tail share {k4kp['tail_share']:.4f} ({k4kp['warps']} warps); "
          f"work {k4kp['work']}", flush=True)

    # the two-level cull (>= 16 clusters), which no ported reference scene
    # reaches: 1500 spheres on the ground, K3 vs plain twin
    sF = _field_scene(1500, 4)
    tabS = mk.prepare_megakernel(sF, derive_camera(c5, device=dev), width=320,
                                 height=c5.image_height, device=dev)
    kS = mk.respawn_pass(tabS, 7, 0, 4, 50)
    pS = mk.respawn_pass_plain(tabS, 7, 0, 4, 50)
    eqS, errS = bool(torch.equal(kS, pS)), torch.abs(kS - pS).max().item()
    # the grid does not change a slot's sums: one block walks the queue
    one3 = bool(torch.equal(mk.respawn_pass(tabS, 7, 0, 4, 50,
                                            max_blocks=1), kS))
    one4 = bool(torch.equal(mk.mono_pass(tabS, 7, 0, 4, 50, max_blocks=1),
                            kS))
    print(f"[8 two-level cull] 1500-sphere field 320x180 4 spp: "
          f"{tabS.n_sclusters} super-clusters of {tabS.n_clusters} clusters;"
          f" K3 vs plain twin max |diff| {errS:.3g}, bitwise equal "
          f"(required): {eqS}; a one-block grid == the full grid, K3 and "
          f"K4, bitwise (required): {one3} / {one4}", flush=True)
    _check(tabS.n_sclusters > 1, "the field scene has no super-clusters")
    _check(eqS, "K3 and its plain twin differ under the two-level cull")
    _check(one3 and one4, "a one-block grid changes the megakernels' sums")

    r9 = _phase9(dev)
    p7 = dict(scene=s7, cfg=c7, cam=cam7, tables=tab100, off=off7,
              accum=st7["accum"], plain4=plain4, k3_sums=k3_sums,
              k3_ms=k3_ms, regs=regs)
    r10 = _phase10(dev, p7)
    r11 = _phase11(dev, r9)
    r12 = _phase12(dev)
    err13 = _phase13(dev)
    r14 = _phase14(dev)
    r15 = _phase15(dev)
    r16 = _phase16(dev)
    s1 = r16["res"]
    r17 = _phase17(dev)
    r18 = _phase18(dev, smi)
    r19 = _phase19(dev)

    def by_path(kernel: str) -> dict:
        """Phase 19's main paths that launched ``kernel``."""
        return {p: n for p, (k, n) in r19["launches"].items() if k == kernel}

    k3_errs = {"book3_cornell_box": k3_err, "book2_cornell_box": err8,
               "flagship_4k": err4k, "field_1500": errS,
               **{k: r9["errs"][k] for k in r9["k3_cells"]},
               "quad_field_1024": r12["err"], "smoke_mis": err13,
               "inverse_rendering": r17["kernel_fwd_err"],
               "the_next_week, sphere grid": r19["errs"]["k3"]}
    # K2 too, where the config-4 forward launched it
    k2_ir = ({"inverse_rendering": r17["kernel_fwd_err"]}
             if r17["kernel_fwd_launches"].get("persist") else {})
    kernels = [dict(name="sphere_hit", route="cuda",
                    source="rustraytrace_tpu_torch/csrc/sphere_hit.cu",
                    replaces="rustraytrace_tpu/ops/pallas_hit.py:164",
                    launches=r14["launches"],
                    launches_by_path={"flagship, sphere_kernel route":
                                      r14["launches"]},
                    max_abs_err=max(k1_err, r14["err"],
                                    *(v[1] for v in k1_cases.values())),
                    ms=r14["ms"],
                    plain_ms=r14["plain_ms"], bound_ms=r14["bound"],
                    bound_by=r14["by"], library_ms=None,
                    ms_shape=f"{r14['n_rays']} first-bounce rays x "
                             f"{r14['n_sph']} spheres, flagship 16 spp",
                    plain_ms_shape=f"{r14['n_rays']} first-bounce rays x "
                                   f"{r14['n_sph']} spheres",
                    random_rays_ms=k1_ms, random_rays_plain_ms=k1_plain_ms,
                    random_rays_bound_ms=k1_bound,
                    random_rays_shape=f"2^20 rays x {sph.shape[0]} spheres"),
               dict(name="persist", route="cuda",
                    source="rustraytrace_tpu_torch/csrc/persist.cu",
                    replaces="rustraytrace_tpu/ops/pallas_wavefront.py:382",
                    launches=r9["k2_launches"],
                    launches_by_path={"the_next_week": r9["k2_launches"],
                                      "flagship": counts["persist"],
                                      "inverse_rendering, forward='kernel'":
                                      r17["kernel_launches"]["persist"],
                                      "cli in_one_weekend": r18["k2_cli"],
                                      "cli --sharded in_one_weekend":
                                      r18["k2_shard"],
                                      "cli --sharded the_next_week":
                                      r18["k2_final"], **by_path("persist")},
                    max_abs_err=max(img_err, r9["k2_err"], *k2_ir.values(),
                                    r19["errs"]["k2"]),
                    max_abs_err_by_route=dict(flagship=img_err,
                                              **r9["errs"], **k2_ir, **{
                                                  "the_next_week, sphere "
                                                  "grid": r19["errs"]["k2"]}),
                    ms=r9["k2_ms"], plain_ms=r9["k2_plain_ms"],
                    bound_ms=r9["k2_bound"], bound_by=r9["k2_by"],
                    library_ms=None, work=r9["k2_work"],
                    ms_shape=f"{r9['R9']} lanes x {r9['iters9']} "
                             "iterations, the_next_week launch 119 of 237",
                    plain_ms_shape=f"{r9['R9']} lanes x 8 iterations from "
                                   "the same state",
                    simt_efficiency=r9["k2_simt"],
                    zero_state_ms=r9["k2_zero_ms"],
                    zero_state_plain_ms=r9["k2_zero_plain_ms"],
                    zero_state_bound_ms=r9["k2_zero_bound"],
                    flagship_main_launch_ms=k2F["ms"],
                    flagship_main_launch_bound_ms=k2F["bound"],
                    flagship_main_launch_plain_ms=k2F["plain_ms"],
                    flagship_main_launch_simt_efficiency=k2F["simt"],
                    flagship_main_launch_work=k2F["work"],
                    flagship_main_launch_shape=f"{RF} lanes x {itF} "
                    "iterations, flagship launch 3 of 52 (plain: 8)",
                    flagship_ms=p_ms, flagship_plain_ms=p_plain_ms,
                    flagship_bound_ms=p_bound,
                    flagship_shape=f"{RF} lanes x 8 iterations from a "
                                   "zeroed state, flagship"),
               dict(name="megakernel", route="cuda",
                    source="rustraytrace_tpu_torch/csrc/megakernel.cu",
                    replaces="rustraytrace_tpu/ops/pallas_megakernel.py:2087",
                    launches=counts7["megakernel"],
                    launches_by_path={"book3_cornell_box":
                                      counts7["megakernel"],
                                      "the_next_week": 0,
                                      "inverse_rendering, forward='kernel'":
                                      r17["kernel_launches"]["megakernel"],
                                      "cli --sharded the_rest_of_your_life":
                                      r18["k3_shard"],
                                      **by_path("megakernel")},
                    max_abs_err=max(k3_errs.values()),
                    max_abs_err_by_route=k3_errs,
                    ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_bound,
                    bound_by=k3_by, library_ms=None, work=k3p["work"],
                    lane_use_share=k3p["lane_use"],
                    tail_share=k3p["tail_share"],
                    ms_shape=f"{R7} lanes x {spp7} spp, book3_cornell_box",
                    plain_ms_shape=f"{R7} lanes x 4 spp, book3_cornell_box",
                    ms_at_plain_shape=k3_ms4,
                    final_scene_ms=r9["k3f_ms"],
                    final_scene_bound_ms=r9["k3f_bound"],
                    final_scene_bound_by=r9["k3f_by"],
                    final_scene_work=r9["k3f_work"],
                    final_scene_shape=f"{r9['R9']} lanes x 2 spp, "
                                      "the_next_week",
                    flagship_4k_ms=k4kp["ms"],
                    flagship_4k_bound_ms=k4kp["bound"],
                    flagship_4k_simt_efficiency=k4kp["simt"],
                    flagship_4k_lane_use_share=k4kp["lane_use"],
                    flagship_4k_tail_share=k4kp["tail_share"],
                    flagship_4k_work=k4kp["work"],
                    flagship_4k_shape=f"{tab4k.n_lanes} lanes x 16 spp",
                    book2_400x225=r9["k3_cells"],
                    quad_field_ms=r12["k3_ms"],
                    quad_field_linear_scan_ms=r12["lin_ms"]),
               dict(name="mono", route="cuda",
                    source="rustraytrace_tpu_torch/csrc/mono.cu",
                    replaces="rustraytrace_tpu/ops/pallas_megakernel.py:2087",
                    launches=r10["launches"],
                    launches_by_path={"book3_cornell_box (K4)":
                                      r10["launches"], **by_path("mono")},
                    max_abs_err=max(r10["err"], err13, r19["errs"]["k4"]),
                    ms=r10["ms"], plain_ms=r10["plain_ms"],
                    bound_ms=r10["bound"], bound_by=r10["by"],
                    library_ms=None, work=r10["work"],
                    ms_shape=f"{r10['R']} lanes x 100 spp, "
                             "book3_cornell_box",
                    plain_ms_shape=f"{r10['R']} lanes x 2 spp, "
                                   "book3_cornell_box",
                    k3_ms_same_shape=k3_ms,
                    lane_use_share=r10["lane_use"], tail_share=r10["tail"],
                    registers=r10["regs"],
                    smoke_ms=r10["smoke_ms"],
                    smoke_k3_ms=r10["smoke_k3_ms"]),
               dict(name="segment", route="cuda",
                    source="rustraytrace_tpu_torch/csrc/segment.cu",
                    replaces="rustraytrace_tpu/ops/pallas_wavefront.py:291",
                    launches=r11["launches"],
                    launches_by_path={"the_next_week (K5)":
                                      r11["launches"], **by_path("segment")},
                    max_abs_err=max(r11["err"], r19["errs"]["k5"]),
                    ms=r11["ms"],
                    plain_ms=r11["plain_ms"], bound_ms=r11["bound"],
                    bound_by=r11["by"], library_ms=None, work=r11["work"],
                    ms_shape=f"{r11['R']} lanes, the first segment (one "
                             "bounce, bank, respawn), the_next_week",
                    plain_ms_shape=f"{r11['R']} lanes, the first segment, "
                                   "the_next_week",
                    path_seconds=r11["wall"], segments=r11["segments"],
                    host_syncs=r11["host_syncs"], chunk=r11["chunk"],
                    earth_seconds=r11["earth_s"],
                    earth_segments=r11["earth_segments"])]
    for name, key, src in (("dense_hit", "highest", 28),
                           ("scalar_hit", None, 111)):
        sp, big = s1["spike"], s1["2^20"]
        row = dict(name=name, route="cuda",
                   source="rustraytrace_tpu_torch/csrc/dense_hit.cu",
                   replaces=f"scripts/spike_dense_mxu.py:{src}",
                   launches=r16["launches"]["highest"][name],
                   launches_by_path={
                       f"spike script, {p}": r16["launches"][p][name]
                       for p in ("highest", "default")},
                   library_ms=None,
                   ms_shape="4096 rays x 1024 spheres x 200 iterations",
                   plain_ms_shape="4096 rays x 1024 spheres, one scan")
        if key:
            row.update(max_abs_err=sp[key]["dt_max"], ms=sp[key]["ms"],
                       plain_ms=sp[key]["plain"], bound_ms=sp["d_bound"],
                       bound_by=sp["d_by"],
                       bound_ms_all_roots=sp["d_bound_all"],
                       tensor_core_ms_bound=sp["t_mma"],
                       split=sp["d_split"], registers=sp["d_regs"],
                       merge_launches=r16["launches"]["highest"][
                           "dense_merge"],
                       ms_includes="dense_hit_kernel and, above one "
                                   "range, dense_merge_kernel",
                       default_ms=sp["default"]["ms"],
                       ms_2p20=big[key]["ms"],
                       plain_ms_2p20=big[key]["plain"],
                       bound_ms_2p20=big["d_bound"],
                       bound_ms_all_roots_2p20=big["d_bound_all"],
                       split_2p20=big["d_split"],
                       default_ms_2p20=big["default"]["ms"],
                       max_abs_err_2p20=big[key]["dt_max"],
                       exact_products_max_abs_err_2p20=big["floor"],
                       forced_splits_max_abs_err={
                           lab: {k: v["dt_max"]
                                 for k, v in r["d_splits"].items()}
                           for lab, r in (("spike", sp), ("2p20", big))})
        else:
            row.update(max_abs_err=max(sp["s_err"], big["s_err"]),
                       ms=sp["s_ms"], plain_ms=sp["s_plain"],
                       bound_ms=sp["s_bound"], bound_by=sp["s_by"],
                       lanes_a_ray=sp["split"], ms_2p20=big["s_ms"],
                       plain_ms_2p20=big["s_plain"],
                       bound_ms_2p20=big["s_bound"],
                       lanes_a_ray_2p20=big["split"])
        kernels.append(row)
    print(f"[done] {time.perf_counter() - t_start:.1f} s after the build "
          f"started", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
