#!/usr/bin/env python3
"""Flagship measurements of the PyTorch / CUDA port on one NVIDIA GPU, the
numbers behind PERF.md's findings:

1. sort on / off A/B of the persist launch loop (interleaved repetitions);
2. a sweep of the launch bound ``persist_iters`` with the sort on;
3. ``render.render_pass`` end to end (prep included) and the host prep alone;
4. one ``torch.profiler`` run: device time per kernel and the idle share;
5. the respawn megakernel K3 on its three cells: the Book-3 Cornell box
   (600x600, 100 spp stratified, depth 50, MIS), the Book-2 Cornell box
   (600x600, 200 spp, path) and the flagship at 3840x2160 (16 spp): the
   kernel alone over ``--reps`` reps, then one profiled end-to-end call;
6. the Book-2 final scene (``get_scene("the_next_week")``, 400x400, 250
   spp, depth 4) through ``render.render_image``: warm wall time over
   ``--reps`` reps, the launch loop's counts, then one profiled call;
7. the head-to-head of the three pass structures (``--heads`` runs only
   this item): the monolithic megakernel K4 against the respawn megakernel
   K3 on the eight cases of ``scripts/bench_backends.py`` at their
   configurations (the kernels alone, same tables and seed, in the order
   K3, K4, K4, K3, each ``--reps`` launches), the per-bounce segment loop
   K5 against the persist loop on the two cases of
   ``scripts/bench_persist.py`` (``render_pass_wavefront`` end to end,
   persist, segments, segments, persist; one profiled segment pass), and
   K3 on 1,024 quads with the quad-cluster cull against the scan of every
   quad row;
8. the reference routes (``--reference`` runs only this item): the
   flagship at 16 spp, depth 50, through ``render_image(backend=
   "sphere_kernel")`` (one pass, one chunk; K1 every bounce) and the
   Book-3 Cornell box at 16 spp (4x4 strata) through ``backend=
   "reference"``: warm wall over ``--reps`` reps, then one profiled call
   each (device time by kernel, K1's share, the idle share);
9. K2 and K1 at the main paths' own launches (``--kernels`` runs only this
   item): the flagship's third 128-iteration K2 launch, a mid-loop launch
   of the final scene with its tile bounds and a ``sphere_field_10k``
   launch, each taken from the main path's own loop and timed from copies
   of its state, with the COUNT instance's bound and SIMT efficiency, a
   bitwise check against the plain twin and the sweep of K2's cooperative
   threshold T (one build per T, ``-DRTT_COOP_LANES=T``); K1 at the
   sphere_kernel flagship's first-bounce
   rays; then one profiled call of each of the three main paths (the
   flagship, the final scene, the sphere_kernel flagship).

10. the megakernels K3 and K4 on their cells (``--megakernels`` runs only
   this item): K3 at the 4K flagship pass, on the Book-3 Cornell box and
   on three 400x225 Book-2 scenes and on the Cornell smoke, K4 on the
   Book-3 box; per cell, twice, the timed kernel, then the counting
   instance's work, bound, SIMT efficiency of the leaf scans, lane-use
   share and tail share (each warp's start and finish on the device
   clock); the registers of every K3 and K4 instance and a census of their
   SASS by instruction class;
11. the sweeps of the megakernels' design (``--mega-sweep`` runs only this
   item): one build and process per setting of ``MEGA_SWEEP`` (every
   instance forced to the cooperative or the per-lane form, the
   cooperative threshold T, block 128 or 256, the launch bounds' resident
   threads), each timing K3 and K4 on ``MEGA_SWEEP_CELLS`` and held
   bitwise to the default build's sums;
12. the segment loop and S1b (``--segments`` runs only this item): the
   chunk sweep of ``_wavefront_pass_segments`` (segments a host sync, and
   a chunk as one CUDA graph, ``_segments_graph``; ``SEGMENT_SWEEP``) on
   the final scene at 400x400 and the two ``scripts/bench_persist.py``
   cases, one profiled segmented pass of each; S1b's split sweep (lanes a ray) at the spike's
   shape and at 2^20 rays, and the same with the kernel built to compute
   the root of a pair whose discriminant is not positive too;
13. the design steps of S1a, the dense kernel (``--dense`` runs only this
   item): one build and process per step of ``DENSE_SWEEP`` (the table
   staged alone, with mma.sync products and every root, unsplit and
   split; then the roots skipped; then wgmma, the kept build; then every
   root on wgmma), each at the spike's shape
   and at 2^20 rays, both precisions, 'highest' held to chip_smoke.py's
   gate, with its registers; ``--dense DIR`` also times the dense kernel
   of the checkout DIR first and last.

    python3 chip_measure.py [--reps 3] [--spp 1024] [--heads] [--reference]
                            [--kernels] [--megakernels] [--mega-sweep]
                            [--segments] [--dense [DIR]]
    python3 chip_measure.py --ab DIR [--reps 3]

Items 1-4: Book-1 random spheres at 1200x675, depth 50, as
``chip_smoke.py`` drives it.  ``--ab DIR`` instead times the flagship
(``render_pass`` and one K2 launch), the Book-3 Cornell box
(``render_image``, one K3 and one K4 pass), the 4K flagship pass
(``render_pass`` and its K3 pass), the three 400x225 Book-2 scenes of
K3's route (their K3 passes; ``book2_perlin_spheres``'s ``render_image``
too), the final scene (``render_image``),
K2's main-path launches (with their work counts), K1, one K5 launch at
the final scene's first bounce, the segmented final scene, scene 9 and
earth (``render_pass_wavefront(per_bounce_segments=True)``), S1b and S1a
(both precisions) at the spike's shape and at 2^20 rays with the
package of the checkout DIR
and with this one, in the order DIR, this, this, DIR, each in its own
process, and prints one JSON line per process.  Prints the card's name,
power limit and SM clock first.  Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _ab_child(reps: int) -> dict:
    """Warm timings of the flagship, the Book-3 Cornell box (K3 and K4),
    the 4K pass (end to end and K3 alone), the three 400x225 Book-2 scenes
    on K3 (``book2_perlin_spheres`` end to end too), the final scene, K2's
    main-path launches with their work counts, K1 at its route's shape,
    the sphere_kernel route, one K5 launch, the three segmented cells, S1b
    and S1a (both precisions) at both shapes, with the package on
    sys.path; uses only calls the earlier slices have too."""
    import torch

    from rustraytrace_tpu_torch import models, render
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import hit
    from rustraytrace_tpu_torch.ops import megakernel as mk
    from rustraytrace_tpu_torch.ops import wavefront as wf

    import rustraytrace_tpu_torch

    dev = torch.device("cuda")
    out: dict = {"package": rustraytrace_tpu_torch.__file__}

    def walls(fn) -> list:
        fn()  # warm: build, tables, allocator
        res = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            res.append(time.perf_counter() - t0)
        return res

    def event_ms(fn) -> float:
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    sf, cf, _ = models.book1_random_spheres(
        dict(image_width=1200, samples_per_pixel=1024, max_depth=50))
    camf = derive_camera(cf, device=dev)
    out["flagship_render_pass_s"] = walls(lambda: render.render_pass(
        sf, camf, cf.seed, width=1200, height=675, spp=1024, max_depth=50,
        device=dev))
    tabf = mk.prepare_megakernel(sf, camf, width=1200, height=675,
                                 device=dev)
    slot = torch.arange(tabf.n_lanes, dtype=torch.int32, device=dev)
    out["flagship_k2_launch_ms"] = event_ms(lambda: wf.persist_step(
        torch.zeros((wf.N_STATE, tabf.n_lanes), device=dev), slot, tabf, 3,
        persist_iters=8, spp=1024, max_depth=50))
    s3, c3, _ = models.book3_cornell_box()
    out["book3_render_image_s"] = walls(lambda: render.render_image(
        s3, c3, integrator="mis", device=dev))
    tab3 = mk.prepare_megakernel(
        s3, derive_camera(c3, device=dev), width=600, height=600, mis=True,
        stratified=True, sqrt_spp=10, device=dev)
    out["book3_k3_pass_ms"] = event_ms(
        lambda: mk.respawn_pass(tab3, c3.seed, 0, 100, 50))
    out["book3_k4_pass_ms"] = event_ms(
        lambda: mk.mono_pass(tab3, c3.seed, 0, 100, 50))
    del tab3
    s4, c4, _ = models.book1_random_spheres(dict(image_width=3840))
    cam4 = derive_camera(c4, device=dev)
    out["flagship_4k_render_pass_s"] = walls(lambda: render.render_pass(
        s4, cam4, c4.seed, width=3840, height=2160, spp=16, max_depth=50,
        device=dev))
    tab4 = mk.prepare_megakernel(s4, cam4, width=3840, height=2160,
                                 tile_rows=mk.respawn_tile_rows(s4),
                                 device=dev)
    out["flagship_4k_k3_pass_ms"] = event_ms(
        lambda: mk.respawn_pass(tab4, c4.seed, 0, 16, 50))
    del tab4
    for name in ("book2_checkered_spheres", "book2_perlin_spheres",
                 "book2_simple_light"):
        sp, cp, _ = models.get_scene(name)
        if name == "book2_perlin_spheres":
            out["perlin_render_image_s"] = walls(lambda: render.render_image(
                sp, cp, device=dev))
        tabp = mk.prepare_megakernel(
            sp, derive_camera(cp, device=dev), width=400, height=225,
            tile_rows=mk.respawn_tile_rows(sp), device=dev)
        out[f"{name}_k3_pass_ms"] = event_ms(
            lambda: mk.respawn_pass(tabp, cp.seed, 0, 100, 50))
        del tabp
    s9, c9, _ = models.get_scene("the_next_week")
    out["final_render_image_s"] = walls(lambda: render.render_image(
        s9, c9, device=dev))

    # K2 at the main paths' own launches and K1 at its route's shape, with
    # this script's helpers (chip_smoke.py beside it) on either package
    smoke = _smoke()

    def k2(loop) -> tuple:
        """(ms, the COUNT instance's work) of a K2 main-path launch."""
        tables, seed, state, slot, kw = loop
        work = torch.zeros(len(mk.WORK_NAMES), dtype=torch.int64,
                           device=dev)
        wf.persist_step(state.clone(), slot, tables, seed, work=work, **kw)
        return smoke._k2_launch_ms(loop, reps=reps), work.tolist()[:9]

    (out["flagship_k2_launch3_ms"], out["flagship_k2_launch3_work"]) = k2(
        smoke._k2_main_launch(sf, cf, "path", dev, 3, spp=1024))
    (out["final_k2_launch119_ms"], out["final_k2_launch119_work"]) = k2(
        smoke._k2_main_launch(s9, c9, "path", dev, 119, spp=250))
    args = smoke._k1_route_args(dev)
    # the float4 planes, built once a pass on the route (earlier slices
    # have none)
    kw = ({"f4": hit.sphere_table_f4(args[3])}
          if hasattr(hit, "sphere_table_f4") else {})
    out["k1_route_ms"] = event_ms(lambda: hit.sphere_hit(*args, **kw))
    del args, kw
    sk, ck, _ = models.book1_random_spheres(
        dict(image_width=1200, samples_per_pixel=16, max_depth=50))
    out["sphere_kernel_render_image_s"] = walls(lambda: render.render_image(
        sk, ck, backend="sphere_kernel", chunk=1 << 20, device=dev))

    # K5: one launch at the final scene's lanes (its first bounce), and
    # the segmented final scene, scene 9 and earth end to end
    cam9 = derive_camera(c9, device=dev)
    tab9 = mk.prepare_megakernel(s9, cam9, width=400, height=400,
                                 tile_rows=wf.wavefront_tile_rows(s9),
                                 device=dev)
    out["final_k5_launch_ms"] = _k5_first_launch_ms(tab9, c9.seed, 250, 4)
    del tab9
    cases = dict(final400=("the_next_week", {}), **{
        k: (name, over) for k, (name, over, _, _) in PERSIST_CASES.items()})
    for key, (name, over) in cases.items():
        sc, cc, _ = models.get_scene(name, over)
        camc = derive_camera(cc, device=dev)
        out[f"{key}_segments_s"] = walls(lambda: wf.render_pass_wavefront(
            sc, camc, cc.seed, width=cc.image_width,
            height=cc.image_height, spp=cc.samples_per_pixel,
            max_depth=cc.max_depth, per_bounce_segments=True, device=dev))

    # S1: both kernels at both shapes, the dense one at both precisions
    from rustraytrace_tpu_torch.ops import dense_hit as dh

    for label, n_rays, iters in (("spike", 4096, 200), ("2p20", 1 << 20, 1)):
        dtab, stab, rays = _spike_tables(1024, n_rays, dev)
        out[f"s1b_{label}_ms"] = event_ms(
            lambda: dh.scalar_hit(stab, *rays, iters=iters))
        for prec in ("highest", "default"):
            out[f"s1a_{label}_{prec}_ms"] = event_ms(
                lambda: dh.dense_hit(dtab, *rays, iters=iters,
                                     precision=prec))
    return out


def _spike_tables(ns: int, n_rays: int, dev):
    """S1's inputs as chip_smoke.py's phase 16 draws them: the spike's
    tables and its 4,096 rays, or ``n_rays`` drawn the same way."""
    import numpy as np
    import torch

    from rustraytrace_tpu_torch.scripts import spike_dense_mxu as spike

    dtab, stab, o, d = spike.spike_inputs(ns)
    if n_rays != o[0].size:
        rng = np.random.default_rng(1)
        o = rng.uniform(-100, 100, (3, n_rays)).astype(np.float32)
        d = rng.normal(size=(3, n_rays)).astype(np.float32)
    rays = [torch.from_numpy(np.ascontiguousarray(x).reshape(-1)).to(dev)
            for x in (*o, *d)]
    return (torch.from_numpy(dtab).to(dev), torch.from_numpy(stab).to(dev),
            rays)


def _k5_first_launch_ms(tables, seed: int, spp: int, depth: int,
                        n: int = 10) -> float:
    """Device ms of one K5 launch from the start of a pass (every lane at
    its first bounce), over ``n`` copies of that state queued behind a
    device sleep, after one launch that loads the kernel: the fused step
    of this package, or the bare bounce of one that has no bank in its
    kernel."""
    import inspect

    import torch

    from rustraytrace_tpu_torch.ops import wavefront as wf

    smoke = _smoke()
    if "sums" in inspect.signature(wf.segment_step).parameters:
        start = wf.segment_start(tables, seed, 0)
        alive = torch.zeros(1, dtype=torch.int32, device=start[0].device)
        copies = [[t.clone() for t in start] for _ in range(n + 1)]
        fns = [lambda c=c: wf.segment_step(
            *c, tables, seed, spp=spp, max_depth=depth, alive=alive)
            for c in copies]
    else:
        R = tables.n_lanes
        dev = tables.geom.device
        slot = torch.arange(R, dtype=torch.int64, device=dev)
        sample = torch.zeros(R, dtype=torch.int64, device=dev)
        v = wf.spawn_lanes(tables, slot, sample, wf.seed_key(seed))
        zero = torch.zeros(R, device=dev)
        st0 = torch.stack([v.get(k, zero) for k in wf._SEG_NAMES])
        s32 = sample.to(torch.int32)
        copies = [st0.clone() for _ in range(n + 1)]
        fns = [lambda c=c: wf.segment_step(c, s32, tables, seed,
                                           max_depth=depth) for c in copies]
    fns[0]()  # a first launch in the process loads the kernel
    return smoke._queued_ms(fns[1:])


def _smoke():
    """chip_smoke.py beside this script, loaded by path (an A/B child runs
    with another checkout's directory first on the path)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_here", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# scripts/bench_backends.py CASES: scene, overrides, spp, depth, mis
BACKEND_CASES = {
    "flagship": ("book1_random_spheres",
                 dict(image_width=1200, samples_per_pixel=64, max_depth=50),
                 64, 50, False),
    "cornell_d20": ("book2_cornell_box",
                    dict(image_width=400, samples_per_pixel=64, max_depth=20),
                    64, 20, False),
    "smoke": ("book2_cornell_smoke",
              dict(image_width=400, samples_per_pixel=64, max_depth=50),
              64, 50, False),
    "bouncing": ("book2_bouncing_spheres",
                 dict(image_width=400, samples_per_pixel=64, max_depth=50),
                 64, 50, False),
    "perlin": ("book2_perlin_spheres",
               dict(image_width=400, samples_per_pixel=64, max_depth=50),
               64, 50, False),
    "quads_d10": ("book2_quads",
                  dict(image_width=400, samples_per_pixel=64, max_depth=10),
                  64, 10, False),
    "field10k": ("sphere_field_10k",
                 dict(image_width=1200, samples_per_pixel=64, max_depth=50),
                 64, 50, False),
    "cornell_mis": ("book3_cornell_box",
                    dict(image_width=600, samples_per_pixel=64, max_depth=50),
                    64, 50, True),
}
# scripts/bench_persist.py CASES: scene, overrides, spp, depth
PERSIST_CASES = {
    "earth": ("book2_earth",
              dict(image_width=800, samples_per_pixel=64, max_depth=50),
              64, 50),
    "final": ("book2_final_scene",
              dict(image_width=800, samples_per_pixel=64, max_depth=40),
              64, 40),
}


def _heads(reps: int) -> None:
    """Item 7: K4 vs K3, K5 vs the persist loop, the quad cull vs the
    scan of every quad row."""
    import dataclasses

    import torch

    from rustraytrace_tpu_torch import RenderConfig, SceneBuilder, models
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import megakernel as mk
    from rustraytrace_tpu_torch.ops import wavefront as wf
    from chip_smoke import _torch_scenes

    dev = torch.device("cuda")

    def event_ms(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for case, (name, over, spp, depth, mis) in BACKEND_CASES.items():
        scene, cfg, _ = models.get_scene(name, over)
        w, h = cfg.image_width, cfg.image_height
        tab = mk.prepare_megakernel(
            scene, derive_camera(cfg, device=dev), width=w, height=h,
            tile_rows=mk.respawn_tile_rows(scene), mis=mis, device=dev)
        k3 = lambda: mk.respawn_pass(tab, cfg.seed, 0, spp, depth)  # noqa
        k4 = lambda: mk.mono_pass(tab, cfg.seed, 0, spp, depth)  # noqa
        same = bool(torch.equal(k3(), k4()))  # also the warm-up
        t = [event_ms(f) for f in (k3, k4, k4, k3)]
        k3_ms, k4_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        paths = w * h * spp
        print(json.dumps({
            "item": "K4 vs K3", "case": case, "scene": name, "width": w,
            "height": h, "spp": spp, "max_depth": depth, "mis": mis,
            "k3_ms": [round(t[0], 3), round(t[3], 3)],
            "k4_ms": [round(t[1], 3), round(t[2], 3)],
            "k3_mpaths_s": round(paths / k3_ms / 1e3, 2),
            "k4_mpaths_s": round(paths / k4_ms / 1e3, 2),
            "k4_over_k3": round(k4_ms / k3_ms, 4),
            "sums_bitwise_equal": same}), flush=True)

    for case, (name, over, spp, depth) in PERSIST_CASES.items():
        scene, cfg, _ = models.get_scene(name, over)
        w, h = cfg.image_width, cfg.image_height
        cam = derive_camera(cfg, device=dev)

        def run(seg: bool, stats=None):
            return wf.render_pass_wavefront(
                scene, cam, cfg.seed, width=w, height=h, spp=spp,
                max_depth=depth, per_bounce_segments=seg, device=dev,
                stats=stats)

        same = bool(torch.equal(run(False), run(True)))  # also the warm-up
        for seg in (False, True, True, False):
            stats: dict = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(seg, stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(json.dumps({
                "item": "K5 vs persist", "case": case, "scene": name,
                "width": w, "height": h, "spp": spp, "max_depth": depth,
                "route": "segments (K5)" if seg else "persist (K2)",
                "wall_s": round(wall, 4),
                "mpaths_s": round(w * h * spp / wall / 1e6, 2),
                "launches": stats["launches"],
                **{k: stats[k] for k in ("kernel_launches", "host_syncs")
                   if k in stats},
                "sums_bitwise_equal": same}), flush=True)
        _profiled(f"{case} segments (K5) end to end", lambda: run(True))

    ts = _torch_scenes()
    scene = ts.quad_field(SceneBuilder, 1024)
    cfg = RenderConfig(image_width=400, samples_per_pixel=64, max_depth=8,
                       **ts.FIELD_INSIDE_CFG)
    tab = mk.prepare_megakernel(scene, derive_camera(cfg, device=dev),
                                width=400, height=400, device=dev)
    lin = dataclasses.replace(tab, n_qclusters=0)
    cull = lambda: mk.respawn_pass(tab, cfg.seed, 0, 64, 8)  # noqa: E731
    scan = lambda: mk.respawn_pass(lin, cfg.seed, 0, 64, 8)  # noqa: E731
    differ = int((cull() != scan()).any(dim=1).sum())
    t = [event_ms(f) for f in (cull, scan, scan, cull)]
    print(json.dumps({
        "item": "quad cull", "quads": 1024, "clusters": tab.n_qclusters,
        "width": 400, "spp": 64, "max_depth": 8,
        "cull_ms": [round(t[0], 3), round(t[3], 3)],
        "scan_ms": [round(t[1], 3), round(t[2], 3)],
        "speedup": round((t[1] + t[2]) / (t[0] + t[3]), 3),
        "lanes_differing": differ, "lanes": tab.n_lanes}), flush=True)


# the chunk sweep of the segment loop: (segments a host sync, one CUDA
# graph a chunk)
SEGMENT_SWEEP = ((1, False), (8, False), (16, False), (32, False),
                 (64, False), (16, True), (32, True), (64, True))


def _segments_graph(tab, seed: int, sample_offset: int, *, spp: int,
                    max_depth: int, chunk: int, stats: dict):
    """The segment loop of ``wavefront._wavefront_pass_segments`` with each
    full chunk of ``chunk`` K5 launches captured once as one CUDA graph and
    replayed (the rest launched one by one), one host sync a chunk.
    Returns the sums [R, 3] in slot order."""
    import torch

    from rustraytrace_tpu_torch.ops import _cuda
    from rustraytrace_tpu_torch.ops import wavefront as wf

    state, sums, done, sample = wf.segment_start(tab, seed, sample_offset)
    launch = wf._segment_launcher(state, sums, done, sample, tab, seed,
                                  spp=spp, max_depth=max_depth,
                                  sample_offset=sample_offset)
    ring = torch.zeros(chunk, dtype=torch.int32, device=state.device)
    counted = _cuda.KERNELS["segment"].launches
    cg = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cg):
        ring.zero_()
        for j in range(chunk):
            launch(ring.data_ptr() + 4 * j)
    _cuda.KERNELS["segment"].launches = counted  # captured, not launched
    n_seg = spp * max_depth + 1
    g = syncs = 0
    segments = n_seg
    while g < n_seg:
        n = min(chunk, n_seg - g)
        if n == chunk:
            cg.replay()
        else:
            ring.zero_()
            for j in range(n):
                launch(ring.data_ptr() + 4 * j)
        counts = ring[:n].tolist()
        syncs += 1
        g += n
        if 0 in counts:
            segments = g - n + counts.index(0) + 1
            break
    stats.update(launches=segments, kernel_launches=g, host_syncs=syncs,
                 chunk=chunk)
    return sums.T.contiguous()


def _segments(reps: int) -> None:
    """Item 12: the segment loop's chunk sweep (``SEGMENT_SWEEP``) on the
    final scene at 400x400 and on the two ``scripts/bench_persist.py``
    cases, walls in turns, each with its segments, kernel launches and
    host syncs and sums equal to the first setting's; one profiled
    segmented pass of each case at the default; S1b's split sweep at the
    spike's shape and at 2^20 rays; and S1b built with
    ``-DRTT_SCALAR_SKIP_MISS=0``, every root computed (one child process
    and build)."""
    import torch

    from rustraytrace_tpu_torch import models
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import megakernel as mk
    from rustraytrace_tpu_torch.ops import wavefront as wf

    dev = torch.device("cuda")
    cases = dict(final400=("the_next_week", {}), **{
        k: (name, over) for k, (name, over, _, _) in PERSIST_CASES.items()})
    for case, (name, over) in cases.items():
        scene, cfg, _ = models.get_scene(name, over)
        w, h = cfg.image_width, cfg.image_height
        spp, depth = cfg.samples_per_pixel, cfg.max_depth
        tab = mk.prepare_megakernel(
            scene, derive_camera(cfg, device=dev), width=w, height=h,
            tile_rows=wf.wavefront_tile_rows(scene), device=dev)
        ref = None
        for rep in range(reps):
            order = SEGMENT_SWEEP if rep % 2 == 0 else SEGMENT_SWEEP[::-1]
            for chunk, graph in order:
                stats: dict = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pass_ = _segments_graph if graph else \
                    wf._wavefront_pass_segments
                sums = pass_(tab, cfg.seed, 0, spp=spp, max_depth=depth,
                             chunk=chunk, stats=stats)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                ref = sums if ref is None else ref
                print(json.dumps({
                    "item": "segment chunks", "case": case, "scene": name,
                    "width": w, "height": h, "spp": spp, "max_depth": depth,
                    "rep": rep, "chunk": chunk, "graph": graph,
                    "wall_s": wall, "mpaths_s": w * h * spp / wall / 1e6,
                    **stats, "sums_equal": bool(torch.equal(sums, ref))}),
                    flush=True)
        cam = derive_camera(cfg, device=dev)
        run = lambda: wf.render_pass_wavefront(  # noqa: E731
            scene, cam, cfg.seed, width=w, height=h, spp=spp,
            max_depth=depth, per_bounce_segments=True, device=dev)
        run()
        _profiled(f"{case} segments (K5) end to end", run)
        del tab
    _s1b_sweep(reps)
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--s1b-child",
         json.dumps(["-DRTT_SCALAR_SKIP_MISS=0"]), "--reps", str(reps)],
        capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"S1b child failed:\n{res.stdout}\n{res.stderr}")
    print(res.stdout.strip(), flush=True)


def _s1b_sweep(reps: int, flags=()) -> None:
    """S1b at the spike's shape and at 2^20 rays: the default split and
    every split, in turns, each held bitwise to the twin, with its rate
    and its counted bound (chip_smoke.py ``_scalar_ops``)."""
    import torch

    from chip_smoke import _bound, _cuda_ms, _scalar_ops
    from rustraytrace_tpu_torch.ops import _cuda
    from rustraytrace_tpu_torch.ops import dense_hit as dh

    dev = torch.device("cuda")
    for label, n_rays, iters in (("spike", 4096, 200), ("2^20", 1 << 20, 1)):
        _, stab, rays = _spike_tables(1024, n_rays, dev)
        tp, ip = dh.scalar_hit_plain(stab, *rays)
        pairs = n_rays * 1024 * iters
        bound, by = _bound(_scalar_ops(stab, rays, iters),
                           4 * (4 * 1024 + 8 * n_rays))
        for split in (None, *dh.SPLITS, None):
            t, i = dh.scalar_hit(stab, *rays, iters=iters, split=split)
            ms = _cuda_ms(lambda: dh.scalar_hit(stab, *rays, iters=iters,
                                                split=split), reps)
            print(json.dumps({
                "item": "S1b split", "flags": list(flags), "shape": label,
                "rays": n_rays, "iters": iters,
                "split": split or f"default ({_cuda.scalar_split(n_rays)})",
                "ms": ms, "gpairs_s": pairs / ms / 1e6, "bound_ms": bound,
                "bound_by": by, "bitwise_equal_twin": bool(
                    torch.equal(t, tp) and torch.equal(i, ip))}),
                flush=True)


def _s1b_child(flags: list, reps: int) -> None:
    """_s1b_sweep with the library built with ``flags``."""
    from rustraytrace_tpu_torch.ops import _cuda

    _cuda.NVCC_FLAGS = _cuda.NVCC_FLAGS + tuple(flags)
    _cuda.BUILD_DIR = os.path.join(_cuda.BUILD_DIR, "sweep")
    _s1b_sweep(reps, flags)


# --dense: the design steps of S1a's kernel, one build each (flags) at the
# split it picks, the first also with the sphere axis unsplit: the table
# staged alone (mma.sync, every root), then the split, the skipped roots,
# wgmma (the kept build); then the kept build with every root
DENSE_SWEEP = (
    ("staged, mma.sync, every root",
     ("-DRTT_DENSE_WGMMA=0", "-DRTT_DENSE_SKIP_MISS=0"), (1, None)),
    ("mma.sync, roots skipped", ("-DRTT_DENSE_WGMMA=0",), (None,)),
    ("wgmma, roots skipped (kept)", (), (1, None)),
    ("wgmma, every root", ("-DRTT_DENSE_SKIP_MISS=0",), (None,)),
)


def _dense_child(flags: list, splits: list, reps: int) -> dict:
    """S1a at both shapes and precisions, each split of ``splits`` (None:
    the wrapper's), with the library built with ``flags``; 'highest' held
    to chip_smoke.py's gate; its registers.  Loads this checkout's
    chip_smoke.py by path, so that the package on sys.path (this one or
    the parent's, which knows no ``split``) is the one measured."""
    import importlib.util

    import torch

    from rustraytrace_tpu_torch.ops import _cuda
    from rustraytrace_tpu_torch.ops import dense_hit as dh

    spec = importlib.util.spec_from_file_location(
        "smoke_here", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if flags:
        _cuda.NVCC_FLAGS = _cuda.NVCC_FLAGS + tuple(flags)
        _cuda.BUILD_DIR = os.path.join(_cuda.BUILD_DIR, "sweep")
    dev = torch.device("cuda")
    out = {"flags": flags}
    for label, n_rays, iters in (("spike", 4096, 200), ("2p20", 1 << 20, 1)):
        dtab, _, rays = _spike_tables(1024, n_rays, dev)
        tp, ip = dh.dense_hit_plain(dtab, *rays)
        for split in splits:
            kw = {} if split is None else dict(split=split)
            tk, ik = dh.dense_hit(dtab, *rays, iters=iters, **kw)
            gate = smoke._dense_gate(tk, ik, tp, ip, label == "spike")
            for prec in ("highest", "default"):
                out[f"{label}_{prec}_split_{split or 'default'}_ms"] = \
                    smoke._cuda_ms(lambda: dh.dense_hit(
                        dtab, *rays, iters=iters, precision=prec, **kw),
                        reps)
            out[f"{label}_split_{split or 'default'}_gate"] = gate
        if "split" in dh.dense_hit.__code__.co_varnames:
            out[f"{label}_default_split"] = dh.default_split(
                n_rays, 1024, _cuda.dense_wave(True))
    out["registers"] = {k: v for k, v in smoke._registers(
        _cuda.build_info["log"]).items() if k.startswith("dense_hit")}
    return out


def _dense(parent: str | None, reps: int) -> int:
    """The DENSE_SWEEP, one process and build per step, and, given a
    checkout ``parent``, its S1a first and last (its package on the
    path); one JSON line each."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = [(label, list(flags), list(splits), here)
            for label, flags, splits in DENSE_SWEEP]
    if parent:
        runs = ([("parent", [], [None], parent)] + runs
                + [("parent", [], [None], parent)])
    for label, flags, splits, tree in runs:
        tree = os.path.abspath(tree)
        # -P: the script's own directory must not shadow the tree's package
        res = subprocess.run(
            [sys.executable, "-P", os.path.abspath(__file__),
             "--dense-child", json.dumps([flags, splits]), "--reps",
             str(reps)], cwd=tree, env=dict(os.environ, PYTHONPATH=tree),
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return res.returncode
        print(json.dumps({"item": "S1a step", "step": label, **json.loads(
            res.stdout.strip().splitlines()[-1])}), flush=True)
    return 0


def _profiled(label: str, fn) -> None:
    """One profiled call of fn: wall, device kernel time, idle share
    and the top kernels.  Device activity only, so each kernel's time
    is counted once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    evs.sort(key=lambda e: -e.self_device_time_total)
    dev_s = sum(e.self_device_time_total for e in evs) / 1e6
    print(f"{label}: profiled wall {wall:.4f} s, device kernel time "
          f"{dev_s:.4f} s, idle share {1 - dev_s / wall:.4f}")
    for e in evs[:12]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:10.2f} ms  x {e.count:4d}  {e.key[:100]}")


def _reference_routes(reps: int) -> None:
    """Item 8: the sphere_kernel flagship and the reference Cornell box,
    warm walls and one profiled call each."""
    import torch

    from rustraytrace_tpu_torch import models, render

    dev = torch.device("cuda")
    flag, fcfg, _ = models.book1_random_spheres(dict(
        image_width=1200, samples_per_pixel=16, max_depth=50))
    box, bcfg, integ = models.book3_cornell_box(dict(samples_per_pixel=16))
    cases = (("sphere_kernel flagship 1200x675 16 spp d50",
              lambda: render.render_image(flag, fcfg, backend="sphere_kernel",
                                          chunk=1 << 20, device=dev),
              1200 * 675 * 16),
             ("reference Book-3 Cornell box 600x600 16 spp d50 MIS",
              lambda: render.render_image(box, bcfg, integrator=integ,
                                          backend="reference", chunk=131072,
                                          device=dev),
              600 * 600 * 16))
    for label, fn, paths in cases:
        fn()  # warm-up
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"{label}: {wall:.4f} s {paths / wall / 1e6:.3f} Mpaths/s",
                  flush=True)
        _profiled(label, fn)


# K2 at the main paths' own launches: label, scene, overrides, launch, the
# pass's samples (None: render_image's first pass)
K2_CASES = (
    ("flagship, launch 3 of 52", "book1_random_spheres",
     dict(image_width=1200, samples_per_pixel=1024, max_depth=50), 3, 1024),
    ("the_next_week, launch 119 of 237", "the_next_week", None, 119, None),
    ("sphere_field_10k, launch 3", "sphere_field_10k", None, 3, None))

# the sweep that fixed K2's cooperative threshold T (csrc/path.cuh
# COOP_LANES; 0: never cooperative, 32: always)
COOP_SWEEP = (0, 4, 8, 12, 16, 24, 32)


def _k2_cases(reps: int) -> list:
    """``chip_smoke._k2_launch`` of each of K2_CASES with the library as
    built: [(label, lanes, result)]; the sphere_field_10k launch is held
    against 2 plain iterations, the others against 8."""
    import torch

    from chip_smoke import _k2_launch, _k2_main_launch
    from rustraytrace_tpu_torch import models

    dev = torch.device("cuda")
    out = []
    for label, name, over, launch, spp in K2_CASES:
        scene, cfg, integ = models.get_scene(name, over)
        loop = _k2_main_launch(scene, cfg, integ, dev, launch, spp=spp)
        r = _k2_launch(loop, reps=reps,
                       plain_iters=2 if name == "sphere_field_10k" else 8)
        r["persist_iters"] = loop[4]["persist_iters"]
        out.append((label, loop[0].n_lanes, r))
        del loop
    return out


def _sweep_child(T: int, reps: int) -> dict:
    """K2_CASES with the library built for COOP_LANES = T: ms, bitwise
    equality with the plain twin and SIMT efficiency per case, and K2's
    registers."""
    from chip_smoke import _registers
    from rustraytrace_tpu_torch.ops import _cuda

    _cuda.NVCC_FLAGS = _cuda.NVCC_FLAGS + (f"-DRTT_COOP_LANES={T}",)
    out = {"T": T}
    for label, _, r in _k2_cases(reps):
        out[label] = dict(ms=r["ms"], equal=r["equal"], simt=r["simt"])
    out["registers"] = {k: v for k, v in _registers(
        _cuda.build_info["log"]).items() if "persist" in k}
    return out


def _kernels(reps: int) -> None:
    """Item 9: K2 at the main paths' own launches and K1 at its route's
    shape.  K2: the flagship's third launch (128 iterations, after two
    launches and their sorts), a mid-loop launch of the final scene (its
    119th of 237, with its tile bounds) and ``sphere_field_10k``'s third
    launch, each taken from the main path's own loop
    (``chip_smoke._k2_main_launch``): device ms from copies of the loop
    state, the COUNT instance's work, bound and SIMT efficiency, and 8
    iterations (2 on the field) held bitwise against the plain twin; then
    the T sweep, one process per T, each building the kernels with
    ``-DRTT_COOP_LANES=T``, which prints K2's registers.  K1: the
    sphere_kernel flagship's 12,960,000 first-bounce rays x 487 spheres."""
    import torch

    from chip_smoke import (OPS, _bound, _cuda_ms, _cuda_ms_once,
                            _k1_route_args)
    from rustraytrace_tpu_torch import models
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import hit

    dev = torch.device("cuda")
    for label, lanes, r in _k2_cases(reps):
        print(json.dumps({"item": "K2 launch", "case": label,
                          "lanes": lanes, **r}), flush=True)
    for T in COOP_SWEEP:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--sweep-child",
             str(T), "--reps", str(reps)], capture_output=True, text=True,
            timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"T sweep child {T} failed:\n{res.stdout}\n"
                               f"{res.stderr}")
        print(json.dumps({"item": "K2 sweep", **json.loads(
            res.stdout.strip().splitlines()[-1])}), flush=True)

    args = _k1_route_args(dev)
    n_rays, n_sph = args[0].shape[0], args[3].shape[0]
    f4 = hit.sphere_table_f4(args[3])  # built once a pass on the route
    ms = _cuda_ms(lambda: hit.sphere_hit(*args, f4=f4), reps)
    (tp, ip), plain_ms = _cuda_ms_once(lambda: hit.sphere_hit_plain(*args))
    tk, ik = hit.sphere_hit(*args)
    equal = bool(torch.equal(tk, tp) and torch.equal(ik, ip))
    bound, by = _bound(n_rays * (n_sph * OPS["sphere"] + 6), n_rays * 9 * 4)
    print(json.dumps({"item": "K1 launch", "rays": n_rays, "spheres": n_sph,
                      "ms": ms, "plain_ms": plain_ms, "equal": equal,
                      "bound": bound, "by": by}), flush=True)
    del args, tp, ip, tk, ik

    # the three main paths end to end, profiled once each after a warm-up
    from rustraytrace_tpu_torch import render

    sf, cf, _ = models.book1_random_spheres(
        dict(image_width=1200, samples_per_pixel=1024, max_depth=50))
    camf = derive_camera(cf, device=dev)
    s9, c9, _ = models.get_scene("the_next_week")
    sk, ck, _ = models.book1_random_spheres(
        dict(image_width=1200, samples_per_pixel=16, max_depth=50))
    for label, fn in (
            ("flagship render_pass 1200x675 1024 spp",
             lambda: render.render_pass(sf, camf, cf.seed, width=1200,
                                        height=675, spp=1024, max_depth=50,
                                        device=dev)),
            ("the_next_week render_image 400x400 250 spp",
             lambda: render.render_image(s9, c9, device=dev)),
            ("sphere_kernel flagship render_image 1200x675 16 spp",
             lambda: render.render_image(sk, ck, backend="sphere_kernel",
                                         chunk=1 << 20, device=dev))):
        fn()
        _profiled(label, fn)


# the megakernels' cells: label, kernel, scene, overrides, spp, table flags
MK_CELLS = (
    ("K3 flagship 4K pass 3840x2160 16 spp", "megakernel",
     "book1_random_spheres", dict(image_width=3840), 16, {}),
    ("K3 book3_cornell_box 600x600 100 spp MIS", "megakernel",
     "book3_cornell_box", None, 100,
     dict(mis=True, stratified=True, sqrt_spp=10)),
    ("K3 book2_checkered_spheres 400x225 100 spp", "megakernel",
     "book2_checkered_spheres", None, 100, {}),
    ("K3 book2_perlin_spheres 400x225 100 spp", "megakernel",
     "book2_perlin_spheres", None, 100, {}),
    ("K3 book2_simple_light 400x225 100 spp", "megakernel",
     "book2_simple_light", None, 100, {}),
    ("K3 book2_cornell_smoke 600x600 200 spp", "megakernel",
     "book2_cornell_smoke", None, 200, {}),
    ("K4 book3_cornell_box 600x600 100 spp MIS", "mono",
     "book3_cornell_box", None, 100,
     dict(mis=True, stratified=True, sqrt_spp=10)),
)

# SASS opcode classes of the census (the opcode before its first dot)
SASS_CLASSES = {
    "fp32": {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET",
             "FCHK", "FRND", "FADD32I", "FMUL32I", "FFMA32I", "FSWZADD"},
    "mufu": {"MUFU"},
    "convert": {"F2I", "I2F", "F2F", "I2FP", "F2IP"},
    "int_philox": {"IMAD", "IADD3", "IMUL", "LOP3", "SHF", "SHL", "SHR",
                   "LEA", "ISETP", "IABS", "IMNMX", "SEL", "PRMT", "POPC",
                   "FLO", "BREV", "IADD", "LOP", "VIADD", "IMAD32I",
                   "IADD32I", "LOP32I", "ISCADD", "BMSK", "SGXT"},
    "memory": {"LDG", "STG", "LDS", "STS", "LDC", "LD", "ST", "LDL", "STL",
               "ATOM", "ATOMG", "ATOMS", "RED", "ULDC", "LDGSTS",
               "CCTL"},
    "warp": {"SHFL", "VOTE", "VOTEU", "MATCH", "WARPSYNC", "BAR", "REDUX"},
    "control": {"BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "BREAK",
                "BMOV", "YIELD", "NOP", "JMP", "BRX", "JMX", "KILL",
                "BPT"},
}


def _sass_census(lib: str, kernels=("respawn_kernel", "mono_kernel")
                 ) -> dict:
    """Static SASS instruction counts by class (SASS_CLASSES; the rest
    "move_other": moves, predicates, uniform datapath, special registers)
    of each timed instance of ``kernels`` in the built library
    (``cuobjdump -sass``)."""
    import re

    from rustraytrace_tpu_torch.ops import _cuda

    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=300).stdout
    out, name = {}, None
    ins = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_]*)")
    for ln in text.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            flags = re.findall(r"Lb([01])E", fn)
            base = next((k for k in kernels if k in fn), None)
            name = None
            if base and len(flags) >= 3 and flags[2] == "0":
                coop = "" if len(flags) == 3 else (
                    ", coop" if flags[3] == "1" else ", lane")
                name = (f"{base}<{'mis' if flags[0] == '1' else 'path'}, "
                        f"{'book2' if flags[1] == '1' else 'base'}{coop}>")
                out[name] = {"total": 0}
            continue
        m = ins.search(ln) if name else None
        if m:
            op = m.group(1)
            cls = next((c for c, ops in SASS_CLASSES.items() if op in ops),
                       "move_other")
            out[name][cls] = out[name].get(cls, 0) + 1
            out[name]["total"] += 1
    return out


def _megakernels(reps: int) -> None:
    """Item 10: K3 and K4 on MK_CELLS (``chip_smoke._mk_profile``), their
    registers and SASS census."""
    import rustraytrace_tpu_torch
    from rustraytrace_tpu_torch.ops import _cuda
    from rustraytrace_tpu_torch.ops import megakernel as mk

    smoke = _smoke()  # a run may take another tree's package (-P)
    # a build of its own, so that ptxas reports every instance
    _cuda.BUILD_DIR = os.path.join(_cuda.BUILD_DIR, "measure")
    _cuda.library()
    print(json.dumps({"item": "megakernel registers",
                      "package": rustraytrace_tpu_torch.__file__, **{
                          k: v for k, v in smoke._registers(
                              _cuda.build_info["log"]).items()
                          if k.startswith(("respawn", "mono"))}}),
          flush=True)
    print(json.dumps({"item": "megakernel SASS census",
                      **_sass_census(_cuda.build_info["path"])}),
          flush=True)
    for label, kind, tab, cfg, spp in _mk_cells():
        r, again = (smoke._mk_profile(kind, tab, cfg.seed, spp,
                                      cfg.max_depth, reps=reps)
                    for _ in range(2))
        coop = mk.cluster_cull(tab) if hasattr(mk, "cluster_cull") else None
        print(json.dumps({"item": "megakernel cell", "cell": label,
                          "lanes": tab.n_lanes, "coop": coop,
                          "ms_again": again["ms"], **r}), flush=True)
        del tab


def _mk_cells(labels=None):
    """(label, kernel, tables, config, spp) of each of MK_CELLS (those of
    ``labels`` only, where given), the tables prepared as the main path
    prepares them."""
    import torch

    from rustraytrace_tpu_torch import models
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import megakernel as mk

    dev = torch.device("cuda")
    for label, kind, name, over, spp, flags in MK_CELLS:
        if labels is not None and label not in labels:
            continue
        scene, cfg, _ = models.get_scene(name, over)
        tab = mk.prepare_megakernel(
            scene, derive_camera(cfg, device=dev), width=cfg.image_width,
            height=cfg.image_height, tile_rows=mk.respawn_tile_rows(scene),
            device=dev, **flags)
        yield label, kind, tab, cfg, spp


# the sweeps of the megakernels' design (csrc/megakernel.cuh): every
# instance forced to the cooperative form (32 slots a warp in K3, K2's leaf
# scan) or the per-lane one (a slot a lane in K3, the per-lane bounce), the
# cooperative threshold T, the block size and the resident threads an SM
# that the launch bounds ask for
MEGA_SWEEP = ((), ("-DRTT_MEGA_FORCE_COOP=1",), ("-DRTT_MEGA_FORCE_COOP=0",),
              ("-DRTT_COOP_LANES=8",), ("-DRTT_COOP_LANES=16",),
              ("-DRTT_MEGA_BLOCK=256",), ("-DRTT_MEGA_MIN_THREADS=512",),
              ("-DRTT_MEGA_MIN_THREADS=1024",))
MEGA_SWEEP_CELLS = ("K3 flagship 4K pass 3840x2160 16 spp",
                    "K3 book3_cornell_box 600x600 100 spp MIS",
                    "K3 book2_checkered_spheres 400x225 100 spp",
                    "K3 book2_cornell_smoke 600x600 200 spp",
                    "K4 book3_cornell_box 600x600 100 spp MIS")


def _mega_sweep_child(flags: list, reps: int) -> dict:
    """MEGA_SWEEP_CELLS with the library built with ``flags``: each cell's
    timed kernel (ms) and a checksum of its sums (the parent compares it
    with the default build's), and the registers of K3 and K4."""
    import hashlib

    from chip_smoke import _cuda_ms, _registers
    from rustraytrace_tpu_torch.ops import _cuda
    from rustraytrace_tpu_torch.ops import megakernel as mk

    _cuda.NVCC_FLAGS = _cuda.NVCC_FLAGS + tuple(flags)
    # a build of its own, so that ptxas reports every instance
    _cuda.BUILD_DIR = os.path.join(_cuda.BUILD_DIR, "sweep")
    out = {"flags": flags}
    for label, kind, tab, cfg, spp in _mk_cells(MEGA_SWEEP_CELLS):
        fn = mk.respawn_pass if kind == "megakernel" else mk.mono_pass
        run = lambda: fn(tab, cfg.seed, 0, spp, cfg.max_depth)  # noqa
        sums = run().cpu().numpy()
        out[label] = dict(ms=_cuda_ms(run, reps), sums_sha=hashlib.sha256(
            sums.tobytes()).hexdigest()[:16])
        del tab
    out["registers"] = {k: v for k, v in _registers(
        _cuda.build_info["log"]).items() if k.startswith(("respawn", "mono"))
        and "count" not in k}
    return out


def _mega_sweep(reps: int) -> None:
    """The MEGA_SWEEP, one process and build per setting; every setting's
    sums must equal the default build's bitwise."""
    first = None
    for flags in MEGA_SWEEP:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--mega-sweep-child",
             json.dumps(list(flags)), "--reps", str(reps)],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"sweep child {flags} failed:\n{res.stdout}"
                               f"\n{res.stderr}")
        r = json.loads(res.stdout.strip().splitlines()[-1])
        sha = {k: v["sums_sha"] for k, v in r.items()
               if isinstance(v, dict) and "sums_sha" in v}
        first = first or sha
        r["sums_equal_default"] = sha == first
        print(json.dumps({"item": "megakernel sweep", **r}), flush=True)


def _ab(parent: str, reps: int) -> int:
    """Run _ab_child with the package of ``parent`` and of this checkout,
    in turns (parent, change, change, parent), one process each."""
    here = os.path.dirname(os.path.abspath(__file__))
    for label, tree in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)):
        tree = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=tree)
        # -P: the script's own directory must not shadow the tree's package
        res = subprocess.run(
            [sys.executable, "-P", os.path.abspath(__file__), "--ab-child",
             "--reps", str(reps)], cwd=tree, env=env, capture_output=True,
            text=True, timeout=1200)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return res.returncode
        print(json.dumps({"tree": label, **json.loads(
            res.stdout.strip().splitlines()[-1])}), flush=True)
    return 0


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--spp", type=int, default=1024)
    ap.add_argument("--ab", metavar="DIR")
    ap.add_argument("--heads", action="store_true",
                    help="run item 7 only")
    ap.add_argument("--reference", action="store_true",
                    help="run item 8 only")
    ap.add_argument("--kernels", action="store_true",
                    help="run item 9 only")
    ap.add_argument("--megakernels", action="store_true",
                    help="run item 10 only")
    ap.add_argument("--mega-sweep", action="store_true",
                    help="run item 11 only")
    ap.add_argument("--segments", action="store_true",
                    help="run item 12 only")
    ap.add_argument("--dense", nargs="?", const="", metavar="DIR",
                    help="run item 13 only (DIR: a parent checkout)")
    ap.add_argument("--dense-child", metavar="FLAGS_SPLITS",
                    help=argparse.SUPPRESS)
    ap.add_argument("--mega-sweep-child", metavar="FLAGS",
                    help=argparse.SUPPRESS)
    ap.add_argument("--s1b-child", metavar="FLAGS", help=argparse.SUPPRESS)
    ap.add_argument("--ab-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--sweep-child", type=int, metavar="T",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_measure: CUDA is not available", file=sys.stderr)
        return 1
    if args.ab_child:
        print(json.dumps(_ab_child(args.reps)))
        return 0
    if args.sweep_child is not None:
        print(json.dumps(_sweep_child(args.sweep_child, args.reps)))
        return 0
    if args.s1b_child is not None:
        _s1b_child(json.loads(args.s1b_child), args.reps)
        return 0
    if args.dense_child is not None:
        print(json.dumps(_dense_child(*json.loads(args.dense_child),
                                      args.reps)))
        return 0
    if args.mega_sweep_child is not None:
        print(json.dumps(_mega_sweep_child(
            json.loads(args.mega_sweep_child), args.reps)))
        return 0
    from rustraytrace_tpu_torch import models, render
    from rustraytrace_tpu_torch.config import derive_camera
    from rustraytrace_tpu_torch.ops import megakernel as mk
    from rustraytrace_tpu_torch.ops import wavefront as wf

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    if args.ab:
        return _ab(args.ab, args.reps)
    if args.dense is not None:
        return _dense(args.dense or None, args.reps)
    if args.heads:
        _heads(args.reps)
        return 0
    if args.reference:
        _reference_routes(args.reps)
        return 0
    if args.kernels:
        _kernels(args.reps)
        return 0
    if args.megakernels:
        _megakernels(args.reps)
        return 0
    if args.mega_sweep:
        _mega_sweep(args.reps)
        return 0
    if args.segments:
        _segments(args.reps)
        return 0
    dev = torch.device("cuda")
    spp, depth = args.spp, 50
    scene, cfg, _ = models.book1_random_spheres(
        dict(image_width=1200, samples_per_pixel=spp, max_depth=depth))
    w, h = cfg.image_width, cfg.image_height
    cam = derive_camera(cfg, device=dev)
    tables = mk.prepare_megakernel(scene, cam, width=w, height=h,
                                   device=dev)
    paths = w * h * spp

    def loop(sort: bool, iters: int) -> dict:
        stats: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wf._wavefront_pass_persist(
            tables, cfg.seed, 0, spp=spp, max_depth=depth,
            persist_iters=iters, sort_rays=sort,
            sort_every=wf.persist_sort_every(iters), stats=stats)
        torch.cuda.synchronize()
        stats["wall"] = time.perf_counter() - t0
        return stats

    def show(label: str, st: dict) -> None:
        print(f"{label}: {st['wall']:.4f} s {paths / st['wall'] / 1e6:.2f} "
              f"Mpaths/s launches {st['launches']} sort_s "
              f"{st.get('sort_seconds', 0.0):.4f}", flush=True)

    iters0 = wf.persist_plain_iters(spp)
    loop(True, iters0)  # warm-up: kernel load, allocator, sort buffers
    order = [True, False, False, True] * args.reps
    for sort in order[:2 * args.reps]:
        show(f"sort={sort} iters={iters0}", loop(sort, iters0))
    for iters in (32, 64, 128, 256, 512):
        show(f"sort=True iters={iters}", loop(True, iters))

    for rep in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render.render_pass(scene, cam, cfg.seed, width=w, height=h, spp=spp,
                           max_depth=depth, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"render_pass rep {rep}: {wall:.4f} s "
              f"{paths / wall / 1e6:.2f} Mpaths/s", flush=True)
    t0 = time.perf_counter()
    mk.prepare_megakernel(scene, derive_camera(cfg, device=dev), width=w,
                          height=h, device=dev)
    torch.cuda.synchronize()
    print(f"prep {time.perf_counter() - t0:.4f} s", flush=True)

    _profiled("flagship sorted loop", lambda: loop(True, iters0))

    s3, c3, _ = models.book3_cornell_box()
    s2, c2, _ = models.book2_cornell_box()
    s4k, c4k, _ = models.book1_random_spheres(dict(image_width=3840))
    cam4k = derive_camera(c4k, device=dev)
    cells = [
        ("K3 book3_cornell_box 600x600 100 spp", s3, c3, 100,
         dict(mis=True, stratified=True, sqrt_spp=10),
         lambda: render.render_image(s3, c3, integrator="mis", device=dev)),
        ("K3 book2_cornell_box 600x600 200 spp", s2, c2, 200, {},
         lambda: render.render_image(s2, c2, device=dev)),
        ("K3 flagship 3840x2160 16 spp", s4k, c4k, 16, {},
         lambda: render.render_pass(s4k, cam4k, c4k.seed, width=3840,
                                    height=2160, spp=16, max_depth=depth,
                                    device=dev)),
    ]
    for label, sc, cf, cspp, kw, end_to_end in cells:
        cw, ch = cf.image_width, cf.image_height
        tk = mk.prepare_megakernel(sc, derive_camera(cf, device=dev),
                                   width=cw,
                                   height=ch, device=dev, **kw)
        for rep in range(-1, args.reps):  # rep -1 warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mk.respawn_pass(tk, cf.seed, 0, cspp, depth)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"{label} kernel rep {rep}: {wall:.4f} s "
                  f"{cw * ch * cspp / wall / 1e6:.2f} Mpaths/s", flush=True)
        end_to_end()  # warm: tables cached, swizzle index built
        _profiled(f"{label} end to end", end_to_end)

    s9, c9, _ = models.get_scene("the_next_week")
    w9, h9, spp9 = c9.image_width, c9.image_height, c9.samples_per_pixel
    main9 = lambda: render.render_image(s9, c9, device=dev)  # noqa: E731
    main9()  # warm: kernels, allocator; the tables are built per call
    for rep in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        main9()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"the_next_week render_image rep {rep}: {wall:.4f} s "
              f"{w9 * h9 * spp9 / wall / 1e6:.2f} Mpaths/s", flush=True)
    stats: dict = {}
    t0 = time.perf_counter()
    mk.prepare_megakernel(s9, derive_camera(c9, device=dev), width=w9,
                          height=h9, tile_rows=wf.wavefront_tile_rows(s9),
                          device=dev)
    torch.cuda.synchronize()
    print(f"the_next_week prep {time.perf_counter() - t0:.4f} s", flush=True)
    render.render_pass(s9, derive_camera(c9, device=dev), c9.seed,
                       width=w9, height=h9, spp=spp9, max_depth=c9.max_depth,
                       device=dev, stats=stats)
    print(f"the_next_week loop: {stats}", flush=True)
    _profiled("the_next_week render_image", main9)
    _heads(args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
