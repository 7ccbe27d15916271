"""The port's measurement scripts (``rustraytrace_tpu_torch/scripts``:
``bench_scenes``, ``baseline_matrix``, ``scaling_bench``) against their
counterparts (``scripts/bench_scenes.py``, ``scripts/baseline_matrix.py``,
``scaling_bench.py``): the same cases and configurations, the same JSON
keys, and a one-rank sharded pass of each ``scaling_bench`` backend equal
to the single-card pass of its route; ``scaling_bench --virtual 2`` as a
job of two gloo ranks on the CPU."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import rustraytrace_tpu.render as jrender  # noqa: E402
from rustraytrace_tpu_torch import render  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import megakernel as mk  # noqa: E402
from rustraytrace_tpu_torch.parallel import Mesh  # noqa: E402
from rustraytrace_tpu_torch.scripts import (baseline_matrix,  # noqa: E402
                                            bench_scenes, scaling_bench)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(rel: str):
    spec = importlib.util.spec_from_file_location(
        "jax_" + os.path.basename(rel)[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_scenes_cases_equal_jax():
    assert bench_scenes.CASES == _jax_script("scripts/bench_scenes.py").CASES


class _Stop(Exception):
    pass


@pytest.mark.parametrize("config", [1, 2, 3, 5])
def test_baseline_matrix_configs_equal_jax(monkeypatch, config):
    """Each configuration's scene, integrator and RenderConfig equal what
    the JAX script builds (stopped where it sizes its passes)."""
    seen = {}

    def route(scene, integ, *a, **k):
        seen["scene"], seen["integ"] = scene, integ
        return "xla"

    def stop(cfg, *a, **k):
        raise _Stop(cfg)

    monkeypatch.setattr(jrender, "resolve_backend", route)
    monkeypatch.setattr(jrender, "effective_spp_per_pass", stop)
    with pytest.raises(_Stop) as stopped:
        _jax_script("scripts/baseline_matrix.py").run(config)
    jcfg = stopped.value.args[0]
    scene, cfg, integ = baseline_matrix.config_scene(config)
    assert integ == seen["integ"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(scene.sph_center.numpy(),
                                  np.asarray(seen["scene"].sph_center))
    assert (cfg.image_width, cfg.image_height) == {
        1: (400, 225), 2: (1200, 675), 3: (800, 450), 5: (3840, 2160)}[config]


def test_baseline_matrix_config4_points_at_the_fit():
    with pytest.raises(SystemExit, match="inverse_rendering"):
        baseline_matrix.run(4, device="cpu")


@pytest.mark.parametrize("backend", ["xla", "megakernel", "wavefront"])
def test_scaling_bench_one_rank_pass_is_the_route(backend):
    """A one-rank pass of each backend is bitwise the single-card pass of
    its route: the reference route, K3 (``respawn=True``), the image route
    on the earth (the kernels' plain twins on the CPU)."""
    scene, cfg = scaling_bench.scene_for(backend, 32, 2, 3)
    cam = derive_camera(cfg, "cpu")
    w, h = cfg.image_width, cfg.image_height
    got = scaling_bench.run_pass(backend, scene, cam, Mesh(1, 1), width=w,
                                 height=h, spp=2, depth=3, device="cpu")
    kw = dict(width=w, height=h, spp=2, max_depth=3, device="cpu")
    if backend == "xla":
        want = render.render_pass(scene, cam, 0, backend="reference",
                                  chunk=16384, **kw)
    elif backend == "megakernel":
        want = mk.render_pass_megakernel(scene, cam, 0, respawn=True, **kw)
    else:
        assert "image" in scene.features
        want = render.render_pass(scene, cam, 0, **kw)
    assert torch.equal(got, want)


def test_scaling_bench_prints_the_jax_keys(capsys):
    """One rank: the timed keys, efficiency 1.0 by definition; two gloo
    ranks: the kernel backends' ``wiring_only`` lines, as the JAX script
    prints them off the TPU."""
    scaling_bench.main(["--backend", "xla", "--width", "32", "--spp", "1",
                        "--depth", "2", "--device", "cpu"])
    scaling_bench.main(["--virtual", "2", "--backend", "megakernel",
                        "--width", "32", "--spp", "2", "--depth", "2"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 3
    assert set(lines[0]) == {"backend", "devices", "paths_per_s", "seconds",
                             "efficiency"}
    assert lines[0]["devices"] == 1 and lines[0]["efficiency"] == 1.0
    assert lines[1:] == [{"backend": "megakernel", "devices": n,
                          "wiring_only": True, "ok": True} for n in (1, 2)]


def test_scaling_bench_leaves_a_callers_group_up(tmp_path, capsys):
    """Inside a process group its caller made (one gloo rank), the
    benchmark runs on that world and leaves the group up."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        scaling_bench.main(["--backend", "xla", "--width", "16", "--spp",
                            "1", "--depth", "2", "--device", "cpu"])
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["devices"] == 1 and line["efficiency"] == 1.0
