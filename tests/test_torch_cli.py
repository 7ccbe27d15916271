"""The port's command line (``cli.py``, ``__main__.py``) on the CPU: the
twins of the seven tests of ``tests/test_cli.py`` with ``--device cpu``,
the parser and the debug renders against the JAX package's, the CLI's
render against the JAX CLI's (channel means within 0.02, 4x4 blocks within
5 SE: independent streams), and the port's own rules: ``--backend
sphere_kernel --sharded`` exits 2, and ``--device cuda`` without a card
raises and writes no image (no CPU fallback).  Under a job of two
processes started with ``torchrun``'s variables, ``--sharded`` writes one
image, one checkpoint and one set of meter lines, from rank 0.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rustraytrace_tpu import cli as jcli  # noqa: E402
from rustraytrace_tpu import models as jmodels  # noqa: E402
from rustraytrace_tpu.utils.checkpoint import \
    load_checkpoint as jax_load_checkpoint  # noqa: E402
from rustraytrace_tpu_torch import models  # noqa: E402
from rustraytrace_tpu_torch.cli import build_parser, debug_render, main  # noqa: E402
from rustraytrace_tpu_torch.render import render_image  # noqa: E402
from rustraytrace_tpu_torch.utils.checkpoint import (load_checkpoint,  # noqa: E402
                                                     save_checkpoint)
from rustraytrace_tpu_torch.utils.image_io import read_ppm  # noqa: E402
from test_torch_reference import _block_agreement  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def test_cli_renders_ppm(tmp_path):
    out = tmp_path / "img.ppm"
    rc = main([
        "book1_three_spheres", "--width", "24", "--spp", "2", "--depth", "3",
        "--backend", "xla", "-o", str(out), "--quiet", *CPU,
    ])
    assert rc == 0
    img = read_ppm(str(out))
    assert img.shape == (int(24 / (16 / 9)), 24, 3)
    assert img.max() > 50  # sky is bright


def test_cli_unknown_scene():
    assert main(["no_such_scene", "--quiet", *CPU]) == 2


def test_cli_book2_dispatch(tmp_path):
    out = tmp_path / "q.ppm"
    rc = main([
        "the_next_week", "5", "--width", "16", "--spp", "1", "--depth", "2",
        "--backend", "xla", "-o", str(out), "--quiet", *CPU,
    ])
    assert rc == 0
    assert read_ppm(str(out)).shape[1] == 16


def test_cli_sharded(tmp_path, capsys):
    out = tmp_path / "s.ppm"
    rc = main([
        "book1_three_spheres", "--width", "16", "--spp", "2", "--depth", "2",
        "--sharded", "-o", str(out), "--chunk", "256", *CPU,
    ])
    assert rc == 0
    assert read_ppm(str(out)).shape[1] == 16
    err = capsys.readouterr().err.splitlines()
    assert err[0] == "mesh: {'px': 1, 'spp': 1}"
    assert '"done_spp": 2' in err[-1]


def test_checkpoint_resume_identity(tmp_path):
    """render(N spp) == render(N/2 spp) -> checkpoint -> resume(N/2 more),
    bitwise."""
    scene, cfg, integ = models.book1_three_spheres(
        dict(image_width=24, samples_per_pixel=8, max_depth=3,
             spp_per_pass=4))
    cfg = cfg.replace(aspect_ratio=2.0)
    kw = dict(integrator=integ, chunk=256, backend="xla", device="cpu")
    full, st_full = render_image(scene, cfg, **kw)
    _, st_half = render_image(scene, cfg.replace(samples_per_pixel=4), **kw)
    ck = tmp_path / "ck.npz"
    save_checkpoint(str(ck), st_half, cfg, scene)
    resumed_state = load_checkpoint(str(ck), cfg, scene)
    img2, st2 = render_image(scene, cfg, accum_state=resumed_state, **kw)
    assert st2["spp_done"] == st_full["spp_done"] == 8
    np.testing.assert_array_equal(full, img2)
    np.testing.assert_array_equal(st_full["accum"], st2["accum"])


def test_checkpoint_fingerprint_mismatch(tmp_path):
    scene, cfg, integ = models.book1_three_spheres(
        dict(image_width=16, samples_per_pixel=2, max_depth=2))
    _, st = render_image(scene, cfg, integrator=integ, chunk=256,
                         backend="xla", device="cpu")
    ck = tmp_path / "ck.npz"
    save_checkpoint(str(ck), st, cfg, scene)
    with pytest.raises(ValueError, match="fingerprint"):
        load_checkpoint(str(ck), cfg.replace(samples_per_pixel=4), scene)
    # and through the CLI: a resume against other settings raises
    with pytest.raises(ValueError, match="fingerprint"):
        main(["book1_three_spheres", "--width", "16", "--spp", "4",
              "--depth", "2", "--resume", str(ck), "-o",
              str(tmp_path / "x.ppm"), "--quiet", *CPU])
    assert not (tmp_path / "x.ppm").exists()


def test_debug_modes(tmp_path):
    """--debug-mode matches the reference's WGSL DEBUG_GRADIENT /
    DEBUG_PARAM sanity renders (gpu/renderer.wgsl:48-49,258-278)."""
    from PIL import Image

    out = tmp_path / "dbg.png"
    assert main(["book1_three_spheres", "--width", "64", "--debug-mode",
                 "param", "-o", str(out), "--quiet", *CPU]) == 0
    a = np.asarray(Image.open(out))
    # flat (width/1024, height/1024, 0) fill
    assert (a == a[0, 0]).all() and a[0, 0, 2] == 0
    assert abs(int(a[0, 0, 0]) - int(64 / 1024.0 * 256)) <= 1

    assert main(["book1_three_spheres", "--width", "64", "--debug-mode",
                 "gradient", "-o", str(out), "--quiet", *CPU]) == 0
    g = np.asarray(Image.open(out)).astype(np.int32)
    # sky gradient: blue channel dominates everywhere, brighter at bottom
    assert (g[..., 2] >= g[..., 0]).all()
    assert g[-1].mean() > g[0].mean()


ARGVS = [
    ["in_one_weekend"],
    ["the_next_week", "7", "--spp", "200", "--backend", "wavefront"],
    ["book3_cornell_box", "--spp", "100", "--width", "300", "--depth", "9",
     "--spp-per-pass", "10", "--chunk", "4096", "--seed", "3", "-o", "a.png",
     "--quiet"],
    ["book1_random_spheres", "--sharded", "--spp-shards", "2",
     "--backend", "megakernel", "--checkpoint", "c.npz", "--resume",
     "r.npz", "--debug-mode", "gradient"],
    ["book2_earth", "--backend", "xla", "--debug-mode", "param"],
    ["book1_three_spheres", "--backend", "sphere_kernel"],
]


def test_build_parser_matches_jax():
    for argv in ARGVS:
        got = vars(build_parser().parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == vars(jcli.build_parser().parse_args(argv)), argv
        assert vars(build_parser().parse_args(argv + CPU))["device"] == "cpu"
    for bad in (["x", "--backend", "plain"], ["x", "--device", "tpu"]):
        with pytest.raises(SystemExit):
            build_parser().parse_args(bad)


@pytest.mark.parametrize("name,width", [("book1_three_spheres", 64),
                                        ("book3_cornell_box", 40),
                                        ("in_one_weekend", 48)])
def test_debug_render_matches_jax(name, width):
    over = dict(image_width=width)
    jcfg = jmodels.get_scene(name, over)[1]
    cfg = models.get_scene(name, over)[1]
    np.testing.assert_array_equal(debug_render(cfg, "param", device="cpu"),
                                  jcli.debug_render(jcfg, "param"))
    got = debug_render(cfg, "gradient", device="cpu").astype(np.int32)
    want = jcli.debug_render(jcfg, "gradient").astype(np.int32)
    assert got.shape == want.shape == (cfg.image_height, width, 3)
    assert np.abs(got - want).max() <= 1


def test_cli_render_matches_the_jax_cli(tmp_path):
    """The slice against JAX: the radiance sums the two CLIs checkpoint
    for ``book1_three_spheres`` 40 wide, 8 spp, depth 6 (the reference
    route both)."""
    args = ["book1_three_spheres", "--width", "40", "--spp", "8", "--depth",
            "6", "--backend", "xla", "--quiet"]
    ck, jck = tmp_path / "port.npz", tmp_path / "jax.npz"
    assert main(args + ["--checkpoint", str(ck), "-o",
                        str(tmp_path / "p.ppm"), *CPU]) == 0
    assert jcli.main(args + ["--checkpoint", str(jck), "-o",
                             str(tmp_path / "j.ppm")]) == 0
    scene, cfg, _ = models.get_scene("book1_three_spheres", dict(
        image_width=40, samples_per_pixel=8, max_depth=6))
    jscene, jcfg, _ = jmodels.get_scene("book1_three_spheres", dict(
        image_width=40, samples_per_pixel=8, max_depth=6))
    st = load_checkpoint(str(ck), cfg, scene)
    jst = jax_load_checkpoint(str(jck), jcfg, jscene)
    assert st["spp_done"] == jst["spp_done"] == 8
    got = np.asarray(st["accum"]) / 8
    assert got.shape == (22, 40, 3) and np.all(np.isfinite(got))
    _block_agreement(got, np.asarray(jst["accum"]) / 8)


def test_sharded_sphere_kernel_exits_2(tmp_path):
    out = tmp_path / "k.ppm"
    assert main(["book1_three_spheres", "--width", "16", "--spp", "1",
                 "--backend", "sphere_kernel", "--sharded", "-o", str(out),
                 "--quiet", *CPU]) == 2
    assert not out.exists()


def test_device_cuda_without_a_card_renders_nothing(tmp_path, monkeypatch):
    """The default ``--device cuda`` with no card raises the port's
    ``RuntimeError``: no image, nothing rendered on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--sharded"], ["--debug-mode", "gradient"]):
        out = tmp_path / "none.ppm"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["book1_three_spheres", "--width", "16", "--spp", "1",
                  "-o", str(out), "--quiet", *extra])
        assert not out.exists()


def test_module_entry_point_writes_a_ppm(tmp_path):
    out = tmp_path / "m.ppm"
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "rustraytrace_tpu_torch", "book1_three_spheres",
         "--width", "16", "--spp", "2", "--depth", "2", "-o", str(out),
         *CPU], cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert read_ppm(str(out)).shape == (9, 16, 3)
    assert '"done_spp": 2' in res.stderr.splitlines()[-1]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_job(tmp_path, args, n=2):
    """Run the CLI as ``n`` processes of one job, each with the variables
    ``torchrun`` sets (the ``env://`` branch of ``parallel.initialize``);
    returns [(stdout, stderr)] by rank."""
    env = dict(os.environ, PYTHONPATH=REPO, WORLD_SIZE=str(n),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rustraytrace_tpu_torch", *args, *CPU],
        cwd=str(tmp_path), env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


@pytest.mark.parametrize("spp_shards", [None, 2])
def test_cli_sharded_two_ranks_one_writer(tmp_path, spp_shards):
    """``--sharded`` over two ranks: rank 0 alone writes the image (to -o,
    or one PPM on stdout), the checkpoint and the meter lines; both equal
    the one-process ``--sharded`` render, bitwise on the pixel-sharded
    mesh and up to the order of the sums on the spp-sharded one."""
    base = ["book1_three_spheres", "--width", "16", "--spp", "4", "--depth",
            "3", "--spp-per-pass", "2", "--chunk", "256", "--sharded"]
    out, ck = tmp_path / "job.ppm", tmp_path / "job.npz"
    to_file = spp_shards is None
    job = base + ["--checkpoint", str(ck)] + (
        ["-o", str(out)] if to_file else ["--spp-shards", str(spp_shards)])
    (out0, err0), (out1, err1) = _cli_job(tmp_path, job)
    if not to_file:
        assert out0.count("P3") == 1
        out.write_text(out0)
    assert out1 == ""
    # the CLI's own lines (torch's c10d may add warnings of its own)
    own = [[ln for ln in err.splitlines() if ln.startswith(("mesh:", "{"))]
           for err in (err0, err1)]
    assert own[1] == []
    want_mesh = {"px": 1, "spp": 2} if spp_shards else {"px": 2, "spp": 1}
    assert own[0][0] == f"mesh: {want_mesh}" and len(own[0]) == 4
    assert ['"pass_spp"' in ln for ln in own[0][1:]] == [True, True, False]
    assert '"done_spp": 4' in own[0][-1]

    one, one_ck = tmp_path / "one.ppm", tmp_path / "one.npz"
    assert main(base + ["--checkpoint", str(one_ck), "-o", str(one),
                        "--quiet", *CPU]) == 0
    scene, cfg, _ = models.get_scene("book1_three_spheres", dict(
        image_width=16, samples_per_pixel=4, max_depth=3, spp_per_pass=2))
    st, st1 = (load_checkpoint(str(f), cfg, scene) for f in (ck, one_ck))
    assert st["spp_done"] == st1["spp_done"] == 4
    img, img1 = read_ppm(str(out)), read_ppm(str(one))
    assert img.shape == (9, 16, 3)
    if spp_shards:
        np.testing.assert_allclose(st["accum"], st1["accum"], rtol=1e-5,
                                   atol=1e-5)
        assert np.abs(img.astype(int) - img1.astype(int)).max() <= 1
    else:
        np.testing.assert_array_equal(st["accum"], st1["accum"])
        np.testing.assert_array_equal(img, img1)
