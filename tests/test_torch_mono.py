"""The monolithic megakernel K4 (plain twin on the CPU): bitwise equal to
K3's twin on a Book-1, a Book-2 and a Book-3 scene, the default of
``render_pass_megakernel``, and the entry points' ``device="cuda"``
default.  The CUDA kernel is held against its twin and K3 in
test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

from rustraytrace_tpu_torch import models  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import megakernel as mk  # noqa: E402
from rustraytrace_tpu_torch.ops import wavefront as wf  # noqa: E402


def _tables(name, width=24, spp=4):
    scene, cfg, integ = models.get_scene(
        name, dict(image_width=width, samples_per_pixel=spp))
    n = int(np.sqrt(spp)) if cfg.stratified else 0
    return mk.prepare_megakernel(
        scene, derive_camera(cfg, "cpu"), width=width,
        height=cfg.image_height, mis=integ == "mis",
        stratified=cfg.stratified, sqrt_spp=n, device="cpu")


@pytest.mark.parametrize("name", ["book1_three_spheres",
                                  "book2_cornell_smoke",
                                  "book3_cornell_box"])
def test_mono_pass_equals_respawn_pass(name):
    """K4's twin (samples one after another, a bounce loop each) and K3's
    (lanes respawning on their own) bank the same sums bitwise: the draws
    are keyed by (slot, sample, bounce, stream) and the sums added in
    sample order."""
    tables = _tables(name)
    k4 = mk.mono_pass(tables, 13, 3, 4, 8)
    k3 = mk.respawn_pass_plain(tables, 13, 3, 4, 8)
    assert k4.shape == (tables.n_lanes, 3)
    assert torch.all(torch.isfinite(k4)) and float(k4.sum()) > 0
    assert torch.equal(k4, k3)


def test_render_pass_megakernel_defaults_to_k4(monkeypatch):
    scene, cfg, _ = models.book1_three_spheres(dict(image_width=16))
    cam = derive_camera(cfg, "cpu")
    calls = []

    def spy(name, fn):
        def run(*args):
            calls.append(name)
            return fn(*args)
        monkeypatch.setattr(mk, name, run)

    spy("mono_pass", mk.mono_pass)
    spy("respawn_pass", mk.respawn_pass)
    kw = dict(width=16, height=cfg.image_height, spp=2, max_depth=4,
              device="cpu")
    k4 = mk.render_pass_megakernel(scene, cam, 5, **kw)
    k3 = mk.render_pass_megakernel(scene, cam, 5, respawn=True, **kw)
    assert calls == ["mono_pass", "respawn_pass"]
    assert k4.shape == (cfg.image_height, 16, 3)
    assert torch.equal(k4, k3)


def test_render_pass_megakernel_rejects_image_scenes():
    scene, cfg, _ = models.book2_earth(dict(image_width=16))
    with pytest.raises(ValueError, match="image"):
        mk.render_pass_megakernel(
            scene, derive_camera(cfg, "cpu"), 5, width=16,
            height=cfg.image_height, spp=1, max_depth=4, device="cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    """``device`` defaults to ``"cuda"``, as in render.py: without a card
    the entry points raise; nothing moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, cfg, _ = models.book1_three_spheres(dict(image_width=16))
    cam = derive_camera(cfg, "cpu")
    kw = dict(width=16, height=cfg.image_height)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mk.prepare_megakernel(scene, cam, **kw)
    for fn in (mk.render_pass_megakernel, wf.render_pass_wavefront):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(scene, cam, 1, spp=1, max_depth=2, **kw)
