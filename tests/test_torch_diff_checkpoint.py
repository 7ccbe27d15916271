"""The port's checkpoints (``utils/checkpoint.py``) on the CPU: the render
accumulation ``.npz`` (the JAX package's keys) with its scene/config
fingerprint, and the train state of ``diff.fit`` with its overwrite
guard."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rustraytrace_tpu_torch import models, render  # noqa: E402
from rustraytrace_tpu_torch.utils import checkpoint as ck  # noqa: E402


def _scene():
    return models.book1_three_spheres(dict(
        image_width=16, samples_per_pixel=4, max_depth=3, spp_per_pass=2))


def test_npz_round_trip_with_the_jax_keys(tmp_path):
    scene, cfg, _ = _scene()
    seen = []
    render.render_image(scene, cfg, backend="reference", device="cpu",
                        on_pass=seen.append)
    path = str(tmp_path / "acc.npz")
    ck.save_checkpoint(path, seen[0], cfg, scene)
    with np.load(path) as z:
        assert sorted(z.files) == ["accum", "fingerprint", "seed",
                                   "spp_done"]
        assert int(z["seed"]) == cfg.seed
    state = ck.load_checkpoint(path, cfg, scene)
    assert state["spp_done"] == 2
    np.testing.assert_array_equal(state["accum"], seen[0]["accum"].numpy())
    # the resumed render equals the unbroken one
    _, full = render.render_image(scene, cfg, backend="reference",
                                  device="cpu")
    _, resumed = render.render_image(scene, cfg, backend="reference",
                                     device="cpu", accum_state=state)
    np.testing.assert_array_equal(resumed["accum"], full["accum"])


def test_fingerprint_mismatch_raises(tmp_path):
    scene, cfg, _ = _scene()
    path = str(tmp_path / "acc.npz")
    ck.save_checkpoint(path, {"accum": np.zeros((9, 16, 3), np.float32),
                              "spp_done": 2}, cfg, scene)
    with pytest.raises(ValueError, match="different scene"):
        ck.load_checkpoint(path, cfg.replace(seed=cfg.seed + 1), scene)
    r = scene.sph_radius.clone()
    r[0] += 1e-3
    with pytest.raises(ValueError, match="different scene"):
        ck.load_checkpoint(path, cfg, dataclasses.replace(
            scene, sph_radius=r))


def test_fingerprint_hashes_the_whole_buffer():
    """A change to the last sphere alone changes the fingerprint."""
    scene, cfg, _ = models.book1_random_spheres(dict(image_width=16))
    c = scene.sph_center.clone()
    c[-1, 0] += 0.5
    moved = dataclasses.replace(scene, sph_center=c)
    assert ck._fingerprint(cfg, scene) != ck._fingerprint(cfg, moved)
    assert ck._fingerprint(cfg, scene) == ck._fingerprint(
        cfg, dataclasses.replace(scene, sph_center=scene.sph_center.clone()))


def test_train_state_round_trip(tmp_path):
    p = {"tex_color1": torch.rand(3, 3, requires_grad=True),
         "sph_center": torch.rand(3, 3, requires_grad=True)}
    opt = torch.optim.Adam([{"params": [p["tex_color1"]], "lr": 0.03},
                            {"params": [p["sph_center"]], "lr": 0.004}])
    (p["tex_color1"].sum() + (p["sph_center"] ** 2).sum()).backward()
    opt.step()
    path = str(tmp_path / "train")
    ck.save_train_checkpoint(path, step=7, params=p,
                             opt_state=opt.state_dict(),
                             rng={"base": 4, "step": 7})
    assert ck.has_train_checkpoint(path)
    step, params, opt_state, rng = ck.load_train_checkpoint(path)
    assert step == 7 and rng == {"base": 4, "step": 7}
    for k in p:
        assert torch.equal(params[k], p[k].detach())
    q = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    opt2 = torch.optim.Adam([{"params": [q["tex_color1"]], "lr": 1.0},
                             {"params": [q["sph_center"]], "lr": 1.0}])
    opt2.load_state_dict(opt_state)
    assert [g["lr"] for g in opt2.param_groups] == [0.03, 0.004]
    for a, b in zip(opt.state.values(), opt2.state.values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    # a later save replaces the earlier state
    ck.save_train_checkpoint(path, step=9, params=p,
                             opt_state=opt.state_dict(),
                             rng={"base": 4, "step": 9})
    assert ck.load_train_checkpoint(path)[0] == 9


def test_train_state_refuses_a_path_that_is_not_one(tmp_path):
    p = {"x": torch.zeros(2)}
    kw = dict(step=1, params=p, opt_state={}, rng={"base": 0, "step": 1})
    data = tmp_path / "data"
    data.mkdir()
    (data / "precious.txt").write_text("keep")
    with pytest.raises(ValueError, match="refusing"):
        ck.save_train_checkpoint(str(data), **kw)
    assert (data / "precious.txt").read_text() == "keep"
    afile = tmp_path / "afile"
    afile.write_text("keep")
    with pytest.raises(ValueError, match="refusing"):
        ck.save_train_checkpoint(str(afile), **kw)
    assert afile.read_text() == "keep"
    empty = tmp_path / "empty"
    empty.mkdir()
    ck.save_train_checkpoint(str(empty), **kw)  # an empty directory is fine
    assert ck.has_train_checkpoint(str(empty))
