"""K1 closest hit: the port's ``sphere_hit`` (plain version on the CPU)
against the JAX Pallas kernel ``_sphere_hit_raw`` in interpret mode, on the
same seeded rays.  The CUDA kernel is held against the plain version in
test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rustraytrace_tpu import models as jmodels  # noqa: E402
from rustraytrace_tpu.ops import pallas_hit as jhit  # noqa: E402
from rustraytrace_tpu.ops import pallas_megakernel as jmk  # noqa: E402
from rustraytrace_tpu_torch import models, scene_from_numpy  # noqa: E402
from rustraytrace_tpu_torch.ops import hit  # noqa: E402

N_RAYS = 16384


def _rays(n, seed, center=(13.0, 2.0, 3.0), spread=3.0, target=4.0):
    """Origins around ``center``; 70% of the rays aimed into the scene."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)) + np.asarray(center)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    to_scene = rng.uniform(-target, target, (n, 3)) - o
    d = np.where((rng.uniform(size=n) < 0.7)[:, None], to_scene, d)
    t = rng.uniform(size=n)
    return (o.astype(np.float32), d.astype(np.float32),
            t.astype(np.float32))


def _jax_hit(sph, quad, n_quads, o, d, t, moving):
    def plane(x):
        return jnp.asarray(x.reshape(-1, 128))

    tt, ii = jhit._sphere_hit_raw(
        jnp.asarray(sph), jnp.asarray(quad), plane(o[:, 0]), plane(o[:, 1]),
        plane(o[:, 2]), plane(d[:, 0]), plane(d[:, 1]), plane(d[:, 2]),
        plane(t), n_quads=n_quads, moving=moving, interpret=True)
    return np.asarray(tt).reshape(-1), np.asarray(ii).reshape(-1)


def _check(t_ref, i_ref, t, i, min_hits):
    same_i = np.mean(i == i_ref)
    close_t = np.mean(np.abs(t - t_ref)
                      <= 1e-4 * np.maximum(1.0, np.abs(t_ref)))
    assert (i_ref >= 0).sum() >= min_hits  # the rays really hit things
    assert same_i >= 0.999, same_i
    assert close_t >= 0.999, close_t


def _jax_fields(scene):
    out = {f.name: np.asarray(getattr(scene, f.name))
           for f in dataclasses.fields(scene) if f.name != "features"}
    out["features"] = tuple(scene.features)
    return out


def test_flagship_matches_jax_interpret():
    jscene, _, _ = jmodels.book1_random_spheres(dict(image_width=64))
    scene, _, _ = models.book1_random_spheres(dict(image_width=64))
    sph = hit.pack_sphere_table(scene)
    np.testing.assert_array_equal(sph.numpy(),
                                  np.asarray(jhit.pack_sphere_table(jscene)))
    o, d, t = _rays(N_RAYS, seed=1)
    t_ref, i_ref = _jax_hit(sph.numpy(), np.zeros((1, 32), np.float32), 0,
                            o, d, t, False)
    tq, iq = hit.sphere_hit(torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(t), sph,
                            torch.zeros((0, hit.Q_COLS)), False)
    assert tq.dtype == torch.float32 and iq.dtype == torch.int32
    _check(t_ref, i_ref, tq.numpy(), iq.numpy(), min_hits=N_RAYS // 2)
    assert np.all(tq.numpy()[iq.numpy() < 0] == hit.T_MAX)


@pytest.mark.parametrize("name,moving,kw", [
    ("book2_bouncing_spheres", True, {}),
    ("book2_quads", False,
     dict(center=(0.0, 0.0, 9.0), spread=1.0, target=3.0)),
])
def test_motion_and_quads_match_jax_interpret(name, moving, kw):
    jscene, _, _ = jmodels.get_scene(name, dict(image_width=32))
    scene = scene_from_numpy(_jax_fields(jscene))
    sph = hit.pack_sphere_table(scene)
    has_quads = "quads" in scene.features
    quad = (hit.pack_quad_table(scene) if has_quads
            else torch.zeros((0, hit.Q_COLS)))
    jquad = (np.asarray(jmk.pack_quad_table(jscene)) if has_quads
             else np.zeros((1, 32), np.float32))
    np.testing.assert_allclose(quad.numpy(), jquad[:quad.shape[0]],
                               rtol=1e-6, atol=1e-7)
    o, d, t = _rays(8192, seed=2, **kw)  # JAX tiles are 64 x 128 rays
    t_ref, i_ref = _jax_hit(sph.numpy(), jquad, quad.shape[0], o, d, t,
                            moving)
    tq, iq = hit.sphere_hit(torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(t), sph, quad, moving)
    _check(t_ref, i_ref, tq.numpy(), iq.numpy(), min_hits=1000)
    if has_quads:
        assert (iq.numpy() >= sph.shape[0]).sum() > 500  # quad winners


@pytest.mark.parametrize("name", ["book1_random_spheres",
                                  "book2_bouncing_spheres"])
def test_float4_repack_equals_the_table_columns(name):
    """K1's float4 planes carry columns 0-3 (center, r^2) and 4-6
    (velocity) of the sphere table bit for bit, the fourth velocity word
    zero; the bouncing spheres move."""
    scene, _, _ = models.get_scene(name)
    tab = hit.pack_sphere_table(scene)
    f4 = hit.sphere_table_f4(tab)
    assert f4.shape == (2, tab.shape[0], 4) and f4.is_contiguous()
    bits = tab.view(torch.int32)
    assert torch.equal(f4[0].view(torch.int32), bits[:, 0:4])
    assert torch.equal(f4[1, :, :3].view(torch.int32), bits[:, 4:7])
    assert torch.equal(f4[1, :, 3], torch.zeros(tab.shape[0]))
    moving = bool((tab[:, hit.S_VX:hit.S_VZ + 1] != 0).any())
    assert moving == (name == "book2_bouncing_spheres")
    # the sphere_kernel route builds the planes once, with its tables
    sph, _, planes = hit.sphere_kernel_tables(scene)
    assert torch.equal(sph, tab) and torch.equal(planes, f4)


def test_sphere_hit_rejects_bad_arguments():
    scene, _, _ = models.book1_random_spheres()
    sph = hit.pack_sphere_table(scene)
    quad = torch.zeros((0, hit.Q_COLS))
    o, d, t = (torch.from_numpy(x) for x in _rays(64, 1))
    hit.sphere_hit(o, d, t, sph, quad, False)
    for args in ((o.double(), d, t, sph, quad), (o, d[:, :2], t, sph, quad),
                 (o, d, t[:32], sph, quad), (o, d, t, sph[:, :7], quad),
                 (o, d, t, sph, quad.int())):
        with pytest.raises(ValueError):
            hit.sphere_hit(*args, False)
