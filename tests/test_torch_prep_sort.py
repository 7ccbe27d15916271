"""Host half of the port's persist path tracer against the JAX package:
prepared tables, slot swizzle, routing predicates, and the between-launch
ray sort — all bit-equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rustraytrace_tpu import models as jmodels  # noqa: E402
from rustraytrace_tpu import native as jnative  # noqa: E402
from rustraytrace_tpu import render as jrender  # noqa: E402
from rustraytrace_tpu.config import derive_camera as jax_derive_camera  # noqa: E402
from rustraytrace_tpu.ops import pallas_megakernel as jmk  # noqa: E402
from rustraytrace_tpu.ops import pallas_wavefront as jwf  # noqa: E402
from rustraytrace_tpu_torch import models, render  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import megakernel as mk  # noqa: E402
from rustraytrace_tpu_torch.ops import wavefront as wf  # noqa: E402

BOOK1 = ["book1_three_spheres", "book1_random_spheres"]


@pytest.fixture
def native_lib():
    if not jnative.available():
        pytest.skip("the JAX package's native library does not load")


@pytest.mark.parametrize("name", BOOK1)
def test_prepared_tables_equal_jax(native_lib, name):
    w = 1200
    jscene, jcfg, _ = getattr(jmodels, name)(dict(image_width=w))
    scene, cfg, _ = getattr(models, name)(dict(image_width=w))
    h = cfg.image_height
    arrays, st = jmk.prepare_megakernel(
        jscene, jax_derive_camera(jcfg), width=w, height=h, spp=8,
        max_depth=8, interpret=True, segment=True)
    prep = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=w,
                                 height=h, device="cpu")
    geom = np.asarray(arrays["tab"]).T  # JAX: column-major geometry
    np.testing.assert_array_equal(prep.geom.numpy(), geom)
    n = geom.shape[0]
    atab = np.asarray(arrays["atab"]).reshape(len(mk.ACOLS), -1)[:, :n].T
    np.testing.assert_array_equal(prep.tab.numpy()[:, list(mk.ACOLS)], atab)
    for k in ("clb", "cls", "sclb", "scls", "cam_u", "bg"):
        have = getattr(prep, k).numpy()
        assert have.dtype == np.asarray(arrays[k]).dtype, k
        np.testing.assert_array_equal(have, np.asarray(arrays[k]), k)
    assert (prep.n_clusters, prep.n_sclusters, prep.rows, prep.unroll) == (
        st["n_clusters"], st["n_sclusters"], st["rows"], st["unroll"])
    assert prep.sky_bg == st["sky_bg"] and prep.defocus == st["defocus"]


@pytest.mark.parametrize("w,h", [(64, 36), (100, 50), (1200, 675)])
def test_slot_swizzle_equal_jax(w, h):
    np.testing.assert_array_equal(mk._unswizzle_index(w, h),
                                  np.asarray(jmk._unswizzle_index(w, h)))
    px, py, rows = wf._slot_pixels(w, h, 32)
    jpx, jpy, jrows = jwf._slot_pixels(w, h, 32)
    assert rows == jrows
    np.testing.assert_array_equal(px, np.asarray(jpx))
    np.testing.assert_array_equal(py, np.asarray(jpy))


def test_device_unswizzle_index_is_cached():
    idx = mk.unswizzle_index_on(100, 50, "cpu")
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), mk._unswizzle_index(100, 50))
    assert mk.unswizzle_index_on(100, 50, torch.device("cpu")) is idx


@pytest.mark.parametrize("width", [64, 1200, 3840])
@pytest.mark.parametrize("name", BOOK1)
def test_routing_predicates_equal_jax(monkeypatch, name, width):
    monkeypatch.delenv("RTT_SORT_RAYS", raising=False)
    jscene, jcfg, _ = getattr(jmodels, name)(dict(image_width=width))
    scene, cfg, _ = getattr(models, name)(dict(image_width=width))
    h = cfg.image_height
    n = wf.slot_lane_count(width, h)
    assert n == jwf.slot_lane_count(width, h)
    assert wf.RAY_SORT_MAX_LANES == jwf.RAY_SORT_MAX_LANES
    assert (mk.active_primitive_count(scene)
            == jmk.active_primitive_count(jscene))
    assert mk.respawn_tile_rows(scene) == jmk.respawn_tile_rows(jscene)
    assert (wf.ray_sort_heuristic(scene, n)
            == jwf.ray_sort_heuristic(jscene, n))
    assert (wf.sorted_persist_route(scene, width, h)
            == jwf.sorted_persist_route(jscene, width, h))
    for spp in (1, 8, 64, 100, 512, 1024, 4096):
        it = wf.persist_plain_iters(spp)
        assert it == jwf.persist_plain_iters(spp)
        assert wf.persist_sort_every(it) == jwf.persist_sort_every(it)
        for per in (0, 7, 64):
            c = cfg.replace(spp_per_pass=per)
            jc = jcfg.replace(spp_per_pass=per)
            assert (render.effective_spp_per_pass(c, "wavefront", spp,
                                                  width * h)
                    == jrender.effective_spp_per_pass(
                        jc, "wavefront", spp, width * h))


def test_flagship_takes_the_sorted_route():
    scene, cfg, _ = models.book1_random_spheres()
    assert wf.sorted_persist_route(scene, 1200, 675)
    assert wf.slot_lane_count(1200, 675) == 856_064
    assert wf.persist_plain_iters(1024) == 128
    assert wf.persist_sort_every(128) == 1
    three, _, _ = models.book1_three_spheres()
    assert not wf.sorted_persist_route(three, 1200, 675)


ROWS, LANES = 8, 128
R = ROWS * LANES


def _synthetic(seed, n_finished, n_idle, spp, clustered=False):
    rng = np.random.default_rng(seed)
    slot = rng.permutation(R).astype(np.int32)
    mid = np.ones(R, np.float32)
    mid[: n_finished + n_idle] = 0.0
    done = rng.integers(0, spp, R).astype(np.float32)
    done[:n_finished] = float(spp)
    if clustered:
        in_b = rng.permutation(R) < R // 2
        pos = np.where(in_b, rng.uniform(100.0, 101.0, (3, R)),
                       rng.uniform(0.0, 1.0, (3, R))).astype(np.float32)
    else:
        pos = rng.uniform(-40, 40, (3, R)).astype(np.float32)
    d = rng.normal(size=(3, R)).astype(np.float32)
    state = np.zeros((20, R), np.float32)
    state[19], state[15] = mid, done
    state[1:4], state[4:7] = pos, d
    return state, slot


@pytest.mark.parametrize("seed,n_finished,n_idle,clustered", [
    (0, 128, 128, False), (1, 0, 0, False), (2, 512, 0, True),
    (3, 0, R, False), (4, R, 0, False), (5, 300, 200, True)])
def test_sort_perm_equal_jax(seed, n_finished, n_idle, clustered):
    spp = 8
    state, slot = _synthetic(seed, n_finished, n_idle, spp, clustered)
    st21 = np.concatenate([state, slot[None].astype(np.float32)]).reshape(
        21, ROWS, LANES)
    ref = np.asarray(jwf._persist_sort_perm(jnp.asarray(st21), spp, R))
    got = wf._persist_sort_perm(torch.from_numpy(state),
                                torch.from_numpy(slot), spp)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_morton8_equal_jax():
    q = np.arange(1024, dtype=np.int32)
    np.testing.assert_array_equal(
        wf._morton8(torch.from_numpy(q)).numpy(),
        np.asarray(jwf._morton8(jnp.asarray(q))))


@pytest.mark.parametrize("backend", ["wavefront", "megakernel", "xla"])
def test_effective_spp_per_pass_takes_the_jax_argument_order(backend):
    """Called positionally, (cfg, backend, spp_total, n_pix), as
    rustraytrace_tpu/parallel/megakernel.py:184 calls the JAX function."""
    for w, spp, per in ((400, 100, 0), (1200, 1024, 0), (3840, 1000, 0),
                        (16, 100000, 0), (400, 100, 4), (3840, 1000, 8)):
        over = dict(image_width=w, spp_per_pass=per)
        _, cfg, _ = models.book1_three_spheres(over)
        _, jcfg, _ = jmodels.book1_three_spheres(over)
        n = w * cfg.image_height
        assert (render.effective_spp_per_pass(cfg, backend, spp, n)
                == jrender.effective_spp_per_pass(jcfg, backend, spp, n))


def test_render_pass_defaults_to_auto_where_jax_defaults_to_xla():
    """The port's render_pass routes by itself ("auto": the kernels on a
    card, their plain twins on the CPU); the JAX package's defaults to its
    reference route "xla", which the port takes when asked by name."""
    import inspect

    assert inspect.signature(render.render_pass).parameters[
        "backend"].default == "auto"
    assert inspect.signature(jrender.render_pass).parameters[
        "backend"].default == "xla"
    scene, _, _ = models.book1_random_spheres()
    assert render.resolve_backend(scene, "path", device="cpu") == "plain"
    assert render.resolve_backend(scene, "path", "xla", "cpu") == "reference"
