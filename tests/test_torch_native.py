"""The port's ``native.available`` and ``native.finalize_ppm_p3`` against
the JAX package's (``tests/test_native.py:92-105``) and the port's own
``render.finalize_image`` + ``native.ppm_p3_from_u8``."""

import numpy as np
import pytest

from rustraytrace_tpu import native as jnative
from rustraytrace_tpu_torch import native, render


def test_available_never_raises(monkeypatch):
    assert native.available()

    def broken():
        raise OSError("no library")

    monkeypatch.setattr(native, "load", broken)
    assert native.available() is False


@pytest.mark.parametrize("spp", [1, 4, 37])
def test_finalize_ppm_p3_equals_jax_and_the_python_path(spp):
    rng = np.random.default_rng(spp)
    accum = rng.uniform(-0.5, 4.0 * spp, (9, 11, 3)).astype(np.float32)
    accum[0, 0, 0] = np.inf  # non-finite guard (render_io.rs:16-18)
    accum[0, 1, 1] = np.nan
    got = native.finalize_ppm_p3(accum, spp)
    assert got.startswith(b"P3\n11 9\n255\n")
    assert got == native.ppm_p3_from_u8(render.finalize_image(accum, spp))
    if jnative.available():
        assert got == jnative.finalize_ppm_p3(accum, spp)
