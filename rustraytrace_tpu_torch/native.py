"""ctypes bindings for the native C++ host components (counterpart:
``rustraytrace_tpu/native.py``).

The port must cluster spheres exactly as the JAX package does, and the C++
SAH builder (``native/src/bvh.cpp``) and the JAX package's NumPy builder do
not produce the same partitions.  So this module has no NumPy fallback: it
loads the committed ``native/librtt_native.so`` read-only, compiles the
sources with ``g++`` into ``build/rtt_torch/`` when that library does not
load, and raises when neither works.  It never runs ``make -C native``,
which would rewrite the committed library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_COMMITTED = os.path.join(_REPO, "native", "librtt_native.so")
_SOURCES = [os.path.join(_REPO, "native", "src", f)
            for f in ("bvh.cpp", "ppm.cpp")]
BUILD_DIR = os.path.join(_REPO, "build", "rtt_torch")
_lock = threading.Lock()
_lib = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    for name in ("rtt_cluster_spheres", "rtt_cluster_aabbs"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [fp, fp, ctypes.c_int, ctypes.c_int, ip, ip, fp, fp]
    lib.rtt_finalize_ppm_p3.restype = ctypes.c_longlong
    lib.rtt_finalize_ppm_p3.argtypes = [fp, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_longlong, ctypes.c_char_p]
    lib.rtt_u8_ppm_p3.restype = ctypes.c_longlong
    lib.rtt_u8_ppm_p3.argtypes = [ctypes.POINTER(ctypes.c_ubyte),
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_char_p]
    return lib


def _build() -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, "librtt_native.so")
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", *_SOURCES,
           "-o", out]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"native build failed: {' '.join(cmd)}\n"
                           f"{res.stderr}")
    return out


def load() -> ctypes.CDLL:
    """The native library; raises when it neither loads nor builds."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(_COMMITTED)
            except OSError:
                lib = ctypes.CDLL(_build())
            _lib = _bind(lib)
        return _lib


def available() -> bool:
    """Whether the library loads or builds; never raises."""
    try:
        load()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def _cptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _cluster(fn_name: str, a: np.ndarray, b: np.ndarray, max_leaf: int
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    n = a.shape[0]
    order = np.empty(n, np.int32)
    start = np.empty(n + 1, np.int32)
    cmin = np.empty((n, 3), np.float32)
    cmax = np.empty((n, 3), np.float32)
    nc = getattr(load(), fn_name)(
        _cptr(a, ctypes.c_float), _cptr(b, ctypes.c_float), n, max_leaf,
        _cptr(order, ctypes.c_int), _cptr(start, ctypes.c_int),
        _cptr(cmin, ctypes.c_float), _cptr(cmax, ctypes.c_float))
    if nc <= 0:
        raise RuntimeError(f"{fn_name} failed (returned {nc}) for n={n}")
    return order, start[: nc + 1].copy(), cmin[:nc].copy(), cmax[:nc].copy()


def build_sphere_clusters(centers: np.ndarray, radii: np.ndarray,
                          max_leaf: int = 16):
    """SAH treelet cut into clusters of <= max_leaf spheres.  Returns
    (order [N], cluster_start [C+1], cluster_min [C,3], cluster_max [C,3])."""
    return _cluster("rtt_cluster_spheres", centers, radii, max_leaf)


def build_aabb_clusters(pmin: np.ndarray, pmax: np.ndarray,
                        max_leaf: int = 16):
    """The same SAH cut over arbitrary primitive AABBs."""
    return _cluster("rtt_cluster_aabbs", pmin, pmax, max_leaf)


def ppm_p3_from_u8(img_u8: np.ndarray) -> bytes:
    """P3 text from an 8-bit image (native/src/ppm.cpp)."""
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w, _ = img_u8.shape
    buf = ctypes.create_string_buffer(64 + h * w * 12)
    n = load().rtt_u8_ppm_p3(_cptr(img_u8, ctypes.c_ubyte), h, w, buf)
    return ctypes.string_at(buf, n)


def finalize_ppm_p3(accum: np.ndarray, spp: int) -> bytes:
    """(radiance sum [H, W, 3], spp) -> P3 text, the finalization fused in
    C++ (native/src/ppm.cpp; render_io.rs:3-31): the bytes of
    ``ppm_p3_from_u8(render.finalize_image(accum, spp))``."""
    accum = np.ascontiguousarray(accum, np.float32)
    h, w, _ = accum.shape
    buf = ctypes.create_string_buffer(64 + h * w * 12)
    n = load().rtt_finalize_ppm_p3(_cptr(accum, ctypes.c_float), h, w, spp,
                                   buf)
    return ctypes.string_at(buf, n)
