"""Build and binding layer for the port's CUDA kernels (no JAX
counterpart: Pallas kernels are compiled by ``pallas_call`` itself).

At first use, every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
for ``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface under ``build/rtt_torch/`` (named by
a hash of the sources and flags, so an edited source rebuilds), loaded with
``ctypes``.  Pointer and stream arguments are ``c_void_p``; the path
tracer's kernels take a pointer to a ``PathParams`` struct, whose layout is
checked against the C ``sizeof`` at load.  Every C entry point returns
``cudaGetLastError()`` after its launch, and ``launch`` raises when that is
not ``cudaSuccess``.  A failed build raises too: nothing falls back to a
plain version.

Each kernel keeps a plain integer count of its launches, raised by
``launch`` after a successful launch and nowhere else, so a run can show
that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "rtt_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC",
              # no contracted multiply-adds: the kernels round exactly as
              # their plain PyTorch twins do (see csrc/rtt_common.cuh)
              "-fmad=false", "--ptxas-options=-v")

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32


class PathParams(ctypes.Structure):
    """Mirror of ``rtt::Params`` (csrc/path.cuh): the tables and uniforms
    that the path kernels (persist, megakernel, mono, segment) read."""

    _fields_ = [
        ("geom", _P), ("gvel", _P), ("tab", _P), ("n_rows", _I),
        ("clb", _P), ("cls", _P), ("n_clusters", _I),
        ("sclb", _P), ("scls", _P), ("n_sclusters", _I),
        ("n_ssc_static", _I), ("unroll", _I),
        ("qtab", _P), ("n_quads", _I), ("n_qclusters", _I),
        ("ltab", _P), ("n_lights", _I),
        ("btab", _P), ("batt", _P), ("bclb", _P), ("bcls", _P),
        ("n_boxes", _I), ("n_bclusters", _I), ("b_unroll", _I),
        ("mtab", _P), ("n_media", _I), ("perm", _P), ("randvec", _P),
        ("texels", _P), ("img_meta", _P), ("n_images", _I),
        ("cam", _P), ("bg", _P),
        ("sky_bg", _I), ("defocus", _I), ("width", _I), ("height", _I),
        ("spp", _I), ("max_depth", _I), ("stratified", _I),
        ("sqrt_spp", _I), ("moving", _I), ("has_checker", _I),
        ("has_noise", _I), ("has_image", _I), ("k0", _U), ("k1", _U),
        ("sample_offset", _I), ("work", _P), ("warp_t", _P),
    ]


@dataclasses.dataclass
class Kernel:
    symbol: str
    argtypes: tuple
    launches: int = 0


KERNELS = {
    "sphere_hit": Kernel("rtt_sphere_hit", (
        _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _P)),
    # state, slot, R, &PathParams, persist_iters, mis, book2, tile_bounds,
    # tile_lanes, stream
    "persist": Kernel("rtt_persist_step",
                      (_P, _P, _I, _P, _I, _I, _I, _P, _I, _P)),
    # out, R, &PathParams, mis, book2, coop, queue, grid, stream
    "megakernel": Kernel("rtt_respawn_pass",
                         (_P, _I, _P, _I, _I, _I, _P, _I, _P)),
    # out, R, &PathParams, mis, book2, coop, queue, grid, stream
    "mono": Kernel("rtt_mono_pass", (_P, _I, _P, _I, _I, _I, _P, _I, _P)),
    # state, sums, done, sample, R, &PathParams, book2, coop, alive, stream
    "segment": Kernel("rtt_segment_step",
                      (_P, _P, _P, _P, _I, _P, _I, _I, _P, _P)),
    # dtab, NS, ox, oy, oz, dx, dy, dz, iters, highest, split, bt, bi
    # ([split, R]: each range's result), R, stream
    "dense_hit": Kernel("rtt_dense_hit", (
        _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _P)),
    # pt, pi [split, R], split, bt, bi, R, stream
    "dense_merge": Kernel("rtt_dense_merge", (_P, _P, _I, _P, _P, _I, _P)),
    # tab, NS, ox, oy, oz, dx, dy, dz, iters, split, bt, bi, R, stream
    "scalar_hit": Kernel("rtt_scalar_hit", (
        _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P)),
}

# the megakernels' launch-shape queries: (mis, book2, count, coop, &block)
# -> blocks an SM holds (the occupancy query), negative on a CUDA error
_SHAPES = {"megakernel": "rtt_respawn_shape", "mono": "rtt_mono_shape"}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def device(dev) -> torch.device:
    """``dev`` as a torch device: CUDA (raises without a card) or CPU.
    Nothing moves to the CPU on its own."""
    dev = torch.device(dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"device type {dev.type!r}")
    return dev


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _build() -> str:
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    deps = sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in deps:
        with open(path, "rb") as f:
            h.update(path.encode() + b"\0" + f.read())
    out = os.path.join(BUILD_DIR, f"librtt_torch_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        log = "(cached)"
        if os.path.exists(f"{out}.log"):  # the ptxas report of its build
            with open(f"{out}.log") as f:
                log = f.read()
        build_info.update(path=out, seconds=0.0, log=log)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in sources]
    t0 = time.perf_counter()
    # one nvcc per source, all at once: the build is as long as the
    # slowest file, not the sum
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    try:
        for cmd, proc in zip(cmds, procs):
            log, _ = proc.communicate(timeout=900)
            logs.append(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{log}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = f"{out}.{os.getpid()}.tmp"
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
    res = subprocess.run(link, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                           f"{' '.join(link)}\n{res.stdout}\n{res.stderr}")
    for obj in objs:
        os.remove(obj)
    log = "".join(logs) + res.stdout + res.stderr
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", f"{out}.log")
    os.replace(tmp, out)
    build_info.update(path=out, seconds=time.perf_counter() - t0, log=log)
    return out


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            for k in KERNELS.values():
                fn = getattr(lib, k.symbol)
                fn.restype = ctypes.c_int
                fn.argtypes = list(k.argtypes)
            lib.rtt_error_string.restype = ctypes.c_char_p
            lib.rtt_error_string.argtypes = [ctypes.c_int]
            lib.rtt_params_size.restype = ctypes.c_int
            lib.rtt_params_size.argtypes = []
            lib.rtt_scalar_split.restype = ctypes.c_int
            lib.rtt_scalar_split.argtypes = [_I]
            lib.rtt_dense_wave.restype = ctypes.c_int
            lib.rtt_dense_wave.argtypes = [_I]
            for fn in _SHAPES.values():
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = [_I, _I, _I, _I,
                                             ctypes.POINTER(_I)]
            if lib.rtt_params_size() != ctypes.sizeof(PathParams):
                raise RuntimeError(
                    f"PathParams is {ctypes.sizeof(PathParams)} bytes, the "
                    f"C struct {lib.rtt_params_size()}: layouts differ")
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current stream; raise on a launch
    error and count the launch otherwise."""
    lib = library()
    k = KERNELS[name]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, k.symbol)(*args, stream)
    if err != 0:
        msg = lib.rtt_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: "
                           f"error {err} ({msg})")
    k.launches += 1


def scalar_split(n_rays: int) -> int:
    """Lanes a ray that the scalar closest-hit kernel takes by default for
    ``n_rays`` rays on the current device (csrc/dense_hit.cu
    rtt_scalar_split); raises on a CUDA error."""
    k = library().rtt_scalar_split(int(n_rays))
    if k <= 0:
        raise RuntimeError(f"rtt_scalar_split failed: error {-k}")
    return k


_dense_waves: dict = {}


def dense_wave(highest: bool) -> int:
    """Rays of one resident wave of the dense closest-hit kernel on the
    current device (csrc/dense_hit.cu rtt_dense_wave: SMs x blocks an SM
    holds x rays a block), queried once per device and precision; raises
    on a CUDA error."""
    key = (torch.cuda.current_device(), bool(highest))
    if key not in _dense_waves:
        wave = library().rtt_dense_wave(int(highest))
        if wave <= 0:
            raise RuntimeError(f"rtt_dense_wave failed: error {-wave}")
        _dense_waves[key] = wave
    return _dense_waves[key]


def megakernel_shape(name: str, mis: bool, book2: bool, count: bool,
                     coop: bool) -> tuple:
    """(threads a block, blocks an SM holds) of the instance <mis, book2,
    count, coop> of megakernel ``name`` on the current device; raises on a
    CUDA error."""
    block = _I(0)
    per_sm = getattr(library(), _SHAPES[name])(
        int(mis), int(book2), int(count), int(coop), ctypes.byref(block))
    if per_sm <= 0:
        raise RuntimeError(f"occupancy query of {name!r} failed: error "
                           f"{-per_sm}")
    return block.value, per_sm


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def require(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``, where a dimension of None matches anything)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and (len(shape) != t.dim() or any(
            s is not None and s != n for s, n in zip(shape, t.shape))):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
