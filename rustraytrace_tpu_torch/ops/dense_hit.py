"""S1: the dense closest-sphere spike's two kernels (counterpart:
``scripts/spike_dense_mxu.py`` ``make_dense`` and ``make_scalar``).

Both find, for every ray, the first index of the smallest valid root over
a sphere table (``(BIG, -1)`` when there is none), the spike's rule: a
block minimum and first-index argmin, then a strict ``<`` across blocks,
which is the first index of the global minimum.  The spike repeats the
whole scan ``iters`` times with the best carried across; the repeats
change nothing (a strict ``<`` keeps the first winner), so the plain twins
scan once and the kernels repeat as the spike does, for timing.

* ``scalar_hit``: the [4, NS] table (cx, cy, cz, r^2) and the half-b
  quadric with ``oc`` subtracted first (``csrc/dense_hit.cu``
  ``scalar_hit_kernel``), ``split`` lanes a ray, each scanning a strided
  share of the table, then a lexicographic (t, index) minimum over them;
  ``scalar_hit_plain`` is the same arithmetic over chunks of spheres,
  bitwise equal on the card for every split.
* ``dense_hit``: the [8, NS] dense table (cx, cy, cz, (C^2 - r^2) / 2,
  then four zero rows) and the expanded quadric, whose two K=4 products
  ``C . [d; 0]`` and ``C . [o; -1]`` run on the tensor cores
  (``dense_hit_kernel``, ``mma.sync`` TF32: 3xTF32 for
  ``precision="highest"``, one pass for ``"default"``).
  ``dense_hit_plain`` computes the products with float32 ``torch.matmul``
  (TF32 off; for ``"default"`` the operands rounded to TF32 first) and
  the same epilogue.

Ray planes may have any shape whose size is a multiple of 128 (the spike
uses [32, 128]); outputs have that shape.  CUDA tensors launch the
kernels, CPU tensors run the twins.
"""

from __future__ import annotations

import torch

from . import _cuda

T_MIN = 1e-3
T_MAX = 1e30
BIG = 3e38
PRECISIONS = ("highest", "default")
SPLITS = (1, 2, 4, 8, 16, 32)  # lanes a ray of the scalar kernel
_SPHERE_CHUNK = 64
_RAY_CHUNK = 65536


def _check_rays(planes, tab, rows: int):
    shape = planes[0].shape
    n = planes[0].numel()
    if n % 128:
        raise ValueError(f"ray count {n} is not a multiple of 128")
    for name, p in zip(("ox", "oy", "oz", "dx", "dy", "dz"), planes):
        if p.shape != shape:
            raise ValueError(f"{name}: shape {tuple(p.shape)} != "
                             f"{tuple(shape)}")
    if tab.dim() != 2 or tab.shape[0] != rows:
        raise ValueError(f"table: expected [{rows}, NS], got "
                         f"{tuple(tab.shape)}")
    return shape, n


def scalar_hit_plain(tab, ox, oy, oz, dx, dy, dz, iters: int = 1):
    """Twin of ``scalar_hit_kernel`` (one scan; see the module note on
    ``iters``)."""
    shape, n = _check_rays((ox, oy, oz, dx, dy, dz), tab, 4)
    x, y, z = (p.reshape(n, 1) for p in (ox, oy, oz))
    ddx, ddy, ddz = (p.reshape(n, 1) for p in (dx, dy, dz))
    a = ddx * ddx + ddy * ddy + ddz * ddz
    inv_a = 1.0 / a
    bt = torch.full((n,), BIG, dtype=torch.float32, device=ox.device)
    bi = torch.full((n,), -1, dtype=torch.int64, device=ox.device)
    for s0 in range(0, tab.shape[1], _SPHERE_CHUNK):
        cx, cy, cz, r2 = (tab[k, None, s0:s0 + _SPHERE_CHUNK]
                          for k in range(4))
        ocx = cx - x
        ocy = cy - y
        ocz = cz - z
        h = ddx * ocx + ddy * ocy + ddz * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r2
        disc = h * h - a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        tn = (h - sq) * inv_a
        tf = (h + sq) * inv_a
        root = torch.where((tn > T_MIN) & (tn < T_MAX), tn, tf)
        take = (disc > 0.0) & (root > T_MIN) & (root < T_MAX)
        kb, ib = torch.min(torch.where(take, root, BIG), dim=1)
        imp = kb < bt
        bt = torch.where(imp, kb, bt)
        bi = torch.where(imp, ib + s0, bi)
    return bt.reshape(shape), bi.to(torch.int32).reshape(shape)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), nearest with ties away
    from zero: what ``cvt.rna.tf32.f32`` gives."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def dense_hit_plain(dtab, ox, oy, oz, dx, dy, dz, iters: int = 1,
                    precision: str = "highest"):
    """Twin of ``dense_hit_kernel``: the products as float32
    ``torch.matmul`` with TF32 off (one scan; see the module note on
    ``iters``).  Rows 4-7 of the dense table are its zero padding and add
    nothing."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}; have {PRECISIONS}")
    shape, n = _check_rays((ox, oy, oz, dx, dy, dz), dtab, 8)
    ct = dtab[0:4].t()  # [NS, 4]
    if precision == "default":
        ct = round_tf32(ct)
    bt = torch.empty(n, dtype=torch.float32, device=ox.device)
    bi = torch.empty(n, dtype=torch.int32, device=ox.device)
    planes = [p.reshape(n) for p in (ox, oy, oz, dx, dy, dz)]
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for lo in range(0, n, _RAY_CHUNK):
            x, y, z, ddx, ddy, ddz = (p[lo:lo + _RAY_CHUNK] for p in planes)
            D = torch.stack([ddx, ddy, ddz, torch.zeros_like(ddx)])
            O = torch.stack([x, y, z, -torch.ones_like(x)])
            if precision == "default":
                D, O = round_tf32(D), round_tf32(O)
            dC = torch.matmul(ct, D)  # [NS, n]
            m = torch.matmul(ct, O)
            a = ddx * ddx + ddy * ddy + ddz * ddz
            inv_a = 1.0 / a
            do = ddx * x + ddy * y + ddz * z
            o2 = x * x + y * y + z * z
            h = dC - do
            c0 = o2 - 2.0 * m
            disc = h * h - a * c0
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            tn = (h - sq) * inv_a
            tf = (h + sq) * inv_a
            root = torch.where((tn > T_MIN) & (tn < T_MAX), tn, tf)
            take = (disc > 0.0) & (root > T_MIN) & (root < T_MAX)
            best, idx = torch.min(torch.where(take, root, BIG), dim=0)
            bt[lo:lo + _RAY_CHUNK] = best
            bi[lo:lo + _RAY_CHUNK] = torch.where(best < BIG, idx, -1).to(
                torch.int32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    return bt.reshape(shape), bi.reshape(shape)


def _launch(name: str, tab, planes, iters: int, *flag):
    shape, n = planes[0].shape, planes[0].numel()
    _cuda.require(tab, "table", torch.float32, (None, None))
    for label, p in zip(("ox", "oy", "oz", "dx", "dy", "dz"), planes):
        _cuda.require(p, label, torch.float32, tuple(shape))
    if iters < 1:
        raise ValueError(f"iters {iters} < 1")
    bt = torch.empty(shape, dtype=torch.float32, device=tab.device)
    bi = torch.empty(shape, dtype=torch.int32, device=tab.device)
    _cuda.launch(name, tab.data_ptr(), tab.shape[1],
                 *(p.data_ptr() for p in planes), int(iters), *flag,
                 bt.data_ptr(), bi.data_ptr(), n)
    return bt, bi


def scalar_hit(tab, ox, oy, oz, dx, dy, dz, iters: int = 1,
               split: int | None = None):
    """Closest sphere of each ray over ``tab`` [4, NS] (cx, cy, cz, r^2),
    ``iters`` scans: (t, idx) of the rays' shape.  CUDA tensors launch
    ``scalar_hit_kernel`` with ``split`` lanes a ray (one of ``SPLITS``;
    by default the least that fills the card, ``_cuda.scalar_split``);
    CPU tensors run ``scalar_hit_plain``.  The result does not depend on
    ``split``."""
    planes = (ox, oy, oz, dx, dy, dz)
    _, n = _check_rays(planes, tab, 4)
    if split is not None and split not in SPLITS:
        raise ValueError(f"split {split}; have {SPLITS}")
    if ox.device.type == "cpu":
        return scalar_hit_plain(tab, *planes, iters=iters)
    if split is None:
        split = _cuda.scalar_split(n)
    return _launch("scalar_hit", tab, planes, iters, int(split))


def dense_hit(dtab, ox, oy, oz, dx, dy, dz, iters: int = 1,
              precision: str = "highest"):
    """Closest sphere of each ray over the dense table ``dtab`` [8, NS]
    (NS a multiple of 16), ``iters`` scans: (t, idx) of the rays' shape.
    CUDA tensors launch ``dense_hit_kernel`` (tensor-core products);
    CPU tensors run ``dense_hit_plain``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}; have {PRECISIONS}")
    planes = (ox, oy, oz, dx, dy, dz)
    _check_rays(planes, dtab, 8)
    if dtab.shape[1] % 16:
        raise ValueError(f"NS {dtab.shape[1]} is not a multiple of 16")
    if ox.device.type == "cpu":
        return dense_hit_plain(dtab, *planes, iters=iters,
                               precision=precision)
    return _launch("dense_hit", dtab, planes, iters,
                   int(precision == "highest"))
