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
  (``dense_hit_kernel``, ``wgmma`` TF32: 3xTF32 for
  ``precision="highest"``, one pass for ``"default"``), the sphere axis
  cut into ``split`` contiguous ranges (``dense_ranges``), each its own
  first strict minimum, merged by the least (t, index).
  ``dense_hit_plain`` computes the products with float32 ``torch.matmul``
  (TF32 off; for ``"default"`` the operands rounded to TF32 first) and
  the same epilogue (``dense_keys``: every pair's key), then the first
  index of the least key.

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
DENSE_SPLITS = (1, 2, 4, 8, 16, 32, 64)  # sphere ranges of the dense one
DENSE_N = 32  # spheres a product of the dense kernel
DENSE_ALIGN = 16  # a range starts at a multiple of 16 spheres
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


def dense_ranges(ns: int, split: int) -> list:
    """The ``split`` contiguous sphere ranges [lo, hi) of the dense kernel
    (csrc/dense_hit.cu rtt_dense_hit): ceil(NS / split) rounded up to a
    multiple of ``DENSE_ALIGN``; the last ones may be short or empty."""
    per = -(-ns // split)
    part = -(-per // DENSE_ALIGN) * DENSE_ALIGN
    return [(min(ns, p * part), min(ns, p * part + part))
            for p in range(split)]


def default_split(n_rays: int, ns: int, wave: int) -> int:
    """The dense kernel's split for ``n_rays`` rays: the least power of two
    whose grid covers ``wave`` rays (one resident wave of the card,
    ``_cuda.dense_wave``), at most ``NS / DENSE_N`` ranges (a range of at
    least one whole product) and at most ``DENSE_SPLITS[-1]``."""
    cap = max(1, min(DENSE_SPLITS[-1], ns // DENSE_N))
    split = 1
    while split < cap and n_rays * split < wave:
        split *= 2
    return split


class _NoTF32:
    """float32 matmuls in full float32 on a card, whatever the caller set."""

    def __enter__(self):
        self.allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.allow


def _dense_ct(dtab, precision: str):
    ct = dtab[0:4].t()  # [NS, 4]
    return round_tf32(ct) if precision == "default" else ct


def _dense_keys(ct, x, y, z, ddx, ddy, ddz, precision: str):
    """(key, disc), each [NS, n]: every pair's root where the take holds
    (else BIG) and its discriminant, for the rays given."""
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
    return torch.where(take, root, BIG), disc


def dense_keys(dtab, ox, oy, oz, dx, dy, dz, precision: str = "highest"):
    """(key, disc) of every (sphere, ray) pair, [NS, n] with the rays
    flattened: ``dense_hit_plain``'s arithmetic before its minimum."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}; have {PRECISIONS}")
    _, n = _check_rays((ox, oy, oz, dx, dy, dz), dtab, 8)
    with _NoTF32():
        return _dense_keys(_dense_ct(dtab, precision),
                           *(p.reshape(n) for p in (ox, oy, oz, dx, dy, dz)),
                           precision)


def dense_hit_plain(dtab, ox, oy, oz, dx, dy, dz, iters: int = 1,
                    precision: str = "highest"):
    """Twin of ``dense_hit_kernel``: the products as float32
    ``torch.matmul`` with TF32 off (one scan; see the module note on
    ``iters``), then the first index of the least key over the whole
    table.  Rows 4-7 of the dense table are its zero padding and add
    nothing."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}; have {PRECISIONS}")
    shape, n = _check_rays((ox, oy, oz, dx, dy, dz), dtab, 8)
    ct = _dense_ct(dtab, precision)
    bt = torch.empty(n, dtype=torch.float32, device=ox.device)
    bi = torch.empty(n, dtype=torch.int32, device=ox.device)
    planes = [p.reshape(n) for p in (ox, oy, oz, dx, dy, dz)]
    with _NoTF32():
        for lo in range(0, n, _RAY_CHUNK):
            key, _ = _dense_keys(ct, *(p[lo:lo + _RAY_CHUNK] for p in planes),
                                 precision)
            best, idx = torch.min(key, dim=0)
            bt[lo:lo + _RAY_CHUNK] = best
            bi[lo:lo + _RAY_CHUNK] = torch.where(best < BIG, idx, -1).to(
                torch.int32)
    return bt.reshape(shape), bi.reshape(shape)


def _launch(name: str, tab, planes, iters: int, flags, parts: int = 1):
    """Launch ``name``: (t, idx) of the rays' shape, or [parts, n] for
    the dense kernel's ``parts`` sphere ranges."""
    shape, n = planes[0].shape, planes[0].numel()
    _cuda.require(tab, "table", torch.float32, (None, None))
    for label, p in zip(("ox", "oy", "oz", "dx", "dy", "dz"), planes):
        _cuda.require(p, label, torch.float32, tuple(shape))
    if iters < 1:
        raise ValueError(f"iters {iters} < 1")
    out = shape if parts == 1 else (parts, n)
    bt = torch.empty(out, dtype=torch.float32, device=tab.device)
    bi = torch.empty(out, dtype=torch.int32, device=tab.device)
    _cuda.launch(name, tab.data_ptr(), tab.shape[1],
                 *(p.data_ptr() for p in planes), int(iters), *flags,
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
    return _launch("scalar_hit", tab, planes, iters, (int(split),))


def dense_hit(dtab, ox, oy, oz, dx, dy, dz, iters: int = 1,
              precision: str = "highest", split: int | None = None):
    """Closest sphere of each ray over the dense table ``dtab`` [8, NS]
    (NS a multiple of 16), ``iters`` scans: (t, idx) of the rays' shape.
    CUDA tensors launch ``dense_hit_kernel`` (tensor-core products) over
    ``split`` sphere ranges (one of ``DENSE_SPLITS``; by default
    ``default_split``, the least that fills the card), then, above one,
    ``dense_merge_kernel``, which merges the ranges; CPU tensors run
    ``dense_hit_plain``.  The result does not depend on ``split``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}; have {PRECISIONS}")
    planes = (ox, oy, oz, dx, dy, dz)
    _, n = _check_rays(planes, dtab, 8)
    ns = dtab.shape[1]
    if ns % DENSE_ALIGN:
        raise ValueError(f"NS {ns} is not a multiple of {DENSE_ALIGN}")
    if split is not None and split not in DENSE_SPLITS:
        raise ValueError(f"split {split}; have {DENSE_SPLITS}")
    if ox.device.type == "cpu":
        return dense_hit_plain(dtab, *planes, iters=iters,
                               precision=precision)
    highest = precision == "highest"
    if split is None:
        split = default_split(n, ns, _cuda.dense_wave(highest))
    if dtab.data_ptr() % 16:  # the bulk copies' alignment
        raise ValueError("table: data must start at a multiple of 16 bytes")
    pt, pi = _launch("dense_hit", dtab, planes, iters,
                     (int(highest), int(split)), split)
    if split == 1:
        return pt, pi
    # each range's (t, index), merged by a second kernel
    bt = torch.empty(ox.shape, dtype=torch.float32, device=dtab.device)
    bi = torch.empty(ox.shape, dtype=torch.int32, device=dtab.device)
    _cuda.launch("dense_merge", pt.data_ptr(), pi.data_ptr(), int(split),
                 bt.data_ptr(), bi.data_ptr(), n)
    return bt, bi
