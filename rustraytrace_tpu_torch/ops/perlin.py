"""Perlin noise with lattice gathers (counterpart:
``rustraytrace_tpu/ops/perlin.py``): the 256-entry random unit-vector
lattice, three xor-combined permutations, Hermite-smoothed trilinear
interpolation (the_next_week/perlin.rs:25-98) and turbulence
(perlin.rs:50-62)."""

from __future__ import annotations

import torch


def noise(p: torch.Tensor, randvec: torch.Tensor,
          perm: torch.Tensor) -> torch.Tensor:
    """Perlin noise of points p [R, 3] -> [R], in [-1, 1]."""
    fl = torch.floor(p)
    uvw = p - fl
    ijk = fl.to(torch.int64)
    s = uvw * uvw * (3.0 - 2.0 * uvw)  # perlin.rs:80-82
    perm = perm.to(torch.int64)
    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                idx = (perm[0][(ijk[..., 0] + di) & 255]
                       ^ perm[1][(ijk[..., 1] + dj) & 255]
                       ^ perm[2][(ijk[..., 2] + dk) & 255])
                c = randvec[idx]
                wx = di * s[..., 0] + (1 - di) * (1.0 - s[..., 0])
                wy = dj * s[..., 1] + (1 - dj) * (1.0 - s[..., 1])
                wz = dk * s[..., 2] + (1 - dk) * (1.0 - s[..., 2])
                dot = (c[..., 0] * (uvw[..., 0] - di)
                       + c[..., 1] * (uvw[..., 1] - dj)
                       + c[..., 2] * (uvw[..., 2] - dk))
                accum = accum + wx * wy * wz * dot
    return accum


def turb(p: torch.Tensor, randvec: torch.Tensor, perm: torch.Tensor,
         depth: int = 7) -> torch.Tensor:
    """|sum_i 0.5^i noise(2^i p)| (perlin.rs:50-62)."""
    accum = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * noise(p, randvec, perm)
        weight *= 0.5
        p = p * 2.0
    return torch.abs(accum)
