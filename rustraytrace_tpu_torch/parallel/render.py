"""Sharded rendering over a ('px', 'spp') mesh of ``torch.distributed``
ranks (counterpart: ``rustraytrace_tpu/parallel/render.py``): the
reference route's sharded pass and contraction, the sharded router
(``resolve_sharded_backend``) and the image loop (``render_image_sharded``),
which hands the kernel routes to ``parallel/megakernel.py``.

Pixels are blocked over ``px`` (rank i of the axis owns a contiguous run
of flat pixel indices) and samples over ``spp``; the JAX package's
``psum`` is an ``all_reduce``.  The port's draws are Philox keyed by
(pixel, absolute sample, bounce, stream) (``render.trace_rays``), so an
N-rank render with spp unsharded is bitwise equal to the 1-rank render,
and equal up to summation order with spp sharded: the property the JAX
package gets from ``fold_in``.

A unit of work is one chunk of a rank's pixels times all of the rank's
samples, traced as one batch, sample-major: the reference route's batch
(``render._render_pass_reference``), which is what keeps the 1-rank
render bitwise equal to it.  ``remat=True`` checkpoints each unit
(``torch.utils.checkpoint``), so a backward holds one unit's graph at a
time, as the JAX package's ``jax.checkpoint`` does per sample; the
``chunk`` argument bounds it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from ..config import CameraParams, RenderConfig, derive_camera
from ..ops._cuda import device as _device
from ..render import (_DEFAULT_SPP_PER_PASS, _scene_on, render_passes,
                      splat_terms, trace_rays, trace_rays_diff)
from ..scene import Scene
from .mesh import Mesh, make_mesh

SHARDED_BACKENDS = ("reference", "xla")  # the reference route only


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def spp_traced(spp: int, mesh: Mesh) -> int:
    """Samples per pixel ``render_pass_sharded`` traces: ``spp`` rounded up
    to a multiple of the mesh's spp axis."""
    n_spp = mesh.shape["spp"]
    return -(-spp // n_spp) * n_spp


class _SumOverMesh(torch.autograd.Function):
    """Sum over the mesh's ranks.  Every rank computes the same loss of the
    summed value, so the cotangent of its own part is the cotangent of the
    sum: the backward passes it through."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """A scene tensor that every rank holds: identity forward, and the
    backward sums the ranks' cotangents (the JAX package's psum of a
    replicated input's cotangent), so every rank gets the whole
    gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _replicated(scene: Scene, group) -> Scene:
    """The scene with every tensor that requires grad wrapped in
    ``_Replicated``."""
    import dataclasses

    return dataclasses.replace(scene, **{
        f.name: _Replicated.apply(getattr(scene, f.name), group)
        for f in dataclasses.fields(scene)
        if f.name != "features" and getattr(scene, f.name).requires_grad})


def _layout(mesh: Mesh, width: int, height: int, spp: int, chunk: int,
            sample_offset: int, dev):
    """This rank's units: (pix, px, py, valid, s_idx) of each chunk, its
    samples (absolute indices ``sample_offset + spp_idx * spp_local +
    [0, spp_local)``) repeated over the chunk, sample-major (the reference
    route's batch); plus (n_pix, n_local, block start, spp_local)."""
    n_px, n_spp = mesh.shape["px"], mesh.shape["spp"]
    n_pix = width * height
    per_shard = -(-n_pix // n_px)
    chunk_eff = min(chunk, _ceil_to(per_shard, 256))
    n_local = _ceil_to(per_shard, chunk_eff)
    spp_local = -(-spp // n_spp)
    lo = mesh.px_idx * n_local
    s0 = sample_offset + mesh.spp_idx * spp_local
    samples = torch.arange(s0, s0 + spp_local, dtype=torch.int64, device=dev)
    s_rep = samples.repeat_interleave(chunk_eff)
    units = []
    for start in range(lo, lo + n_local, chunk_eff):
        pix = torch.arange(start, start + chunk_eff, dtype=torch.int64,
                           device=dev)
        px = (pix % width).to(torch.float32)
        py = torch.clamp(pix // width, max=height - 1).to(torch.float32)
        valid = (pix < n_pix).to(torch.float32)
        units.append(tuple(x.repeat(spp_local) for x in (pix, px, py, valid))
                     + (s_rep,))
    return units, n_pix, n_local, lo, spp_local


def _check(backend: str, mesh: Optional[Mesh]) -> Mesh:
    if backend not in SHARDED_BACKENDS:
        raise ValueError(f"sharded rendering runs the reference route "
                         f"(backend 'reference' or 'xla'); got {backend!r}")
    return make_mesh() if mesh is None else mesh


def _run(fn, remat: bool, *args):
    """``fn(*args)``, checkpointed when asked and a graph is being built."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def render_pass_sharded(scene: Scene, cam: CameraParams, seed: int, *,
                        width: int, height: int, spp: int, max_depth: int,
                        mesh: Optional[Mesh] = None, integrator: str = "path",
                        chunk: int = 65536, stratified: bool = False,
                        sqrt_spp: int = 0, sample_offset: int = 0,
                        remat: bool = True, backend: str = "reference",
                        warp_primary=False, device="cuda") -> torch.Tensor:
    """Trace ``spp_traced(spp, mesh)`` samples per pixel across the mesh,
    absolute sample indices ``sample_offset + [0, spp_traced)``, stratified
    over a ``sqrt_spp`` grid when asked (parallel/render.py:49-168 there);
    returns the radiance SUM [H, W, 3], the same on every rank.  ``mesh``
    defaults to ``make_mesh()``.

    ``warp_primary`` selects the differentiable path's estimator: samples
    go through ``render.trace_rays_diff`` and are tent-splatted onto their
    2x2 pixel neighborhoods; True adds the silhouette warp, "tent" is the
    value-identical plain forward.  Differentiable: with a graph being
    built on a mesh over a process group, every rank's backward of the
    same loss gives the whole gradient."""
    mesh = _check(backend, mesh)
    dev = _device(device)
    scene = _scene_on(scene, dev)
    multi = mesh.group is not None
    if multi and torch.is_grad_enabled():
        scene = _replicated(scene, mesh.group)
    units, n_pix, n_local, lo, spp_local = _layout(
        mesh, width, height, spp, chunk, sample_offset, dev)
    kw = dict(max_depth=max_depth, integrator=integrator,
              stratified=stratified, sqrt_spp=sqrt_spp)

    if warp_primary:
        def unit(scene, pix, px, py, valid, s_idx):
            rad, u_w = trace_rays_diff(scene, cam, seed, s_idx, pix, px, py,
                                       warp=warp_primary is True, **kw)
            img = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
            for idx, w in splat_terms(px, py, u_w, valid, width, height):
                img = img.index_add(0, idx, rad * w[:, None])
            return img

        accum = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
        for u in units:
            accum = accum + _run(unit, remat, scene, *u)
    else:
        def unit(scene, pix, px, py, valid, s_idx):
            rad = trace_rays(scene, cam, seed, s_idx, pix, px, py,
                             backend="reference", **kw)
            rad = rad.reshape(spp_local, -1, 3)
            acc = torch.zeros_like(rad[0])
            for s in range(spp_local):  # in sample order, as the route
                acc = acc + rad[s]
            return acc

        parts = [_run(unit, remat, scene, *u) for u in units]
        block = torch.cat(parts) if len(parts) > 1 else parts[0]
        # the whole padded image on every rank (zeros outside its block),
        # so the sum over the mesh is the gather
        accum = torch.zeros((n_local * mesh.px, 3), dtype=torch.float32,
                            device=dev)
        accum = accum.index_copy(
            0, torch.arange(lo, lo + n_local, device=dev), block)[:n_pix]
    if multi:
        accum = _SumOverMesh.apply(accum, mesh.group)
    return accum.reshape(height, width, 3)


def render_contract_sharded(scene: Scene, cam: CameraParams, seed: int,
                            ct: torch.Tensor, *, width: int, height: int,
                            spp: int, max_depth: int,
                            mesh: Optional[Mesh] = None,
                            integrator: str = "path", chunk: int = 65536,
                            stratified: bool = False, sqrt_spp: int = 0,
                            sample_offset: int = 0, remat: bool = True,
                            warp_primary=False, wrt: Optional[dict] = None,
                            device="cuda"):
    """The contraction ``sum(radiance_sum * ct)`` of the sample set
    ``render_pass_sharded`` traces (the same draws, and the same
    ``stratified``, ``sqrt_spp`` and ``sample_offset``), without the
    radiance image: each unit's radiance contracts against ``ct`` at once
    (parallel/render.py:183-299 there).  ``ct`` [H, W, 3] is the cotangent
    of the radiance SUM; ``warp_primary`` is as in ``render_pass_sharded``
    (a truthy value contracts each sample against the tent splat's gather
    sum_4 w_i ct[p_i]).

    With ``wrt`` None, returns the scalar, summed over the mesh and
    differentiable as ``render_pass_sharded`` is: the JAX package's form,
    which the tests hold the per-unit backward against.  With ``wrt`` (a dict of
    the tensors ``scene`` was built from that require grad), returns
    (value, {name: d value / d tensor}): one backward per unit right after
    its forward, so memory stays at one unit's graph (what the JAX
    package's remat buys), and the gradient summed over the mesh."""
    mesh = _check("reference", mesh)
    dev = _device(device)
    scene = _scene_on(scene, dev)
    multi = mesh.group is not None
    if multi and wrt is None and torch.is_grad_enabled():
        scene = _replicated(scene, mesh.group)
    units, n_pix, n_local, _, _ = _layout(
        mesh, width, height, spp, chunk, sample_offset, dev)
    # zeros past the image: the padding pixels of the last block
    ct_flat = torch.zeros((n_local * mesh.px, 3), dtype=torch.float32,
                          device=dev)
    ct_flat[:n_pix] = ct.reshape(n_pix, 3).to(dev, torch.float32)
    kw = dict(max_depth=max_depth, integrator=integrator,
              stratified=stratified, sqrt_spp=sqrt_spp)

    def unit(scene, pix, px, py, valid, s_idx):
        if warp_primary:
            rad, u_w = trace_rays_diff(scene, cam, seed, s_idx, pix, px, py,
                                       warp=warp_primary is True, **kw)
            ct_eff = sum(w[:, None] * ct_flat[idx] for idx, w in
                         splat_terms(px, py, u_w, valid, width, height))
        else:
            rad = trace_rays(scene, cam, seed, s_idx, pix, px, py,
                             backend="reference", **kw)
            ct_eff = ct_flat[pix]
        return torch.sum(rad * ct_eff)

    if wrt is None:
        total = sum(_run(unit, remat, scene, *u) for u in units)
        if multi:
            total = _SumOverMesh.apply(total, mesh.group)
        return total

    names = list(wrt)
    leaves = [wrt[n] for n in names]
    total = torch.zeros((), dtype=torch.float32, device=dev)
    grads = [torch.zeros_like(t) for t in leaves]
    for u in units:
        with torch.enable_grad():
            s = unit(scene, *u)
        gs = torch.autograd.grad(s, leaves, allow_unused=True)
        total = total + s.detach()
        grads = [g if gu is None else g + gu for g, gu in zip(grads, gs)]
    if multi:
        flat = torch.cat([total.reshape(1)] + [g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group)
        total = flat[0]
        grads, at = [], 1
        for t in leaves:
            grads.append(flat[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
    return total, dict(zip(names, grads))


def resolve_sharded_backend(scene: Scene, integrator: str, mesh: Mesh,
                            backend: str = "auto", _mk_eligible=None,
                            _wf_eligible=None, device="cuda") -> str:
    """Route a sharded render to its per-pass loop: the JAX package's
    decision table (parallel/render.py:302-346 there).  ``"auto"``:
    megakernel-eligible -> ``"wavefront"`` for ``path`` and
    ``"megakernel"`` for ``mis``; else wavefront-eligible ->
    ``"wavefront"``; else ``"xla"`` (the reference route).  The kernel
    backends take ``path`` and ``mis``; anything else raises
    ``ValueError``.  The port's names: ``"reference"`` is ``"xla"``, and
    ``"plain"`` runs the kernel routes' loop on their plain twins, as
    ``render.render_pass`` takes it.

    ``_mk_eligible`` / ``_wf_eligible`` (``(scene, integrator, mesh) ->
    bool``) replace the eligibility predicates of ``parallel/megakernel``
    so that the table is testable without a card; the default ones are
    False off a CUDA ``device`` and raise ``RuntimeError`` for
    ``device="cuda"`` without a card."""
    from .megakernel import (megakernel_shard_eligible,
                             wavefront_shard_eligible)

    mk = _mk_eligible or (lambda s, i, m: megakernel_shard_eligible(
        s, i, m, device=device))
    wf = _wf_eligible or (lambda s, i, m: wavefront_shard_eligible(
        s, i, m, device=device))
    if backend == "reference":
        backend = "xla"
    if backend == "auto":
        if mk(scene, integrator, mesh):
            backend = "wavefront" if integrator == "path" else "megakernel"
        elif wf(scene, integrator, mesh):
            backend = "wavefront"
        else:
            backend = "xla"
    if backend not in ("xla", "megakernel", "wavefront", "plain"):
        raise ValueError(
            f"sharded rendering supports backends 'auto', 'xla' "
            f"('reference'), 'megakernel', 'wavefront', 'plain'; got "
            f"{backend!r}")
    if backend != "xla" and integrator not in ("path", "mis"):
        raise ValueError(
            f"backend={backend!r} supports integrators 'path' and 'mis'; "
            f"use 'xla' for integrator={integrator!r}")
    return backend


def render_image_sharded(scene: Scene, cfg: RenderConfig, *,
                         mesh: Optional[Mesh] = None,
                         integrator: str = "path", chunk: int = 65536,
                         progress=None, accum_state: Optional[dict] = None,
                         backend: str = "auto", on_pass=None, device="cuda"):
    """Full sharded render: ``render.render_passes`` (the host pass loop)
    over the sharded pass, sums added over the mesh, finalize
    (parallel/render.py:349-441 there).  Returns (image_u8 [H, W, 3],
    {"accum": sum [H, W, 3], "spp_done": n}), the same on every rank (the
    sums are added with ``all_reduce``, so no gather is needed); a
    stratified config renders floor(sqrt(spp))^2 samples.  ``on_pass``,
    when given, receives {"accum": a CPU copy of the running sum,
    "spp_done": n} after every pass, as ``render.render_image`` gives it.
    ``mesh`` defaults to ``make_mesh()``.

    The kernel backends run ``parallel.megakernel
    .render_image_sharded_megakernel``.  There is no fallback: a failed
    pass raises, and the last ``on_pass`` state is the point to resume
    from."""
    dev = _device(device)
    mesh = make_mesh() if mesh is None else mesh
    backend = resolve_sharded_backend(scene, integrator, mesh, backend,
                                      device=dev)
    loop = dict(progress=progress, accum_state=accum_state, on_pass=on_pass,
                device=dev)
    if backend != "xla":
        from .megakernel import render_image_sharded_megakernel

        return render_image_sharded_megakernel(
            scene, cfg, mesh=mesh, integrator=integrator, backend=backend,
            **loop)

    cam = derive_camera(cfg, device=dev)
    n_spp = mesh.shape["spp"]

    def one_pass(spp, sample_offset, stratified, sqrt_spp):
        return render_pass_sharded(
            scene, cam, cfg.seed, width=cfg.image_width,
            height=cfg.image_height, spp=spp, max_depth=cfg.max_depth,
            mesh=mesh, integrator=integrator, chunk=chunk,
            stratified=stratified, sqrt_spp=sqrt_spp,
            sample_offset=sample_offset, remat=False, device=dev)

    return render_passes(
        cfg, one_pass,
        _ceil_to(cfg.spp_per_pass or _DEFAULT_SPP_PER_PASS, n_spp),
        unit=n_spp, **loop)
