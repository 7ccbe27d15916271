"""Checkpoints (counterpart: ``rustraytrace_tpu/utils/checkpoint.py``):
the render accumulation at a pass boundary, and the train state of
``diff.fit``.

The accumulation (RGB sum, samples done) is an ``.npz`` with the JAX
package's keys (``accum``, ``spp_done``, ``seed``, ``fingerprint``); the
fingerprint, a SHA-256 over the config and every Scene tensor (the whole
buffer), makes a resume against other settings raise instead of blending
incompatible renders.  It is computed over the port's tensors, so a port
fingerprint need not equal the JAX package's for the same scene: a
checkpoint is resumed by the package that wrote it.

A train state is a directory holding one ``torch.save`` file: the step,
the parameters, the optimizer's ``state_dict`` and the RNG state (the
seed counter of ``diff.fit``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch

TRAIN_STATE = "train_state.pt"  # the one file of a train-state directory


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fingerprint(cfg, scene) -> str:
    h = hashlib.sha256()
    h.update(json.dumps(
        {k: str(v) for k, v in sorted(vars(cfg).items())}).encode())
    h.update(repr(tuple(scene.features)).encode())
    for f in dataclasses.fields(scene):
        if f.name == "features":
            continue
        a = _np(getattr(scene, f.name))
        h.update(f"{f.name}{a.shape}{a.dtype}".encode())
        # the WHOLE buffer: scenes that differ past the first rows (a later
        # sphere of a large field, a diff.fit-updated parameter) must not
        # fingerprint alike
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def save_checkpoint(path: str, accum_state: dict, cfg, scene) -> None:
    """The accumulation state of ``render.render_image`` at a pass
    boundary ({"accum", "spp_done"}) as a compressed ``.npz``."""
    np.savez_compressed(
        path,
        accum=_np(accum_state["accum"]).astype(np.float32),
        spp_done=np.asarray(accum_state["spp_done"], np.int64),
        seed=np.asarray(cfg.seed, np.int64),
        fingerprint=np.asarray(_fingerprint(cfg, scene)),
    )


def load_checkpoint(path: str, cfg, scene) -> Optional[dict]:
    """Load and validate; raises ValueError on a fingerprint mismatch."""
    with np.load(path, allow_pickle=False) as z:
        fp = str(z["fingerprint"])
        if fp != _fingerprint(cfg, scene):
            raise ValueError(
                f"checkpoint {path} was produced by a different scene/config "
                f"(fingerprint {fp}); refusing to resume")
        return {"accum": z["accum"], "spp_done": int(z["spp_done"])}


def save_train_checkpoint(path: str, *, step: int, params: dict,
                          opt_state: dict, rng: dict) -> None:
    """The train state of ``diff.fit``: ``params`` (name -> tensor),
    ``opt_state`` (an optimizer's ``state_dict()``) and ``rng`` (the seed
    counter) after ``step`` steps, in the directory ``path``.  An earlier
    train state there is replaced (its file only); any other existing path
    (a file, a directory with other contents) is refused, never touched."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        is_ckpt = os.path.isfile(os.path.join(path, TRAIN_STATE))
        if not is_ckpt and (not os.path.isdir(path) or os.listdir(path)):
            raise ValueError(
                f"refusing to overwrite {path!r}: it exists but is not a "
                "train state written by save_train_checkpoint")
    os.makedirs(path, exist_ok=True)
    state = {"step": int(step),
             "params": {k: v.detach().cpu().clone()
                        for k, v in params.items()},
             "opt_state": opt_state, "rng": dict(rng)}
    tmp = os.path.join(path, TRAIN_STATE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, TRAIN_STATE))


def has_train_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, TRAIN_STATE))


def load_train_checkpoint(path: str):
    """Restore a train state saved by :func:`save_train_checkpoint`:
    (step, params, opt_state, rng), tensors on the CPU (an optimizer's
    ``load_state_dict`` moves its state to its parameters' device)."""
    state = torch.load(os.path.join(path, TRAIN_STATE), map_location="cpu",
                       weights_only=True)
    return state["step"], state["params"], state["opt_state"], state["rng"]
