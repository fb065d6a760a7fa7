"""Checkpoint and resume (PyTorch port of
``picles_tpu/simulation/checkpoint.py``, npz backend).

A checkpoint is the whole model state (node state, particles, clock,
iteration, counters) in one compressed ``.npz`` file, in the JAX package's
layout: ``__meta__`` holds ``{"version": 2, "kind": ..., "n_leaves": ...}``
and ``leaf_i`` the i-th leaf in the JAX pytree order of the state.  The
kinds are ``ModelState2D`` (22 leaves) and ``ModelState1D`` (18: state, z,
t, dt, on, time, iteration and the 11 counters).  So a checkpoint written
by ``picles_tpu`` resumes here and the other way round, bit for bit.  A
layered state's leaves carry their leading ``[L]`` axis, counters too, in
both packages' files alike.  The orbax backend is not ported (ROADMAP item
17).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..models.state import (ModelState1D, ModelState2D, Particles1D,
                            Particles2D, StepMetrics)

_FORMAT_VERSION = 2
# kind -> (state class, particle class)
_KINDS = {"ModelState2D": (ModelState2D, Particles2D),
          "ModelState1D": (ModelState1D, Particles1D)}
_N_METRICS = len(dataclasses.fields(StepMetrics))


def _orbax_refused():
    return NotImplementedError("the orbax checkpoint backend is not ported "
                               "(ROADMAP item 17); use the npz backend")


def npz_path(path: str) -> str:
    """``path`` with ``.npz`` appended if missing."""
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, ms, backend: str = "npz") -> str:
    """Write ``ms`` (a ``ModelState2D`` or ``ModelState1D``) to ``path``
    (``.npz`` appended if missing); returns the path written."""
    if backend == "orbax":
        raise _orbax_refused()
    if backend != "npz":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    path = npz_path(path)
    leaves = ms.leaves()
    arrays = {f"leaf_{i}": x.detach().cpu().numpy()
              for i, x in enumerate(leaves)}
    kind = type(ms).__name__
    if kind not in _KINDS:
        raise TypeError(f"cannot checkpoint a {kind}")
    meta = json.dumps(dict(version=_FORMAT_VERSION, kind=kind,
                           n_leaves=len(leaves)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, __meta__=np.bytes_(meta), **arrays)
    return path


def load_checkpoint(path: str, device="cuda"):
    """Read a checkpoint written by either package onto ``device``: the
    CUDA device unless the caller names another; raises when a CUDA device
    is asked for and there is none.  Returns the state of the file's kind."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_checkpoint: no CUDA device found; pass "
                           "device='cpu' to load the state onto the CPU")
    if os.path.isdir(path) and os.path.exists(
            os.path.join(path, "picles_meta.json")):
        raise _orbax_refused()
    with np.load(npz_path(path), allow_pickle=False) as f:
        meta = json.loads(bytes(f["__meta__"].item()).decode())
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unknown checkpoint version {meta['version']}")
        if meta["kind"] not in _KINDS:
            raise ValueError(f"checkpoint kind {meta['kind']!r}: only "
                             f"{sorted(_KINDS)} are ported")
        state_cls, parts_cls = _KINDS[meta["kind"]]
        k = 1 + len(dataclasses.fields(parts_cls))
        n = k + 2 + _N_METRICS
        if meta["n_leaves"] != n:
            raise ValueError(f"{meta['n_leaves']} leaves, a {meta['kind']} "
                             f"has {n}")
        leaves = [torch.as_tensor(f[f"leaf_{i}"], device=device)
                  for i in range(n)]
    return state_cls(
        state=leaves[0],
        particles=parts_cls(*leaves[1:k]),
        time=leaves[k], iteration=leaves[k + 1],
        metrics=StepMetrics(*leaves[k + 2:]))
