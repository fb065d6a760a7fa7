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
both packages' files alike.

``backend="orbax"`` writes a directory in the layout orbax-checkpoint's
``PyTreeCheckpointer`` gives the JAX package's state (a zarr array a leaf,
named by its field path such as ``particles.lne``, in one OCDBT key-value
store; ``_METADATA`` with the tree's field paths, ``_CHECKPOINT_METADATA``,
and the package's ``picles_meta.json``), through ``tensorstore``, which
orbax writes with; orbax itself imports JAX, which this package does not.
A directory either package writes, the other reads, bit for bit.  Without
``tensorstore`` the backend raises ``ImportError``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time

import numpy as np
import torch

from ..models.state import (ModelState1D, ModelState2D, Particles1D,
                            Particles2D, StepMetrics)

_FORMAT_VERSION = 2
# kind -> (state class, particle class)
_KINDS = {"ModelState2D": (ModelState2D, Particles2D),
          "ModelState1D": (ModelState1D, Particles1D)}
_N_METRICS = len(dataclasses.fields(StepMetrics))


# what orbax-checkpoint writes into a PyTreeCheckpointer's directory
_ORBAX_HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
                  "PyTreeCheckpointHandler")
_OCDBT_CONFIG = {"compression": {"id": "zstd"},
                 "max_decoded_node_bytes": 100_000_000,
                 "max_inline_value_bytes": 1024,
                 "version_tree_arity_log2": 4}
_KEY_DICT = 2   # orbax's key type of a named field


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError("the orbax checkpoint backend reads and writes "
                          "through tensorstore, which is not installed; use "
                          "the npz backend") from e
    return tensorstore


def npz_path(path: str) -> str:
    """``path`` with ``.npz`` appended if missing."""
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, ms, backend: str = "npz") -> str:
    """Write ``ms`` (a ``ModelState2D`` or ``ModelState1D``) to ``path``:
    an npz file (``.npz`` appended if missing), or with ``backend="orbax"``
    an orbax-checkpoint directory; returns the path written."""
    if backend == "orbax":
        return _save_orbax(path, ms)
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


def _field_paths(ms) -> list:
    """(field path, tensor) of every leaf, depth first in field order."""
    out = []
    for f in dataclasses.fields(ms):
        v = getattr(ms, f.name)
        if dataclasses.is_dataclass(v):
            out += [((f.name, g.name), getattr(v, g.name))
                    for g in dataclasses.fields(v)]
        else:
            out.append(((f.name,), v))
    return out


def _leaf_spec(path: str, keys) -> dict:
    return {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": f"file://{path}/",
                        "config": _OCDBT_CONFIG, "path": ".".join(keys)}}


def _write_json(path: str, name: str, obj) -> None:
    with open(os.path.join(path, name), "w") as f:
        json.dump(obj, f)


def _save_orbax(path: str, ms) -> str:
    """Write ``ms`` as an orbax-checkpoint directory at ``path`` (replaced
    if it exists, as orbax's ``force=True`` does)."""
    ts = _tensorstore()
    kind = type(ms).__name__
    if kind not in _KINDS:
        raise TypeError(f"cannot checkpoint a {kind}")
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    t0 = time.time_ns()
    ctx = ts.Context()
    txn = ts.Transaction()
    tree = {}
    for keys, x in _field_paths(ms):
        a = x.detach().cpu().numpy()
        spec = _leaf_spec(path, keys)
        spec["metadata"] = {"shape": list(a.shape), "chunks": list(a.shape),
                            "dtype": a.dtype.str, "fill_value": None,
                            "compressor": {"id": "zstd", "level": 1},
                            "dimension_separator": "."}
        store = ts.open(spec, create=True, context=ctx,
                        transaction=txn).result()
        store.write(a).result()
        tree[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": _KEY_DICT} for k in keys],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
    txn.commit_async().result()
    _write_json(path, "_METADATA", {
        "tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None})
    _write_json(path, "_CHECKPOINT_METADATA", {
        "item_handlers": _ORBAX_HANDLER, "metrics": {},
        "performance_metrics": {}, "init_timestamp_nsecs": t0,
        "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}})
    _write_json(path, "picles_meta.json", dict(
        version=_FORMAT_VERSION, kind=kind, backend="orbax"))
    return path


def _load_orbax(path: str, device):
    """Read an orbax-checkpoint directory of either package onto
    ``device``, leaf by leaf by field name."""
    ts = _tensorstore()
    path = os.path.abspath(path)
    with open(os.path.join(path, "picles_meta.json")) as f:
        meta = json.load(f)
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"unknown checkpoint version {meta['version']}")
    if meta["kind"] not in _KINDS:
        raise ValueError(f"checkpoint kind {meta['kind']!r}: only "
                         f"{sorted(_KINDS)} are ported")
    state_cls, parts_cls = _KINDS[meta["kind"]]
    ctx = ts.Context()

    def read(*keys):
        a = ts.open(_leaf_spec(path, keys), context=ctx).result().read()
        return torch.as_tensor(a.result(), device=device)

    def fields(cls, name):
        return cls(**{f.name: read(name, f.name)
                      for f in dataclasses.fields(cls)})

    return state_cls(state=read("state"),
                     particles=fields(parts_cls, "particles"),
                     time=read("time"), iteration=read("iteration"),
                     metrics=fields(StepMetrics, "metrics"))


def load_checkpoint(path: str, device="cuda"):
    """Read a checkpoint written by either package onto ``device``: the
    CUDA device unless the caller names another; raises when a CUDA device
    is asked for and there is none.  ``path``: an npz file, or an orbax
directory (``picles_meta.json`` in it).  Returns the state of the file's
kind."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_checkpoint: no CUDA device found; pass "
                           "device='cpu' to load the state onto the CPU")
    if os.path.isdir(path) and os.path.exists(
            os.path.join(path, "picles_meta.json")):
        return _load_orbax(path, device)
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
