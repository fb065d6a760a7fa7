"""Carry grids, states, parameters and configs across from the JAX package.

The model has no learned weights: what the two packages share is the grid,
the step state and the static parameters.  These helpers take the JAX
package's values as numpy arrays and plain attributes (this module imports
no JAX), so a test can seed both packages with the identical state and
step them side by side.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple

import numpy as np
import torch

from .core.constants import IDConstants, ODEParameters, ODESettings
from .grids.base import Boundary, Grid2D, GridStats
from .models.state import ModelState2D, Particles2D, StepMetrics
from .models.wave_growth_2d import ParticleDefaults2D, WaveGrowth2DConfig

GRID_FIELDS = ("x", "y", "dx_m", "dy_m", "area", "angle", "mask", "proj", "pc")
PARTICLE_FIELDS = ("lne", "cgx", "cgy", "px", "py", "t", "dt", "on")
_MODES = {"pallas": "cuda", "xla": "torch", "auto": "auto",
          "dense_pallas": "dense_cuda", "dense": "dense"}


def _get(obj: Any, name: str):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _from_fields(cls, obj):
    return cls(**{f.name: _get(obj, f.name) for f in dataclasses.fields(cls)})


def grid_from_numpy(arrays: Mapping[str, np.ndarray], stats, *, device,
                    dtype: torch.dtype = torch.float32) -> Grid2D:
    """A ``Grid2D`` from the JAX grid's leaves (``GRID_FIELDS``, numpy) and
    its ``GridStats`` (attributes or a mapping)."""
    st = {f.name: _get(stats, f.name) for f in dataclasses.fields(GridStats)}
    st["bx"], st["by"] = Boundary(int(st["bx"])), Boundary(int(st["by"]))
    planes = {}
    for name in GRID_FIELDS:
        a = np.array(arrays[name])   # a writable copy
        planes[name] = torch.as_tensor(
            a.astype(np.int32) if name == "mask" else a, device=device)
        if name != "mask":
            planes[name] = planes[name].to(dtype)
    return Grid2D(**planes, stats=GridStats(**st))


def state_from_numpy(state: np.ndarray, particles: Mapping[str, np.ndarray],
                     time, iteration, *, device) -> ModelState2D:
    """A ``ModelState2D`` from the JAX state's leaves as numpy arrays:
    ``state [nx, ny, 3]``, the particle planes (``PARTICLE_FIELDS``), the
    clock and the iteration.  Counters start at zero."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a), device=device).to(dtype)

    parts = {k: t(particles[k], torch.bool if k == "on" else torch.float32)
             for k in PARTICLE_FIELDS}
    return ModelState2D(state=t(state, torch.float32),
                        particles=Particles2D(**parts),
                        time=t(time, torch.float32),
                        iteration=t(iteration, torch.int32),
                        metrics=StepMetrics.zeros(device))


def state_to_numpy(ms: ModelState2D) -> dict:
    """The reverse of ``state_from_numpy``: a dict of numpy arrays with keys
    ``state``, ``time``, ``iteration``, the particle planes, and
    ``metrics`` (a dict of ints)."""
    out = {k: getattr(ms.particles, k).cpu().numpy() for k in PARTICLE_FIELDS}
    out.update(state=ms.state.cpu().numpy(), time=ms.time.cpu().numpy(),
               iteration=ms.iteration.cpu().numpy(),
               metrics=ms.metrics.as_dict())
    return out


def settings_from_values(ode_settings, ode_params=None, constants=None
                         ) -> Tuple[ODESettings, ODEParameters, IDConstants]:
    """The port's ``ODESettings``, ``ODEParameters`` and ``IDConstants`` from
    objects (or mappings) with the same fields; missing parameter packs get
    the defaults, as the model does."""
    sett = _from_fields(ODESettings, ode_settings)
    if ode_params is None:
        params, cid, _ = ODEParameters.create()
    else:
        params = _from_fields(ODEParameters, ode_params)
        cid = IDConstants.create(r_g=params.r_g)
    if constants is not None:
        cid = _from_fields(IDConstants, constants)
    return sett, params, cid


def config_from_jax(cfg) -> WaveGrowth2DConfig:
    """The port's config from a ``picles_tpu`` ``WaveGrowth2DConfig``: the
    Pallas modes map to the CUDA kernels ("pallas" -> "cuda",
    "dense_pallas" -> "dense_cuda") and "xla" advance to "torch"; TPU block
    and interpret settings have no counterpart."""
    init = cfg.ode_init_type
    if not isinstance(init, str):
        init = ParticleDefaults2D(float(init.lne), float(init.cg_x),
                                  float(init.cg_y), float(init.x),
                                  float(init.y))
    if np.dtype(getattr(cfg.dtype, "dtype", cfg.dtype)) != np.float32:
        raise ValueError(f"only float32 is ported, got {cfg.dtype}")
    halo = cfg.halo
    if not isinstance(halo, int):
        halo = tuple(tuple(int(v) for v in h) if not isinstance(h, int)
                     else int(h) for h in halo)
    scatter = cfg.scatter_mode if cfg.scatter_mode == "xla" \
        else _MODES[cfg.scatter_mode]
    return WaveGrowth2DConfig(
        periodic_boundary=bool(cfg.periodic_boundary), ode_init_type=init,
        boundary_type=cfg.boundary_type, scatter_mode=scatter,
        advance_mode=_MODES[cfg.advance_mode],
        dt_reset_mode=cfg.dt_reset_mode, remesh_mode=cfg.remesh_mode,
        halo=halo, layers=int(cfg.layers), dtype=torch.float32)
