"""Carry grids, states, parameters, configs, term flags and gridded wind
records across from the JAX package, 2D and 1D.

The model has no learned weights: what the two packages share is the grid,
the step state, the static parameters and the forcing.  These helpers take
the JAX package's values as numpy arrays and plain attributes (this module
imports no JAX), so a test can seed both packages with the identical state
and step them side by side.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from .core.constants import IDConstants, ODEParameters, ODESettings
from .forcing.winds import GriddedWinds1D, GriddedWinds2D
from .grids.base import Boundary, Grid1D, Grid2D, GridStats
from .models.state import (ModelState1D, ModelState2D, Particles1D,
                           Particles2D, StepMetrics)
from .models.wave_growth_1d import ParticleDefaults1D, WaveGrowth1DConfig
from .models.wave_growth_2d import ParticleDefaults2D, WaveGrowth2DConfig
from .ops.rhs import TermFlags

GRID_FIELDS = ("x", "y", "dx_m", "dy_m", "area", "angle", "mask", "proj", "pc")
PARTICLE_FIELDS = ("lne", "cgx", "cgy", "px", "py", "t", "dt", "on")
_MODES = {"pallas": "cuda", "xla": "torch", "auto": "auto",
          "dense_pallas": "dense_cuda", "dense": "dense"}
_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64}


def _get(obj: Any, name: str):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _from_fields(cls, obj):
    return cls(**{f.name: _get(obj, f.name) for f in dataclasses.fields(cls)})


def _stats(stats) -> GridStats:
    st = {f.name: _get(stats, f.name) for f in dataclasses.fields(GridStats)}
    st["bx"], st["by"] = Boundary(int(st["bx"])), Boundary(int(st["by"]))
    return GridStats(**st)


def _dtype(dt) -> torch.dtype:
    """The torch dtype of a JAX config's float32 or float64 (others
    raise)."""
    out = _DTYPES.get(np.dtype(getattr(dt, "dtype", dt)))
    if out is None:
        raise ValueError(f"only float32 and float64 are ported, got {dt}")
    return out


def _counters(metrics, device) -> StepMetrics:
    return StepMetrics(**{f.name: torch.as_tensor(
        np.array(metrics[f.name]), device=device).to(torch.int32)
        for f in dataclasses.fields(StepMetrics)})


def grid_from_numpy(arrays: Mapping[str, np.ndarray], stats, *, device,
                    dtype: torch.dtype = torch.float32) -> Grid2D:
    """A ``Grid2D`` from the JAX grid's leaves (``GRID_FIELDS``, numpy) and
    its ``GridStats`` (attributes or a mapping)."""
    planes = {}
    for name in GRID_FIELDS:
        a = np.array(arrays[name])   # a writable copy
        planes[name] = torch.as_tensor(
            a.astype(np.int32) if name == "mask" else a, device=device)
        if name != "mask":
            planes[name] = planes[name].to(dtype)
    return Grid2D(**planes, stats=_stats(stats))


def state_from_numpy(state: np.ndarray, particles: Mapping[str, np.ndarray],
                     time, iteration, *, device,
                     dtype: torch.dtype = torch.float32,
                     metrics: Optional[Mapping[str, Any]] = None
                     ) -> ModelState2D:
    """A ``ModelState2D`` from the JAX state's leaves as numpy arrays:
    ``state [nx, ny, 3]`` (``[L, nx, ny, 3]`` layered), the particle planes
    (``PARTICLE_FIELDS``, ``[L, nx, ny]`` layered), the clock and the
    iteration, the floats as ``dtype`` (the model's).  ``metrics``: the
    counters by name (ints, or ``[L]`` sequences layered, as
    ``state_to_numpy`` gives them); they start at zero without it."""
    def t(a, dt):
        return torch.as_tensor(np.array(a), device=device).to(dt)

    parts = {k: t(particles[k], torch.bool if k == "on" else dtype)
             for k in PARTICLE_FIELDS}
    layers = state.shape[0] if np.ndim(state) == 4 else None
    counters = (StepMetrics.zeros(device, layers) if metrics is None
                else _counters(metrics, device))
    return ModelState2D(state=t(state, dtype),
                        particles=Particles2D(**parts),
                        time=t(time, dtype),
                        iteration=t(iteration, torch.int32),
                        metrics=counters)


def state_to_numpy(ms: ModelState2D) -> dict:
    """The reverse of ``state_from_numpy``: a dict of numpy arrays with keys
    ``state``, ``time``, ``iteration``, the particle planes, and
    ``metrics`` (a dict of ints, of ``[L]`` lists for a layered state)."""
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


def flags_from_jax(flags) -> TermFlags:
    """The port's ``TermFlags`` from a ``picles_tpu`` ``TermFlags``
    (attributes or a mapping)."""
    return TermFlags(**{f.name: bool(_get(flags, f.name))
                        for f in dataclasses.fields(TermFlags)})


def gridded_from_jax(gw, *, device) -> GriddedWinds2D:
    """The port's ``GriddedWinds2D`` on ``device`` from a ``picles_tpu``
    one (attributes or a mapping): the record's arrays and node tables as
    float32 tensors (taken as numpy arrays), the axis metadata and the
    edge modes as they are."""
    def tensor(a):
        return None if a is None else torch.as_tensor(
            np.array(a, dtype=np.float32), device=device)

    return GriddedWinds2D(
        u_data=tensor(_get(gw, "u_data")), v_data=tensor(_get(gw, "v_data")),
        **{k: float(_get(gw, k)) for k in ("x0", "dx", "y0", "dy", "t0",
                                           "dt")},
        mode=str(_get(gw, "mode")), mode_t=str(_get(gw, "mode_t")),
        **{k: tensor(_get(gw, k)) for k in ("x_nodes", "y_nodes",
                                            "t_nodes")})


def config_from_jax(cfg) -> WaveGrowth2DConfig:
    """The port's config from a ``picles_tpu`` ``WaveGrowth2DConfig``: the
    Pallas modes map to the CUDA kernels ("pallas" -> "cuda",
    "dense_pallas" -> "dense_cuda") and "xla" advance to "torch"; float32
    and float64 to their torch types (any other dtype raises); TPU block
    and interpret settings have no counterpart."""
    init = cfg.ode_init_type
    if not isinstance(init, str):
        init = ParticleDefaults2D(float(init.lne), float(init.cg_x),
                                  float(init.cg_y), float(init.x),
                                  float(init.y))
    dtype = _dtype(cfg.dtype)
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
        halo=halo, layers=int(cfg.layers), dtype=dtype)


# ---------------------------------------------------------------------------
# the 1D model
# ---------------------------------------------------------------------------

def grid1d_from_numpy(x: np.ndarray, stats, *, device,
                      dtype: torch.dtype = torch.float32) -> Grid1D:
    """A ``Grid1D`` from the JAX grid's node positions ``x [nx]`` (numpy)
    and its ``GridStats`` (attributes or a mapping)."""
    return Grid1D(x=torch.as_tensor(np.array(x), device=device).to(dtype),
                  stats=_stats(stats))


def state1d_from_numpy(state: np.ndarray, particles: Mapping[str, np.ndarray],
                       time, iteration, *, device,
                       dtype: torch.dtype = torch.float32,
                       metrics: Optional[Mapping[str, Any]] = None
                       ) -> ModelState1D:
    """A ``ModelState1D`` from the JAX state's leaves as numpy arrays:
    ``state [nx, 3]``, the particles' ``z [nx, 3]``, ``t``, ``dt`` and
    ``on``, the clock and the iteration, the floats as ``dtype``.
    ``metrics``: the counters by name; they start at zero without it."""
    def t(a, dt):
        return torch.as_tensor(np.array(a), device=device).to(dt)

    parts = Particles1D(z=t(particles["z"], dtype), t=t(particles["t"], dtype),
                        dt=t(particles["dt"], dtype),
                        on=t(particles["on"], torch.bool))
    return ModelState1D(
        state=t(state, dtype), particles=parts, time=t(time, dtype),
        iteration=t(iteration, torch.int32),
        metrics=(StepMetrics.zeros(device) if metrics is None
                 else _counters(metrics, device)))


def state1d_to_numpy(ms: ModelState1D) -> dict:
    """The reverse of ``state1d_from_numpy``: numpy arrays under ``state``,
    ``z``, ``t``, ``dt``, ``on``, ``time`` and ``iteration``, and
    ``metrics`` (a dict of ints)."""
    out = {k: getattr(ms.particles, k).cpu().numpy()
           for k in ("z", "t", "dt", "on")}
    out.update(state=ms.state.cpu().numpy(), time=ms.time.cpu().numpy(),
               iteration=ms.iteration.cpu().numpy(),
               metrics=ms.metrics.as_dict())
    return out


def config1d_from_jax(cfg) -> WaveGrowth1DConfig:
    """The port's ``WaveGrowth1DConfig`` from a ``picles_tpu`` one."""
    init = cfg.ode_init_type
    if not isinstance(init, str):
        init = ParticleDefaults1D(float(init.lne), float(init.cg_x),
                                  float(init.x))
    return WaveGrowth1DConfig(
        periodic_boundary=bool(cfg.periodic_boundary), ode_init_type=init,
        boundary_type=cfg.boundary_type, merge_rule=bool(cfg.merge_rule),
        dtype=_dtype(cfg.dtype))


def gridded1d_from_jax(gw, *, device) -> GriddedWinds1D:
    """The port's ``GriddedWinds1D`` on ``device`` from a ``picles_tpu``
    one (attributes or a mapping): the record as a float32 tensor, the
    axes and the edge modes as they are."""
    return GriddedWinds1D(
        u_data=torch.as_tensor(np.array(_get(gw, "u_data"), dtype=np.float32),
                               device=device),
        **{k: float(_get(gw, k)) for k in ("x0", "dx", "t0", "dt")},
        mode=str(_get(gw, "mode")), mode_t=str(_get(gw, "mode_t")))
