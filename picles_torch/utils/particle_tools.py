"""Particle diagnostics (PyTorch port of
``picles_tpu/utils/particle_tools.py``).

``record_trajectories`` runs a model for n steps and keeps each step's
particle structure of arrays, the counterpart of the per-particle ODE
solution histories of the Julia source; with a saving step shorter than the
model step it also keeps the particles' raw in-window history at that
cadence.  The converters give pandas DataFrames with the JAX package's
columns; pandas is imported inside them (the package imports without it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..models.state import Particles2D
from ..models.wave_growth_1d import WaveGrowth1D
from ..models.wave_growth_2d import (LayeredWaveGrowth2D, WaveGrowth2D,
                                     layer_of)
from ..ops import transforms as TR
from ..ops.advance_cuda import advance_cuda
from ..ops.tsit5 import integrate_to


def create_iteration_mask(time: np.ndarray) -> np.ndarray:
    """A segment counter from 1 that steps up wherever time jumps back."""
    time = np.asarray(time)
    mask = np.zeros(len(time), dtype=int)
    seg = 1
    for i in range(len(time)):
        if i > 0 and time[i] < time[i - 1]:
            seg += 1
        mask[i] = seg
    return mask


def particle_z(P) -> torch.Tensor:
    """The particles' ODE state: ``z [..., 5]`` = (lne, cg_x, cg_y, x, y)
    of 2D particles, the 1D model's ``z [..., 3]`` as it is."""
    if isinstance(P, Particles2D):
        return torch.stack([P.lne, P.cgx, P.cgy, P.px, P.py], dim=-1)
    return P.z


def _shadow_2d(model: WaveGrowth2D, K: int) -> Callable:
    """The sub-window advance of a 2D model's particles: K windows of
    DT / K, each one launch of K1 where the model advances with it, else
    the plain ``integrate_to``; the lanes the step advances (``on`` and
    ``active_mask``)."""
    h = float(torch.tensor(model.settings.timestep / K,
                           dtype=model.config.dtype))
    grid = model.grid

    def run(ms):
        P = ms.particles
        active = P.on & model.active_mask
        comps, t, dt = (P.lne, P.cgx, P.cgy, P.px, P.py), P.t, P.dt
        zs, ts = [], []
        if model.modes.advance_mode == "cuda":
            # the wind's planes of the step's window, as the step forms
            # them (a gridded record's are valid over all of [t, t + DT])
            wf = model.wind_fields(grid, ms.time)
            proj = model.projection(grid)
            for _ in range(K):
                r = advance_cuda(model.winds, model.consts, model.flags,
                                 model.solver, h, comps, t, dt, active,
                                 grid.x, grid.y, proj, wind_fields=wf)
                comps, t, dt = (r.lne, r.cgx, r.cgy, r.x, r.y), r.t, r.dt
                zs.append(torch.stack(comps, dim=-1))
                ts.append(t)
        else:
            z = torch.stack(comps, dim=-1)
            for _ in range(K):
                r = integrate_to(model.rhs, z, t, t + h, dt, model.aux,
                                 active, model.solver)
                z, t, dt = r.z, r.t, r.dt
                zs.append(z)
                ts.append(t)
        return zs, ts

    return run


def _shadow_1d(model: WaveGrowth1D, K: int) -> Callable:
    """The 1D model's sub-window advance: K windows of DT / K, each one
    launch of K7 where the model advances with it, else the plain
    ``integrate_to`` (``WaveGrowth1D.advance``), on the lanes its step
    advances (``on`` and not a boundary lane)."""
    h = float(torch.tensor(model.settings.timestep / K,
                           dtype=model.config.dtype))

    def run(ms):
        P = ms.particles
        active = P.on & ~model.boundary_mask
        z, t, dt = P.z, P.t, P.dt
        zs, ts = [], []
        for _ in range(K):
            r = model.advance(z, t, dt, active, h)
            z, t, dt = r.z, r.t, r.dt
            zs.append(z)
            ts.append(t)
        return zs, ts

    return run


def _shadow(model, K: int) -> Callable:
    """``run(ms) -> (K states z, K clocks t)`` of ``model``'s kind."""
    if isinstance(model, LayeredWaveGrowth2D):
        if model.layer_models is None:
            return _shadow_2d(model.model, K)
        runs = [_shadow_2d(m, K) for m in model.layer_models]

        def run(ms):
            outs = [r(layer_of(ms, i)) for i, r in enumerate(runs)]
            return ([torch.stack([o[0][k] for o in outs]) for k in range(K)],
                    [torch.stack([o[1][k] for o in outs]) for k in range(K)])

        return run
    if isinstance(model, WaveGrowth2D):
        return _shadow_2d(model, K)
    if isinstance(model, WaveGrowth1D):
        return _shadow_1d(model, K)
    raise TypeError(f"record_trajectories: no sub-window advance for a "
                    f"{type(model).__name__}")


def record_trajectories(model, ms, n_steps: int, saving_step=None):
    """Run ``n_steps`` steps of ``model`` from ``ms``, keeping each step's
    particles.  Returns (final state, dict of stacked tensors ``z [n, ...,
    D]``, ``t``, ``on`` and ``state [n, ..., 3]``, each row the state after
    that step).  Works on ``WaveGrowth2D`` (one layer or several),
    ``LayeredWaveGrowth2D`` and ``WaveGrowth1D``.

    The steps are the model's own: one replay each of its captured step
    where the model is graphed (``models/drivers.py``), else ``model.step``.
    ``saving_step`` (by default ``model.settings.saving_step``) shorter
    than DT also keeps the raw ODE history inside each step: before the
    step, a copy of its particles is advanced over K = round(DT /
    saving_step) windows of DT / K (K launches of K1, or of K7 for the 1D
    model, where the model advances with it, else the plain
    ``integrate_to``; the guards and the
    remesh are per-DT events and do not enter a window), and the dict
    gains ``z_fine [n * K, ...]`` and ``t_fine`` at the window ends."""
    DT = float(model.settings.timestep)
    if saving_step is None:
        saving_step = float(getattr(model.settings, "saving_step", DT))
    K = max(1, int(round(DT / float(saving_step))))
    shadow = _shadow(model, K) if K > 1 else None

    graph = model._capture(ms) if model.graphed and n_steps else None
    if graph is not None:
        graph.state.copy_(ms)
        ms = graph.state
    z, t, on, state, z_fine, t_fine = [], [], [], [], [], []
    for _ in range(n_steps):
        if shadow is not None:
            zs, ts = shadow(ms)
            z_fine += zs
            t_fine += ts
        if graph is not None:
            # the replay writes the graph's own state: each row is a copy
            graph.graph.replay()
        else:
            ms = model.step(ms)
        P = ms.particles
        z.append(particle_z(P))
        t.append(P.t.clone())
        on.append(P.on.clone())
        state.append(ms.state.clone())
    if graph is not None:
        ms = graph.state.clone()
    rec = dict(z=torch.stack(z), t=torch.stack(t), on=torch.stack(on),
               state=torch.stack(state))
    if shadow is not None:
        rec["z_fine"] = torch.stack(z_fine)
        rec["t_fine"] = torch.stack(t_fine)
    return ms, rec


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def particle_to_dataframe(z_hist, t_hist, ij: Tuple[int, ...]):
    """One particle's history (``record_trajectories``' ``z`` and ``t``,
    or ``z_fine`` and ``t_fine``) as a pandas DataFrame: time, lne, cgx,
    cgy, x, y, E, mx, my (1D: time, lne, cgx, x, E, mx) and the iteration
    mask."""
    import pandas as pd

    z = _np(z_hist)[(slice(None),) + tuple(ij)]
    t = _np(t_hist)[(slice(None),) + tuple(ij)]
    if z.shape[-1] == 5:
        e, mx, my = TR.particle_to_node(*(torch.from_numpy(z[:, i])
                                          for i in range(3)))
        df = pd.DataFrame(dict(time=t, lne=z[:, 0], cgx=z[:, 1], cgy=z[:, 2],
                               x=z[:, 3], y=z[:, 4], E=e.numpy(),
                               mx=mx.numpy(), my=my.numpy()))
    else:
        e, mx = TR.particle_to_node_1d(torch.from_numpy(z[:, 0]),
                                       torch.from_numpy(z[:, 1]))
        df = pd.DataFrame(dict(time=t, lne=z[:, 0], cgx=z[:, 1], x=z[:, 2],
                               E=e.numpy(), mx=mx.numpy()))
    df["mask"] = create_iteration_mask(df["time"].to_numpy())
    return df


def particles_to_dataframes(z_hist, t_hist,
                            ij_list: Sequence[Tuple[int, ...]]) -> List:
    return [particle_to_dataframe(z_hist, t_hist, ij) for ij in ij_list]


def metrics_to_dict(ms) -> dict:
    """A step's counters as Python ints (a layered state's summed over its
    layers); reads the device."""
    m = ms.metrics
    return {f.name: int(getattr(m, f.name).sum())
            for f in dataclasses.fields(m)}


def state_to_dataframe(state, grid):
    """A node state ``[nx, ny, 3]`` as a tidy pandas DataFrame: x, y, e,
    m_x, m_y a node."""
    import pandas as pd

    s = _np(state)
    return pd.DataFrame(dict(x=_np(grid.x).ravel(), y=_np(grid.y).ravel(),
                             e=s[..., 0].ravel(), m_x=s[..., 1].ravel(),
                             m_y=s[..., 2].ravel()))
