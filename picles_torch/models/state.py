"""Model state (PyTorch port of ``picles_tpu/models/state.py``, 2D).

The step state is a dataclass of tensors: the Eulerian node state, the
particle structure of arrays, the clock, and per-step counters that stay on
the device (reading them is the caller's choice, never the step's).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class StepMetrics:
    """Per-step counters, int32 0-dim tensors."""

    n_active: torch.Tensor       # particles advanced this step
    n_failed: torch.Tensor       # ODE failures
    n_nan_reset: torch.Tensor    # NaN guards tripped
    n_inf_reset: torch.Tensor
    n_emax_clamp: torch.Tensor   # log_energy_maximum clamps
    n_relight: torch.Tensor      # off -> on wind re-lights in the advance
    n_gather: torch.Tensor       # remesh: node state adopted
    n_reseed: torch.Tensor       # remesh: windsea reseeds
    n_off: torch.Tensor          # on -> off transitions in the remesh
    n_clamped: torch.Tensor      # deposit displacements clamped to the halo
    substeps_max: torch.Tensor   # max accepted ODE substeps over the batch

    @classmethod
    def zeros(cls, device) -> "StepMetrics":
        z = torch.zeros((), dtype=torch.int32, device=device)
        return cls(*([z] * len(dataclasses.fields(cls))))

    def as_dict(self) -> dict:
        """Counters as Python ints (reads the device)."""
        return {f.name: int(getattr(self, f.name))
                for f in dataclasses.fields(self)}


@dataclasses.dataclass(frozen=True)
class Particles2D:
    """One particle per grid node, as separate ``[nx, ny]`` planes.

    lne, cgx, cgy: log-energy and mean group velocity
    px, py:        position relative to the home node, in grid-index units
    t, dt:         per-particle clock and next sub-step
    on:            bool
    """

    lne: torch.Tensor
    cgx: torch.Tensor
    cgy: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    on: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ModelState2D:
    """state: ``[nx, ny, 3]`` Eulerian (e, m_x, m_y); time float32 and
    iteration int32, both 0-dim."""

    state: torch.Tensor
    particles: Particles2D
    time: torch.Tensor
    iteration: torch.Tensor
    metrics: StepMetrics
