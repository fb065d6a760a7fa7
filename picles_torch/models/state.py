"""Model state (PyTorch port of ``picles_tpu/models/state.py``).

The step state is a dataclass of tensors: the Eulerian node state, the
particle structure of arrays, the clock, and per-step counters that stay on
the device (reading them is the caller's choice, never the step's).

Each state class also copies itself: ``clone()`` into new tensors, and
``copy_(src)`` into its own tensors in place.  A CUDA graph of the step
(``models/drivers.py``) reads fixed input tensors and writes fixed output
tensors; these two move a state in and out of them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


class TensorTree:
    """Copies of a dataclass whose fields are tensors or such dataclasses."""

    def leaves(self) -> list:
        """The tensors, depth first in field order (for ``ModelState2D``
        the JAX package's pytree order)."""
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out += v.leaves() if isinstance(v, TensorTree) else [v]
        return out

    def clone(self):
        """The same state in new tensors, one per field (fields that shared
        a tensor no longer do)."""
        return type(self)(*(getattr(self, f.name).clone()
                            for f in dataclasses.fields(self)))

    def copy_(self, src) -> None:
        """Copy ``src``'s values into this state's tensors, field by field
        (shapes and dtypes must match; nothing is reallocated)."""
        for f in dataclasses.fields(self):
            getattr(self, f.name).copy_(getattr(src, f.name))


@dataclasses.dataclass(frozen=True)
class StepMetrics(TensorTree):
    """Per-step counters, int32 0-dim tensors; a layered state (several
    wave systems on one grid) counts each layer apart, ``[L]`` each."""

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
    def zeros(cls, device, layers: Optional[int] = None) -> "StepMetrics":
        """Zero counters: 0-dim, or ``[layers]`` for a layered state."""
        shape = () if layers is None else (layers,)
        z = torch.zeros(shape, dtype=torch.int32, device=device)
        return cls(*([z] * len(dataclasses.fields(cls))))

    def as_dict(self) -> dict:
        """Counters as Python ints, lists of them for ``[L]`` counters
        (reads the device)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.tolist() if v.dim() else int(v)
        return out


@dataclasses.dataclass(frozen=True)
class Particles2D(TensorTree):
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
class ModelState2D(TensorTree):
    """state: ``[nx, ny, 3]`` Eulerian (e, m_x, m_y); time float32 and
    iteration int32, both 0-dim.  A layered state (``config.layers`` wave
    systems on one grid, one clock) puts a leading ``[L]`` axis on the node
    state, the particle planes and the counters."""

    state: torch.Tensor
    particles: Particles2D
    time: torch.Tensor
    iteration: torch.Tensor
    metrics: StepMetrics


@dataclasses.dataclass(frozen=True)
class Particles1D(TensorTree):
    """The 1D model's particles, one per node: ``z [nx, 3]`` = (lne, cg_x,
    x) with x absolute in meters, the clock ``t`` and next sub-step ``dt``
    ``[nx]``, and ``on`` (bool)."""

    z: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    on: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ModelState1D(TensorTree):
    """state: ``[nx, 3]`` Eulerian (e, m_x, 0); time float32 and iteration
    int32, both 0-dim; the leaves in the JAX package's pytree order."""

    state: torch.Tensor
    particles: Particles1D
    time: torch.Tensor
    iteration: torch.Tensor
    metrics: StepMetrics
