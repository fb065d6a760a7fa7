"""Legacy ParticleMesh grid API (PyTorch port of
``picles_tpu/grids/legacy.py``; reference src/ParticleMesh.jl).

The reference keeps two grid stacks: the legacy absolute-coordinate
``TwoDGrid``/``TwoDGridNotes``/``TwoDGridMesh`` (ParticleMesh.jl:20-100,
used by its older tests and the movie code) and the current
``CartesianGrid`` mesh path.  This framework integrates on the mesh path
(``grids.cartesian``, node-relative particle positions — see
docs/PARITY.md); this module supplies the legacy API as thin metadata
containers with the same constructor signatures and field names, plus
``to_grid2d()`` so a legacy-constructed grid drops straight into
``WaveGrowth2D``.

Intentional semantic difference (documented, not hidden): particle
POSITIONS here are node-relative grid units, not the legacy absolute
meters (ParticleMesh.jl:61-134 / mapping_2D.jl:43-57) — old tests
written against absolute-position internals are not bit-reproducible,
but every field-level result is.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TwoDGrid:
    """Regular 2D grid metadata (reference ParticleMesh.jl:20-49).

    Construct as ``TwoDGrid(xmin, xmax, Nx, ymin, ymax, Ny)`` or the
    origin-anchored ``TwoDGrid(dimx, Nx, dimy, Ny)`` convenience form
    (ParticleMesh.jl:56).
    """

    Nx: int
    Ny: int
    Ndx: int
    Ndy: int
    xmin: float
    xmax: float
    ymin: float
    ymax: float
    dimx: float
    dimy: float
    dx: float
    dy: float

    def __init__(self, *args):
        if len(args) == 4:      # TwoDGrid(dimx, Nx, dimy, Ny)
            dimx, Nx, dimy, Ny = args
            xmin, xmax, ymin, ymax = 0.0, float(dimx), 0.0, float(dimy)
        elif len(args) == 6:    # TwoDGrid(xmin, xmax, Nx, ymin, ymax, Ny)
            xmin, xmax, Nx, ymin, ymax, Ny = args
        else:
            raise TypeError("TwoDGrid(dimx, Nx, dimy, Ny) or "
                            "TwoDGrid(xmin, xmax, Nx, ymin, ymax, Ny)")
        Nx, Ny = int(Nx), int(Ny)
        if Nx < 2 or Ny < 2:
            raise ValueError(f"TwoDGrid needs Nx, Ny >= 2 (node spacing is "
                             f"dim/(N-1)); got Nx={Nx}, Ny={Ny}")
        dimx, dimy = float(xmax) - float(xmin), float(ymax) - float(ymin)
        object.__setattr__(self, "Nx", Nx)
        object.__setattr__(self, "Ny", Ny)
        object.__setattr__(self, "Ndx", Nx - 1)
        object.__setattr__(self, "Ndy", Ny - 1)
        object.__setattr__(self, "xmin", float(xmin))
        object.__setattr__(self, "xmax", float(xmax))
        object.__setattr__(self, "ymin", float(ymin))
        object.__setattr__(self, "ymax", float(ymax))
        object.__setattr__(self, "dimx", dimx)
        object.__setattr__(self, "dimy", dimy)
        object.__setattr__(self, "dx", dimx / (Nx - 1))
        object.__setattr__(self, "dy", dimy / (Ny - 1))

    def to_grid2d(self, periodic_boundary=(True, True), *, device):
        """The modern mesh grid covering the same box on ``device`` — pass
        this to ``WaveGrowth2D`` (origin offsets are a coordinate
        relabeling; the physics is translation-invariant)."""
        from .cartesian import cartesian_box

        g = cartesian_box(self.dimx, self.Nx, self.dimy, self.Ny,
                          periodic_boundary=periodic_boundary, device=device)
        if self.xmin == 0.0 and self.ymin == 0.0:
            return g
        return dataclasses.replace(g, x=g.x + self.xmin, y=g.y + self.ymin)


@dataclasses.dataclass(frozen=True)
class TwoDGridNotes:
    """Grid + node coordinate vectors (reference ParticleMesh.jl:60-89)."""

    Nx: int
    Ny: int
    Ndx: int
    Ndy: int
    xmin: float
    xmax: float
    ymin: float
    ymax: float
    dimx: float
    dimy: float
    dx: float
    dy: float
    x: np.ndarray
    y: np.ndarray

    def __init__(self, grid: TwoDGrid):
        for f in ("Nx", "Ny", "Ndx", "Ndy", "xmin", "xmax", "ymin", "ymax",
                  "dimx", "dimy", "dx", "dy"):
            object.__setattr__(self, f, getattr(grid, f))
        object.__setattr__(self, "x",
                           np.linspace(grid.xmin, grid.xmax, grid.Nx))
        object.__setattr__(self, "y",
                           np.linspace(grid.ymin, grid.ymax, grid.Ny))


def TwoDGridMesh(grid: TwoDGrid, skip: int = 1):
    """Meshed node coordinates (reference ParticleMesh.jl:91-97): returns
    a namespace with ``tuples``, ``x``, ``y`` (subsampled by ``skip``)."""
    import types

    gn = TwoDGridNotes(grid)
    gx, gy = np.meshgrid(gn.x[::skip], gn.y[::skip], indexing="ij")
    tuples = np.stack([gx, gy], axis=-1)
    return types.SimpleNamespace(tuples=tuples, x=gx, y=gy)


@dataclasses.dataclass(frozen=True)
class OneDGrid:
    """Regular 1D grid metadata (reference ParticleMesh.jl:104-134); the
    integrating counterpart is ``models.wave_growth_1d.one_d_grid``."""

    Nx: int
    Ndx: int
    xmin: float
    xmax: float
    dimx: float
    dx: float

    def __init__(self, xmin, xmax, Nx):
        Nx = int(Nx)
        if Nx < 2:
            raise ValueError(f"OneDGrid needs Nx >= 2 (node spacing is "
                             f"dim/(Nx-1)); got Nx={Nx}")
        object.__setattr__(self, "Nx", Nx)
        object.__setattr__(self, "Ndx", Nx - 1)
        object.__setattr__(self, "xmin", float(xmin))
        object.__setattr__(self, "xmax", float(xmax))
        object.__setattr__(self, "dimx", float(xmax) - float(xmin))
        object.__setattr__(self, "dx", (float(xmax) - float(xmin)) / (Nx - 1))


def OneDGridNotes(grid: OneDGrid):
    """Node coordinates for a OneDGrid (reference ParticleMesh.jl:122-134;
    the reference builds ``x = LinRange(0, dimx, Nx)`` ignoring ``xmin`` —
    a latent offset bug for non-zero-origin grids; here x spans
    [xmin, xmax] consistently with TwoDGridNotes)."""
    import types

    return types.SimpleNamespace(
        Nx=grid.Nx, Ndx=grid.Ndx, xmin=grid.xmin, xmax=grid.xmax,
        dimx=grid.dimx, dx=grid.dx,
        x=np.linspace(grid.xmin, grid.xmax, grid.Nx))
