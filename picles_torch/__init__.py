"""PiCLES on PyTorch and CUDA: the WaveGrowth2D step with hand-written
Hopper kernels (advance, auto-dt, CIC gather, remesh, and the gather with
the remesh fused) and plain PyTorch versions of each, driven by
``Simulation`` with stores and checkpoints, on Cartesian, spherical and
tripolar (MOM6) grids, forced by analytic winds or a gridded (NetCDF) wind
record, with one wave system or several layered on one grid, on one card
or cut into blocks over ``torch.distributed`` ranks; and the 1D growth
model (``WaveGrowth1D``, plain PyTorch).  The JAX package ``picles_tpu`` is
the reference it is tested against; this package imports no JAX."""

from .convert import (config1d_from_jax, config_from_jax, flags_from_jax,
                      grid1d_from_numpy, grid_from_numpy, gridded1d_from_jax,
                      gridded_from_jax, settings_from_values,
                      state1d_from_numpy, state1d_to_numpy, state_from_numpy,
                      state_to_numpy)
from .core.constants import IDConstants, ODEParameters, ODESettings
from .forcing.winds import (GriddedWinds1D, GriddedWinds2D, WindKernel,
                            WindKind, Winds1D, Winds2D, constant_winds,
                            constant_winds_1d, gridded_samplers,
                            half_domain_winds, load_gridded_winds_2d,
                            time_cosine_winds)
from .grids.base import Boundary, Grid1D, Grid2D, GridStats, one_d_grid
from .grids.cartesian import cartesian_box, cartesian_grid_2d
from .grids.spherical import spherical_grid_2d
from .grids.tripolar import (load_mom6_grid, mom6_grid_from_supergrid,
                             synthetic_tripolar_grid)
from .models.state import (ModelState1D, ModelState2D, Particles1D,
                           Particles2D, StepMetrics)
from .models.wave_growth_1d import (ParticleDefaults1D, WaveGrowth1D,
                                    WaveGrowth1DConfig)
from .models.wave_growth_2d import (LayeredWaveGrowth2D, ParticleDefaults2D,
                                    WaveGrowth2D, WaveGrowth2DConfig)
from .ops.advance_cuda import advance_cuda, auto_dt_cuda
from .ops.pic_cuda import pic_gather, pic_gather_remesh
from .ops.remesh import RemeshParams, RemeshResult, remesh_core
from .ops.remesh_cuda import remesh_cuda
from .ops.rhs import TermFlags, particle_equations_1d
from .ops.tsit5 import SolverConfig
from .simulation.checkpoint import load_checkpoint, save_checkpoint
from .simulation.simulation import Simulation
from .simulation.store import (CashStore, EmptyStore, StateStore,
                               convert_store_to_tuple)

__all__ = [
    "Boundary", "CashStore", "EmptyStore", "Grid1D",
    "Grid2D", "GridStats", "GriddedWinds1D", "GriddedWinds2D", "IDConstants",
    "LayeredWaveGrowth2D", "ModelState1D", "ModelState2D", "ODEParameters",
    "ODESettings", "ParticleDefaults1D", "ParticleDefaults2D", "Particles1D",
    "Particles2D", "RemeshParams", "RemeshResult", "Simulation",
    "SolverConfig", "StateStore", "StepMetrics", "TermFlags", "WaveGrowth1D",
    "WaveGrowth1DConfig", "WaveGrowth2D", "WaveGrowth2DConfig", "WindKernel",
    "WindKind", "Winds1D", "Winds2D", "advance_cuda", "auto_dt_cuda",
    "cartesian_box", "cartesian_grid_2d", "config1d_from_jax",
    "config_from_jax", "constant_winds", "constant_winds_1d",
    "convert_store_to_tuple", "flags_from_jax", "grid1d_from_numpy",
    "grid_from_numpy", "gridded1d_from_jax", "gridded_from_jax",
    "gridded_samplers", "half_domain_winds", "load_checkpoint",
    "load_gridded_winds_2d", "load_mom6_grid", "mom6_grid_from_supergrid",
    "one_d_grid", "particle_equations_1d",
    "pic_gather", "pic_gather_remesh", "remesh_core", "remesh_cuda",
    "save_checkpoint", "settings_from_values", "spherical_grid_2d",
    "state1d_from_numpy", "state1d_to_numpy", "state_from_numpy",
    "state_to_numpy", "synthetic_tripolar_grid", "time_cosine_winds",
]
