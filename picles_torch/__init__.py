"""PiCLES on PyTorch and CUDA: the WaveGrowth2D step with hand-written
Hopper kernels (advance, auto-dt, CIC gather) and plain PyTorch versions of
each.  The JAX package ``picles_tpu`` is the reference it is tested
against; this package imports no JAX."""

from .convert import (config_from_jax, grid_from_numpy, settings_from_values,
                      state_from_numpy, state_to_numpy)
from .core.constants import IDConstants, ODEParameters, ODESettings
from .forcing.winds import (WindKernel, WindKind, Winds2D, constant_winds,
                            half_domain_winds, time_cosine_winds)
from .grids.base import Boundary, Grid2D, GridStats
from .grids.cartesian import cartesian_box, cartesian_grid_2d
from .models.state import ModelState2D, Particles2D, StepMetrics
from .models.wave_growth_2d import (ParticleDefaults2D, WaveGrowth2D,
                                    WaveGrowth2DConfig)
from .ops.advance_cuda import advance_cuda, auto_dt_cuda
from .ops.pic_cuda import pic_gather
from .ops.rhs import TermFlags
from .ops.tsit5 import SolverConfig

__all__ = [
    "Boundary", "Grid2D", "GridStats", "IDConstants", "ModelState2D",
    "ODEParameters", "ODESettings", "ParticleDefaults2D", "Particles2D",
    "SolverConfig", "StepMetrics", "TermFlags", "WaveGrowth2D",
    "WaveGrowth2DConfig", "WindKernel", "WindKind", "Winds2D",
    "advance_cuda", "auto_dt_cuda", "cartesian_box", "cartesian_grid_2d",
    "config_from_jax", "constant_winds", "grid_from_numpy",
    "half_domain_winds", "pic_gather", "settings_from_values",
    "state_from_numpy", "state_to_numpy", "time_cosine_winds",
]
