"""Command-line flags and the standard initialization (PyTorch port of
``picles_tpu/utils/cli.py``)."""

from __future__ import annotations

import argparse

from ..core import fetch_relations as FR
from ..core.constants import IDConstants, ODEParameters, ScgConstants


def arg_settings() -> argparse.ArgumentParser:
    """The flag table of the JAX package's CLI."""
    p = argparse.ArgumentParser(prog="picles_torch",
                                description="PiCLES wave model on PyTorch")
    p.add_argument("--ID", type=str, help="ID (or folder) of the model output")
    p.add_argument("--T", type=float, help="run time in hours")
    p.add_argument("--DT", type=float, help="re-meshing time step in minutes")
    p.add_argument("--Lx", type=float, help="domain length in km")
    p.add_argument("--Nx", type=int, help="# of nodes")
    p.add_argument("--U10", type=float, help="10-meter windspeed amplitude")
    p.add_argument("--c_beta", type=float, default=4.0,
                   help="growth parameter in 1e-2")
    p.add_argument("--gamma", type=float, help="input dissipation coefficient")
    p.add_argument("--r_g0", type=float, default=0.85,
                   help="c_g / c_p ratio")
    p.add_argument("--periodic", action="store_true",
                   help="periodic boundary condition")
    p.add_argument("--parset", type=str, help="set/group of experiments")
    return p


def init_standard(uscale: float, vscale: float, DT: float,
                  r_g0: float = 0.85, *, device="cuda"):
    """The standard initialization: returns (the particle defaults of the
    windsea, the ODE parameters, the windsea as float32 0-dim tensors on
    ``device``, the ID constants).

    As in the JAX package (and the Julia source it follows), the windsea
    is that of a DT/2 duration, and the parameters set ``C_varphi`` to
    the constants' ``c_beta`` (sic), so that the two packages agree."""
    from ..models.wave_growth_2d import ParticleDefaults2D

    const_id = IDConstants.create(r_g=r_g0)
    const_scg = ScgConstants()
    pars = ODEParameters(r_g=r_g0, C_alpha=const_scg.C_alpha,
                         C_varphi=const_id.c_beta, C_e=const_id.C_e, g=9.81)
    windsea_min = FR.get_initial_windsea(FR._f32(uscale, device),
                                         FR._f32(vscale, device), DT / 2)
    particle_state = ParticleDefaults2D(float(windsea_min.lne),
                                        float(windsea_min.cg_bar_x),
                                        float(windsea_min.cg_bar_y), 0.0, 0.0)
    return particle_state, pars, windsea_min, const_id
