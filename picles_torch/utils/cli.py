"""Command-line flags (PyTorch port of ``picles_tpu/utils/cli.py``
``arg_settings``)."""

from __future__ import annotations

import argparse


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
