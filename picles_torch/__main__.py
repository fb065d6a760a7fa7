"""CLI entry point: ``python -m picles_torch --T 2 --DT 10 --Nx 51 --U10 10``.

Runs the JAX package CLI's experiment (a constant-wind 2D box, the same flag
table) and writes the same HDF5 state store.  ``--device cuda`` (the
default) puts the grid on the CUDA device, where the kernels run, and exits
with an error when there is none; ``--device cpu`` runs the plain PyTorch
versions on the CPU.  The device is printed."""

from __future__ import annotations

import sys

import torch

from .core import fetch_relations as FR
from .core.constants import ODEParameters, ODESettings
from .forcing.winds import constant_winds
from .grids.cartesian import cartesian_box
from .models.wave_growth_2d import WaveGrowth2D, WaveGrowth2DConfig
from .simulation.simulation import Simulation
from .utils.cli import arg_settings


def parser():
    """The JAX package CLI's flags and ``--device``."""
    ap = arg_settings()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs: cuda (the kernels; the "
                         "default) or cpu (the plain PyTorch versions)")
    return ap


def build_simulation(args) -> Simulation:
    """The experiment of the parsed flags ``args``: its model on
    ``args.device`` and a seeded Simulation to the run time."""
    T = (args.T or 2.0) * 3600.0
    DT = (args.DT or 10.0) * 60.0
    Lx = (args.Lx or 100.0) * 1e3
    Nx = args.Nx or 51
    U10 = args.U10 if args.U10 is not None else 10.0
    device = torch.device(args.device)
    pars, cid, _ = ODEParameters.create(r_g=args.r_g0)
    ws_min = FR.MinimalWindsea(U10, U10, DT)
    sett = ODESettings(log_energy_minimum=float(ws_min.lne), saving_step=DT,
                       timestep=DT, total_time=T, dt=1e-3, dtmin=1e-4,
                       force_dtmin=True)
    grid = cartesian_box(Lx, Nx, Lx, Nx, device=device,
                         periodic_boundary=(args.periodic, args.periodic))
    model = WaveGrowth2D(grid, constant_winds(U10, U10), sett,
                         ode_params=pars, constants=cid,
                         config=WaveGrowth2DConfig(
                             periodic_boundary=args.periodic))
    sim = Simulation.create(model, stop_time=T, verbose=True)
    sim.initialize()
    return sim


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("picles_torch: no CUDA device found; pass --device cpu to run "
              "the plain PyTorch versions on the CPU", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    sim = build_simulation(args)
    sim.init_state_store(args.ID or "picles_run")
    sim.run(store=True)
    sim.store.close()
    print(f"wrote {sim.store.path}; final mean E = "
          f"{float(sim.state.state[..., 0].mean()):.4e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
