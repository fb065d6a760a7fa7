"""Global tripolar run with land mask, pole masking, and a zonal-jet wind
(T03_PIC_tripolar analog on the synthetic supergrid) on the PyTorch port,
as ``examples/example_02_tripolar_global.py`` runs it on the JAX package;
point the loader at a real MOM6 ocean_hgrid file to run the production
grid:

    grid = pt.load_mom6_grid("ocean_hgrid.nc", k=4, mask_file="topo.nc",
                             device="cuda")

The jet is a plain callable, ``pt.Winds2D(u=u, v=v)``: it does not read its
time, so the model runs it on the CUDA kernels as its two node planes.

Run:  python picles_torch/examples/example_02_tripolar_global.py [outdir] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import picles_torch as pt  # noqa: E402

SMOKE = os.environ.get("PICLES_SMOKE") == "1"  # see tests/test_torch_examples.py
_ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
_ap.add_argument("outdir", nargs="?", help="write the globes there")
_ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ARGS = _ap.parse_args()

DT = 1200.0
grid = pt.synthetic_tripolar_grid(k=2, device=ARGS.device)
STOP = 2 * DT if SMOKE else 6 * 3600.0


def u(x, y, t):
    return 12.0 * torch.exp(-(((y - 40.0) / 20.0) ** 2))


def v(x, y, t):
    return torch.zeros_like(x)


winds = pt.Winds2D(u=u, v=v)
ws = pt.FetchRelations.MinimalWindsea(10.0, 10.0, DT)
sett = pt.ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                      timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                      dtmin=1e-4, force_dtmin=True)
model = pt.WaveGrowth2D(grid, winds, sett,
                        config=pt.WaveGrowth2DConfig(periodic_boundary=True))
sim = pt.Simulation.create(model, stop_time=STOP, verbose=True)
sim.run(cash_store=True)

states = sim.store.as_array()
e = states[-1, ..., 0]
mask = grid.mask.cpu().numpy()
print(f"ocean nodes: {(mask == 1).sum()}, max Hs: {4*np.sqrt(e.max()):.2f} m, "
      f"land energy: {e[mask == 0].sum():.2e}")

if ARGS.outdir:
    from picles_torch.viz import plotting as V

    V.plot_state_double_globe(grid, states[-1], show_seam=True,
                              path=f"{ARGS.outdir}/tripolar_globes.png")
    print(f"wrote {ARGS.outdir}/tripolar_globes.png")
