"""Minimal end-to-end example on the PyTorch port — the README example_00
analog (reference README.md:80-140), as ``examples/example_00_minimal.py``
runs it on the JAX package: homogeneous 10 m/s winds over a 100 km box,
2 h simulation, plot the final Hs field.

Run:  python picles_torch/examples/example_00_minimal.py [outdir] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

import picles_torch as pt  # noqa: E402

# PICLES_SMOKE=1 shrinks the run for the example smoke tests
# (tests/test_torch_examples.py) — same code path, smaller grid/horizon.
SMOKE = os.environ.get("PICLES_SMOKE") == "1"
_ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
_ap.add_argument("outdir", nargs="?", help="write the figures there")
_ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ARGS = _ap.parse_args()

# Parameters (reference README values)
U10, V10 = 10.0, 10.0
DT = 10 * 60.0          # 10 minutes
r_g0 = 0.85
N = 15 if SMOKE else 51
STOP = 3 * DT if SMOKE else 2 * 3600.0

winds = pt.constant_winds(U10, V10)
grid = pt.cartesian_box(100e3, N, 100e3, N, device=ARGS.device)

ode_pars, const_id, _ = pt.ODEParameters.create(r_g=r_g0)
windsea_min = pt.FetchRelations.MinimalWindsea(U10, V10, DT)

settings = pt.ODESettings(
    log_energy_minimum=float(windsea_min.lne),
    saving_step=DT, timestep=DT,
    total_time=6 * 24 * 3600.0,
    dt=1e-3, dtmin=1e-4, force_dtmin=True)

model = pt.WaveGrowth2D(
    grid, winds, settings, ode_params=ode_pars, constants=const_id,
    minimal_particle=pt.FetchRelations.MinimalParticle(U10, V10, DT),
    config=pt.WaveGrowth2DConfig(periodic_boundary=False))

sim = pt.Simulation.create(model, stop_time=STOP, verbose=True)
sim.run(cash_store=True)

states = sim.store.as_array()
print(f"ran {len(sim.store.store) - 1} steps; "
      f"final mean E = {states[-1, ..., 0].mean():.4e}, "
      f"max Hs = {4 * np.sqrt(states[-1, ..., 0].max()):.2f} m")

if ARGS.outdir:
    from picles_torch.viz import plotting as V

    outdir = ARGS.outdir
    V.plot_state_2d(grid, states[-1], title="E [m^2] after 2 h")
    import matplotlib.pyplot as plt

    plt.savefig(f"{outdir}/example_00_final_state.png", dpi=110)
    V.movie_2d(grid, states, f"{outdir}/example_00.gif",
               times=np.arange(len(states)) * DT)
    print(f"wrote plots to {outdir}")
