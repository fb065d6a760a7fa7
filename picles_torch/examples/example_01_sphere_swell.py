"""Spherical aquaplanet swell propagation (T03_PIC_sphere_aqua analog) on
the PyTorch port, as ``examples/example_01_sphere_swell.py`` runs it on the
JAX package: a swell blob crosses the sphere along great circles with no
forcing.

Run:  python picles_torch/examples/example_01_sphere_swell.py [outdir] [--device cpu]
"""

import argparse
import dataclasses
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import picles_torch as pt  # noqa: E402
from picles_torch.models.state import Particles2D  # noqa: E402
from picles_torch.ops.rhs import TermFlags  # noqa: E402

SMOKE = os.environ.get("PICLES_SMOKE") == "1"  # see tests/test_torch_examples.py
_ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
_ap.add_argument("outdir", nargs="?", help="write the movie there")
_ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ARGS = _ap.parse_args()

DT = 1800.0
NX, NY, NSTEP = (31, 21, 6) if SMOKE else (91, 41, 48)
grid = pt.spherical_grid_2d(0.0, 180.0, NX, 0.0, 80.0, NY,
                            periodic_boundary=(True, False),
                            device=ARGS.device)

ws = pt.FetchRelations.MinimalWindsea(1.0, 1.0, DT)
sett = pt.ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                      timestep=DT, total_time=10 * 24 * 3600.0, dt=1.0,
                      dtmin=1e-2, force_dtmin=True)
flags = TermFlags(input=False, dissipation=False, peak_shift=False,
                  direction=False)
# the model flag is False on a MIXED-periodicity grid (periodic lon,
# open lat): the lat-edge ring (mask==3) must be boundary nodes, not
# active interior — same usage as the reference's sphere-aqua test
# (T03_PIC_sphere_aqua.jl:55,171: grid (true, false), model false)
model = pt.WaveGrowth2D(grid, pt.constant_winds(0.0, 0.0), sett, flags=flags,
                        minimal_state=np.array([1e-12, 1e-20]),
                        config=pt.WaveGrowth2DConfig(periodic_boundary=False,
                                                     halo=4))
ms = model.init_state()

# plant an eastward swell blob at 30N
on = np.zeros((grid.nx, grid.ny), bool)
z = np.zeros((grid.nx, grid.ny, 5), np.float32)
z[..., 0] = math.log(0.2)
on[10:16, 14:19] = True
z[..., 1] = 12.0   # eastward 12 m/s
zt = torch.as_tensor(z, device=model.device)
ms = dataclasses.replace(ms, particles=Particles2D(
    *(zt[..., k].contiguous() for k in range(5)), t=ms.particles.t,
    dt=ms.particles.dt, on=torch.as_tensor(on, device=model.device)))

snaps, times = [], []
for k in range(NSTEP):  # one day (6 steps when smoke-testing)
    ms = model.step(ms)
    if k % (8 if not SMOKE else 2) == (7 if not SMOKE else 1):
        snaps.append(ms.state.cpu().numpy())
        times.append(float(ms.time))

e_last = snaps[-1][..., 0]
com_lon = (grid.x.cpu().numpy()[..., 0][:, None] * e_last).sum() / e_last.sum()
print(f"blob total E: {e_last.sum():.3f}, center lon: {com_lon:.1f} deg, "
      f"failures: {int(ms.metrics.n_failed)}")

if ARGS.outdir:
    from picles_torch.viz import plotting as V

    V.movie_2d(grid, np.stack(snaps), f"{ARGS.outdir}/sphere_swell.gif",
               times=np.asarray(times))
    print(f"wrote {ARGS.outdir}/sphere_swell.gif")
