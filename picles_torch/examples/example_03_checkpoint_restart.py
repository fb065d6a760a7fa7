"""Checkpoint / resume + storage + movie — the full production run loop
on the PyTorch port, as ``examples/example_03_checkpoint_restart.py`` runs
it on the JAX package.

Demonstrates what the reference's ``run!(pickup=...)`` stub promises but
never implements (reference src/Simulations/run.jl:32-36): run a forced box
for 3 h under growing-then-decaying winds, checkpoint, keep running to 6 h,
then restart a second simulation from the checkpoint and verify the resumed
trajectory matches the uninterrupted one bit-for-bit.  Given an outdir, it
also writes the HDF5 state store of the first leg (reference storing.jl
layout; needs h5py) and an animation (needs matplotlib) there; without
one, the checkpoint goes to a temporary directory and neither is written.

Run:  python picles_torch/examples/example_03_checkpoint_restart.py [outdir] [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

import picles_torch as pt  # noqa: E402

SMOKE = os.environ.get("PICLES_SMOKE") == "1"  # see tests/test_torch_examples.py
_ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
_ap.add_argument("outdir", nargs="?",
                 help="write the store, checkpoint and movie there")
_ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ARGS = _ap.parse_args()

U10, DT = 12.0, 10 * 60.0
N = 16 if SMOKE else 40
T_CKPT = (3 * DT) if SMOKE else (3 * 3600.0)
T_END = (6 * DT) if SMOKE else (6 * 3600.0)

winds = pt.time_cosine_winds(U10, 4.0, period=12 * 3600.0)
grid = pt.cartesian_box(150e3, N, 150e3, N, device=ARGS.device)
wsmin = pt.FetchRelations.MinimalWindsea(U10, 4.0, DT)
settings = pt.ODESettings(log_energy_minimum=float(wsmin.lne),
                          saving_step=DT, timestep=DT,
                          total_time=6 * 3600.0, dt=1e-3, dtmin=1e-4,
                          force_dtmin=True)
model = pt.WaveGrowth2D(grid, winds, settings,
                        config=pt.WaveGrowth2DConfig(periodic_boundary=False))

with tempfile.TemporaryDirectory() as _tmp:
    outdir = ARGS.outdir or _tmp

    # --- leg 1: 0 -> 3 h, checkpoint at the end ----------------------------
    sim = pt.Simulation.create(model, stop_time=T_CKPT, verbose=True)
    sim.initialize()
    if ARGS.outdir:
        sim.init_state_store(outdir, name="leg1")
    sim.run(store=bool(ARGS.outdir))
    ckpt = sim.checkpoint(os.path.join(outdir, "t3h"))
    print(f"checkpointed at t = {float(sim.state.time):.0f} s -> {ckpt}")

    # --- continue uninterrupted to 6 h -------------------------------------
    sim.stop_time = T_END
    sim.run(cash_store=True)
    final_a = np.asarray(sim.store.as_array()[-1])

    # --- leg 2: fresh Simulation resumed from the checkpoint ----------------
    model2 = pt.WaveGrowth2D(grid, winds, settings,
                             config=pt.WaveGrowth2DConfig(
                                 periodic_boundary=False))
    sim2 = pt.Simulation.create(model2, stop_time=T_END, verbose=True)
    sim2.pickup(ckpt)
    print(f"resumed at t = {float(sim2.state.time):.0f} s")
    sim2.run(cash_store=True)
    final_b = np.asarray(sim2.store.as_array()[-1])

assert np.array_equal(final_a, final_b), "resume is not bit-exact!"
print(f"resume is bit-exact; final mean E = {final_a[..., 0].mean():.4e}, "
      f"max Hs = {4 * np.sqrt(final_a[..., 0].max()):.2f} m")

if ARGS.outdir:
    from picles_torch.viz import plotting as V

    states = np.asarray(sim2.store.as_array())
    V.movie_2d(grid, states, os.path.join(ARGS.outdir, "example_03.gif"),
               times=3 * 3600.0 + np.arange(len(states)) * DT)
    print(f"wrote {ARGS.outdir}/example_03.gif and {ARGS.outdir}/leg1.h5")
