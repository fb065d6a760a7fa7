"""Multi-rank (sharded) run on the PyTorch port — the counterpart of
``examples/example_04_sharded.py`` (the reference's ``Distributed.pmap``
experiment, exmpl_homogenous_box_mprocess.jl, tests/T05_2D_distributed
_particles.jl): the grid block-shards over a 2D mesh of
``torch.distributed`` ranks, the CIC deposit's halo slabs go between
neighbouring blocks, and the whole thing drives through the same
``Simulation`` as a single-device run.

On the CPU the script starts 4 ranks of itself over gloo (a 2 x 2 mesh,
``--ranks`` for another count); on a card it runs one NCCL rank in this
process (a (1, 1) mesh: the kernels K1, K4 and K3, the self-wrap folds,
the counters' all-reduces).  Rank 0 gathers the run's states; the launcher
holds the last against the same model's single-device run within rtol
2e-3 of its largest value.

Run:  python picles_torch/examples/example_04_sharded.py [--device cpu] [--ranks N]
"""

import argparse
import os
import socket
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import picles_torch as pt  # noqa: E402
from picles_torch.parallel.sharded import init_distributed  # noqa: E402

SMOKE = os.environ.get("PICLES_SMOKE") == "1"  # see tests/test_torch_examples.py
_ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
_ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
_ap.add_argument("--ranks", type=int, default=None,
                 help="ranks of the mesh (default: 1 on cuda, 4 on cpu)")
_ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
_ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
_ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
ARGS = _ap.parse_args()

DEVICE = ARGS.device
N_RANKS = ARGS.ranks or (1 if DEVICE == "cuda" else 4)
# 2D mesh factorization so both axes carry exchanges when possible
px = int(N_RANKS ** 0.5)
while N_RANKS % px:
    px -= 1
MESH = (N_RANKS // px, px)
BACKEND = "nccl" if DEVICE == "cuda" and N_RANKS == 1 else "gloo"

U10, V10, DT = 10.0, 5.0, 600.0
STOP = (3 if SMOKE else 6) * DT
nx, ny = 16 * MESH[0], 16 * MESH[1]          # a 16 x 16 block a rank


def build_model():
    grid = pt.cartesian_box(2e3 * (nx - 1), nx, 2e3 * (ny - 1), ny,
                            periodic_boundary=(True, True), device=DEVICE)
    ws = pt.FetchRelations.MinimalWindsea(U10, V10, DT)
    sett = pt.ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                          timestep=DT, total_time=6 * 3600.0, dt=1e-3,
                          dtmin=1e-4, force_dtmin=True)
    return pt.WaveGrowth2D(grid, pt.constant_winds(U10, V10), sett,
                           config=pt.WaveGrowth2DConfig(
                               periodic_boundary=True))


def run_rank(rank: int, port: int, out: str) -> None:
    """One rank: the sharded model through Simulation; rank 0 saves the
    gathered states."""
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    init_distributed(rank, N_RANKS, BACKEND, port)
    try:
        sharded = pt.ShardedWaveGrowth2D(build_model(), pt.make_mesh(MESH))
        sim = pt.Simulation.create(sharded, stop_time=STOP)
        sim.run(cash_store=True)
        n_failed = int(sim.state.metrics.n_failed)   # summed over the ranks
        if sharded.is_root:
            np.savez(out, states=sim.store.as_array(), n_failed=n_failed,
                     transport=sharded.transport)
    finally:
        dist.destroy_process_group()


def launch():
    """The ranks (this process alone for one rank), then the single-device
    run of the same model, compared."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.npz")
        if N_RANKS == 1:
            run_rank(0, port, out)
        else:
            cmd = [sys.executable, os.path.abspath(__file__), "--device",
                   DEVICE, "--ranks", str(N_RANKS), "--port", str(port),
                   "--out", out]
            procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
                     for r in range(N_RANKS)]
            for r, p in enumerate(procs):
                so, se = p.communicate(timeout=600)
                print(so, end="")
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} failed:\n{se[-4000:]}")
        z = np.load(out)
        states, n_failed = z["states"], int(z["n_failed"])
        transport = str(z["transport"])
    single = pt.Simulation.create(build_model(), stop_time=STOP)
    single.run(cash_store=True)
    ref = single.store.as_array()
    rel = float(np.abs(states[-1] - ref[-1]).max() / np.abs(ref[-1]).max())
    return states, ref, rel, n_failed, transport


if ARGS.rank is not None:
    run_rank(ARGS.rank, ARGS.port, ARGS.out)
else:
    states, ref, rel, n_failed, transport = launch()
    print(f"mesh {MESH} over {N_RANKS} {DEVICE} rank(s) ({transport}); "
          f"state {states.shape[1:]}")
    print(f"ran {len(states) - 1} steps; final mean E = "
          f"{states[-1, ..., 0].mean():.4e}; failures: {n_failed}; max rel "
          f"diff vs single-device = {rel:.2e}")
    assert np.all(np.isfinite(states))
    assert rel < 2e-3, rel
