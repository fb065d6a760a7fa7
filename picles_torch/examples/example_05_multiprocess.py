"""Multi-PROCESS run on the PyTorch port: 2 real OS processes, one mesh —
the counterpart of ``examples/example_05_multiprocess.py``.

The reference ships an experimental multi-process script
(`examples/exmpl_homogenous_box_mprocess.jl`: `Distributed.addprocs` +
`pmap(advance_wrap, workers, ParticleCollection)` with a SharedArray
State).  Here every process is one ``torch.distributed`` rank of a gloo
group, owns one block of a (2, 1) mesh and steps it with
``ShardedWaveGrowth2D``; the step's halo exchange goes between the
processes.  No SharedArray: each process only ever touches its own block.

This script is self-launching: run it with no arguments and it spawns 2
rank copies of itself (on the CPU, or both sharing one card over gloo with
``--device cuda``), waits for both, then reassembles their block dumps into
the global field and compares it against a single-process run of the
identical model within rtol 2e-3 of its largest value.

Run:  python picles_torch/examples/example_05_multiprocess.py [--device cpu]
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

SMOKE = os.environ.get("PICLES_SMOKE") == "1"  # see tests/test_torch_examples.py
_ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
_ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
_ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
_ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
_ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
ARGS = _ap.parse_args()

N_STEPS = 3 if SMOKE else 12
NX = NY = 32
DT, U10, V10 = 600.0, 10.0, 5.0
MESH = (2, 1)


def _build_model():
    import picles_torch as pt

    ws = pt.FetchRelations.MinimalWindsea(U10, V10, DT)
    sett = pt.ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                          timestep=DT, total_time=6 * 3600.0, dt=1e-3,
                          dtmin=1e-4, force_dtmin=True)
    grid = pt.cartesian_box(2e3 * (NX - 1), NX, 2e3 * (NY - 1), NY,
                            periodic_boundary=(True, True), device=ARGS.device)
    return pt.WaveGrowth2D(grid, pt.constant_winds(U10, V10), sett,
                           config=pt.WaveGrowth2DConfig(
                               periodic_boundary=True))


def _worker(rank: int, port: int, out_path: str) -> None:
    """One of 2 processes: block ``rank`` of the (2, 1) mesh."""
    import torch.distributed as dist

    import picles_torch as pt
    from picles_torch.parallel.sharded import block_slices, init_distributed

    init_distributed(rank, 2, "gloo", port)
    try:
        mesh = pt.make_mesh(MESH)
        sharded = pt.ShardedWaveGrowth2D(_build_model(), mesh)
        ms = sharded.init_state()      # every rank seeds, keeps its block
        for _ in range(N_STEPS):
            ms = sharded.step(ms)      # halo slabs cross the processes
        sx, sy = block_slices(MESH, NX, NY, *mesh.coords(rank))
        np.savez(out_path, data=ms.state.cpu().numpy(),
                 x0=np.array([sx.start, sy.start]),
                 n_active=np.array(int(ms.metrics.n_active)))   # summed
        print(f"[rank {rank}] block at ({sx.start}, {sy.start}), "
              f"{sharded.transport}, global n_active="
              f"{int(ms.metrics.n_active)}", flush=True)
    finally:
        dist.destroy_process_group()


def _launch():
    """Parent: spawn 2 ranks, reassemble the global field, cross-check."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="picles_mp_") as tmp:
        outs = [os.path.join(tmp, f"w{i}.npz") for i in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--device",
             ARGS.device, "--rank", str(r), "--port", str(port), "--out",
             outs[r]], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(2)]
        for r, p in enumerate(procs):
            so, se = p.communicate(timeout=600)
            print(so, end="")
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} failed:\n{se[-4000:]}")

        # reassemble the global [NX, NY, 3] field from both blocks
        field = np.full((NX, NY, 3), np.nan, np.float32)
        n_active = None
        for path in outs:
            z = np.load(path)
            d, (x0, y0) = z["data"], z["x0"]
            field[x0:x0 + d.shape[0], y0:y0 + d.shape[1]] = d
            n_active = int(z["n_active"])
    assert np.isfinite(field).all(), "blocks did not tile the global grid"

    # single-process cross-check (the same model, the same horizon)
    model = _build_model()
    dense = model.init_state()
    for _ in range(N_STEPS):
        dense = model.step(dense)
    ref = dense.state.cpu().numpy()
    rel = np.abs(field - ref).max() / max(np.abs(ref).max(), 1e-30)
    print(f"2 processes, {N_STEPS} steps on {NX}x{NY}: "
          f"mean E = {field[..., 0].mean():.4e}, n_active = {n_active}, "
          f"max rel diff vs single-process = {rel:.2e}")
    assert rel < 2e-3, rel
    return field, ref, n_active


if ARGS.rank is not None:
    _worker(ARGS.rank, ARGS.port, ARGS.out)
else:
    field, ref, n_active = _launch()
