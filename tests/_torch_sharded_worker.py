"""Worker for test_torch_sharded.py: one rank of a gloo process group that
runs the port's sharded cases (``picles_torch/parallel/sharded.py``) on the
CPU and leaves their results for the test process to compare with
``picles_tpu``.

    python _torch_sharded_worker.py <rank> <world_size> <port> <out_dir>

Every rank runs every case in the same order (the cases are collectives);
rank 0 writes one ``<case>.npz`` a case with the whole (gathered) result.
A case that raises is written to ``<case>.err`` by the rank that raised,
which then exits non-zero (the other ranks time out in their next
collective).
"""

import os
import sys
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import picles_torch as pt  # noqa: E402
from picles_torch.core import fetch_relations as FR  # noqa: E402
from picles_torch.parallel.sharded import (ShardedWaveGrowth2D,  # noqa: E402
                                           init_distributed, make_mesh)

DT = 600.0
NX, NY = 32, 24

# the seven deposit families of tests/test_sharded.py:163-171
DEPOSIT_CASES = [("periodic", 3), ("periodic", ((0, 3), (0, 3))),
                 ("nonperiodic", 3), ("nonperiodic", ((1, 3), (0, 2))),
                 ("tripolar", 3), ("tripolar", ((0, 3), (0, 3))),
                 ("tripolar", ((2, 3), (1, 3)))]
STEP_CASES = [(m, p) for p in (True, False) for m in ((8, 1), (4, 2), (2, 4))]
ASYM_MESHES = [(4, 2), (2, 4)]
# the gridded (NetCDF-like) record under the "pallas" and "xla" remeshes
GRIDDED_REMESH = ("pallas", "xla")
LAYERS = 3
LAYERED_N = 16
# the synthetic tripolar grid (64 x 48 supergrid, 32 x 24 nodes) with its
# metrics scaled by 1/100, so that particles cross cells and the seam in a
# step; ocean but for three land nodes on the top row, two of them the
# seam mirrors (x' = nx - 2 - x) of ocean nodes
TRI_SCALE = 1.0 / 100.0
TRI_LAND_X = (5, 6, 20)
TRI_HALOS = {"h03": ((0, 3), (0, 3)), "h3": 3}
TRI_STEPS = 4
# fixed substeps of 20 s: at 60 s the young sea of this northward wind
# diverges on every lane, and every lane's NaN guard reseeds it (on this
# grid and on the Cartesian box alike), which no comparison could fault
TRI_SUB = 20.0


def settings(adaptive=True, sub=1e-3, **tols):
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    return pt.ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                          timestep=DT, total_time=6 * 24 * 3600.0, dt=sub,
                          dtmin=1e-4, force_dtmin=True, adaptive=adaptive,
                          **tols)


def model(periodic=True, halo=3, sett=None, dtype=torch.float32,
          tripolar=False, winds=None, n=(NX, NY), **cfg):
    """tests/test_sharded.py's ``_model`` on the port (32 x 24 box,
    constant (10, 5) m/s winds); ``tripolar`` swaps the y boundary for the
    north seam, as that file's seam tests do; ``cfg`` more config
    entries (``layers``, the remesh)."""
    import dataclasses

    grid = pt.cartesian_box(100e3, n[0], 100e3, n[1], device="cpu",
                            dtype=dtype,
                            periodic_boundary=(periodic, periodic))
    if tripolar:
        grid = dataclasses.replace(grid, stats=dataclasses.replace(
            grid.stats, bx=pt.Boundary.PERIODIC,
            by=pt.Boundary.TRIPOLAR_NORTH))
    return pt.WaveGrowth2D(grid, winds or pt.constant_winds(10.0, 5.0),
                           sett or settings(),
                           config=pt.WaveGrowth2DConfig(
                               periodic_boundary=periodic, halo=halo,
                               dtype=dtype, **cfg))


# the solver tolerances of the gridded tests (tests/test_torch_gridded_winds
# .py ``_settings``): at the defaults the young seas of a record leave the
# controller at the edge of accepting
GRIDDED_TOLS = dict(abstol=1e-7, reltol=1e-6)


def storm_record():
    """A storm that crosses the 100 km box in x and turns through a full
    circle in 6 h over a (6, 4) m/s background, on a 12 x 10 node record
    (periodic, hourly frames): its winds change across every block edge
    of a (4, 2) mesh.  Returns (u, v, the axis keywords) as numpy arrays
    and floats, for either package's ``GriddedWinds2D``."""
    nt, nxw, nyw = 7, 12, 10
    t = np.arange(nt) * 3600.0
    x = np.arange(nxw) * (100e3 / nxw)
    y = np.arange(nyw) * (100e3 / nyw)
    T, X, Y = np.meshgrid(t, x, y, indexing="ij")
    xc = 10e3 + 80e3 * T / t[-1]
    g = np.exp(-(((X - xc) / 25e3) ** 2 + ((Y - 50e3) / 30e3) ** 2))
    phi = 2.0 * np.pi * T / t[-1]
    u = (6.0 + 10.0 * g * np.cos(phi)).astype(np.float32)
    v = (4.0 + 10.0 * g * np.sin(phi)).astype(np.float32)
    return u, v, dict(x0=0.0, dx=float(x[1]), y0=0.0, dy=float(y[1]),
                      t0=0.0, dt=3600.0, mode="wrap")


def gridded_model(remesh):
    u, v, kw = storm_record()
    gw = pt.GriddedWinds2D(u_data=torch.as_tensor(u),
                           v_data=torch.as_tensor(v), **kw)
    return model(winds=gw, sett=settings(**GRIDDED_TOLS),
                 dt_reset_mode="carry", remesh_mode=remesh)


def spherical_model():
    """tests/test_sharded.py:393-419's spherical grid (periodic lon, open
    lat) with constant (10, 5) m/s winds and fixed substeps of 60 s."""
    grid = pt.spherical_grid_2d(0.0, 40.0, NX, 30.0, 60.0, NY, device="cpu",
                                periodic_boundary=(True, False))
    return pt.WaveGrowth2D(grid, pt.constant_winds(10.0, 5.0),
                           settings(False, 60.0),
                           config=pt.WaveGrowth2DConfig(
                               periodic_boundary=False))


def tripolar_supergrid():
    """The synthetic supergrid's arrays, metrics scaled by ``TRI_SCALE``
    (numpy, for either package's ``mom6_grid_from_supergrid``)."""
    from picles_torch.grids.tripolar import synthetic_tripolar_supergrid

    X, Y, dx, dy, area, ang = synthetic_tripolar_supergrid()
    s = TRI_SCALE
    return X, Y, dx * s, dy * s, area * s * s, ang


def tripolar_mask():
    """The ocean mask: explicit, because the pole masking measures cell
    size and would mask every node of a scaled grid."""
    m = np.ones((NX, NY), dtype=bool)
    m[list(TRI_LAND_X), -1] = False
    return m


def tripolar_model(halo, sett):
    """The scaled tripolar grid under a northward (2, 10) m/s wind, as
    tests/test_full_step_oracle.py's seam oracle forces it."""
    grid = pt.mom6_grid_from_supergrid(*tripolar_supergrid(), k=2,
                                       device="cpu", mask=tripolar_mask())
    return pt.WaveGrowth2D(grid, pt.constant_winds(2.0, 10.0), sett,
                           config=pt.WaveGrowth2DConfig(
                               periodic_boundary=True, halo=halo))


def tripolar_run(halo, sett, fold=True):
    """``TRI_STEPS`` steps of the tripolar model over a (4, 2) mesh;
    ``fold=False`` leaves the seam fold out (a witness that it moves
    energy)."""
    sh = ShardedWaveGrowth2D(tripolar_model(halo, sett), make_mesh((4, 2)))
    if not fold:
        sh._fold_seam = lambda S, top: None
    return step_run(sh, TRI_STEPS)


def swell_defaults(L):
    """tests/test_layers.py's ``_swell_defaults``: L distinct swell
    systems."""
    out = []
    for k in range(L):
        ang = 2 * np.pi * k / L
        cg = 4.0 + 0.5 * k
        out.append(pt.ParticleDefaults2D(lne=float(np.log(0.002 * (k + 1))),
                                         cg_x=float(cg * np.cos(ang)),
                                         cg_y=float(cg * np.sin(ang))))
    return out


def layered_model():
    """tests/test_layers.py's ``_model(3, n=16)`` on the port."""
    return model(n=(LAYERED_N, LAYERED_N), layers=LAYERS)


def whole(sharded, ms):
    """The gathered state as numpy arrays (rank 0), else None."""
    g = sharded.gather_state(ms)
    if g is None:
        return None
    out = {"state": g.state.numpy(), "time": g.time.numpy(),
           "iteration": g.iteration.numpy()}
    out.update({f"p_{k}": getattr(g.particles, k).numpy()
                for k in pt.convert.PARTICLE_FIELDS})
    out.update({f"m_{k}": np.asarray(v)
                for k, v in g.metrics.as_dict().items()})
    return out


def deposit_case(i):
    boundary, halo = DEPOSIT_CASES[i]
    m = model(periodic=boundary == "periodic", halo=halo,
              tripolar=boundary == "tripolar")
    sh = ShardedWaveGrowth2D(m, make_mesh((4, 2)))
    rng = np.random.default_rng(42)
    (xl, xh), (yl, yh) = pt.ops.pic.normalize_halo(halo)
    xr = rng.uniform(-xl, xh - 0.1, (NX, NY)).astype(np.float32)
    yr = rng.uniform(-yl, yh - 0.1, (NX, NY)).astype(np.float32)
    ch = rng.uniform(0.1, 1.0, (NX, NY, 3)).astype(np.float32)
    act = rng.random((NX, NY)) > 0.1
    sx, sy = sh._slices

    def blk(a):
        return torch.as_tensor(np.ascontiguousarray(a[sx, sy]))

    planes, st = sh._scatter_sharded(
        blk(xr), blk(yr), tuple(blk(ch[..., c]) for c in range(3)), blk(act))
    S = sh.gather_blocks(torch.stack(planes, dim=-1))
    if S is None:
        return None
    return dict(S=S.numpy(), xr=xr, yr=yr, ch=ch, act=act)


def step_run(sh, n=3, ms=None):
    ms = sh.init_state() if ms is None else ms
    for _ in range(n):
        ms = sh.step(ms)
    return whole(sh, ms)


def layered_run():
    """Two layered steps of the swell systems over a (4, 2) mesh."""
    m = layered_model()
    sh = ShardedWaveGrowth2D(m, make_mesh((4, 2)))
    return step_run(sh, 2, sh.shard_state(
        m.init_state_layers(swell_defaults(LAYERS))))


def simulation_case(out_dir):
    """Simulation.run over the sharded model with a CashStore, then a
    checkpoint, a resume and the uninterrupted run it must equal."""
    sh = ShardedWaveGrowth2D(model(), make_mesh((4, 2)))
    sim = pt.Simulation.create(sh, stop_time=1800.0)
    sim.run(cash_store=True)
    frames = sim.store.store
    quiet = pt.Simulation.create(sh, stop_time=1800.0)
    quiet.run()
    ck = quiet.checkpoint(os.path.join(out_dir, "sharded_ck"))
    rest = pt.Simulation.create(sh, stop_time=3600.0)
    rest.pickup(ck)
    rest.run()
    full = pt.Simulation.create(sh, stop_time=3600.0)
    full.run()
    parts = {"quiet": whole(sh, quiet.state), "resumed": whole(sh, rest.state),
             "full": whole(sh, full.state)}
    if parts["quiet"] is None:
        if frames:
            raise AssertionError("a rank other than 0 wrote the store")
        return None
    out = dict(frames=np.stack(frames), ck=np.asarray(ck))
    for tag, d in parts.items():
        out.update({f"{tag}_{k}": v for k, v in d.items()})
    return out


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    init_distributed(rank, world, "gloo", port, timeout_s=120.0)
    cases = [(f"deposit_{i}", lambda i=i: deposit_case(i))
             for i in range(len(DEPOSIT_CASES))]
    cases += [(f"step_{m[0]}x{m[1]}_{'periodic' if p else 'open'}",
               lambda m=m, p=p: step_run(ShardedWaveGrowth2D(
                   model(periodic=p), make_mesh(m))))
              for m, p in STEP_CASES]
    cases += [(f"asym_{m[0]}x{m[1]}",
               lambda m=m: step_run(ShardedWaveGrowth2D(
                   model(halo=((1, 3), (0, 2))), make_mesh(m))))
              for m in ASYM_MESHES]
    cases += [("tripolar_fixed", lambda: step_run(ShardedWaveGrowth2D(
        model(halo=((0, 3), (0, 3)), sett=settings(False, 60.0),
              tripolar=True), make_mesh((4, 2)))))]
    cases += [("fixed_f64", lambda: step_run(ShardedWaveGrowth2D(
        model(sett=settings(False, 60.0), dtype=torch.float64,
              winds=pt.half_domain_winds(10.0, 5.0, 50e3)),
        make_mesh((4, 2)))))]
    cases += [(f"gridded_{r}", lambda r=r: step_run(ShardedWaveGrowth2D(
        gridded_model(r), make_mesh((4, 2)))))
              for r in GRIDDED_REMESH]
    cases += [("sphere_fixed", lambda: step_run(ShardedWaveGrowth2D(
        spherical_model(), make_mesh((4, 2)))))]
    cases += [(f"tripolar_grid_{tag}",
               lambda h=h: tripolar_run(h, settings(False, TRI_SUB)))
              for tag, h in TRI_HALOS.items()]
    cases += [("tripolar_grid_nofold", lambda: tripolar_run(
        TRI_HALOS["h03"], settings(False, TRI_SUB), fold=False))]
    cases += [("tripolar_adaptive", lambda: tripolar_run(
        TRI_HALOS["h03"], settings(**GRIDDED_TOLS)))]
    cases += [("layered", layered_run)]
    cases += [("simulation", lambda: simulation_case(out_dir))]
    for name, run in cases:
        try:
            out = run()
        except Exception:
            with open(os.path.join(out_dir, f"{name}.err"), "a") as f:
                f.write(f"rank {rank}:\n{traceback.format_exc()}")
            raise
        if out is not None:
            np.savez(os.path.join(out_dir, f"{name}.npz"), **out)
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: ok", flush=True)


if __name__ == "__main__":
    main()
