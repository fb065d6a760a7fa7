#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from: the port's numbers
over many seeds, and the control's.

    python3 wavebench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--witness-seeds 1,2,3] [--seconds 4] \\
        [--out readings.json]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load (long enough that the job drawn from the seed finishes),
then the plain reference over the compared member-days, as a run does
(``compare.state_gaps``, ``compare.guarantees``).  For each control seed,
the family's control as well (for ``wave_growth_2d`` the reference with its
state rounded to bfloat16 after every step), in the port's place, against
the reference, on the first compared member-day.  For each witness seed,
the family's witness: the reference against itself from the member moved
by one ulp, how far the configuration itself carries a last-ulp difference
over a member-day.  The grid is built once.  Prints one JSON object of the
readings, each seed's and their largest (the port's, the witness's) and
smallest (the control's)."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GAPS = ("gap_l2", "gap_max", "gap_share")


def readings(cell, win, control: bool, witness: bool) -> dict:
    from wavebench import compare

    fam = cell.family
    g = compare.guarantees(win["finals"], cell.steps, cell.DT)
    ref = cell.reference_model()
    pool = list(cell.members(ref))
    out = dict(jobs=len(win["jobs"]), clock=g["clock"], failed=g["failed"],
               clamped=g["clamped"], port=[], control=[], witness=[])
    for n, (j, state) in enumerate(sorted(win["kept"].items())):
        member = pool[j % len(pool)]
        r, counts = ref.run(member, cell.steps)
        out["port"].append(dict(job=j, **compare.state_gaps(
            *fam.compared(state, r)), ref_clamped=counts["n_clamped"],
            ref_failed=counts["n_failed"]))
        for on, side, key in ((control, fam.control, "control"),
                              (witness, fam.witness, "witness")):
            if on and n == 0:
                got = side(ref, member, cell.steps)
                out[key].append(dict(job=j, **compare.state_gaps(
                    fam.final(got), fam.final(r))))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    from wavebench.harness import Bench, Cell

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    witnesses = {int(s) for s in args.witness_seeds.split(",") if s}
    bench = Bench()
    grids = None
    per_seed = {}
    for seed in seeds + sorted((controls | witnesses) - set(seeds)):
        t0 = time.perf_counter()
        cell = Cell(bench, args.workload, seed, "cuda")
        if grids is None:
            grids = cell.grids()
        cell.grids = lambda: grids
        cell.setup(0.0)
        win = cell.window(args.seconds)
        cell.release()
        per_seed[seed] = readings(cell, win, seed in controls,
                                  seed in witnesses)
        per_seed[seed]["seconds"] = time.perf_counter() - t0
        print(f"calibrate: seed {seed}: {json.dumps(per_seed[seed])}",
              file=sys.stderr, flush=True)
    port = [r for s in seeds for r in per_seed[s]["port"]]
    ctrl = [r for s in controls for r in per_seed[s]["control"]]
    wit = [r for s in witnesses for r in per_seed[s]["witness"]]
    summary = dict(
        workload=args.workload, device=torch.cuda.get_device_name(0),
        seeds=seeds, control_seeds=sorted(controls),
        witness_seeds=sorted(witnesses),
        port_max={k: max(r[k] for r in port) for k in GAPS},
        control_min=({k: min(r[k] for r in ctrl) for k in GAPS}
                     if ctrl else None),
        witness_max=({k: max(r[k] for r in wit) for k in GAPS}
                     if wit else None),
        guarantees_max={k: max(per_seed[s][k] for s in seeds)
                        for k in ("clock", "failed", "clamped")},
        per_seed=per_seed)
    text = json.dumps(summary)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
