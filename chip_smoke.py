#!/usr/bin/env python3
"""Drive the PyTorch port's WaveGrowth2D step once on one NVIDIA card.

    python3 chip_smoke.py [--out results.json] [--profile profile.json]

Builds the CUDA kernels of ``picles_torch/csrc/`` (nvcc, sm_90a), checks
each against its plain PyTorch version on the card, runs the flagship
configuration (1536^2, bosh3, carried dt, halo ((0,3),(0,3))) and the
default one (tsit5, Hairer dt reset) through ``WaveGrowth2D`` with launch
counters proving that the main path went through the kernels, matches a
small run on the card against the same model on the CPU, and times the
kernels and the step beside their plain versions.  ``--profile`` adds a
trace of the step's time at full size (step times, host enqueue time,
device busy time and idle share, device time by kernel).

Every phase asserts; any failure exits non-zero.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their launches, errors and times.  Without a CUDA
device the script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from picles_torch import (Boundary, GridStats, ODEParameters, ODESettings,
                          TermFlags, WaveGrowth2D, WaveGrowth2DConfig,
                          cartesian_box, constant_winds, time_cosine_winds)
from picles_torch.core import fetch_relations as FR
from picles_torch.ops import cuda_build
from picles_torch.ops.advance_cuda import advance_cuda, auto_dt_cuda
from picles_torch.ops.pic import scatter_dense
from picles_torch.ops.pic_cuda import pic_gather
from picles_torch.ops.rhs import RHSParams, make_rhs, make_rhs_consts
from picles_torch.ops.tsit5 import SolverConfig, auto_dt, integrate_to

FLAG_N = 1536
DT = 600.0


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def max_abs(a, b) -> float:
    d = (a.double() - b.double()).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def assert_close(what: str, a, b, rtol: float, atol: float) -> float:
    """torch.allclose with NaN == NaN; returns the max absolute error."""
    assert a.shape == b.shape, f"{what}: shapes {a.shape} vs {b.shape}"
    ok = torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True)
    err = max_abs(a, b)
    if not bool(ok.all()):
        i = int((~ok).reshape(-1).nonzero()[0])
        raise AssertionError(
            f"{what}: {int((~ok).sum())} of {ok.numel()} differ beyond "
            f"rtol={rtol} atol={atol}; first at {i}: "
            f"{float(a.reshape(-1)[i])} vs {float(b.reshape(-1)[i])}; "
            f"max abs err {err:.3e}")
    return err


def assert_adaptive(what: str, k, p, rtol: float = 5e-3, atol: float = 1e-4,
                    min_share: float = 0.99, loose: float = 0.1,
                    loose_atol: float = 1e-3) -> float:
    """Adaptive-mode check.  The error controller turns last-ulp differences
    into different accept/reject sequences, and on a few lanes of a
    perturbed state such sequences end more than ``rtol`` apart (the float32
    plain version and a float64 run of it do too: up to 4% in lne, measured
    on the CPU).  So: at least ``min_share`` of the lanes agree to ``rtol``,
    and every lane to ``loose`` (``loose_atol`` for values near zero, such
    as positions in cells).  Returns the max abs error."""
    near = torch.isclose(k, p, rtol=rtol, atol=atol, equal_nan=True)
    share = float(near.float().mean())
    ok = torch.isclose(k, p, rtol=loose, atol=loose_atol, equal_nan=True)
    if share < min_share or not bool(ok.all()):
        raise AssertionError(
            f"{what}: {share:.4%} of lanes within rtol {rtol} (need "
            f"{min_share:.0%}), {int((~ok).sum())} beyond rtol {loose}; "
            f"max abs err {max_abs(k, p):.3e}")
    return max_abs(k, p)


def assert_controller(what: str, k, p, active, min_share: float = 0.95,
                      max_bias: float = 1e-2) -> str:
    """Adaptive-mode rule for the error controller's outputs, the accepted
    substep count ``naccept`` and the step-size proposal ``dt``.  A lane
    whose last substep was shortened to land on ``t_end`` has an error
    estimate at float32 rounding, so its proposal is rounding noise (for
    tsit5 only about half the lanes agree to 5e-3, measured on the card), and
    a few lanes take another substep path.  Rounding has no sign, a wrong
    controller has: at least ``min_share`` of the active lanes take as many
    substeps, and the mean of log(dt_kernel / dt_plain) over them is within
    ``max_bias`` of 0.  On the card the kernel keeps 96.0-99.997% of the
    lanes on the plain version's count with |bias| <= 9.3e-4; a host build
    of the kernel with the safety factor 0.85 for 0.9 (count share 72-83%),
    the growth clip 8 for 10 (bias -3.8e-2 to -5.4e-2) or the reject-branch
    floor 0.3 for 0.2 (tsit5 count share 36-54%) fails.  Returns a summary
    for the log."""
    a = active & ~p.failed
    share = float((k.naccept[a] == p.naccept[a]).double().mean())
    bias = float(torch.log(k.dt[a].double() / p.dt[a].double()).mean())
    if share < min_share or not abs(bias) <= max_bias:
        raise AssertionError(
            f"{what}: naccept equal on {share:.4%} of active lanes (need "
            f"{min_share:.0%}), mean log dt ratio {bias:+.3e} (bound "
            f"{max_bias:g})")
    return (f"naccept equal on {share:.4%}, mean log dt ratio {bias:+.3e}, "
            f"max |naccept diff| {int((k.naccept - p.naccept).abs().max())}")


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def settings(solver: str):
    ws = FR.MinimalWindsea(10.0, 10.0, DT)
    return ODESettings(log_energy_minimum=float(ws.lne), saving_step=DT,
                       timestep=DT, total_time=6 * 24 * 3600.0, dt=1e-3,
                       dtmin=1e-4, force_dtmin=True, solver=solver)


def flagship_model(n: int, device, solver="bosh3", dt_reset_mode="carry",
                   **modes):
    """bench.py's production configuration on the port: 2 km spacing,
    periodic box, constant (10, 10) m/s winds, directional halo."""
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                         periodic_boundary=(True, True), device=device)
    cfg = WaveGrowth2DConfig(periodic_boundary=True,
                             dt_reset_mode=dt_reset_mode,
                             halo=((0, 3), (0, 3)), **modes)
    return WaveGrowth2D(grid, constant_winds(10.0, 10.0), settings(solver),
                        config=cfg)


def default_model(n: int, device, **modes):
    """The package default (tsit5, Hairer dt reset, halo 3) on the same
    box."""
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                         periodic_boundary=(True, True), device=device)
    return WaveGrowth2D(grid, constant_winds(10.0, 10.0), settings("tsit5"),
                        config=WaveGrowth2DConfig(periodic_boundary=True,
                                                  **modes))


def perturbed_state(n: int, device, seed: int):
    """Windsea seeds of (10, 10) m/s winds plus a numpy-seeded perturbation;
    returns (comps, dt, active, grid)."""
    rng = np.random.default_rng(seed)
    grid = cartesian_box(2e3 * (n - 1), n, 2e3 * (n - 1), n,
                         periodic_boundary=(True, True), device=device)
    ws = FR.get_initial_windsea(torch.full((n, n), 10.0, device=device),
                                torch.full((n, n), 10.0, device=device), DT)

    def noise(fn, *a):
        return torch.as_tensor(fn(*a, (n, n)).astype(np.float32),
                               device=device)

    lne = (ws.lne + noise(rng.normal, 0.0, 0.05)).contiguous()
    cgx = (ws.cg_bar_x * noise(rng.uniform, 0.95, 1.05)).contiguous()
    cgy = (ws.cg_bar_y * noise(rng.uniform, 0.95, 1.05)).contiguous()
    px = noise(rng.uniform, -0.3, 0.3)
    py = noise(rng.uniform, -0.3, 0.3)
    dt = noise(rng.uniform, 10.0, 120.0)
    active = torch.as_tensor(rng.uniform(size=(n, n)) < 0.95, device=device)
    return (lne, cgx, cgy, px, py), dt, active, grid


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log("device", f"{name} | nvidia-smi: {smi} | torch {torch.__version__} "
                  f"cuda {torch.version.cuda} | count "
                  f"{torch.cuda.device_count()}")
    return name, smi


def phase_build():
    res = cuda_build.build()
    cuda_build.library()
    lines = res.log.splitlines()
    regs = sorted({ln.split(":", 1)[1].strip() for ln in lines
                   if "registers" in ln})
    n_double = sum("double precision" in ln for ln in lines)
    bad = cuda_build.unexpected_double_ops()
    log("build", f"{res.seconds:.1f} s ({res.path.parent.name}); ptxas: "
                 f"{' | '.join(regs)}; float64 PTX lines: {n_double} "
                 f"warned, all in the cosf argument reduction")
    assert not bad, f"float64 in the kernels' own code: {bad[:5]}"
    return res


def phase_k1_k3(dev, results):
    """K1 and K3 against integrate_to / auto_dt on the card."""
    params, cid, _ = ODEParameters.create()
    consts = make_rhs_consts(gamma=cid.gamma, constants=cid, params=params)
    flags = TermFlags()
    comps, dt0, active, grid = perturbed_state(256, dev, seed=0)
    proj = (float(grid.proj[0, 0, 0, 0]), 0.0, 0.0,
            float(grid.proj[0, 0, 1, 1]), 0.0)
    aux = RHSParams(x=grid.x, y=grid.y, M=grid.proj, pc=grid.pc)
    k1_err = k3_err = 0.0
    cases = []
    for wname, winds in (("constant", constant_winds(10.0, 10.0)),
                         ("time-cosine",
                          time_cosine_winds(10.0, 5.0, period=6 * 3600.0))):
        for method in ("bosh3", "tsit5"):
            for adaptive in (False, True):
                cases.append((wname, winds, method, adaptive, 0.0))
    cases.append(("constant", constant_winds(10.0, 10.0), "bosh3", True,
                  2.0 ** 19))
    cases.append(("constant", constant_winds(10.0, 10.0), "tsit5", False,
                  2.0 ** 19))
    for wname, winds, method, adaptive, t0v in cases:
        cfg = SolverConfig(method=method, adaptive=adaptive, dtmin=1e-4,
                           force_dtmin=True)
        t = torch.full_like(comps[0], t0v)
        dt = dt0 if adaptive else torch.full_like(dt0, 37.5)
        k = advance_cuda(winds, consts, flags, cfg, DT, comps, t, dt, active,
                         grid.x, grid.y, proj)
        rhs = make_rhs(winds.u, winds.v, consts, flags)
        p = integrate_to(rhs, torch.stack(comps, dim=-1), t, t + DT, dt, aux,
                         active, cfg)
        torch.cuda.synchronize()
        tag = f"K1 {wname} {method} {'adaptive' if adaptive else 'fixed'} t0={t0v:g}"
        names = ("lne", "cgx", "cgy", "x", "y")
        extra = ""
        if adaptive:
            assert torch.equal(k.failed, p.failed), f"{tag}: failed differs"
            errs = [assert_adaptive(f"{tag} {nm}", kz, p.z[..., i])
                    for i, (nm, kz) in enumerate(zip(names, k[:5]))]
            assert_close(f"{tag} t", k.t, p.t, 1e-6, 0.0)
            extra = "; " + assert_controller(tag, k, p, active)
        else:
            errs = [assert_close(f"{tag} {nm}", kz, p.z[..., i], 1e-5, 1e-6)
                    for i, (nm, kz) in enumerate(zip(names, k[:5]))]
            errs.append(assert_close(f"{tag} t", k.t, p.t, 1e-6, 0.0))
            assert torch.equal(k.dt, p.dt), f"{tag}: dt not carried as given"
            assert torch.equal(k.failed, p.failed), f"{tag}: failed differs"
            assert torch.equal(k.naccept, p.naccept), f"{tag}: naccept differs"
            k1_err = max(k1_err, max(errs))
        nfail = int(k.failed.sum())
        log("K1", f"{tag}: max abs err {max(errs):.3e}, substeps max "
                  f"{int(k.naccept.max())}/{int(p.naccept.max())}, "
                  f"failed {nfail}{extra}")
        if t0v > 0:
            assert nfail == 0, f"{tag}: lanes failed at t = 2^19 s"

    for wname, winds in (("constant", constant_winds(10.0, 10.0)),
                         ("time-cosine",
                          time_cosine_winds(10.0, 5.0, period=6 * 3600.0))):
        for order in (3.0, 5.0):
            t = torch.full_like(comps[0], 1800.0)
            k = auto_dt_cuda(winds, consts, flags, t, comps, grid.x, grid.y,
                             proj, order=order)
            p = auto_dt(make_rhs(winds.u, winds.v, consts, flags), t,
                        torch.stack(comps, dim=-1), aux, order=order)
            err = assert_close(f"K3 {wname} order {order:g}", k, p, 1e-5, 0.0)
            k3_err = max(k3_err, err)
            log("K3", f"{wname} order {order:g}: max abs err {err:.3e}")
    results["K1"]["max_abs_err"] = k1_err
    results["K3"]["max_abs_err"] = k3_err


def phase_k2(dev, results):
    """K2 against scatter_dense at 1536^2."""
    rng = np.random.default_rng(1)
    n = FLAG_N
    k2_err = 0.0
    cases = [(True, ((0, 3), (0, 3)), (-0.2, 3.2)),
             (True, 3, (-3.2, 3.2)),
             (False, ((1, 2), (2, 1)), (-2.2, 2.2))]
    for periodic, halo, (lo, hi) in cases:
        b = Boundary.PERIODIC if periodic else Boundary.NONPERIODIC
        stats = GridStats(nx=n, ny=n, bx=b, by=b)

        def plane(fn, *a):
            return torch.as_tensor(fn(*a, (n, n)).astype(np.float32),
                                   device=dev)

        xr, yr = plane(rng.uniform, lo, hi), plane(rng.uniform, lo, hi)
        chans = (plane(rng.uniform, 0.0, 1.0), plane(rng.normal, 0.0, 0.1),
                 plane(rng.normal, 0.0, 0.1))
        act = torch.as_tensor(rng.uniform(size=(n, n)) < 0.9, device=dev)
        (o, st) = pic_gather(xr, yr, chans, act, stats, halo)
        (o2, st2) = pic_gather(xr, yr, chans, act, stats, halo)
        S, st_p = scatter_dense(xr, yr, torch.stack(chans, dim=-1), act,
                                stats, halo)
        torch.cuda.synchronize()
        tag = f"K2 {'periodic' if periodic else 'open'} halo {halo}"
        for c in range(3):
            scale = float(S[..., c].abs().max())
            k2_err = max(k2_err, assert_close(f"{tag} ch{c}", o[c], S[..., c],
                                              1e-5, 1e-6 * scale))
            assert torch.equal(o[c], o2[c]), f"{tag}: two runs differ"
        assert int(st.clamped) == int(st_p.clamped), \
            f"{tag}: clamped {int(st.clamped)} vs {int(st_p.clamped)}"
        if periodic:
            src = float((chans[0].double() * act).sum())
            dep = float(o[0].double().sum())
            assert abs(dep - src) <= 1e-5 * abs(src), \
                f"{tag}: E not conserved ({dep} vs {src})"
        log("K2", f"{tag}: max abs err {k2_err:.3e}, clamped "
                  f"{int(st.clamped)}, bitwise repeatable")
        if halo == ((0, 3), (0, 3)):
            results["K2"]["ms"] = cuda_time_ms(
                lambda: pic_gather(xr, yr, chans, act, stats, halo), 20)
            results["K2"]["plain_ms"] = cuda_time_ms(
                lambda: scatter_dense(xr, yr, torch.stack(chans, dim=-1), act,
                                      stats, halo), 5)
    results["K2"]["max_abs_err"] = k2_err


def counters():
    return {"K1": advance_cuda.launches, "K2": pic_gather.launches,
            "K3": auto_dt_cuda.launches}


def reset_counters():
    advance_cuda.launches = pic_gather.launches = auto_dt_cuda.launches = 0


def time_steps(model, ms, n_steps: int):
    """Run ``n_steps`` steps; returns (state, device ms per step)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ms = model.step_n_quiet(ms, n_steps)
    end.record()
    torch.cuda.synchronize()
    return ms, start.elapsed_time(end) / n_steps


def check_state(tag: str, ms, **expect):
    assert bool(torch.isfinite(ms.state).all()), f"{tag}: state not finite"
    m = ms.metrics.as_dict()
    for k, v in expect.items():
        assert m[k] == v, f"{tag}: {k} = {m[k]}, expected {v}"
    return m


def phase_main_path(dev, results, timing):
    """Flagship then default config through WaveGrowth2D, counters reset
    just before and read just after."""
    n = FLAG_N
    flag = flagship_model(n, dev)
    default = default_model(n, dev)
    assert flag.resolved_config().advance_mode == "cuda"
    assert flag.resolved_config().scatter_mode == "dense_cuda"
    s_flag, s_def = flag.init_state(), default.init_state()

    reset_counters()
    s_flag = flag.step_n_quiet(s_flag, 4)
    m = check_state("flagship spin-up", s_flag, n_failed=0, n_clamped=0)
    c0 = counters()
    assert c0["K1"] == 4 and c0["K2"] == 4 and c0["K3"] == 0, c0
    steps = 20
    s_flag, ms_step = time_steps(flag, s_flag, steps)
    m = check_state("flagship", s_flag, n_failed=0, n_clamped=0)
    c1 = counters()
    assert c1["K1"] - c0["K1"] == steps and c1["K2"] - c0["K2"] == steps, c1
    timing["flagship_ms_per_step"] = ms_step
    timing["flagship_pushes_per_s"] = n * n / (ms_step / 1e3)
    log("flagship", f"{n}^2 bosh3 carry: {ms_step:.3f} ms/step, "
                    f"{n * n / (ms_step / 1e3):.4e} pushes/s; metrics {m}")

    d_steps = 3
    s_def, ms_def = time_steps(default, s_def, d_steps)
    m = check_state("default", s_def, n_failed=0)
    c2 = counters()
    assert c2["K1"] - c1["K1"] == d_steps and c2["K2"] - c1["K2"] == d_steps
    assert c2["K3"] > 0, "the default config did not launch K3"
    timing["default_ms_per_step"] = ms_def
    timing["default_pushes_per_s"] = n * n / (ms_def / 1e3)
    log("default", f"{n}^2 tsit5 auto-dt: {ms_def:.3f} ms/step (first "
                   f"{d_steps} steps from seed), {n * n / (ms_def / 1e3):.4e} "
                   f"pushes/s; metrics {m}")
    for k in ("K1", "K2", "K3"):
        results[k]["launches"] = c2[k]
        assert c2[k] > 0, f"{k} was not launched on the main path"
    log("counters", f"main path launches {c2}")
    return flag, s_flag, default, s_def


def phase_card_vs_cpu():
    """64^2: kernels on the card against the plain versions on the CPU."""
    for name, mk in (("flagship", flagship_model), ("default", default_model)):
        mg, mc = mk(64, "cuda"), mk(64, "cpu")
        assert mc.resolved_config().advance_mode == "torch"
        sg, sc = mg.init_state(), mc.init_state()
        for _ in range(3):
            sg, sc = mg.step(sg), mc.step(sc)
        S = sc.state
        err = assert_close(f"card vs CPU {name}", sg.state.cpu(), S, 5e-3,
                           1e-6 * float(S.abs().max()))
        assert_close(f"card vs CPU {name} dt", sg.particles.dt.cpu(),
                     sc.particles.dt, 5e-3, 0.0)
        mg_, mc_ = sg.metrics.as_dict(), sc.metrics.as_dict()
        assert mg_ == mc_, f"card vs CPU {name}: counters {mg_} vs {mc_}"
        log("card-vs-cpu", f"{name} 64^2, 3 steps: max abs err {err:.3e}")


def phase_kernel_times(flag, s_flag, default, s_def, results):
    """K1 and K3 at the main path's shape (FLAG_N^2) on its own states: held
    against their plain versions, then timed beside them."""
    P = s_flag.particles
    adv = P.on & flag.active_mask
    comps = (P.lne, P.cgx, P.cgy, P.px, P.py)
    g = flag.grid

    def k1():
        return advance_cuda(flag.winds, flag.consts, flag.flags, flag.solver,
                            DT, comps, P.t, P.dt, adv, g.x, g.y,
                            flag.uniform_proj)

    def k1_plain():
        return integrate_to(flag.rhs, torch.stack(comps, dim=-1), P.t,
                            P.t + DT, P.dt, flag.aux, adv, flag.solver)

    k, p = k1(), k1_plain()
    # the main path's own state, one substep per lane: every lane on the
    # plain version's path, and its outputs to float32 rounding
    assert torch.equal(k.failed, p.failed), "K1 main-path state: failed differs"
    assert torch.equal(k.naccept, p.naccept), \
        "K1 main-path state: naccept differs"
    err = max(assert_close(f"K1 flagship state {nm}", kz, p.z[..., i], 1e-5,
                           1e-6)
              for i, (nm, kz) in enumerate(zip(("lne", "cgx", "cgy", "x", "y"),
                                               k[:5])))
    # the proposal dt = 600 s * 0.9 * enorm^(-1/3), unclipped here; enorm is
    # a sum of stage derivatives that cancel, so last-ulp differences in them
    # move it by ~5e-4 and dt by ~1.6e-4 (measured on the card); a safety
    # factor or exponent off by a few percent moves dt by as much
    err_dt = assert_close("K1 flagship state dt", k.dt, p.dt, 1e-3, 0.0)
    assert_close("K1 flagship state t", k.t, p.t, 1e-6, 0.0)
    log("K1", f"{FLAG_N}^2 flagship state (bosh3 adaptive): max abs err "
              f"{err:.3e}, dt {err_dt:.3e} (dt {float(p.dt.min()):.2f}-"
              f"{float(p.dt.max()):.2f} s), naccept equal on every lane "
              f"({int(p.naccept.min())}-{int(p.naccept.max())})")
    results["K1"]["max_abs_err"] = max(results["K1"]["max_abs_err"], err)
    results["K1"]["ms"] = cuda_time_ms(k1, 10)
    results["K1"]["plain_ms"] = cuda_time_ms(k1_plain, 2)

    Q = s_def.particles
    qc = (Q.lne, Q.cgx, Q.cgy, Q.px, Q.py)
    sett = default.settings

    def k3():
        return auto_dt_cuda(default.winds, default.consts, default.flags,
                            Q.t, qc, g.x, g.y, default.uniform_proj,
                            abstol=sett.abstol, reltol=sett.reltol, order=5.0)

    def k3_plain():
        return auto_dt(default.rhs, Q.t, torch.stack(qc, dim=-1),
                       default.aux, abstol=sett.abstol, reltol=sett.reltol,
                       order=5.0)

    # K1 on the default config's state (tsit5, several substeps per lane).
    # Its last substep is shortened to land on t_end, so the proposal dt is
    # rounding noise on this uniform state (the config replaces it by K3's
    # estimate on every reset lane): the substep counts and the components
    # are held, dt is not
    q_adv = Q.on & default.active_mask
    k = advance_cuda(default.winds, default.consts, default.flags,
                     default.solver, DT, qc, Q.t, Q.dt, q_adv, g.x, g.y,
                     default.uniform_proj)
    p = integrate_to(default.rhs, torch.stack(qc, dim=-1), Q.t, Q.t + DT,
                     Q.dt, default.aux, q_adv, default.solver)
    assert torch.equal(k.failed, p.failed), "K1 default state: failed differs"
    errs = [assert_adaptive(f"K1 default state {nm}", kz, p.z[..., i])
            for i, (nm, kz) in enumerate(zip(("lne", "cgx", "cgy", "x", "y"),
                                             k[:5]))]
    share = float((k.naccept == p.naccept).double().mean())
    assert share >= 0.95, f"K1 default state: naccept equal on {share:.4%}"
    log("K1", f"{FLAG_N}^2 default state (tsit5 adaptive): max abs err "
              f"{max(errs):.3e}; naccept equal on {share:.4%} "
              f"({int(p.naccept.min())}-{int(p.naccept.max())}); dt max abs "
              f"err {max_abs(k.dt, p.dt):.3e}")

    err = assert_close("K3 default state", k3(), k3_plain(), 1e-5, 0.0)
    log("K3", f"{FLAG_N}^2 default state: max abs err {err:.3e}")
    results["K3"]["max_abs_err"] = max(results["K3"]["max_abs_err"], err)
    results["K3"]["ms"] = cuda_time_ms(k3, 20)
    results["K3"]["plain_ms"] = cuda_time_ms(k3_plain, 5)
    for k in ("K1", "K2", "K3"):
        log("kernel-time", f"{k}: {results[k]['ms']:.4f} ms, plain "
                           f"{results[k]['plain_ms']:.4f} ms")


def phase_twin_timing(timing, steps: int):
    """The flagship with the plain versions on the card."""
    n = FLAG_N
    m = flagship_model(n, "cuda", advance_mode="torch", scatter_mode="dense")
    ms = m.step_n_quiet(m.init_state(), 4)
    ms, ms_step = time_steps(m, ms, steps)
    check_state("flagship twin", ms, n_failed=0, n_clamped=0)
    timing["flagship_plain_ms_per_step"] = ms_step
    timing["flagship_plain_steps"] = steps
    log("twin-timing", f"{n}^2 flagship, advance torch + scatter dense: "
                       f"{ms_step:.3f} ms/step over {steps} steps, "
                       f"{n * n / (ms_step / 1e3):.4e} pushes/s; kernels "
                       f"{timing['flagship_ms_per_step']:.3f} ms/step")


def profile_config(tag: str, model, reps: int, steps: int = 10,
                   prof_steps: int = 5) -> dict:
    """Step times of one configuration over ``reps`` x ``steps`` steps (CUDA
    events), the host's enqueue time against the wall, and, for kernel
    configurations, a ``torch.profiler`` trace of ``prof_steps`` steps:
    device time by kernel, the device's busy time and idle share in the
    traced window, and launches per step."""
    from torch.profiler import ProfilerActivity, profile

    ms = model.step_n_quiet(model.init_state(), 4)
    per_rep = []
    for _ in range(reps):
        ms, t = time_steps(model, ms, steps)
        per_rep.append(t)
    out = dict(ms_per_step=per_rep, median=float(np.median(per_rep)),
               metrics=ms.metrics.as_dict())
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    ms = model.step_n_quiet(ms, steps)
    h1 = time.perf_counter()
    torch.cuda.synchronize()
    h2 = time.perf_counter()
    out["host_enqueue_ms_per_step"] = (h1 - h0) * 1e3 / steps
    out["host_wall_ms_per_step"] = (h2 - h0) * 1e3 / steps
    log("profile", f"{tag}: ms/step per rep {[f'{t:.4f}' for t in per_rep]}, "
                   f"median {out['median']:.4f}; host enqueue "
                   f"{out['host_enqueue_ms_per_step']:.4f}, wall "
                   f"{out['host_wall_ms_per_step']:.4f} ms/step")
    if model.resolved_config().advance_mode != "cuda":
        return out
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms = model.step_n_quiet(ms, prof_steps)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert dev, f"{tag}: the trace holds no device events"
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    by_name = {}
    for e in dev:
        d, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (d + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    out.update(profiled_steps=prof_steps,
               device_window_us=window, device_busy_us=busy,
               device_busy_ms_per_step=busy / 1e3 / prof_steps,
               idle_share=1.0 - busy / window,
               device_ops_per_step=len(dev) / prof_steps,
               by_kernel_us_per_step={k: d / prof_steps
                                      for k, (d, _) in top})
    log("profile", f"{tag}: device busy {busy / 1e3 / prof_steps:.4f} "
                   f"ms/step, idle share {out['idle_share']:.4f} of the "
                   f"traced window, {len(dev) / prof_steps:.1f} device ops "
                   f"per step")
    for k, (d, n) in top:
        log("profile", f"    {d / prof_steps:9.2f} us/step  n={n:4d}  "
                       f"{k[:90]}")
    return out


def phase_profile(path: str) -> None:
    """The step's time split at FLAG_N^2: both configurations with the
    kernels (traced) and with the plain versions on the card."""
    n = FLAG_N
    res = {"flagship": profile_config("flagship", flagship_model(n, "cuda"), 7),
           "default": profile_config("default", default_model(n, "cuda"), 7),
           "flagship_plain": profile_config(
               "flagship plain", flagship_model(n, "cuda", advance_mode="torch",
                                                scatter_mode="dense"), 3),
           "default_plain": profile_config(
               "default plain", default_model(n, "cuda", advance_mode="torch",
                                              scatter_mode="dense"), 3)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    ap.add_argument("--profile", metavar="JSON",
                    help="also profile the step at full size and write the "
                         "split of its time to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name, smi = phase_device()
    build = phase_build()
    dev = torch.device("cuda", 0)
    results = {
        "K1": dict(name="advance", route="cuda",
                   source="picles_torch/csrc/advance.cu",
                   replaces="picles_tpu/ops/advance_pallas.py:50"),
        "K2": dict(name="pic_gather", route="cuda",
                   source="picles_torch/csrc/pic_gather.cu",
                   replaces="picles_tpu/ops/pic_pallas.py:91"),
        "K3": dict(name="auto_dt", route="cuda",
                   source="picles_torch/csrc/advance.cu",
                   replaces="picles_tpu/ops/advance_pallas.py:200"),
    }
    timing = {}
    phase_k1_k3(dev, results)
    phase_k2(dev, results)
    flag, s_flag, default, s_def = phase_main_path(dev, results, timing)
    phase_card_vs_cpu()
    phase_kernel_times(flag, s_flag, default, s_def, results)
    phase_twin_timing(timing, 20)
    if args.profile:
        phase_profile(args.profile)

    kernels = [dict(results[k]) for k in ("K1", "K2", "K3")]
    for k in kernels:
        assert all(f in k for f in ("launches", "max_abs_err", "ms",
                                    "plain_ms")), k
    seconds = time.perf_counter() - t_start
    log("done", f"{seconds:.1f} s in all, build {build.seconds:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=name, nvidia_smi=smi, kernels=kernels,
                           timing=timing, build_seconds=build.seconds,
                           ptxas=build.log, seconds=seconds), f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
