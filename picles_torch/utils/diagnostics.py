"""Run diagnostics (PyTorch port of the ``picles_tpu/utils/diagnostics.py``
helpers that ``Simulation`` callbacks use).  Each reads the device."""

from __future__ import annotations


def mean_of_state(ms) -> float:
    """Mean energy over the nodes."""
    return float(ms.state[..., 0].mean())


def max_energy(ms) -> float:
    return float(ms.state[..., 0].max())


def check_nans(ms, name: str = "state") -> None:
    """Raise ``FloatingPointError`` if the node state holds a NaN or an
    infinity."""
    bad = ~ms.state.isfinite()
    if bool(bad.any()):
        raise FloatingPointError(f"{int(bad.sum())} non-finite values in "
                                 f"{name} at t={float(ms.time)}")


def step_summary(ms) -> dict:
    """One structured log record of a step: clock, energy, counters."""
    m = ms.metrics
    return dict(time=float(ms.time), iteration=int(ms.iteration),
                mean_e=mean_of_state(ms), max_e=max_energy(ms),
                n_active=int(m.n_active), n_failed=int(m.n_failed),
                n_gather=int(m.n_gather), n_reseed=int(m.n_reseed),
                n_off=int(m.n_off), n_relight=int(m.n_relight),
                n_clamped=int(m.n_clamped),
                substeps_max=int(m.substeps_max))
