"""Visualization (PyTorch port of ``picles_tpu/viz/plotting.py``; reference
src/visualization/: plotting_1D.jl, movie_2D.jl, global.jl) on matplotlib.

Every function takes the port's grids and states (torch tensors on any
device, or numpy arrays) through numpy, and draws what the JAX package's
functions draw from the same values.  matplotlib (with the Agg backend, as
the JAX module selects it) is imported by the functions, not by this
module, so the package imports where matplotlib is missing.

cartopy/GeoMakie are not available in this environment, so the globe views
implement the orthographic projection directly (the same views as
PlotState_SingleGlobe/DoubleGlobe, global.jl:4-60): far-side points are
masked, two hemispheres give the double-globe layout, and the tripolar seam
can be overlaid.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


def _pyplot():
    """matplotlib's pyplot on the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def significant_wave_height(e):
    """Hs = 4 sqrt(E)."""
    return 4.0 * np.sqrt(np.maximum(_np(e), 0.0))


# ---------------------------------------------------------------------------
# 1D panels (reference plotting_1D.jl:7-34)
# ---------------------------------------------------------------------------

def plot_results_1d(data, x, time, *, u_func=None, path=None):
    """Hs / group-speed / forcing panel plot for a 1D run.

    data: [nt, nx, 3] stacked state history; x: [nx] meters; time: [nt] s.
    """
    plt = _pyplot()
    data = _np(data)
    x_km = _np(x) / 1e3
    t_h = _np(time) / 3600.0
    nrows = 3 if u_func is not None else 2
    fig, axes = plt.subplots(nrows, 1, figsize=(8, 2.6 * nrows), sharex=True)

    hs = significant_wave_height(data[..., 0])
    im0 = axes[0].pcolormesh(x_km, t_h, hs, shading="auto", cmap="viridis")
    fig.colorbar(im0, ax=axes[0], label="Hs [m]")
    axes[0].set_ylabel("time [h]")

    with np.errstate(divide="ignore", invalid="ignore"):
        cg = np.where(np.abs(data[..., 1]) > 0,
                      data[..., 0] / (2 * data[..., 1]), 0.0)
    im1 = axes[1].pcolormesh(x_km, t_h, cg, shading="auto", cmap="RdBu_r")
    fig.colorbar(im1, ax=axes[1], label="c_g [m/s]")
    axes[1].set_ylabel("time [h]")

    if u_func is not None:
        U = np.asarray([[float(u_func(xx, tt)) for xx in _np(x)]
                        for tt in _np(time)])
        im2 = axes[2].pcolormesh(x_km, t_h, U, shading="auto", cmap="PuOr_r")
        fig.colorbar(im2, ax=axes[2], label="U10 [m/s]")
        axes[2].set_ylabel("time [h]")
    axes[-1].set_xlabel("x [km]")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


# ---------------------------------------------------------------------------
# 2D box plots + movie (reference movie_2D.jl)
# ---------------------------------------------------------------------------

def plot_state_2d(grid, state, var: int = 0, *, ax=None, coast=True,
                  title=None, cmap="viridis"):
    """Heatmap of one state variable with land mask overlay."""
    plt = _pyplot()
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 5))
    x = _np(grid.x)
    y = _np(grid.y)
    s = _np(state)[..., var]
    land = _np(grid.mask) == 0
    s = np.ma.masked_where(land, s)
    im = ax.pcolormesh(x, y, s, shading="auto", cmap=cmap)
    plt.colorbar(im, ax=ax)
    if title:
        ax.set_title(title)
    return ax


def _finite_max(a, default):
    """nanmax with a floor: all-NaN / empty / zero data falls back to
    ``default`` instead of propagating NaN into pcolormesh color limits
    (``nanmax(...) or 1.0`` does NOT guard NaN — NaN is truthy)."""
    with np.errstate(invalid="ignore"):
        v = float(np.nanmax(a)) if np.size(a) else float("nan")
    return v if np.isfinite(v) and v > 0 else default


def _wind_pair(winds):
    """Normalize a winds argument to a (u(x,y,t), v(x,y,t)) pair of the
    port's samplers (torch tensors in and out) — accepts Winds2D /
    GriddedWinds2D / a plain (u, v) tuple."""
    if winds is None:
        return None
    if hasattr(winds, "u") and hasattr(winds, "v"):
        return winds.u, winds.v
    u, v = winds
    return u, v


def _group_velocity(state):
    """Field c_x/c_y diagnostic (reference GetGroupVelocity,
    core_2D.jl:138-147): c = m * e / (2 |m|^2), 0 where |m| ~ 0."""
    e, mx, my = state[..., 0], state[..., 1], state[..., 2]
    m2 = mx ** 2 + my ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        cx = np.where(m2 > 1e-30, mx * e / (2.0 * m2), 0.0)
        cy = np.where(m2 > 1e-30, my * e / (2.0 * m2), 0.0)
    return cx, cy


def movie_2d(grid, states, path: str, *, winds=None, times=None, fps: int = 8,
             var: int = 0, as_hs: bool = True, dt: Optional[float] = None,
             name_string: str = "", arrow_skip: int = 3):
    """Animated movie (reference movie_2D.jl init_movie_2D_box_plot).

    With ``winds`` given, renders the reference's multi-panel dashboard
    (movie_2D.jl:63-98): wind-speed heatmap with an arrow (quiver)
    overlay, Hs, momentum m_x/m_y panels, and group-velocity c_x/c_y
    panels, plus the DT/dx/CFL/time header line (movie_2D.jl:125).
    Without winds, a single Hs panel (the pre-r5 behavior).

    states: [nt, nx, ny, 3]; writes a GIF via pillow.  The winds are
    sampled on the CPU at the grid's nodes with a float64 time plane.
    """
    plt = _pyplot()
    from matplotlib import animation

    states = _np(states)
    cart = grid.stats.kind == "cartesian"
    x = _np(grid.x) / 1e3 if cart else _np(grid.x)
    y = _np(grid.y) / 1e3 if cart else _np(grid.y)
    land = _np(grid.mask) == 0
    nt = states.shape[0]
    if times is not None:
        t_of = lambda i: float(times[i])            # noqa: E731
    elif dt is not None:
        # frames are one store interval apart: sample winds at i * dt
        # (NOT at t = frame index, which would freeze time-varying winds
        # near t=0 for every frame)
        t_of = lambda i: float(i) * float(dt)       # noqa: E731
    else:
        t_of = float

    def tlabel(i):
        return (f"time = {t_of(i) / 3600.0:.1f} h"
                if times is not None or dt is not None else f"frame {i}")

    wp = _wind_pair(winds)
    if wp is None:
        data = (significant_wave_height(states[..., 0]) if as_hs
                else states[..., var])
        vmax = _finite_max(data, 1.0)
        fig, ax = plt.subplots(figsize=(6.5, 5.5))
        im = ax.pcolormesh(x, y, np.ma.masked_where(land, data[0]),
                           shading="auto", cmap="viridis", vmin=0, vmax=vmax)
        fig.colorbar(im, ax=ax, label="Hs [m]" if as_hs else f"state[{var}]")
        title = ax.set_title(tlabel(0))

        def update(i):
            im.set_array(np.ma.masked_where(land, data[i]).ravel())
            title.set_text(tlabel(i))
            return im, title

        ani = animation.FuncAnimation(fig, update, frames=nt)
        ani.save(path, writer=animation.PillowWriter(fps=fps))
        plt.close(fig)
        return path

    # ---- dashboard (reference 3x2 panel grid, movie_2D.jl:67-98) ----
    u_f, v_f = wp
    xm, ym = _np(grid.x), _np(grid.y)
    xt, yt = torch.as_tensor(xm), torch.as_tensor(ym)

    def wind_fields(i):
        t = torch.full(xt.shape, t_of(i), dtype=torch.float64)
        u = np.broadcast_to(_np(u_f(xt, yt, t)).astype(np.float64), xm.shape)
        v = np.broadcast_to(_np(v_f(xt, yt, t)).astype(np.float64), xm.shape)
        return u, v

    hs = significant_wave_height(states[..., 0])
    u0, v0 = wind_fields(0)
    # shared color range from a subsample of frames
    sp_max = max(float(np.hypot(*wind_fields(i)).max())
                 for i in range(0, nt, max(1, nt // 8))) or 1.0  # winds: caller-supplied callables, assumed finite
    hs_max = _finite_max(hs, 1.0)
    m_lim = _finite_max(np.abs(states[..., 1:3]), 0.1)
    cx0, cy0 = _group_velocity(states)
    c_lim = _finite_max(np.hypot(cx0, cy0), 1.0)

    sk = max(1, arrow_skip)
    qsl = (slice(None, None, sk), slice(None, None, sk))

    fig, axes = plt.subplots(3, 2, figsize=(10, 13.5),
                             sharex=True, sharey=True)
    (ax_wind, ax_hs), (ax_mx, ax_my), (ax_cx, ax_cy) = axes
    masked = lambda a: np.ma.masked_where(land, a)  # noqa: E731

    im_wind = ax_wind.pcolormesh(x, y, np.hypot(u0, v0), shading="auto",
                                 cmap="cividis", vmin=0, vmax=sp_max)
    quiv = ax_wind.quiver(x[qsl], y[qsl], u0[qsl], v0[qsl], color="w",
                          scale=sp_max * 12.0)
    ax_wind.set_title("Winds")
    im_hs = ax_hs.pcolormesh(x, y, masked(hs[0]), shading="auto",
                             cmap="viridis", vmin=0, vmax=hs_max)
    ax_hs.set_title("Hs")
    im_mx = ax_mx.pcolormesh(x, y, masked(states[0, ..., 1]), shading="auto",
                             cmap="RdBu_r", vmin=-m_lim, vmax=m_lim)
    ax_mx.set_title("x momentum")
    im_my = ax_my.pcolormesh(x, y, masked(states[0, ..., 2]), shading="auto",
                             cmap="RdBu_r", vmin=-m_lim, vmax=m_lim)
    ax_my.set_title("y momentum")
    im_cx = ax_cx.pcolormesh(x, y, masked(cx0[0]), shading="auto",
                             cmap="RdBu_r", vmin=-c_lim, vmax=c_lim)
    ax_cx.set_title("c_x")
    im_cy = ax_cy.pcolormesh(x, y, masked(cy0[0]), shading="auto",
                             cmap="RdBu_r", vmin=-c_lim, vmax=c_lim)
    ax_cy.set_title("c_y")
    fig.colorbar(im_wind, ax=ax_wind, label="winds [m/s]")
    fig.colorbar(im_hs, ax=ax_hs, label="Hs [m]")
    fig.colorbar(im_mx, ax=ax_mx, label="momentum x []")
    fig.colorbar(im_my, ax=ax_my, label="momentum y []")
    fig.colorbar(im_cx, ax=ax_cx, label="group velocity [m/s]")
    fig.colorbar(im_cy, ax=ax_cy, label="group velocity [m/s]")
    unit = "km" if cart else "deg"
    for ax in (ax_cx, ax_cy):
        ax.set_xlabel(f"x [{unit}]")
    for ax in (ax_wind, ax_mx, ax_cx):
        ax.set_ylabel(f"y [{unit}]")

    dx = float(getattr(grid.stats, "dx", 0.0) or 0.0)

    def header(i):
        # reference title line: DT, dx, CFL, time (movie_2D.jl:125)
        parts = []
        if dt is not None:
            parts.append(f"DT={dt:.0f} s")
        if dx:
            cmax = float(np.nanmax(np.hypot(cx0[i], cy0[i])))
            parts.append(f"dx={dx:.0f} m")
            if dt is not None:
                parts.append(f"CFL={cmax * dt / dx:.3f}")
        parts.append(tlabel(i))
        if name_string:
            parts.append(name_string)
        return ", ".join(parts)

    suptitle = fig.suptitle(header(0))
    fig.tight_layout(rect=(0, 0, 1, 0.97))

    def update(i):
        ui, vi = wind_fields(i)
        im_wind.set_array(np.hypot(ui, vi).ravel())
        quiv.set_UVC(ui[qsl], vi[qsl])
        im_hs.set_array(masked(hs[i]).ravel())
        im_mx.set_array(masked(states[i, ..., 1]).ravel())
        im_my.set_array(masked(states[i, ..., 2]).ravel())
        im_cx.set_array(masked(cx0[i]).ravel())
        im_cy.set_array(masked(cy0[i]).ravel())
        suptitle.set_text(header(i))
        return (im_wind, quiv, im_hs, im_mx, im_my, im_cx, im_cy, suptitle)

    ani = animation.FuncAnimation(fig, update, frames=nt)
    ani.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path


# ---------------------------------------------------------------------------
# globes (reference global.jl)
# ---------------------------------------------------------------------------

def _orthographic(lon, lat, lon0, lat0):
    """Orthographic projection; returns (X, Y, visible mask)."""
    lam = np.radians(_np(lon) - lon0)
    phi = np.radians(_np(lat))
    phi0 = math.radians(lat0)
    cosc = math.sin(phi0) * np.sin(phi) + math.cos(phi0) * np.cos(phi) * np.cos(lam)
    X = np.cos(phi) * np.sin(lam)
    Y = math.cos(phi0) * np.sin(phi) - math.sin(phi0) * np.cos(phi) * np.cos(lam)
    return X, Y, cosc > 0


def plot_state_globe(grid, state, *, var: int = 0, lon0: float = 0.0,
                     lat0: float = 30.0, ax=None, cmap="viridis",
                     show_seam: bool = False):
    """Single orthographic globe (PlotState_SingleGlobe analog)."""
    plt = _pyplot()
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 5))
    X, Y, vis = _orthographic(_np(grid.x), _np(grid.y), lon0, lat0)
    s = _np(state)[..., var].copy()
    s[~vis] = np.nan
    s[_np(grid.mask) == 0] = np.nan
    im = ax.scatter(X[vis], Y[vis], c=s[vis], s=4, cmap=cmap)
    plt.colorbar(im, ax=ax)
    th = np.linspace(0, 2 * math.pi, 200)
    ax.plot(np.cos(th), np.sin(th), color="k", lw=0.6)
    if show_seam:
        top = (slice(None), -1)
        Xs, Ys, vs = _orthographic(_np(grid.x)[top], _np(grid.y)[top], lon0,
                                   lat0)
        ax.plot(Xs[vs], Ys[vs], color="r", lw=1.0)
    ax.set_aspect("equal")
    ax.axis("off")
    return ax


def plot_state_double_globe(grid, state, *, var: int = 0, lat0: float = 30.0,
                            lons=(-30.0, 150.0), path=None,
                            show_seam: bool = False):
    """Two opposing hemispheres (PlotState_DoubleGlobe[Seam] analog)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    for ax, lon0 in zip(axes, lons):
        plot_state_globe(grid, state, var=var, lon0=lon0, lat0=lat0, ax=ax,
                         show_seam=show_seam)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig
