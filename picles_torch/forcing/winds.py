"""Wind forcing (PyTorch port of ``picles_tpu/forcing/winds.py``).

A wind is a pair of samplers ``u(x, y, t)``, ``v(x, y, t)`` on tensors.  The
Pallas kernels of the JAX package inline any such Python closure; a CUDA
kernel cannot.  So each analytic helper below also attaches a
``WindKernel`` descriptor — a kind plus its float parameters — which is
exactly the set the kernels in ``picles_torch/csrc/rhs.cuh`` compile.

Gridded winds (``GriddedWinds2D``, a record read by
``load_gridded_winds_2d``) are trilinear in (t, x, y).  Winds are sampled at
the fixed node positions, so over one model step only time varies, and the
interpolant is piecewise linear in t between the record's frame times: the
kernels take it as ``4 + 3B`` per-node planes
(``GriddedWinds2D.pallas_pwl_fields``) and evaluate them with the operations
of ``gridded_samplers``.  The model builds the descriptor (kind
``GRIDDED`` and B) and the planes once per step.

A ``Winds2D`` without a descriptor (any other callable, as the JAX
examples write them: ``Winds2D(u=u, v=v)``) runs in the kernels too.  The
model tries two ways, in order.  A steady callable (the model calls it once
on the nodes with a probe time under a ``TorchFunctionMode`` that records
whether the time reaches any torch operation, ``steady_node_planes``) is
exactly its two node planes, since the kernels read a wind sampled at the
node: kind ``NODE`` (``node_kernel``), the planes passed with every launch,
and ``node_plane_winds`` their plain version.  A callable that reads its
time is traced (``forcing/wind_trace.py``): kind ``TRACED``
(``traced_kernel``), its operations compiled into a library of the
kernels' traced instances, the node y passed with every launch, and
``TracedWind.winds`` its plain version.  A callable the tracer cannot
lower (a value read on the host, an indexed captured tensor, a reduction;
``wind_trace``'s docstring) raises, naming the operation; it runs with
``advance_mode="torch"``.  A float64 model takes both kinds in float64: its
node planes are the callable's values cast to float64 (``steady_node_planes``
with ``dtype``), as JAX casts them to the lanes' dtype, and its traced
graph is traced on float64 placeholders (``traced_kernel`` with ``dtype``),
a library of its own.  The analytic samplers compute in float32 with the
JAX package's operation order.

The 1D model's winds (``Winds1D``: ``u(x, t)``) reach its advance kernel K7
in three kinds: a steady callable as its one node plane ``[nx]``
(``steady_node_plane_1d``, the same probe, tried first), a callable that
reads its time as its traced graph (``traced_kernel_1d``: kind ``TRACED``,
``traced_wind_1d(x, t)`` compiled into a library of K7's traced instances;
the tracer's refusals raise as in 2D), and a ``GriddedWinds1D`` record as
itself (``u_data`` and its axes).  A float64 1D model takes each kind in
float64: the node plane in float64, the traced graph traced in float64, and
the record indexed in the coordinates' float64, as JAX's ``GriddedWinds1D``
under x64 (its samples, interpolated with float64 weights, rounded to the
record's float32 at the end).
"""

from __future__ import annotations

import dataclasses
import enum
import math
import warnings
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

from .wind_trace import TracedWind, trace_winds, trace_winds_1d


class WindKind(enum.IntEnum):
    """Wind families the kernels compile (``WindKind`` in ``rhs.cuh``)."""

    CONSTANT = 0
    HALF_DOMAIN = 1
    TIME_COSINE = 2
    GRIDDED = 3
    NODE = 4
    TRACED = 5


@dataclasses.dataclass(frozen=True)
class WindKernel:
    """Kernel-side description of a wind.  A gridded wind carries no
    parameters but its breakpoint count ``n_break``: its values arrive as
    ``4 + 3 * n_break`` planes with each launch; a steady wind of kind
    ``NODE`` none: its values arrive as its two node planes (u, v); a wind
    of kind ``TRACED`` its ``traced`` graph, compiled into a library of its
    own (``ops/cuda_build.py`` ``traced_library``)."""

    kind: WindKind
    u0: float
    v0: float
    x_split: float = 0.0
    background: float = 0.0
    period: float = 1.0
    t_off: Optional[float] = None
    n_break: int = 0
    traced: Optional[TracedWind] = None


class Winds2D(NamedTuple):
    """(u, v) sampler pair plus the optional kernel descriptor."""

    u: Callable
    v: Callable
    kernel: Optional[WindKernel] = None

    def __call__(self, x, y, t):
        return self.u(x, y, t), self.v(x, y, t)


def constant_winds(U10: float, V10: float) -> Winds2D:
    """Uniform steady winds."""
    return Winds2D(u=lambda x, y, t: torch.full_like(x, U10, dtype=torch.float32),
                   v=lambda x, y, t: torch.full_like(x, V10, dtype=torch.float32),
                   kernel=WindKernel(WindKind.CONSTANT, U10, V10))


def half_domain_winds(U10: float, V10: float, x_split: float,
                      background: float = 0.0) -> Winds2D:
    """x < x_split -> (U10, V10), else ``background``."""
    def u(x, y, t):
        return torch.where(x < x_split, U10, background).to(torch.float32)

    def v(x, y, t):
        return torch.where(x < x_split, V10, background).to(torch.float32)

    return Winds2D(u=u, v=v, kernel=WindKernel(
        WindKind.HALF_DOMAIN, U10, V10, x_split=x_split,
        background=background))


def time_cosine_winds(U10: float, V10: float, period: float,
                      t_off: Optional[float] = None) -> Winds2D:
    """Growing/decaying winds: amplitude cos(2 pi t / period) in float32 on
    float32(t), the period divided as the JAX package divides it (``_div``:
    an IEEE division on a card too, as the kernels' ``cosine_amplitude``),
    optionally zeroed after ``t_off`` (the cut-off compares t itself, as
    the JAX sampler does)."""
    def amp(t):
        a = torch.cos(_div(2.0 * math.pi * torch.as_tensor(
            t, dtype=torch.float32), period))
        if t_off is not None:
            a = torch.where(torch.as_tensor(t) > t_off, 0.0, a)
        return a

    return Winds2D(u=lambda x, y, t: U10 * amp(t) + 0.0 * x,
                   v=lambda x, y, t: V10 * amp(t) + 0.0 * x,
                   kernel=WindKernel(WindKind.TIME_COSINE, U10, V10,
                                     period=period, t_off=t_off))


# ---------------------------------------------------------------------------
# steady callables: the node kind
# ---------------------------------------------------------------------------

class _TimeProbe(TorchFunctionMode):
    """Records whether the probe time ``t`` enters any torch operation
    (arithmetic, comparisons, ``float(t)``, ``t.item()``, ``t.cpu()`` and
    numpy's ``__array__`` all dispatch through the mode).  A tensor derived
    from ``t`` comes out of such an operation, so the first one decides."""

    def __init__(self, t: torch.Tensor):
        super().__init__()
        self.t = t
        self.read = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.read:
            self.read = any(a is self.t for a in tree_flatten((args, kwargs))[0])
        return func(*args, **kwargs)


def _steady_at(x: torch.Tensor, *samplers,
               dtype: torch.dtype = torch.float32) -> Optional[list]:
    """Each sampler called once with a 0-dim probe time under
    ``_TimeProbe``: None when any reads the time, else their values cast to
    the model's ``dtype`` (the lanes', as JAX's kernels cast the closure's
    value), planes shaped like the nodes ``x``."""
    t = torch.zeros((), dtype=torch.float32, device=x.device)
    with _TimeProbe(t) as probe:
        out = [f(t) for f in samplers]
    if probe.read:
        return None
    return [torch.broadcast_to(torch.as_tensor(c, device=x.device).to(
        dtype), x.shape) for c in out]


def steady_node_planes(winds: "Winds2D", x: torch.Tensor, y: torch.Tensor,
                       dtype: torch.dtype = torch.float32
                       ) -> Optional[torch.Tensor]:
    """The wind's (u, v) at the nodes ``(x, y)`` as one contiguous
    ``[2, *x.shape]`` tensor of the model's ``dtype`` (the kernels' node
    planes: float32, or float64 in a float64 model, where a callable
    written in float64 arithmetic keeps its float64 values), or None when
    the callable reads its time: ``u`` and ``v`` are called once with a
    0-dim probe time under ``_TimeProbe``.  A callable in which the time
    enters no torch operation is steady, whatever host state it reads (the
    Pallas kernels of the JAX package trace the closure once and bake that
    state in too)."""
    planes = _steady_at(x, lambda t: winds.u(x, y, t),
                        lambda t: winds.v(x, y, t), dtype=dtype)
    return None if planes is None else torch.stack(planes).contiguous()


def node_kernel() -> "WindKernel":
    """The descriptor of a steady wind given as its node planes."""
    return WindKernel(WindKind.NODE, 0.0, 0.0)


def node_plane_winds(u_plane: torch.Tensor, v_plane: torch.Tensor
                     ) -> "Winds2D":
    """The plain version of the node kind: a steady wind whose samplers
    return the node planes ``u_plane`` and ``v_plane`` whatever the time, so
    it is sampled at the nodes the planes belong to, as the kernels' plain
    versions sample it (as ``pwl_winds`` does for a gridded window)."""
    return Winds2D(u=lambda x, y, t: u_plane, v=lambda x, y, t: v_plane,
                   kernel=node_kernel())


def traced_kernel(winds: "Winds2D", device="cpu",
                  dtype: torch.dtype = torch.float32) -> "WindKernel":
    """The descriptor of a callable traced on ``device`` in the model's
    ``dtype`` (kind ``TRACED``, ``forcing/wind_trace.py``; the dtype is the
    traced graph's, so the same callable traced for float32 and for float64
    gets two libraries); raises ``NotImplementedError`` for a callable the
    tracer cannot lower.  Each call traces anew (the model traces once, at
    construction); the same emitted source loads the same library
    (``ops/cuda_build.py`` ``traced_library``)."""
    return WindKernel(WindKind.TRACED, 0.0, 0.0,
                      traced=trace_winds(winds.u, winds.v, device, dtype))


# ---------------------------------------------------------------------------
# gridded winds
# ---------------------------------------------------------------------------

# No function below reads a tensor back to the host or copies a host value
# to the card (which would wait for the card's queue): tables are read with
# ``take`` (indexing with a 0-dim tensor index reads it back), and constants
# enter as kernel arguments (``torch.full``).

def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` for a Python float ``b``, divided as the JAX package divides:
    on a card PyTorch multiplies by the reciprocal of a host scalar, so the
    divisor goes as a 0-dim tensor on ``a``'s device."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """``jnp.interp(x, xp, fp)`` with its operations: linear between the
    nodes ``xp``, the end values outside them."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.shape[0] - 1)
    f0, x0 = fp.take(i - 1), xp.take(i - 1)
    df = fp.take(i) - f0
    dx = xp.take(i) - x0
    delta = x - x0
    npdt = np.float64 if xp.dtype == torch.float64 else np.float32
    eps = float(np.spacing(np.finfo(npdt).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f0, f0 + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _linear(coord: torch.Tensor, size: int):
    """``map_coordinates(order=1, mode="wrap")``'s two (index, weight) pairs
    of one axis."""
    lower = torch.floor(coord)
    upper = coord - lower
    idx = lower.to(torch.int64)
    return [(torch.remainder(idx, size), 1 - upper),
            (torch.remainder(idx + 1, size), upper)]


@dataclasses.dataclass(frozen=True, eq=False)
class GriddedWinds2D:
    """Trilinear interpolation of gridded (t, x, y) wind data, the port of
    ``picles_tpu/forcing/winds.py`` ``GriddedWinds2D``.

    ``u_data``, ``v_data``: ``[nt, nx, ny]`` float32 tensors on one device
    (``to`` moves the record).  Axes are uniform (``x0``/``dx`` etc.; index
    ``(c - c0) / dc``) or node tables (``x_nodes``/``y_nodes``/``t_nodes``,
    strictly increasing float32 tensors; index by ``jnp.interp``'s
    coordinate-to-index map).  ``mode`` covers both spatial axes
    ("nearest" clamps, "wrap" is periodic: a uniform axis of n samples
    wraps with period n dc, interpolating its last interval against sample
    0; a node table with period nodes[-1] - nodes[0]); ``mode_t`` the time
    axis ("clamp" holds the first and last frames, "wrap" loops the
    record).  The samplers are ``map_coordinates(order=1, mode="wrap")`` on
    pre-folded indices, with its corner order and sums.
    """

    u_data: torch.Tensor
    v_data: torch.Tensor
    x0: float
    dx: float
    y0: float
    dy: float
    t0: float
    dt: float
    mode: str = "nearest"
    mode_t: str = "clamp"
    x_nodes: Optional[torch.Tensor] = None
    y_nodes: Optional[torch.Tensor] = None
    t_nodes: Optional[torch.Tensor] = None

    def __post_init__(self):
        # the time nodes on the host, for n_breakpoints (sizes, not values,
        # of the per-step planes): read once here, never per step
        tn = (None if self.t_nodes is None else
              self.t_nodes.detach().cpu().numpy().astype(np.float64))
        object.__setattr__(self, "_t_nodes_host", tn)

    @property
    def device(self) -> torch.device:
        return self.u_data.device

    def to(self, device) -> "GriddedWinds2D":
        """The record on ``device``."""
        def mv(a):
            return None if a is None else a.to(device)

        return dataclasses.replace(
            self, u_data=mv(self.u_data), v_data=mv(self.v_data),
            x_nodes=mv(self.x_nodes), y_nodes=mv(self.y_nodes),
            t_nodes=mv(self.t_nodes))

    # -- the interpolant ---------------------------------------------------

    def _axis_index(self, c, nodes, c0: float, dc: float, n: int,
                    wrap: bool) -> torch.Tensor:
        """Coordinate -> fractional index of one axis."""
        c = torch.as_tensor(c, device=self.device)
        if not c.is_floating_point():
            c = c.to(torch.float32)
        if nodes is None:
            ci = _div(c - c0, dc)
            return torch.remainder(ci, n) if wrap else torch.clamp(
                ci, 0.0, n - 1.0)
        nd = nodes.to(c.dtype)
        if wrap:
            c = nd[0] + torch.remainder(c - nd[0], nd[-1] - nd[0])
        return _interp(c, nd, torch.arange(nd.shape[0], dtype=nd.dtype,
                                           device=nd.device))

    def corners(self, x, y):
        """The four spatial corners of the points ``(x, y)`` in
        ``map_coordinates``' order: (flat index into a frame, x weight, y
        weight).  They depend on the points alone, so a caller that samples
        the same nodes every step computes them once
        (``pallas_pwl_fields(..., corners=)``)."""
        _, nxw, nyw = self.u_data.shape
        wrap = self.mode == "wrap"
        cx = _linear(self._axis_index(x, self.x_nodes, self.x0, self.dx, nxw,
                                      wrap), nxw)
        cy = _linear(self._axis_index(y, self.y_nodes, self.y0, self.dy, nyw,
                                      wrap), nyw)
        return [(ix * nyw + iy, wx, wy) for ix, wx in cx for iy, wy in cy]

    def _time(self, t):
        nt = self.u_data.shape[0]
        return _linear(self._axis_index(t, self.t_nodes, self.t0, self.dt, nt,
                                        self.mode_t == "wrap"), nt)

    def _sample(self, space, t, datas):
        """Each record of ``datas`` at the corners of ``space`` and time
        ``t``: the weights' product (w_t w_x) w_y times the sample, summed
        over the corners in ``map_coordinates``' order, cast to float32."""
        frame = self.u_data.shape[1] * self.u_data.shape[2]
        outs = [None] * len(datas)
        for it, wt in self._time(t):
            for ixy, wx, wy in space:
                w = wt * wx * wy
                idx = it * frame + ixy
                for k, data in enumerate(datas):
                    c = w * data.take(idx)
                    outs[k] = c if outs[k] is None else outs[k] + c
        return tuple(o.to(torch.float32) for o in outs)

    def u(self, x, y, t):
        return self._sample(self.corners(x, y), t, (self.u_data,))[0]

    def v(self, x, y, t):
        return self._sample(self.corners(x, y), t, (self.v_data,))[0]

    def uv(self, x, y, t):
        """(u, v) from one set of corners."""
        return self._sample(self.corners(x, y), t, (self.u_data, self.v_data))

    def as_winds(self) -> Winds2D:
        return Winds2D(u=self.u, v=self.v)

    # -- the kernels' per-step planes --------------------------------------

    def n_breakpoints(self, DT: float) -> int:
        """The most record frame times a ``[t0, t0 + DT]`` window can
        straddle: ``ceil(DT / dt)`` for a uniform time axis,
        ``floor(DT / min gap) + 1`` for a node table, capped at the record
        length (from the host copy of the table taken at construction)."""
        tn = self._t_nodes_host
        if tn is not None:
            d = np.diff(tn)
            if d.size == 0:
                return 1
            return max(1, min(int(math.floor(float(DT) / float(d.min()))) + 1,
                              int(tn.size)))
        return max(1, int(math.ceil(float(DT) / float(self.dt) - 1e-9)))

    def pallas_pwl_fields(self, x, y, t0, DT: float, corners=None
                          ) -> Tuple[torch.Tensor, ...]:
        """The exact per-node time dependence of the winds over one step
        window ``[t0, t0 + DT]``, as ``GriddedWinds2D.pallas_pwl_fields`` of
        the JAX package forms it:

            u(t) = a_u + s_u t + sum_k ds_u_k max(t - b_k, 0)

        with the slope jumps ``ds_k`` at the frame times ``b_k`` the window
        can straddle (``B = n_breakpoints(DT)``).  Returns the planes ``(a_u,
        s_u, a_v, s_v, [ds_u_k, ds_v_k, b_k] * B)`` shaped like ``x``, views
        of one contiguous ``[4 + 3B, *x.shape]`` float32 tensor (the layout
        the kernels read), computed on the record's device from ``t0`` (a
        0-dim tensor or a number) with no read back to the host.
        ``corners``: ``corners(x, y)``, when the caller keeps them.

        A node-table time axis takes its frame times from the table around
        ``searchsorted(t_nodes, t0)``, with a zero slope across repeated
        clamped node times; ``mode_t="wrap"`` with a node table is refused,
        as in the JAX package (its wrap boundaries are not frame times of
        the window)."""
        B = self.n_breakpoints(DT)
        dev = self.device
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        shp = torch.broadcast_shapes(x.shape, y.shape)
        t0b = torch.as_tensor(t0, device=dev).to(torch.float32)
        if self.t_nodes is None:
            k0 = torch.floor(_div(t0b - self.t0, self.dt))
            tf = [self.t0 + (k0 + j) * self.dt for j in range(B + 2)]
            gaps = [self.dt] * (B + 1)
        else:
            if self.mode_t == "wrap":
                raise ValueError(
                    "pallas_pwl_fields: mode_t='wrap' is not supported with "
                    "a non-uniform t_nodes table; use advance_mode='torch' "
                    "or a clamped time axis")
            tn = self.t_nodes.to(torch.float32)
            ntf = tn.shape[0]
            k0 = torch.searchsorted(tn, t0b.reshape(-1), right=True
                                    ).reshape(t0b.shape) - 1
            tf = []
            for j in range(B + 2):
                t_j = tn.take(torch.clamp(k0 + j, 0, ntf - 1))
                if j == 0:
                    t_j = torch.where(k0 < 0, t0b, t_j)
                tf.append(t_j)
            gaps = [tf[j + 1] - tf[j] for j in range(B + 1)]
        space = self.corners(x, y) if corners is None else corners
        us, vs = zip(*(self._sample(space, t, (self.u_data, self.v_data))
                       for t in tf))

        def slope(hi, lo, gap):
            if isinstance(gap, float):
                return _div(hi - lo, gap)
            ok = gap > 0
            return torch.where(ok, (hi - lo) / torch.where(ok, gap, 1.0), 0.0)

        s_u = [slope(us[j + 1], us[j], gaps[j]) for j in range(B + 1)]
        s_v = [slope(vs[j + 1], vs[j], gaps[j]) for j in range(B + 1)]
        fields = [us[0] - tf[0] * s_u[0], s_u[0], vs[0] - tf[0] * s_v[0],
                  s_v[0]]
        for k in range(1, B + 1):
            fields += [s_u[k] - s_u[k - 1], s_v[k] - s_v[k - 1], tf[k]]
        out = torch.empty((len(fields),) + tuple(shp), dtype=torch.float32,
                          device=dev)
        for o, f in zip(out, fields):
            o.copy_(torch.broadcast_to(f, shp))
        return tuple(out.unbind(0))


def gridded_samplers(n_break: int):
    """The kernels' wind samplers over ``pallas_pwl_fields``' planes (the
    JAX package's ``gridded_pallas_samplers``): ``u(xn, yn, t, a_u, s_u,
    a_v, s_v, [ds_u_k, ds_v_k, b_k] * B) = a_u + t s_u``, then ``+ ds_u_k
    max(t - b_k, 0)`` in k order, the max propagating NaN."""
    def ramp(t, b):
        d = t - b
        return torch.maximum(d, torch.zeros((), dtype=d.dtype,
                                            device=d.device))

    def u(xn, yn, t, *f):
        val = f[0] + t * f[1]
        for k in range(n_break):
            val = val + f[4 + 3 * k] * ramp(t, f[6 + 3 * k])
        return val

    def v(xn, yn, t, *f):
        val = f[2] + t * f[3]
        for k in range(n_break):
            val = val + f[5 + 3 * k] * ramp(t, f[6 + 3 * k])
        return val

    return u, v


def pwl_winds(fields: Sequence[torch.Tensor]) -> Winds2D:
    """``gridded_samplers`` closed over one window's planes: the wind of the
    kernels' plain versions."""
    B = (len(fields) - 4) // 3
    if len(fields) != 4 + 3 * B:
        raise ValueError(f"{len(fields)} planes are not 4 + 3B")
    u_k, v_k = gridded_samplers(B)
    fields = tuple(fields)
    return Winds2D(u=lambda x, y, t: u_k(x, y, t, *fields),
                   v=lambda x, y, t: v_k(x, y, t, *fields))


def gridded_kernel(n_break: int) -> WindKernel:
    """The descriptor of a gridded wind of ``n_break`` breakpoints."""
    return WindKernel(WindKind.GRIDDED, 0.0, 0.0, n_break=int(n_break))


def load_gridded_winds_2d(path: str, *, u_name: str = "u10",
                          v_name: str = "v10", x_name: str = "longitude",
                          y_name: str = "latitude", t_name: str = "time",
                          mode: str = "nearest", mode_t: str = "clamp",
                          time_scale: float = 1.0,
                          relative_time: bool = False,
                          device="cuda") -> GriddedWinds2D:
    """Load (t, x, y) wind fields from a NetCDF file (NetCDF-4 through h5py,
    NetCDF-3 through scipy, ``utils.io.read_netcdf_vars``) into a
    ``GriddedWinds2D`` on ``device``: the CUDA device unless the caller
    names another; raises when a CUDA device is asked for and there is
    none.

    Data stored ``[t, y, x]`` (the CF convention) is transposed to
    ``[t, x, y]``; a strictly decreasing spatial axis (ERA5's latitude,
    north to south) is flipped with its data; a non-uniform axis is kept as
    a node table.  ERA5-style files name the variables
    ``lon/lat/time/U10N/V10N`` and carry time in hours: pass
    ``u_name="U10N", v_name="V10N", x_name="lon", y_name="lat",
    time_scale=3600.0, relative_time=True`` for seconds since the first
    frame.  Epoch-scale times warn, as float32 sampling quantizes them."""
    from ..utils.io import read_netcdf_vars

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_gridded_winds_2d: no CUDA device found; "
                           "pass device='cpu' to load the record onto the "
                           "CPU")

    v = read_netcdf_vars(path, [u_name, v_name, x_name, y_name, t_name])
    xs, ys, ts = (np.asarray(v[x_name], np.float64),
                  np.asarray(v[y_name], np.float64),
                  np.asarray(v[t_name], np.float64))

    def _txy(a):
        a = np.asarray(a, np.float32)
        if a.shape == (ts.size, ys.size, xs.size):   # CF [t, y, x]
            return np.transpose(a, (0, 2, 1))
        if a.shape == (ts.size, xs.size, ys.size):
            return a
        raise ValueError(f"wind variable shape {a.shape} does not match axes")

    u_txy, v_txy = _txy(v[u_name]), _txy(v[v_name])
    if xs.size > 1 and np.all(np.diff(xs) < 0):
        xs, u_txy, v_txy = xs[::-1], u_txy[:, ::-1, :], v_txy[:, ::-1, :]
    if ys.size > 1 and np.all(np.diff(ys) < 0):
        ys, u_txy, v_txy = ys[::-1], u_txy[:, :, ::-1], v_txy[:, :, ::-1]

    def _axis(a, name):
        """(c0, dc, nodes): nodes is None for a uniform axis."""
        if a.size > 1:
            d = np.diff(a)
            if np.any(d <= 0):
                raise ValueError(f"{name} axis is not strictly increasing")
            if np.allclose(d, d[0], rtol=1e-4):
                return float(a[0]), float(d[0]), None
            return float(a[0]), float(d.mean()), torch.as_tensor(
                a.astype(np.float32), device=device)
        return float(a[0]), 1.0, None

    x0, dx, x_nodes = _axis(xs, x_name)
    y0, dy, y_nodes = _axis(ys, y_name)
    if relative_time:
        ts = ts - ts[0]
    t0, dt, t_nodes = _axis(ts * time_scale, t_name)
    if abs(t0) > 1e7:
        warnings.warn(
            f"wind time axis starts at {t0:.3g} s; float32 sampling "
            f"quantizes epoch-scale times to ~{abs(t0) * 1.2e-7:.0f} s — "
            f"pass relative_time=True (seconds since the first frame)",
            stacklevel=2)

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return GriddedWinds2D(u_data=tensor(u_txy), v_data=tensor(v_txy),
                          x0=x0, dx=dx, y0=y0, dy=dy, t0=t0, dt=dt,
                          mode=mode, mode_t=mode_t, x_nodes=x_nodes,
                          y_nodes=y_nodes, t_nodes=t_nodes)


# ---------------------------------------------------------------------------
# 1D winds
# ---------------------------------------------------------------------------

class Winds1D(NamedTuple):
    """The 1D model's wind ``u(x, t)`` (signed, along x)."""

    u: Callable

    def __call__(self, x, t):
        return self.u(x, t)


def _float_on(a, device) -> torch.Tensor:
    """``a`` as a float tensor: a float32 or float64 tensor as it is, any
    other value as float32 (a tensor keeps its device), as JAX keeps an
    array's dtype."""
    if isinstance(a, torch.Tensor):
        return a if a.dtype in (torch.float32, torch.float64) \
            else a.to(torch.float32)
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def traced_kernel_1d(winds: Winds1D, device="cpu",
                     dtype: torch.dtype = torch.float32) -> WindKernel:
    """The descriptor of a 1D callable traced on ``device`` in the model's
    ``dtype`` (kind ``TRACED``, its ``traced`` graph a 1D sampler,
    ``trace_winds_1d``), as ``traced_kernel`` is for a ``Winds2D``; raises
    ``NotImplementedError`` for a callable the tracer cannot lower."""
    return WindKernel(WindKind.TRACED, 0.0, 0.0,
                      traced=trace_winds_1d(winds.u, device, dtype))


def constant_winds_1d(U10: float) -> Winds1D:
    """A uniform steady 1D wind."""
    return Winds1D(u=lambda x, t: torch.full_like(torch.as_tensor(x), U10,
                                                  dtype=torch.float32))


def steady_node_plane_1d(winds: Winds1D, x: torch.Tensor,
                         dtype: torch.dtype = torch.float32
                         ) -> Optional[torch.Tensor]:
    """The 1D form of ``steady_node_planes``: the wind ``u`` at the nodes
    ``x`` as one contiguous plane of the model's ``dtype`` shaped like
    ``x``, or None when the callable reads its time (``u`` is called once
    with a 0-dim probe time under ``_TimeProbe``)."""
    planes = _steady_at(x, lambda t: winds.u(x, t), dtype=dtype)
    return None if planes is None else planes[0].contiguous()


@dataclasses.dataclass(frozen=True, eq=False)
class GriddedWinds1D:
    """Bilinear interpolation of gridded (x, t) wind data ``u_data [nx,
    nt]`` (a float32 tensor), the port of ``picles_tpu``'s
    ``GriddedWinds1D``.  Each axis has its own edge mode: ``mode`` covers
    space ("wrap" periodic, "nearest" clamped), ``mode_t`` time ("clamp"
    holds the last frame, "wrap" loops the record).  ``u`` pre-folds each
    axis by its mode, then interpolates as ``map_coordinates(order=1,
    mode="wrap")``, so on a wrapped axis the interval [n - 1, n) runs
    against sample 0.  The coordinates keep their dtype (float64 ones index
    and weigh in float64, as JAX under x64); the sum is rounded to the
    record's float32, as ``map_coordinates`` returns the input's dtype."""

    u_data: torch.Tensor
    x0: float
    dx: float
    t0: float
    dt: float
    mode: str = "wrap"
    mode_t: str = "clamp"

    @property
    def device(self) -> torch.device:
        return self.u_data.device

    def to(self, device) -> "GriddedWinds1D":
        return dataclasses.replace(self, u_data=self.u_data.to(device))

    def u(self, x, t):
        nxw, ntw = self.u_data.shape
        dev = self.device
        xi = _div(_float_on(x, dev) - self.x0, self.dx)
        ti = _div(_float_on(t, dev) - self.t0, self.dt)
        xi = torch.remainder(xi, nxw) if self.mode == "wrap" \
            else torch.clamp(xi, 0.0, nxw - 1.0)
        ti = torch.remainder(ti, ntw) if self.mode_t == "wrap" \
            else torch.clamp(ti, 0.0, ntw - 1.0)
        xi, ti = torch.broadcast_tensors(xi, ti)
        flat = self.u_data.reshape(-1)
        out = None
        for ix, wx in _linear(xi, nxw):
            for it, wt in _linear(ti, ntw):
                c = (wx * wt) * flat.take(ix * ntw + it)
                out = c if out is None else out + c
        return out.to(torch.float32)

    def as_winds(self) -> Winds1D:
        return Winds1D(u=self.u)


def idealized_wind_grid_1d(u_func, Lx: float, T: float, dx: float,
                           dt: float, *, device) -> GriddedWinds1D:
    """An analytic wind ``u_func(x, t)`` sampled on the record's nodes
    (x from 0 to Lx every dx, t from 0 to T every dt)."""
    xi = np.arange(0, Lx + dx / 2, dx)
    ti = np.arange(0, T + dt / 2, dt)
    data = np.asarray([[float(u_func(x, t)) for t in ti] for x in xi],
                      dtype=np.float32)
    return GriddedWinds1D(u_data=torch.as_tensor(data, device=device),
                          x0=0.0, dx=dx, t0=0.0, dt=dt)


def slopped_blob(x, t, U10, V, T, x_scale, t_scale, x0=300e3):
    """A Gaussian wind blob moving at speed V, peaking at time T / 2: 0.5 +
    U10 exp(-((x - (x0 + t V)) / x_scale)^2) exp(-((t - T/2) / t_scale)^2),
    in the dtype of x and t (float32, or float64 as JAX under x64)."""
    x = _float_on(x, None)
    if isinstance(t, torch.Tensor):
        t = _float_on(t, None)
        b = _div(t - T / 2, t_scale)
        b = -(b * b)
    else:
        # a host time stays a Python float, as JAX keeps it until it
        # meets an array
        b = torch.full((), -(((t - T / 2) / t_scale) ** 2),
                       dtype=x.dtype, device=x.device)
    a = _div(x - (x0 + t * V), x_scale)
    return 0.5 + U10 * (torch.exp(-(a * a)) * torch.exp(b))
