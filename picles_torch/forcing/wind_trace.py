"""Wind callables that read their time, traced for the kernels.

The Pallas kernels of the JAX package inline whatever wind closure the model
holds: JAX traces ``u(x, y, t)`` and ``v(x, y, t)`` into each kernel's body,
where they are evaluated at every stage time, and the 1D model's jitted loop
evaluates ``u(x, t)`` likewise.  A CUDA kernel is compiled before its
launch, so the port does the same in three steps:

1. ``trace_winds`` traces the two samplers once with ``make_fx`` on float32
   placeholders (``x`` and ``y`` of shape ``[n]``, ``t`` 0-dim) and lowers
   the aten graph to a short list of elementwise operations (``Op``), the
   ``TracedWind``; ``trace_winds_1d`` traces the 1D sampler ``u(x, t)`` the
   same way, through the same lowering;
2. ``TracedWind.source`` emits that list as one CUDA device function,
   ``picles::traced_wind(x, y, t, u, v)``, or for a 1D sampler
   ``picles::traced_wind_1d(x, t)`` returning u (``traced_wind.cuh``);
3. ``ops/cuda_build.py`` ``traced_library`` compiles the 2D function into
   the traced instances of K1, K3, K5 and K6, and ``traced_library_1d`` the
   1D one into those of K7 (wind kind ``TRACED``), a library of each traced
   wind's own.

``TracedWind.evaluate`` is the plain version: the same list run as torch
operations in the same order, bit for bit the callable on the device it
runs on (``TracedWind.winds`` wraps it as a ``Winds2D``, or a ``Winds1D``
for a 1D sampler).

What the tracer takes: the operations of ``OPS`` on float32 and bool
values, literals (Python numbers, and captured tensors of one element), and
nothing else.  It refuses, with a ``NotImplementedError`` that names the
aten operation and ``advance_mode="torch"``: a value read on the host
(``float(t)``, ``t.item()``, a Python branch on ``t``: aten
``_local_scalar_dense``), an indexed captured tensor (a record in
disguise), a reduction, a shape change, any float64 or integer value, a
clamp with a NaN bound, and any operation not listed.  Such a wind runs
with ``advance_mode="torch"`` (and in 2D ``remesh_mode="xla"``), or as a
``GriddedWinds2D`` or ``GriddedWinds1D`` record.

The emitter writes each operation as PyTorch's CUDA kernels compute it,
not as the Python text reads: a division by a host scalar (a Python number,
or a tensor of one element on the CPU while the trace runs on a card) is a
product with its float32 reciprocal (ATen's ``div_true_kernel_cuda``), a
division by a device value a division; ``c / x`` reaches the graph as
``reciprocal(x) * c`` (``Tensor.__rtruediv__``); ``pow(x, 2)`` is ``x * x``,
``pow(x, 3)`` ``x * x * x``, ``pow(x, 0.5)`` ``sqrtf(x)``, ``pow(x, -1)``
``1 / x``, any other exponent ``powf`` (-2 and -0.5, which ATen computes
through a double or ``rsqrt``, are refused); ``minimum``, ``maximum`` and
``clamp`` pass a NaN operand through as ATen does; the transcendentals are
the precise ``expf``, ``logf``, ``sinf``, ``cosf``, ``tanhf``, ``sqrtf``.
Literals are exact float32 hexadecimal floats, so the text, and the hash
that names its library, depend only on the graph and its constants.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

# The operations whose result is bool (every other one is float32); the
# operations the tracer lowers are the keys of ``_EVAL``, below (``OPS``).
# ``pow`` and ``fill`` carry a number in ``Op.param``, ``clamp`` its two
# bounds (None for an open side).
_BOOL_RESULT = frozenset(("lt", "le", "gt", "ge", "eq", "ne", "and", "or",
                          "xor", "not"))

# aten packet name -> the operation it lowers to
_BINARY = {"add": "add", "sub": "sub", "rsub": "rsub", "mul": "mul",
           "div": "div", "minimum": "minimum", "maximum": "maximum",
           "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq",
           "ne": "ne", "bitwise_and": "and", "logical_and": "and",
           "bitwise_or": "or", "logical_or": "or", "bitwise_xor": "xor",
           "logical_xor": "xor"}
_UNARY = {"neg": "neg", "abs": "abs", "exp": "exp", "log": "log",
          "sin": "sin", "cos": "cos", "tanh": "tanh", "sqrt": "sqrt",
          "reciprocal": "reciprocal", "bitwise_not": "not",
          "logical_not": "not"}
# a copy of its operand, value for value
_IDENTITY = ("clone", "alias", "detach", "lift_fresh_copy")
_FILL = {"full_like": None, "zeros_like": 0.0, "ones_like": 1.0}
# the exponents ATen's CUDA pow computes through a double or rsqrt
_POW_REFUSED = (-2.0, -0.5)

# the samplers' inputs: u(x, y, t) and v(x, y, t), or the 1D u(x, t)
INPUTS = ("x", "y", "t")
INPUTS_1D = ("x", "t")


@dataclasses.dataclass(frozen=True)
class Lit:
    """A constant operand.  ``shape`` None: a Python number; else a tensor
    of that shape (one element).  ``host``: ATen takes it as a CPU scalar
    on a card (a Python number, or a CPU tensor in a trace on a card)."""

    value: float
    host: bool
    shape: Optional[Tuple[int, ...]] = None
    boolean: bool = False


Arg = Union[int, Lit]


@dataclasses.dataclass(frozen=True)
class Op:
    """One elementwise operation: its operands are values (``int``: the
    inputs in order (x, y, t, or x, t in 1D), then the results of the
    operations before it in order) or literals."""

    name: str
    args: Tuple[Arg, ...]
    param: tuple = ()


def _refuse(what: str, op: str) -> NotImplementedError:
    return NotImplementedError(
        f"the wind callable cannot be traced into the CUDA kernels: {what} "
        f"(aten op {op}).  The kernels take u(x, y, t) and v(x, y, t), or "
        f"the 1D u(x, t), built from elementwise float32 operations "
        f"(forcing/wind_trace.py OPS) and constants; run this wind with "
        f"advance_mode=\"torch\" (in 2D with remesh_mode=\"xla\": the plain "
        f"step), or as a GriddedWinds2D or GriddedWinds1D record")


def _hex(v: float) -> str:
    """A float32 literal in C: exact hexadecimal, or a math.h macro."""
    from ..ops.cuda_build import _hex32

    f = np.float32(v)
    if np.isnan(f):
        return "NAN"
    if np.isinf(f):
        return "INFINITY" if f > 0 else "(-INFINITY)"
    s = _hex32(float(f))
    return f"({s})" if s.startswith("-") else s


@dataclasses.dataclass(frozen=True)
class TracedWind:
    """A wind callable lowered to elementwise operations: ``ops`` in order,
    ``outputs`` the values (or literals) of u and v, or of the 1D u alone
    (``inputs`` ``INPUTS_1D``)."""

    ops: Tuple[Op, ...]
    outputs: Tuple[Arg, ...]
    inputs: Tuple[str, ...] = INPUTS

    @property
    def one_d(self) -> bool:
        """Whether this is a 1D sampler ``u(x, t)``."""
        return self.inputs == INPUTS_1D

    # -- the plain version -------------------------------------------------

    def evaluate(self, *coords) -> Tuple[torch.Tensor, ...]:
        """(u, v) at ``(x, y, t)``, or (u,) of a 1D sampler at ``(x, t)``:
        the operations run as torch operations in order, on ``x``'s
        device."""
        dev = coords[0].device
        t = torch.as_tensor(coords[-1], dtype=torch.float32, device=dev)
        vals = [*coords[:-1], t]

        def get(a):
            if isinstance(a, int):
                return vals[a]
            if a.shape is None:
                return a.value
            return torch.full(a.shape, a.value,
                              dtype=torch.bool if a.boolean else torch.float32,
                              device="cpu" if a.host else dev)

        for op in self.ops:
            vals.append(_EVAL[op.name](op, *(get(a) for a in op.args)))
        return tuple(torch.as_tensor(get(o), dtype=torch.float32, device=dev)
                     for o in self.outputs)

    def winds(self):
        """The plain version as a ``Winds2D`` (samplers ``u`` and ``v`` of
        ``evaluate``), or a ``Winds1D`` of a 1D sampler."""
        from .winds import Winds1D, Winds2D

        if self.one_d:
            return Winds1D(u=lambda x, t: self.evaluate(x, t)[0])
        return Winds2D(u=lambda x, y, t: self.evaluate(x, y, t)[0],
                       v=lambda x, y, t: self.evaluate(x, y, t)[1])

    # -- the emitter -------------------------------------------------------

    @functools.cached_property
    def source(self) -> str:
        """``traced_wind.cuh``: the device function ``picles::traced_wind(x,
        y, t, u, v)``, or ``picles::traced_wind_1d(x, t)`` returning u, one
        ``const`` a value in order."""
        names = list(self.inputs)

        def ref(a) -> str:
            if isinstance(a, int):
                return names[a]
            if a.boolean:
                return "true" if a.value else "false"
            return _hex(a.value)

        lines = []
        for k, op in enumerate(self.ops):
            name = f"s{k}"
            boolean = op.name in _BOOL_RESULT
            lines.append(f"  const {'bool' if boolean else 'float'} {name} = "
                         f"{_emit(op, ref)};")
            names.append(name)
        outs = [ref(o) for o in self.outputs]
        if self.one_d:
            what, head, tail = (
                "u of one traced 1D wind callable at (x, t)",
                "__device__ __forceinline__ float traced_wind_1d(float x, "
                "float t) {", [f"  return {outs[0]};"])
        else:
            what, head, tail = (
                "u and v of one traced wind callable at (x, y, t)",
                "__device__ __forceinline__ void traced_wind(float x, float "
                "y, float t, float& u, float& v) {",
                [f"  u = {outs[0]};", f"  v = {outs[1]};"])
        return "\n".join([
            f"// {what}: the",
            "// elementwise operations of its graph in order, each as",
            "// PyTorch's CUDA kernels compute it.  Written by",
            "// picles_torch/forcing/wind_trace.py.",
            "#pragma once",
            "#include <math.h>",
            "namespace picles {",
            head,
            *lines,
            *tail,
            "}",
            "}  // namespace picles",
            ""])

    @functools.cached_property
    def digest(self) -> str:
        """A hash of the emitted text (it names the wind's library)."""
        return hashlib.sha256(self.source.encode()).hexdigest()[:16]


def _nan_pass(a: str, b: str, fn: str) -> str:
    """ATen's minimum/maximum on a card: a NaN operand passes through."""
    return f"({a} != {a} ? {a} : ({b} != {b} ? {b} : {fn}({a}, {b})))"


_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_ARITH = {"add": "+", "sub": "-", "mul": "*", "and": "&&", "or": "||",
          "xor": "!="}
_MATH = {"abs": "fabsf", "exp": "expf", "log": "logf", "sin": "sinf",
         "cos": "cosf", "tanh": "tanhf", "sqrt": "sqrtf"}


def _emit(op: Op, ref) -> str:
    """The C expression of one operation."""
    n, a = op.name, op.args
    r = [ref(x) for x in a]
    if n in _ARITH:
        return f"{r[0]} {_ARITH[n]} {r[1]}"
    if n in _CMP:
        return f"{r[0]} {_CMP[n]} {r[1]}"
    if n == "rsub":
        return f"{r[1]} - {r[0]}"
    if n == "div":
        d = a[1]
        if isinstance(d, Lit) and d.host:
            inv = np.float32(1.0) / np.float32(d.value)
            return f"{r[0]} * {_hex(float(inv))}"
        return f"{r[0]} / {r[1]}"
    if n in ("minimum", "maximum"):
        return _nan_pass(r[0], r[1], "fminf" if n == "minimum" else "fmaxf")
    if n in _MATH:
        return f"{_MATH[n]}({r[0]})"
    if n == "neg":
        return f"-{r[0]}"
    if n == "not":
        return f"!{r[0]}"
    if n == "reciprocal":
        return f"1.0f / {r[0]}"
    if n == "pow":
        e = op.param[0]
        if e == 2:
            return f"{r[0]} * {r[0]}"
        if e == 3:
            return f"{r[0]} * {r[0]} * {r[0]}"
        if e == 0.5:
            return f"sqrtf({r[0]})"
        if e == 1:
            return r[0]
        if e == 0:
            return "1.0f"
        if e == -1:
            return f"1.0f / {r[0]}"
        return f"powf({r[0]}, {_hex(e)})"
    if n == "clamp":
        lo, hi = op.param
        val = r[0]
        if lo is not None:
            val = f"fmaxf({val}, {_hex(lo)})"
        if hi is not None:
            val = f"fminf({val}, {_hex(hi)})"
        return f"({r[0]} != {r[0]} ? {r[0]} : {val})"
    if n == "where":
        return f"{r[0]} ? {r[1]} : {r[2]}"
    if n == "float":
        return f"{r[0]} ? 1.0f : 0.0f"
    if n == "fill":
        return _hex(op.param[0])
    raise AssertionError(n)


def _clamp(op, a):
    return torch.clamp(a, *op.param)


_EVAL = {
    "add": lambda op, a, b: torch.add(a, b),
    "sub": lambda op, a, b: torch.sub(a, b),
    "rsub": lambda op, a, b: torch.rsub(a, b),
    "mul": lambda op, a, b: torch.mul(a, b),
    "div": lambda op, a, b: torch.div(a, b),
    "minimum": lambda op, a, b: torch.minimum(a, b),
    "maximum": lambda op, a, b: torch.maximum(a, b),
    "lt": lambda op, a, b: torch.lt(a, b),
    "le": lambda op, a, b: torch.le(a, b),
    "gt": lambda op, a, b: torch.gt(a, b),
    "ge": lambda op, a, b: torch.ge(a, b),
    "eq": lambda op, a, b: torch.eq(a, b),
    "ne": lambda op, a, b: torch.ne(a, b),
    "and": lambda op, a, b: torch.logical_and(a, b),
    "or": lambda op, a, b: torch.logical_or(a, b),
    "xor": lambda op, a, b: torch.logical_xor(a, b),
    "not": lambda op, a: torch.logical_not(a),
    "neg": lambda op, a: torch.neg(a),
    "abs": lambda op, a: torch.abs(a),
    "exp": lambda op, a: torch.exp(a),
    "log": lambda op, a: torch.log(a),
    "sin": lambda op, a: torch.sin(a),
    "cos": lambda op, a: torch.cos(a),
    "tanh": lambda op, a: torch.tanh(a),
    "sqrt": lambda op, a: torch.sqrt(a),
    "reciprocal": lambda op, a: torch.reciprocal(a),
    "pow": lambda op, a: torch.pow(a, op.param[0]),
    "clamp": _clamp,
    "where": lambda op, c, a, b: torch.where(c, a, b),
    "float": lambda op, a: a.to(torch.float32),
    "fill": lambda op, a: torch.full_like(a, op.param[0],
                                          dtype=torch.float32),
}
OPS = frozenset(_EVAL)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def _number(v, op: str) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise _refuse(f"a constant {v!r} that is not a number", op)
    return float(v)


def _check_value(node, op: str) -> None:
    """A node's value must be float32 or bool, of at most one axis."""
    val = node.meta.get("val")
    if not isinstance(val, torch.Tensor):
        raise _refuse(f"a value that is not a tensor ({type(val).__name__})",
                      op)
    if val.dtype == torch.float64:
        raise _refuse("a float64 value (the kernels compute in float32)", op)
    if val.dtype not in (torch.float32, torch.bool):
        raise _refuse(f"a {val.dtype} value (the kernels take float32 and "
                      f"bool values)", op)
    if val.dim() > 1:
        raise _refuse(f"a value of shape {tuple(val.shape)} (the samplers "
                      f"see one node a lane)", op)


def _lower(gm: torch.fx.GraphModule, trace_dev: torch.device,
           inputs: Tuple[str, ...]) -> TracedWind:
    env = {}
    ops = []
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for k, node in enumerate(placeholders):
        env[node] = k
    on_card = trace_dev.type != "cpu"

    def arg(a, op):
        if isinstance(a, torch.fx.Node):
            return env[a]
        return Lit(_number(a, op), host=True)

    def emit(name, args, param=()):
        ops.append(Op(name, tuple(args), tuple(param)))
        return len(inputs) + len(ops) - 1

    out = None
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "output":
            out = node.args[0]
            continue
        if node.op == "get_attr":
            c = getattr(gm, node.target)
            if not isinstance(c, torch.Tensor) or c.numel() != 1:
                raise _refuse(
                    f"a captured tensor of shape {tuple(c.shape)} (an indexed "
                    f"or whole captured tensor is a record in disguise: "
                    f"pass it as a GriddedWinds2D)", "get_attr")
            if c.dtype not in (torch.float32, torch.bool):
                raise _refuse(f"a captured {c.dtype} constant", "get_attr")
            env[node] = Lit(float(c.item()), host=on_card and c.is_cpu,
                            shape=tuple(c.shape),
                            boolean=c.dtype == torch.bool)
            continue
        opname = str(node.target)
        pkt = getattr(node.target, "_overloadpacket", None)
        name = pkt.__name__ if pkt is not None else opname
        if name == "_local_scalar_dense":
            raise _refuse("a value read on the host (float(t), t.item() or "
                          "a Python branch on t)", opname)
        _check_value(node, opname)
        a, kw = node.args, dict(node.kwargs)
        if name in _IDENTITY:
            env[node] = env[a[0]] if isinstance(a[0], torch.fx.Node) \
                else arg(a[0], opname)
            continue
        if name in ("scalar_tensor", "full"):
            if name == "full" and tuple(a[0]) not in ((), (1,)):
                raise _refuse(f"a filled tensor of shape {tuple(a[0])}",
                              opname)
            val = node.meta["val"]
            dev = kw.get("device") or trace_dev
            env[node] = Lit(_number(a[-1], opname),
                            host=on_card and torch.device(dev).type == "cpu",
                            shape=tuple(val.shape),
                            boolean=val.dtype == torch.bool)
            continue
        if name == "_to_copy":
            src = a[0]
            extra = set(kw) - {"dtype", "device", "layout", "pin_memory"}
            if extra or kw.get("dtype", torch.float32) != torch.float32:
                raise _refuse(f"a copy with {kw}", opname)
            if on_card and torch.device(kw.get("device") or trace_dev
                                        ).type == "cpu":
                raise _refuse("a copy to the host (t.cpu())", opname)
            if src.meta["val"].dtype == torch.bool:
                env[node] = emit("float", [env[src]])
            else:
                env[node] = env[src]
            continue
        if name in _FILL:
            if kw.get("dtype", torch.float32) != torch.float32 or \
                    a[0].meta["val"].dtype != torch.float32:
                raise _refuse("a filled tensor that is not float32", opname)
            value = _FILL[name] if _FILL[name] is not None else _number(
                a[1], opname)
            env[node] = emit("fill", [env[a[0]]], [value])
            continue
        if name in _BINARY:
            if name in ("add", "sub", "rsub") and kw.get("alpha", 1) != 1:
                raise _refuse("an add or sub with alpha", opname)
            if name == "div" and kw.get("rounding_mode") is not None:
                raise _refuse("a division with rounding", opname)
            env[node] = emit(_BINARY[name], [arg(x, opname) for x in a[:2]])
            continue
        if name in _UNARY:
            env[node] = emit(_UNARY[name], [env[a[0]]])
            continue
        if name == "where" and opname.endswith(".self"):
            env[node] = emit("where", [arg(x, opname) for x in a[:3]])
            continue
        if name == "pow" and opname.endswith(".Tensor_Scalar"):
            e = _number(a[1], opname)
            if e in _POW_REFUSED:
                raise _refuse(f"pow by {e} (ATen computes it through a "
                              f"double or rsqrt)", opname)
            env[node] = emit("pow", [env[a[0]]], [e])
            continue
        if name in ("clamp", "clamp_min", "clamp_max") and \
                not opname.endswith("Tensor"):
            lo = a[1] if len(a) > 1 else kw.get("min")
            hi = a[2] if len(a) > 2 else kw.get("max")
            if name == "clamp_max":
                lo, hi = None, lo
            bounds = [None if b is None else _number(b, opname)
                      for b in (lo, hi)]
            if any(b is not None and b != b for b in bounds):
                raise _refuse("a clamp with a NaN bound (ATen fills NaN)",
                              opname)
            env[node] = emit("clamp", [env[a[0]]], bounds)
            continue
        raise _refuse("an operation the kernels do not compile (reductions, "
                      "shape changes, indexing and others)", opname)
    outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    if len(outs) != len(inputs) - 1:
        raise _refuse("samplers that do not return one tensor each", "output")
    lowered = []
    for o in outs:
        if not isinstance(o, torch.fx.Node):
            raise _refuse(f"a sampler that returns {o!r}, not a tensor",
                          "output")
        if o.meta["val"].dtype != torch.float32:
            raise _refuse(f"a sampler that returns {o.meta['val'].dtype}",
                          "output")
        lowered.append(env[o])
    return TracedWind(tuple(ops), tuple(lowered), tuple(inputs))


def _trace(fn, placeholders, dev) -> TracedWind:
    """``fn`` (the samplers, returning a tuple) traced by ``make_fx`` on
    the float32 ``placeholders`` (x, y, t or x, t) and lowered."""
    from torch.fx.experimental.proxy_tensor import make_fx

    try:
        gm = make_fx(fn)(*placeholders)
    except RuntimeError as e:
        if "_local_scalar_dense" in str(e):
            raise _refuse("a value read on the host (float(t), t.item() or "
                          "a Python branch on t)",
                          "aten._local_scalar_dense") from e
        raise
    return _lower(gm, dev, INPUTS if len(placeholders) == 3 else INPUTS_1D)


def trace_winds(u: Callable, v: Callable, device="cpu") -> TracedWind:
    """Trace the samplers ``u(x, y, t)``, ``v(x, y, t)`` on ``device``
    (float32 placeholders: ``x``, ``y`` of shape ``[4]``, ``t`` 0-dim) and
    lower them (module docstring); raises ``NotImplementedError`` naming
    the first operation the kernels cannot take."""
    dev = torch.device(device)
    x = torch.zeros(4, dtype=torch.float32, device=dev)
    y = torch.zeros(4, dtype=torch.float32, device=dev)
    t = torch.zeros((), dtype=torch.float32, device=dev)
    # through a lambda: make_fx counts defaulted parameters as inputs
    return _trace(lambda x, y, t: (u(x, y, t), v(x, y, t)), (x, y, t), dev)


def trace_winds_1d(u: Callable, device="cpu") -> TracedWind:
    """Trace the 1D sampler ``u(x, t)`` on ``device`` (float32
    placeholders: ``x`` of shape ``[4]``, ``t`` 0-dim) and lower it as
    ``trace_winds`` lowers a 2D pair, with the same refusals; its
    ``source`` is ``traced_wind_1d(x, t)``."""
    dev = torch.device(device)
    x = torch.zeros(4, dtype=torch.float32, device=dev)
    t = torch.zeros((), dtype=torch.float32, device=dev)
    return _trace(lambda x, t: (u(x, t),), (x, t), dev)
