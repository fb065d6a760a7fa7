"""Wind callables that read their time, traced for the kernels.

The Pallas kernels of the JAX package inline whatever wind closure the model
holds: JAX traces ``u(x, y, t)`` and ``v(x, y, t)`` into each kernel's body,
where they are evaluated at every stage time on the lanes' own arrays, in
the lanes' dtype, and the 1D model's jitted loop evaluates ``u(x, t)``
likewise.  A CUDA kernel is compiled before its launch, so the port does
the same in three steps:

1. ``trace_winds`` traces the two samplers once with ``make_fx`` on
   placeholders of the model's dtype (float32: ``x`` and ``y`` of shape
   ``[n]``, ``t`` 0-dim; float64: ``t`` of shape ``[n]`` too, the rank at
   which the plain callers pass it, and once more 0-dim, below) and lowers
   the aten graph to a short list of elementwise operations (``Op``), each
   with the dtype of its result, the ``TracedWind``; ``trace_winds_1d``
   traces the 1D sampler ``u(x, t)`` the same way, through the same
   lowering;
2. ``TracedWind.source`` emits that list as one CUDA device function in the
   model's scalar type, ``picles::traced_wind(x, y, t, u, v)``, or for a 1D
   sampler ``picles::traced_wind_1d(x, t)`` returning u
   (``traced_wind.cuh``), each value in its own C type;
3. ``ops/cuda_build.py`` ``traced_library`` compiles the 2D function into
   the traced instances of K1, K3, K5 and K6, and ``traced_library_1d`` the
   1D one into those of K7 (wind kind ``TRACED``), a library of each traced
   wind's own (of each dtype's own: the float64 ones hold the double
   instances).

``TracedWind.evaluate`` is the plain version: the same list run as torch
operations in the same order and dtypes, bit for bit the callable on the
device it runs on (``TracedWind.winds`` wraps it as a ``Winds2D``, or a
``Winds1D`` for a 1D sampler).

What the tracer takes: the operations of ``OPS`` on float32 and bool values
(and float64 ones in a float64 trace; a float32 trace refuses any float64
value), conversions between them, literals (Python numbers, and captured
tensors of one element), and nothing else.  It refuses, with a
``NotImplementedError`` that names the aten operation and
``advance_mode="torch"``: a value read on the host (``float(t)``,
``t.item()``, a Python branch on ``t``: aten ``_local_scalar_dense``), an
indexed captured tensor (a record in disguise), a reduction, a shape
change, an integer value, a clamp with a NaN bound, in a float64 trace a
value whose dtype depends on the rank of ``t`` (torch promotes a float32
``[n]`` tensor with a float64 0-dim one to float32, with a float64 ``[n]``
one to float64: the kernel could follow one caller only), and any
operation not listed.  Such a wind runs with ``advance_mode="torch"`` (and
in 2D ``remesh_mode="xla"``), or as a ``GriddedWinds2D`` or
``GriddedWinds1D`` record.

The emitter writes each operation as PyTorch's CUDA kernels compute it,
not as the Python text reads, in the dtype ATen computes it in (the
result's; for a comparison, its operands' promoted dtype), a value of
another dtype converted to it first: a division by a host scalar (a Python
number, or a tensor of one element on the CPU while the trace runs on a
card) is a product with its reciprocal in the operation's dtype (ATen's
``div_true_kernel_cuda``), a division by a device value a division; ``c /
x`` reaches the graph as ``reciprocal(x) * c`` (``Tensor.__rtruediv__``);
``pow(x, 2)`` is ``x * x``, ``pow(x, 3)`` ``x * x * x``, ``pow(x, 0.5)``
``sqrt(x)``, ``pow(x, -1)`` ``1 / x``, in double ``pow(x, -2)`` ``1 / (x *
x)`` (ATen's ``pow_tensor_scalar_kernel_impl``), any other exponent ``pow``
(-0.5, which ATen computes through ``rsqrt``, and in float32 -2, which it
computes through a double, are refused); ``minimum``, ``maximum`` and
``clamp`` pass a NaN operand through as ATen does; the transcendentals are
the precise ``expf`` ... ``sqrtf`` of float32 and ``exp`` ... ``sqrt`` of
float64.  Literals are exact hexadecimal floats of the operation's dtype,
so the text, and the hash that names its library, depend only on the
graph, its constants and its dtype.  In a float64 function every
conversion to float32 and the float32 ``sinf`` and ``cosf`` (whose
argument reduction runs in float64) sit out of line, in functions named
``traced_f32_...``, which the build's check of the double instances passes
over by name (``cuda_build.narrowing_summary``).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

F32, F64, BOOL = torch.float32, torch.float64, torch.bool
# the C type of each dtype a value may take
_CTYPE = {F32: "float", F64: "double", BOOL: "bool"}
# the dtypes a trace's values may take, by the model's (the lanes') dtype
_VALUE_DTYPES = {F32: (F32, BOOL), F64: (F32, F64, BOOL)}

# The operations whose result is bool (every other one is a float); the
# operations the tracer lowers are the keys of ``_EVAL``, below (``OPS``).
# ``pow`` and ``fill`` carry a number in ``Op.param``, ``clamp`` its two
# bounds (None for an open side).
_BOOL_RESULT = frozenset(("lt", "le", "gt", "ge", "eq", "ne", "and", "or",
                          "xor", "not"))
_LOGICAL = frozenset(("and", "or", "xor", "not"))

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
# the exponents ATen's CUDA pow computes through rsqrt or, in float32, a
# double (1.0 / (x * x) with a double literal)
_POW_REFUSED = {F32: (-2.0, -0.5), F64: (-0.5,)}

# the samplers' inputs: u(x, y, t) and v(x, y, t), or the 1D u(x, t)
INPUTS = ("x", "y", "t")
INPUTS_1D = ("x", "t")

# the prefix of the out-of-line float32 functions of a float64 graph
TRACED_F32_PREFIX = "traced_f32_"


@dataclasses.dataclass(frozen=True)
class Lit:
    """A constant operand.  ``shape`` None: a Python number (``dtype``
    None: it takes the dtype of the operation it enters, as ATen's wrapped
    numbers do); else a tensor of that shape (one element) and ``dtype``.
    ``host``: ATen takes it as a CPU scalar on a card (a Python number, or
    a CPU tensor in a trace on a card)."""

    value: float
    host: bool
    shape: Optional[Tuple[int, ...]] = None
    dtype: Optional[torch.dtype] = None

    @property
    def boolean(self) -> bool:
        return self.dtype == BOOL


Arg = Union[int, Lit]


@dataclasses.dataclass(frozen=True)
class Op:
    """One elementwise operation: its operands are values (``int``: the
    inputs in order (x, y, t, or x, t in 1D), then the results of the
    operations before it in order) or literals; ``dtype`` its result's,
    ``ctype`` the dtype it computes in (the result's, but for a
    comparison: its operands' promoted dtype)."""

    name: str
    args: Tuple[Arg, ...]
    param: tuple = ()
    dtype: torch.dtype = F32
    ctype: torch.dtype = F32


def _refuse(what: str, op: str) -> NotImplementedError:
    return NotImplementedError(
        f"the wind callable cannot be traced into the CUDA kernels: {what} "
        f"(aten op {op}).  The kernels take u(x, y, t) and v(x, y, t), or "
        f"the 1D u(x, t), built from elementwise float32 (in a float64 "
        f"model also float64) operations (forcing/wind_trace.py OPS) and "
        f"constants; run this wind with advance_mode=\"torch\" (in 2D with "
        f"remesh_mode=\"xla\": the plain step), or as a GriddedWinds2D or "
        f"GriddedWinds1D record")


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


def _hex_double(v: float) -> str:
    """A float64 literal in C: exact hexadecimal, or math.h's macros
    widened."""
    v = float(v)
    if v != v:
        return "((double)NAN)"
    if v in (float("inf"), float("-inf")):
        return "((double)INFINITY)" if v > 0 else "(-(double)INFINITY)"
    s = v.hex()
    return f"({s})" if s.startswith("-") else s


def _lit(v: float, dtype: torch.dtype) -> str:
    """``v`` as a literal of ``dtype`` (float32 or float64), rounded once."""
    return _hex_double(v) if dtype == F64 else _hex(v)


@dataclasses.dataclass(frozen=True)
class TracedWind:
    """A wind callable lowered to elementwise operations: ``ops`` in order,
    ``outputs`` the values (or literals) of u and v, or of the 1D u alone
    (``inputs`` ``INPUTS_1D``); ``dtype`` the model's (the lanes', and the
    inputs'), float32 or float64."""

    ops: Tuple[Op, ...]
    outputs: Tuple[Arg, ...]
    inputs: Tuple[str, ...] = INPUTS
    dtype: torch.dtype = F32

    @property
    def one_d(self) -> bool:
        """Whether this is a 1D sampler ``u(x, t)``."""
        return self.inputs == INPUTS_1D

    def dtype_of(self, a: Arg) -> torch.dtype:
        """The dtype of a value or literal operand (a Python number's is
        the model's)."""
        if isinstance(a, int):
            return (self.dtype if a < len(self.inputs)
                    else self.ops[a - len(self.inputs)].dtype)
        return a.dtype or self.dtype

    @property
    def narrowings(self) -> int:
        """The conversions from float64 to float32 the graph makes (its
        cast operations, and its float64 values entering a float32
        operation)."""
        call = TRACED_F32_PREFIX + "narrow("
        return sum(ln.count(call) for ln in self.source.splitlines()
                   if not ln.startswith("static"))

    # -- the plain version -------------------------------------------------

    def evaluate(self, *coords) -> Tuple[torch.Tensor, ...]:
        """(u, v) at ``(x, y, t)``, or (u,) of a 1D sampler at ``(x, t)``:
        the operations run as torch operations in order, on ``x``'s
        device, each output in its own dtype (a float64 trace's may be
        float32, which the caller casts to the lanes' dtype, as JAX's
        kernel casts the closure's value)."""
        dev = coords[0].device
        t = torch.as_tensor(coords[-1], dtype=self.dtype, device=dev)
        vals = [*coords[:-1], t]

        def get(a):
            if isinstance(a, int):
                return vals[a]
            if a.shape is None:
                return a.value
            return torch.full(a.shape, a.value, dtype=a.dtype,
                              device="cpu" if a.host else dev)

        for op in self.ops:
            vals.append(_EVAL[op.name](op, *(get(a) for a in op.args)))
        return tuple(torch.as_tensor(get(o), dtype=self.dtype_of(o),
                                     device=dev) for o in self.outputs)

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
        y, t, u, v)``, or ``picles::traced_wind_1d(x, t)`` returning u, in
        the model's scalar type, one ``const`` a value in order."""
        names = list(self.inputs)
        used = _Used(self.dtype == F64)

        def ref(a, ty=None) -> str:
            """Operand ``a`` in the dtype ``ty`` its operation computes in
            (None: as it is)."""
            if isinstance(a, int):
                return _convert(names[a], self.dtype_of(a), ty, used)
            if a.boolean:
                return "true" if a.value else "false"
            return _lit(a.value, ty or a.dtype or self.dtype)

        lines = []
        for k, op in enumerate(self.ops):
            name = f"s{k}"
            lines.append(f"  const {_CTYPE[op.dtype]} {name} = "
                         f"{_emit(op, ref, used)};")
            names.append(name)
        outs = [ref(o, self.dtype) for o in self.outputs]
        ty = _CTYPE[self.dtype]
        if self.one_d:
            what, head, tail = (
                "u of one traced 1D wind callable at (x, t)",
                f"__device__ __forceinline__ {ty} traced_wind_1d({ty} x, "
                f"{ty} t) {{", [f"  return {outs[0]};"])
        else:
            what, head, tail = (
                "u and v of one traced wind callable at (x, y, t)",
                f"__device__ __forceinline__ void traced_wind({ty} x, {ty} "
                f"y, {ty} t, {ty}& u, {ty}& v) {{",
                [f"  u = {outs[0]};", f"  v = {outs[1]};"])
        return "\n".join([
            f"// {what}: the",
            "// elementwise operations of its graph in order, each as",
            "// PyTorch's CUDA kernels compute it.  Written by",
            "// picles_torch/forcing/wind_trace.py.",
            "#pragma once",
            "#include <math.h>",
            "namespace picles {",
            *_out_of_line(used),
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


# the out-of-line float32 functions of a float64 graph: each narrows inside
# (a conversion, or sinf's and cosf's float64 argument reduction)
_F32_FUNCS = {"narrow": ("double", "(float)a"), "sin": ("float", "sinf(a)"),
              "cos": ("float", "cosf(a)")}


def _out_of_line(used) -> list:
    """The definitions of the ``traced_f32_...`` functions a float64 graph
    calls, in a fixed order (none in a float32 graph)."""
    out = []
    if used:
        out.append("// float32 operations of this float64 graph that narrow "
                   "inside, out of line")
    for fn, (arg, body) in _F32_FUNCS.items():
        if fn in used:
            out.append(f"static __device__ __noinline__ float "
                       f"{TRACED_F32_PREFIX}{fn}({arg} a) {{ return {body}; }}")
    return out


def _convert(name: str, have: torch.dtype, want: Optional[torch.dtype],
             used) -> str:
    """Value ``name`` of dtype ``have`` in dtype ``want``: as it is (the
    same dtype, None, or a bool, which C promotes exactly), widened, or
    narrowed out of line."""
    if want is None or want == have or have == BOOL or want == BOOL:
        return name
    if want == F64:
        return f"(double){name}"
    used.add("narrow")
    return f"{TRACED_F32_PREFIX}narrow({name})"


def _nan_pass(a: str, b: str, fn: str) -> str:
    """ATen's minimum/maximum on a card: a NaN operand passes through."""
    return f"({a} != {a} ? {a} : ({b} != {b} ? {b} : {fn}({a}, {b})))"


_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_ARITH = {"add": "+", "sub": "-", "mul": "*", "and": "&&", "or": "||",
          "xor": "!="}
_MATH = {"abs": "fabsf", "exp": "expf", "log": "logf", "sin": "sinf",
         "cos": "cosf", "tanh": "tanhf", "sqrt": "sqrtf"}
_MATH64 = {"abs": "fabs", "exp": "exp", "log": "log", "sin": "sin",
           "cos": "cos", "tanh": "tanh", "sqrt": "sqrt"}


def _math(n: str, ty: torch.dtype, used) -> str:
    """The precise function ``n`` of ``ty``; float32 sin and cos out of
    line where a float64 graph calls them."""
    if ty == F64:
        return _MATH64[n]
    if n in ("sin", "cos") and used is not None and used.is_f64:
        used.add(n)
        return TRACED_F32_PREFIX + n
    return _MATH[n]


class _Used(set):
    """The out-of-line functions a graph calls, and whether it is a
    float64 graph (whose float32 sin and cos go out of line)."""

    def __init__(self, is_f64: bool):
        super().__init__()
        self.is_f64 = is_f64


def _emit(op: Op, ref, used) -> str:
    """The C expression of one operation."""
    n, a, ty = op.name, op.args, op.ctype
    dbl = ty == F64
    one = "1.0" if dbl else "1.0f"
    if n == "where":
        r = [ref(a[0]), ref(a[1], ty), ref(a[2], ty)]
    elif n in ("float", "cast") or n in _LOGICAL:
        r = [ref(x) for x in a]
    else:
        r = [ref(x, ty) for x in a]
    if n in _ARITH:
        return f"{r[0]} {_ARITH[n]} {r[1]}"
    if n in _CMP:
        return f"{r[0]} {_CMP[n]} {r[1]}"
    if n == "rsub":
        return f"{r[1]} - {r[0]}"
    if n == "div":
        d = a[1]
        if isinstance(d, Lit) and d.host:
            with np.errstate(divide="ignore", over="ignore"):
                if dbl:
                    inv = float(np.float64(1.0) / np.float64(d.value))
                else:
                    inv = float(np.float32(1.0) / np.float32(d.value))
            return f"{r[0]} * {_lit(inv, ty)}"
        return f"{r[0]} / {r[1]}"
    if n in ("minimum", "maximum"):
        fn = "fmin" if n == "minimum" else "fmax"
        return _nan_pass(r[0], r[1], fn if dbl else fn + "f")
    if n in _MATH:
        return f"{_math(n, ty, used)}({r[0]})"
    if n == "neg":
        return f"-{r[0]}"
    if n == "not":
        return f"!{r[0]}"
    if n == "reciprocal":
        return f"{one} / {r[0]}"
    if n == "pow":
        e = op.param[0]
        if e == 2:
            return f"{r[0]} * {r[0]}"
        if e == 3:
            return f"{r[0]} * {r[0]} * {r[0]}"
        if e == 0.5:
            return f"{'sqrt' if dbl else 'sqrtf'}({r[0]})"
        if e == 1:
            return r[0]
        if e == 0:
            return one
        if e == -1:
            return f"{one} / {r[0]}"
        if e == -2 and dbl:
            return f"{one} / ({r[0]} * {r[0]})"
        return f"{'pow' if dbl else 'powf'}({r[0]}, {_lit(e, ty)})"
    if n == "clamp":
        lo, hi = op.param
        val = r[0]
        if lo is not None:
            val = f"{'fmax' if dbl else 'fmaxf'}({val}, {_lit(lo, ty)})"
        if hi is not None:
            val = f"{'fmin' if dbl else 'fminf'}({val}, {_lit(hi, ty)})"
        return f"({r[0]} != {r[0]} ? {r[0]} : {val})"
    if n == "where":
        return f"{r[0]} ? {r[1]} : {r[2]}"
    if n == "float":
        zero = "0.0" if op.dtype == F64 else "0.0f"
        return f"{r[0]} ? {'1.0' if op.dtype == F64 else '1.0f'} : {zero}"
    if n == "cast":
        return _convert(r[0], op.param[0], op.dtype, used)
    if n == "fill":
        return _lit(op.param[0], op.dtype)
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
    "float": lambda op, a: a.to(op.dtype),
    "cast": lambda op, a: a.to(op.dtype),
    "fill": lambda op, a: torch.full_like(a, op.param[0], dtype=op.dtype),
}
OPS = frozenset(_EVAL)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def _number(v, op: str) -> float:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise _refuse(f"a constant {v!r} that is not a number", op)
    return float(v)


def _check_value(node, op: str, real: torch.dtype) -> None:
    """A node's value must be of a dtype the trace takes
    (``_VALUE_DTYPES``), of at most one axis."""
    val = node.meta.get("val")
    if not isinstance(val, torch.Tensor):
        raise _refuse(f"a value that is not a tensor ({type(val).__name__})",
                      op)
    if val.dtype == F64 and real == F32:
        raise _refuse("a float64 value in a float32 trace (a float32 model's "
                      "kernels compute in float32)", op)
    if val.dtype not in _VALUE_DTYPES[real]:
        raise _refuse(f"a {val.dtype} value (the kernels take float32, "
                      f"float64 and bool values)", op)
    if val.dim() > 1:
        raise _refuse(f"a value of shape {tuple(val.shape)} (the samplers "
                      f"see one node a lane)", op)


def _proto(val) -> torch.Tensor:
    """An empty tensor of a value's shape and dtype (for ATen's dtype
    promotion rules)."""
    return torch.empty(tuple(val.shape), dtype=val.dtype)


def _lower(gm: torch.fx.GraphModule, trace_dev: torch.device,
           inputs: Tuple[str, ...], real: torch.dtype) -> TracedWind:
    env = {}
    proto = {}
    ops = []
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for k, node in enumerate(placeholders):
        env[node] = k
        proto[node] = _proto(node.meta["val"])
    on_card = trace_dev.type != "cpu"

    def arg(a, op):
        if isinstance(a, torch.fx.Node):
            return env[a]
        return Lit(_number(a, op), host=True)

    def proto_of(a):
        return proto[a] if isinstance(a, torch.fx.Node) else a

    def emit(name, args, param=(), dtype=F32, ctype=None):
        ops.append(Op(name, tuple(args), tuple(param), dtype,
                      dtype if ctype is None else ctype))
        return len(inputs) + len(ops) - 1

    def floats(*dts):
        return all(d in _VALUE_DTYPES[real] and d != BOOL for d in dts)

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
            if c.dtype == F64 and real == F32:
                raise _refuse("a float64 value in a float32 trace (a "
                              "captured constant)", "get_attr")
            if c.dtype not in _VALUE_DTYPES[real]:
                raise _refuse(f"a captured {c.dtype} constant", "get_attr")
            env[node] = Lit(float(c.item()), host=on_card and c.is_cpu,
                            shape=tuple(c.shape), dtype=c.dtype)
            proto[node] = _proto(c)
            continue
        opname = str(node.target)
        pkt = getattr(node.target, "_overloadpacket", None)
        name = pkt.__name__ if pkt is not None else opname
        if name == "_local_scalar_dense":
            raise _refuse("a value read on the host (float(t), t.item() or "
                          "a Python branch on t)", opname)
        _check_value(node, opname, real)
        val = node.meta["val"]
        proto[node] = _proto(val)
        a, kw = node.args, dict(node.kwargs)
        if name in _IDENTITY:
            env[node] = env[a[0]] if isinstance(a[0], torch.fx.Node) \
                else arg(a[0], opname)
            continue
        if name in ("scalar_tensor", "full"):
            if name == "full" and tuple(a[0]) not in ((), (1,)):
                raise _refuse(f"a filled tensor of shape {tuple(a[0])}",
                              opname)
            dev = kw.get("device") or trace_dev
            env[node] = Lit(_number(a[-1], opname),
                            host=on_card and torch.device(dev).type == "cpu",
                            shape=tuple(val.shape), dtype=val.dtype)
            continue
        if name in ("_to_copy", "convert_element_type"):
            src = a[0]
            if name == "_to_copy":
                extra = set(kw) - {"dtype", "device", "layout", "pin_memory"}
                if extra:
                    raise _refuse(f"a copy with {kw}", opname)
                if on_card and torch.device(kw.get("device") or trace_dev
                                            ).type == "cpu":
                    raise _refuse("a copy to the host (t.cpu())", opname)
            have = proto[src].dtype
            if have == BOOL and val.dtype != BOOL:
                env[node] = emit("float", [env[src]], dtype=val.dtype)
            elif have == val.dtype:
                env[node] = env[src]
            elif floats(have, val.dtype):
                env[node] = emit("cast", [env[src]], [have], dtype=val.dtype)
            else:
                raise _refuse(f"a conversion from {have} to {val.dtype}",
                              opname)
            continue
        if name in _FILL:
            if not floats(val.dtype, proto[a[0]].dtype):
                raise _refuse("a filled tensor that is not a float",
                              opname)
            value = _FILL[name] if _FILL[name] is not None else _number(
                a[1], opname)
            env[node] = emit("fill", [env[a[0]]], [value], dtype=val.dtype)
            continue
        if name in _BINARY:
            if name in ("add", "sub", "rsub") and kw.get("alpha", 1) != 1:
                raise _refuse("an add or sub with alpha", opname)
            if name == "div" and kw.get("rounding_mode") is not None:
                raise _refuse("a division with rounding", opname)
            low = _BINARY[name]
            ctype = BOOL if low in _LOGICAL else torch.result_type(
                *(proto_of(x) for x in a[:2]))
            if low not in _BOOL_RESULT and ctype != val.dtype:
                raise _refuse(f"a {val.dtype} result of {ctype} operands",
                              opname)
            env[node] = emit(low, [arg(x, opname) for x in a[:2]],
                             dtype=val.dtype, ctype=ctype)
            continue
        if name in _UNARY:
            low = _UNARY[name]
            env[node] = emit(low, [env[a[0]]], dtype=val.dtype,
                             ctype=BOOL if low in _LOGICAL else val.dtype)
            continue
        if name == "where" and opname.endswith(".self"):
            env[node] = emit("where", [arg(x, opname) for x in a[:3]],
                             dtype=val.dtype)
            continue
        if name == "pow" and opname.endswith(".Tensor_Scalar"):
            e = _number(a[1], opname)
            if e in _POW_REFUSED[val.dtype]:
                raise _refuse(f"pow by {e} in {val.dtype} (ATen computes it "
                              f"through rsqrt or a double)", opname)
            env[node] = emit("pow", [env[a[0]]], [e], dtype=val.dtype)
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
            env[node] = emit("clamp", [env[a[0]]], bounds, dtype=val.dtype)
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
        if not floats(o.meta["val"].dtype):
            raise _refuse(f"a sampler that returns {o.meta['val'].dtype}",
                          "output")
        lowered.append(env[o])
    return TracedWind(tuple(ops), tuple(lowered), tuple(inputs), real)


def _make_fx(fn, placeholders):
    from torch.fx.experimental.proxy_tensor import make_fx

    try:
        return make_fx(fn)(*placeholders)
    except RuntimeError as e:
        if "_local_scalar_dense" in str(e):
            raise _refuse("a value read on the host (float(t), t.item() or "
                          "a Python branch on t)",
                          "aten._local_scalar_dense") from e
        raise


def _signature(tr: TracedWind) -> tuple:
    """What the dtypes of a trace are: each operation's name and dtypes,
    and the outputs' dtypes."""
    return (tuple((op.name, op.dtype, op.ctype) for op in tr.ops),
            tuple(tr.dtype_of(o) for o in tr.outputs))


def _trace(fn, n_inputs: int, dev, dtype) -> TracedWind:
    """``fn`` (the samplers, returning a tuple) traced by ``make_fx`` on
    placeholders of ``dtype`` (x, y, t or x, t; the points of shape
    ``[4]``) and lowered.  A float32 trace takes ``t`` 0-dim; a float64
    one ``t`` of shape ``[4]``, the rank at which the plain callers pass
    it, and again 0-dim: it is refused where a value's dtype differs
    between the two."""
    inputs = INPUTS if n_inputs == 3 else INPUTS_1D
    if dtype not in _VALUE_DTYPES:
        raise ValueError(f"a wind is traced in float32 or float64, not "
                         f"{dtype}")
    points = [torch.zeros(4, dtype=dtype, device=dev)
              for _ in range(n_inputs - 1)]
    t0 = torch.zeros((), dtype=dtype, device=dev)
    if dtype == F32:
        return _lower(_make_fx(fn, (*points, t0)), dev, inputs, dtype)
    lanes = _lower(_make_fx(fn, (*points, torch.zeros(4, dtype=dtype,
                                                      device=dev))),
                   dev, inputs, dtype)
    scalar = _lower(_make_fx(fn, (*points, t0)), dev, inputs, dtype)
    if _signature(lanes) != _signature(scalar):
        raise _refuse("a value whose dtype depends on the rank of t (torch "
                      "promotes a float32 [n] tensor with a float64 0-dim "
                      "one to float32, with a float64 [n] one to float64)",
                      "the dtypes of the graph")
    return lanes


def trace_winds(u: Callable, v: Callable, device="cpu",
                dtype: torch.dtype = F32) -> TracedWind:
    """Trace the samplers ``u(x, y, t)``, ``v(x, y, t)`` on ``device`` in
    the model's ``dtype`` (placeholders ``x``, ``y`` of shape ``[4]``, ``t``
    0-dim, and in float64 of shape ``[4]`` too: ``_trace``) and lower them
    (module docstring); raises ``NotImplementedError`` naming the first
    operation the kernels cannot take."""
    # through a lambda: make_fx counts defaulted parameters as inputs
    return _trace(lambda x, y, t: (u(x, y, t), v(x, y, t)), 3,
                  torch.device(device), dtype)


def trace_winds_1d(u: Callable, device="cpu",
                   dtype: torch.dtype = F32) -> TracedWind:
    """Trace the 1D sampler ``u(x, t)`` on ``device`` in the model's
    ``dtype`` (placeholders ``x`` of shape ``[4]``, ``t`` as
    ``trace_winds`` has it) and lower it as ``trace_winds`` lowers a 2D
    pair, with the same refusals; its ``source`` is ``traced_wind_1d(x,
    t)``."""
    return _trace(lambda x, t: (u(x, t),), 2, torch.device(device), dtype)
