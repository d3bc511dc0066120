"""CUDA device functions for the policies added with ``register_policy``.

The reference runs a registered policy inside its Pallas kernels: it
traces the policy's ``jnp`` step into the kernel body. The port does the
same for its CUDA kernels (``csrc/policy_scan.cu``): a registered lane
step ``fn(carry, arrive, params, dt)`` is traced once with
``torch.fx.experimental.proxy_tensor.make_fx`` (fake tensors, so no value
is baked in), its ATen operations are taken apart into scalar operations
per lane, and each becomes one line of a ``__device__`` function. The
functions of every registered policy (an override of a built-in
included: it loses its built-in branch) go into one header,
``registered_steps.cuh``, with a switch on the kernel branch; ``build``
compiles ``policy_scan.cu`` with it into a library of its own, keyed by
the header's text, and the kernels run a generated branch as they run a
built-in one.

Kernel branch ids: the five built-ins are 0-4; a registered policy with
registry index ``p`` is ``FIRST_GENERATED + p``.

Values per lane are float32, float64, int32, int64 or bool; the carry,
the parameters and the five outputs stay float32. Every elementwise
operation falls in one of two classes.

Bitwise the port's CPU run, each emitted as the formula ATen's CPU
kernel computes, under the kernels' flags (``--fmad=false``, IEEE
division and square root): + - * /, neg, abs, min, max, clamp, ceil,
floor, trunc, round, sqrt, reciprocal, the scalar powers the CPU takes
as products, square roots and quotients (2, 3, 0.5, -0.5, -1, -2),
comparisons, logical and bitwise and / or / xor / not, shifts (a count
below 0 or at the width and above gives the CPU's 0 or sign fill),
``where``, constants, the indexing, stacking and reshaping that keep
the lane dimension first; integer + - * and neg wrap in two's
complement (emitted through unsigned arithmetic); ``//``, ``%``,
``fmod`` and ``div`` with a rounding mode, on integers and on floats
(floor semantics by ATen's ``div_floor_*`` and ``remainder`` fix-ups);
``nextafter``, ``copysign``, ``sign``, ``signbit``, ``isnan``, ``isinf``,
``isfinite``, ``frac``; casts between all five types (a float to an
integer as x86's truncating conversion gives it: NaN, +-inf and values
out of range become the type's minimum) and bit views of equal width
(float32 <-> int32, float64 <-> int64). An integer division or
remainder by zero sets a flag in the kernel (``INT_DIV_FLAG``), and the
wrapper raises the CPU's ``RuntimeError: ZeroDivisionError`` after the
launch (``Generated.int_div`` names the policies that divide integers).

Within an ulp bound (``TRANSCENDENTAL``): ``exp``, ``log``, ``tanh``,
``expm1``, ``log1p``, ``sigmoid``, ``softplus`` (with its ``beta`` and
``threshold``), ``pow`` with any other scalar exponent, ``sin``,
``cos``, ``tan``, ``atan``, ``atan2``, ``exp2``, ``log2``, ``log10``,
``erf``, ``hypot``, ``sinh``, ``cosh`` and ``rsqrt`` (the CPU's is not
``1 / sqrt``): CUDA's functions of the operand's type, sigmoid as ``1 /
(1 + exp(-x))`` and softplus as ``x * beta > threshold ? x :
log1p(exp(x * beta)) / beta``, the formulas of PyTorch's own kernels.
They do not round as the CPU's do: a policy whose step uses one is
listed in ``Generated.transcendental``, and its rows are held to the CPU
run within an ulp bound, not bit for bit.

What has no CUDA form is what the reference refuses too: Python control
flow on a value (JAX cannot trace it), and an operation across lanes or
a lane index (the reference's lane parity check fails on such a step).
The wrappers refuse its rows on the card, naming the operation
(``Generated.refused``), and it runs with ``device="cpu"``.

``interpret`` runs a translation with PyTorch operations, one per scalar
operation, so the CPU tests can hold the decomposition (ATen's formulas
taken apart into these operations) against the step itself bit for
bit.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.twin import (CARRY_DIM, PARAM_DIM, policy_names,
                                   policy_spec)

#: the kernel branch id of the registered policy at registry index 0
FIRST_GENERATED = 5
#: the kernel branch of a policy whose step has no CUDA form
REFUSED = -3
#: lanes of the traced block: a prime no parameter or carry width equals,
#: so a lane dimension is never mistaken for another
TRACE_LANES = 7
#: the device flag an integer division by zero sets (``csrc/policy_scan.cu``)
INT_DIV_FLAG = "repro_int_div_by_zero"

_DTYPES = {torch.float32: "f32", torch.float64: "f64", torch.bool: "bool",
           torch.int32: "i32", torch.int64: "i64"}
_TORCH = {v: k for k, v in _DTYPES.items()}
_CTYPE = {"f32": "float", "f64": "double", "bool": "bool", "i32": "int",
          "i64": "long long"}
_INTS = ("i32", "i64")
_FLOATS = ("f32", "f64")
#: integer types: bits, C's unsigned type of the same width, the minimum
_INT_INFO = {"i32": (32, "unsigned", "(-2147483647 - 1)"),
             "i64": (64, "unsigned long long",
                     "(-9223372036854775807LL - 1)")}


class Untranslatable(NotImplementedError):
    """A lane step with an operation the kernels cannot reproduce."""


@dataclass(frozen=True)
class Scalar:
    """One per-lane value: a variable (``name``) or a literal (``value``),
    of dtype f32, f64, i32, i64, bool or, for literals only, int."""
    dtype: str
    name: Optional[str] = None
    value: object = None


@dataclass(frozen=True)
class Instr:
    """``dst = op(args)`` computed in ``dtype`` (the result's dtype; a
    comparison or ``signbit`` computes in its operands' dtype and yields
    bool; a cast or bit view yields ``dtype`` from its operand's)."""
    dst: str
    dtype: str
    op: str
    args: Tuple[Scalar, ...]


@dataclass
class Program:
    """A lane step as scalar operations: the new carry (``carry``, two
    entries) and the five outputs, in terms of the inputs ``c_0``,
    ``c_1``, ``arrive``, ``p[0]`` .. ``p[5]`` and ``dt``."""
    instrs: List[Instr] = field(default_factory=list)
    carry: Tuple[Scalar, ...] = ()
    outs: Tuple[Scalar, ...] = ()


@dataclass(frozen=True)
class Generated:
    """What the registry needs of the kernels: ``header`` (the text of
    ``registered_steps.cuh``, None when no policy is registered),
    ``branches`` (the kernel branch of each policy, by registry index:
    a built-in's own, ``FIRST_GENERATED + index`` for a translated step,
    ``REFUSED``), ``refused`` (policy name -> why its step has no CUDA
    form), ``transcendental`` (the policies whose translated step uses
    an operation of ``TRANSCENDENTAL``) and ``int_div`` (those whose step
    divides integers by a value that may be zero, so a launch must read
    back the zero-divisor flag)."""
    header: Optional[str]
    branches: Tuple[int, ...]
    refused: Dict[str, str]
    transcendental: Tuple[str, ...] = ()
    int_div: Tuple[str, ...] = ()


class _Arr:
    """A traced value: its shape (lane dimension first, or 0-dim) and its
    per-lane entries, row-major over the dimensions after the first."""

    def __init__(self, shape, entries):
        self.shape = tuple(shape)
        self.entries = list(entries)


def _n_entries(shape) -> int:
    if len(shape) == 0:
        return 1
    if shape[0] != TRACE_LANES or len(shape) > 2:
        raise Untranslatable(f"a value of shape {tuple(shape)} (only "
                             f"per-lane values [L] or [L, k] translate)")
    return 1 if len(shape) == 1 else int(shape[1])


def _wrap(v: int, bits: int) -> int:
    """``v`` as a two's-complement integer of ``bits`` bits."""
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _literal_as(s: Scalar, dtype: str) -> Scalar:
    v = s.value
    if dtype == "bool":
        return Scalar("bool", value=bool(v))
    if dtype in _INTS:
        return Scalar(dtype, value=_wrap(int(v), _INT_INFO[dtype][0]))
    if dtype == "f32":
        return Scalar("f32", value=float(np.float32(float(v))))
    return Scalar("f64", value=float(v))


def _dtype_of(val) -> str:
    try:
        return _DTYPES[val.dtype]
    except KeyError:
        raise Untranslatable(f"dtype {val.dtype}") from None


def _dummy(x):
    """A real tensor standing in for ``x`` (a traced tensor or a number)
    in ``torch.result_type``: same dtype and 0-dim-ness."""
    if isinstance(x, torch.Tensor):
        return torch.zeros(() if x.dim() == 0 else (1,), dtype=x.dtype)
    return x


#: the scalar exponents the CPU's ``pow`` computes exactly, as products,
#: square roots and quotients (ATen's ``pow_tensor_scalar_kernel``); any
#: other goes through ``std::pow``
_POW_FORMS = {2.0: ("mul",), 3.0: ("mul", "mul"), 0.5: ("sqrt",),
              -0.5: ("sqrt", "reciprocal"), -1.0: ("reciprocal",),
              -2.0: ("mul", "reciprocal")}

#: ATen elementwise operations of one operand: packet name -> scalar op
_UNARY = {"neg": "neg", "abs": "abs", "sqrt": "sqrt",
          "reciprocal": "reciprocal", "exp": "exp", "log": "log",
          "tanh": "tanh", "expm1": "expm1", "log1p": "log1p",
          "sigmoid": "sigmoid", "logical_not": "not", "bitwise_not": "not",
          "sin": "sin", "cos": "cos", "tan": "tan", "atan": "atan",
          "exp2": "exp2", "log2": "log2", "log10": "log10", "erf": "erf",
          "sinh": "sinh", "cosh": "cosh", "rsqrt": "rsqrt"}
#: rounding to an integer value: the identity on integer types
_ROUNDING = {"ceil": "ceil", "floor": "floor", "trunc": "trunc"}
#: scalar operations that CUDA rounds otherwise than the CPU
TRANSCENDENTAL = ("exp", "log", "tanh", "expm1", "log1p", "sigmoid",
                  "softplus", "pow", "sin", "cos", "tan", "atan", "atan2",
                  "exp2", "log2", "log10", "erf", "hypot", "sinh", "cosh",
                  "rsqrt")
_BINARY = {"add": "add", "sub": "sub", "mul": "mul", "div": "div",
           "minimum": "min", "maximum": "max", "fmin": "min", "fmax": "max",
           "logical_and": "and", "logical_or": "or", "logical_xor": "xor",
           "bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor",
           "__lshift__": "shl", "bitwise_left_shift": "shl",
           "__rshift__": "shr", "bitwise_right_shift": "shr",
           "nextafter": "nextafter", "copysign": "copysign",
           "atan2": "atan2", "hypot": "hypot"}
_COMPARE = {"lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq",
            "ne": "ne"}
#: scalar operations whose result is bool whatever they compute in
_BOOL_RESULT = frozenset(_COMPARE.values()) | {"signbit"}
#: integer division and remainder: they set the zero-divisor flag
_INT_DIVISION = ("idiv", "irem")
_IDENTITY = {"clone", "alias", "detach", "lift_fresh_copy", "contiguous",
             "view", "_unsafe_view", "reshape", "expand", "squeeze",
             "unsqueeze", "_to_copy", "to"}
_CONSTANT = {"zeros_like": 0.0, "ones_like": 1.0, "new_zeros": 0.0,
             "new_ones": 1.0, "zeros": 0.0, "ones": 1.0}
#: bit views of equal width
_BITCAST = {("f32", "i32"), ("i32", "f32"), ("f64", "i64"), ("i64", "f64")}


class _Translator:
    def __init__(self, gm: torch.fx.GraphModule):
        self.gm = gm
        self.prog = Program()
        self.env: Dict[torch.fx.Node, _Arr] = {}

    # -- scalar operations ---------------------------------------------
    def emit(self, op: str, dtype: str, args) -> Scalar:
        dst = f"v{len(self.prog.instrs)}"
        self.prog.instrs.append(Instr(dst, dtype, op, tuple(args)))
        return Scalar("bool" if op in _BOOL_RESULT else dtype, name=dst)

    def cast(self, s: Scalar, dtype: str) -> Scalar:
        if s.dtype == dtype:
            return s
        if s.name is None:
            return _literal_as(s, dtype)
        return self.emit("cast", dtype, (s,))

    def lit(self, value, dtype: str) -> Scalar:
        return _literal_as(Scalar("f64", value=value), dtype)

    # ATen's composite formulas, taken apart into scalar operations ------
    def differ(self, r: Scalar, b: Scalar, dt: str) -> Scalar:
        """ATen's fix-up condition of a truncated remainder ``r`` of a
        division by ``b``: ``r != 0`` and ``r`` and ``b`` differ in sign
        (for integers, ``r`` takes the dividend's sign: ATen's
        ``signs_differ(a, b) && r != 0``)."""
        zero = self.lit(0, dt)
        return self.emit("and", "bool", (
            self.emit("ne", dt, (r, zero)),
            self.emit("ne", "bool", (self.emit("lt", dt, (b, zero)),
                                     self.emit("lt", dt, (r, zero))))))

    def remainder(self, a: Scalar, b: Scalar, dt: str) -> Scalar:
        """ATen's ``remainder``: the truncated one, plus ``b`` where
        ``differ``."""
        r = self.emit("irem" if dt in _INTS else "fmod", dt, (a, b))
        return self.emit("where", dt, (self.differ(r, b, dt),
                                       self.emit("add", dt, (r, b)), r))

    def floor_div(self, a: Scalar, b: Scalar, dt: str) -> Scalar:
        """ATen's ``div_floor_integer`` / ``div_floor_floating``."""
        one = self.lit(1, dt)
        if dt in _INTS:
            q = self.emit("idiv", dt, (a, b))
            r = self.emit("irem", dt, (a, b))
            return self.emit("where", dt, (self.differ(r, b, dt),
                                           self.emit("sub", dt, (q, one)),
                                           q))
        zero = self.lit(0, dt)
        quot = self.emit("div", dt, (a, b))
        mod = self.emit("fmod", dt, (a, b))
        div = self.emit("div", dt, (self.emit("sub", dt, (a, mod)), b))
        div = self.emit("where", dt, (self.differ(mod, b, dt),
                                      self.emit("sub", dt, (div, one)), div))
        fl = self.emit("floor", dt, (div,))
        up = self.emit("gt", dt, (self.emit("sub", dt, (div, fl)),
                                  self.lit(0.5, dt)))
        fl = self.emit("where", dt, (up, self.emit("add", dt, (fl, one)),
                                     fl))
        signed_zero = self.emit("copysign", dt, (zero, quot))
        got = self.emit("where", dt, (self.emit("ne", dt, (div, zero)), fl,
                                      signed_zero))
        return self.emit("where", dt, (self.emit("eq", dt, (b, zero)), quot,
                                       got))

    def trunc_div(self, a: Scalar, b: Scalar, dt: str) -> Scalar:
        if dt in _INTS:
            return self.emit("idiv", dt, (a, b))
        return self.emit("trunc", dt, (self.emit("div", dt, (a, b)),))

    def scalar_op(self, op: str, dt: str, args) -> Scalar:
        """One operation of the step in compute dtype ``dt`` (args already
        cast to it): a scalar op, or its formula taken apart."""
        if op == "remainder":
            return self.remainder(*args, dt)
        if op == "fmod":
            return self.emit("irem" if dt in _INTS else "fmod", dt, args)
        if op == "floor_div":
            return self.floor_div(*args, dt)
        if op == "trunc_div":
            return self.trunc_div(*args, dt)
        if op in ("ceil", "floor", "trunc", "round") and dt in _INTS:
            return args[0]
        if op == "sign":
            zero = self.lit(0, dt)
            pos = self.cast(self.emit("gt", dt, (args[0], zero)), dt)
            neg = self.cast(self.emit("lt", dt, (args[0], zero)), dt)
            return self.emit("sub", dt, (pos, neg))
        if op == "frac":
            return self.emit("sub", dt, (args[0], self.emit(
                "trunc", dt, (args[0],))))
        return self.emit(op, dt, args)

    # -- traced values --------------------------------------------------
    def arr(self, x) -> _Arr:
        if isinstance(x, _Arr):
            return x
        if isinstance(x, torch.fx.Node):
            return self.env[x]
        if isinstance(x, bool):
            return _Arr((), [Scalar("bool", value=x)])
        if isinstance(x, int):
            return _Arr((), [Scalar("int", value=x)])
        if isinstance(x, float):
            return _Arr((), [Scalar("f64", value=x)])
        raise Untranslatable(f"an operand {x!r}")

    @staticmethod
    def meta(x):
        return x.meta["val"] if isinstance(x, torch.fx.Node) else x

    def broadcast(self, a: _Arr, shape) -> List[Scalar]:
        n = _n_entries(shape)
        if a.shape == tuple(shape):
            return a.entries
        if len(a.shape) == 0 or a.shape == (TRACE_LANES, 1):
            return a.entries * n
        raise Untranslatable(f"a broadcast of {a.shape} to {tuple(shape)}")

    def elementwise(self, node, op, operands, compute=None) -> _Arr:
        val = node.meta["val"]
        shape = tuple(val.shape)
        compute = compute or _dtype_of(val)
        cols = [self.broadcast(self.arr(x), shape) for x in operands]
        entries = []
        for i in range(_n_entries(shape)):
            args = [self.cast(c[i], compute) for c in cols]
            entries.append(self.scalar_op(op, compute, args))
        return _Arr(shape, entries)

    def promoted(self, args) -> str:
        """The dtype ATen computes a binary operation of ``args`` in."""
        dtype = torch.result_type(_dummy(self.meta(args[0])),
                                  _dummy(self.meta(args[1])))
        try:
            return _DTYPES[dtype]
        except KeyError:
            raise Untranslatable(f"dtype {dtype}") from None

    def constant(self, node, value) -> _Arr:
        val = node.meta["val"]
        lit = self.lit(value, _dtype_of(val))
        return _Arr(val.shape, [lit] * _n_entries(val.shape))

    # -- the graph --------------------------------------------------------
    def run(self, placeholders: Dict[str, _Arr]) -> Program:
        names = iter(placeholders.values())
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                self.env[node] = next(names)
            elif node.op == "get_attr":
                self.env[node] = self.tensor_constant(
                    getattr(self.gm, node.target))
            elif node.op == "call_function":
                self.env[node] = self.call(node)
            elif node.op == "output":
                self.output(node.args[0])
            else:
                raise Untranslatable(f"a graph node {node.op}")
        return self.prog

    def tensor_constant(self, t: torch.Tensor) -> _Arr:
        if t.dim() != 0:
            raise Untranslatable(f"a tensor constant of shape "
                                 f"{tuple(t.shape)}")
        return _Arr((), [self.lit(t.item(), _dtype_of(t))])

    def call(self, node) -> _Arr:
        target = node.target
        packet = getattr(getattr(target, "overloadpacket", None), "__name__",
                         str(target))
        overload = getattr(target, "_overloadname", "")
        args, kw = list(node.args), dict(node.kwargs)
        if packet == "div" and kw.get("rounding_mode") is not None:
            mode = kw["rounding_mode"]
            return self.elementwise(node, {"floor": "floor_div",
                                           "trunc": "trunc_div"}[mode],
                                    args[:2])
        if packet in ("floor_divide", "remainder", "fmod"):
            op = "floor_div" if packet == "floor_divide" else packet
            return self.elementwise(node, op, args[:2])
        if packet in _BINARY or packet in ("rsub",):
            if kw.get("alpha", 1) != 1 or len(args) > 2:
                raise Untranslatable(f"{packet} with alpha")
            if packet == "rsub":
                return self.elementwise(node, "sub", args[::-1])
            return self.elementwise(node, _BINARY[packet], args)
        if packet in _COMPARE:
            return self.elementwise(node, _COMPARE[packet], args,
                                    self.promoted(args))
        if packet in _UNARY:
            return self.elementwise(node, _UNARY[packet], args[:1])
        if packet in _ROUNDING:
            return self.elementwise(node, _ROUNDING[packet], args[:1])
        if packet == "round" and overload == "default":
            return self.elementwise(node, "round", args[:1])
        if packet in ("sign", "frac"):
            return self.elementwise(node, packet, args[:1])
        if packet in ("signbit", "isnan", "isinf", "isfinite"):
            return self.classify(node, packet, args[0])
        if packet == "relu":
            return self.elementwise(node, "max", [args[0], 0])
        if packet == "square":
            return self.elementwise(node, "mul", [args[0], args[0]])
        if packet == "pow" and overload == "Tensor_Scalar":
            return self.power(node, args[0], args[1])
        if packet == "softplus":
            beta = args[1] if len(args) > 1 else kw.get("beta", 1.0)
            threshold = args[2] if len(args) > 2 else kw.get("threshold",
                                                             20.0)
            return self.with_scalars(node, "softplus", args[0],
                                     (beta, threshold))
        if packet in ("clamp_min", "clamp_max"):
            op = "max" if packet == "clamp_min" else "min"
            return self.elementwise(node, op, args[:2])
        if packet == "clamp":
            lo = args[1] if len(args) > 1 else kw.get("min")
            hi = args[2] if len(args) > 2 else kw.get("max")
            x = args[0]
            if lo is not None:
                x = self.elementwise(node, "max", [x, lo])
            if hi is not None:
                x = self.elementwise(node, "min", [x, hi])
            return self.arr(x)
        if packet == "where" and len(args) == 3:
            val = node.meta["val"]
            shape, out = tuple(val.shape), _dtype_of(val)
            cols = [self.broadcast(self.arr(x), shape) for x in args]
            entries = [self.emit("where", out, (
                self.cast(c, "bool"), self.cast(a, out), self.cast(b, out)))
                for c, a, b in zip(*cols)]
            return _Arr(shape, entries)
        if packet == "select":
            return self.select(node, *args)
        if packet == "slice":
            return self.slice(node, *args)
        if packet in ("stack", "cat"):
            return self.join(node, args[0])
        if packet == "view" and overload == "dtype":
            return self.bitcast(node, args[0])
        if packet in _IDENTITY:
            return self.reshape(node, args[0])
        if packet in _CONSTANT:
            return self.constant(node, _CONSTANT[packet])
        if packet in ("full_like", "new_full"):
            return self.constant(node, args[-1] if packet == "full_like"
                                 else args[2])
        if packet in ("full", "scalar_tensor"):
            return self.constant(node, args[-1] if packet == "full"
                                 else args[0])
        raise Untranslatable(f"the operation aten.{packet}.{overload}")

    def classify(self, node, what, x) -> _Arr:
        """``signbit``, ``isnan``, ``isinf``, ``isfinite``: on floats
        ``signbit`` itself, ``x != x``, ``|x| == inf``, ``|x| < inf``; on
        integers ``x < 0`` and constants."""
        shape = tuple(node.meta["val"].shape)
        dt = _dtype_of(self.meta(x))
        entries = []
        for e in self.broadcast(self.arr(x), shape):
            e = self.cast(e, dt)
            if dt not in _FLOATS:
                entries.append(
                    self.emit("lt", dt, (e, self.lit(0, dt)))
                    if what == "signbit" and dt != "bool"
                    else self.lit(what == "isfinite", "bool"))
            elif what == "signbit":
                entries.append(self.emit("signbit", dt, (e,)))
            elif what == "isnan":
                entries.append(self.emit("ne", dt, (e, e)))
            else:
                mag = self.emit("abs", dt, (e,))
                op = "eq" if what == "isinf" else "lt"
                entries.append(self.emit(op, dt, (mag, self.lit(np.inf,
                                                                dt))))
        return _Arr(shape, entries)

    def bitcast(self, node, x) -> _Arr:
        a = self.arr(x)
        val = node.meta["val"]
        shape, out = tuple(val.shape), _dtype_of(val)
        src = _dtype_of(self.meta(x))
        if (src, out) not in _BITCAST:
            raise Untranslatable(f"a bit view of {src} as {out}")
        return _Arr(shape, [self.emit("bitcast", out, (e,))
                            for e in a.entries])

    def with_scalars(self, node, op, x, scalars) -> _Arr:
        """``op(x, *scalars)``: the scalars kept as the step gave them
        (float64 literals; ``_c_expr`` writes them in the operand's type,
        as ATen's CUDA kernels convert them, and ``interpret`` passes
        them on as the step did)."""
        val = node.meta["val"]
        shape, out = tuple(val.shape), _dtype_of(val)
        if out not in _FLOATS:
            raise Untranslatable(f"{op} of {out}")
        lits = [Scalar("f64", value=float(v)) for v in scalars]
        return _Arr(shape, [self.emit(op, out, [self.cast(e, out)] + lits)
                            for e in self.broadcast(self.arr(x), shape)])

    def power(self, node, x, exponent) -> _Arr:
        """``pow(x, exponent)`` for a scalar exponent: the products,
        square roots and quotients the CPU computes it by (``x * x * x``
        for 3, ``1 / (x * x)`` for -2, ...), else one ``pow``."""
        try:
            e = float(exponent)
        except (TypeError, ValueError):
            raise Untranslatable(f"pow with exponent {exponent!r}") from None
        form = _POW_FORMS.get(e)
        if _dtype_of(node.meta["val"]) in _INTS and e not in (2.0, 3.0):
            raise Untranslatable(f"an integer pow with exponent {e}")
        if form is None:
            return self.with_scalars(node, "pow", x, (e,))
        y = x
        for op in form:
            y = self.elementwise(node, op, [y, x] if op == "mul" else [y])
        return y

    def select(self, node, x, dim, index) -> _Arr:
        a = self.arr(x)
        if len(a.shape) != 2 or dim not in (1, -1):
            raise Untranslatable(f"a select of dim {dim} of {a.shape}")
        return _Arr((TRACE_LANES,), [a.entries[index]])

    def slice(self, node, x, dim=0, start=None, end=None, step=1) -> _Arr:
        a = self.arr(x)
        shape = tuple(node.meta["val"].shape)
        if dim in (1, -1) and len(a.shape) == 2:
            return _Arr(shape, a.entries[slice(start, end, step)])
        if dim == 0 and shape == a.shape:
            return a
        raise Untranslatable(f"a slice of dim {dim} of {a.shape}")

    def join(self, node, items) -> _Arr:
        shape = tuple(node.meta["val"].shape)
        dim = node.args[1] if len(node.args) > 1 else node.kwargs.get(
            "dim", 0)
        if len(shape) != 2 or dim not in (1, -1):
            raise Untranslatable(f"a stack or cat on dim {dim} into "
                                 f"{shape}")
        entries = [e for x in items for e in self.arr(x).entries]
        if len(entries) != _n_entries(shape):
            raise Untranslatable(f"a stack or cat into {shape}")
        return _Arr(shape, entries)

    def reshape(self, node, x) -> _Arr:
        a = self.arr(x)
        val = node.meta["val"]
        shape, out = tuple(val.shape), _dtype_of(val)
        entries = (a.entries if len(a.entries) == _n_entries(shape)
                   else self.broadcast(a, shape))
        return _Arr(shape, [self.cast(e, out) for e in entries])

    def output(self, result):
        try:
            carry, outs = result
            outs = tuple(outs)
        except (TypeError, ValueError):
            raise Untranslatable("a result that is not (carry, five "
                                 "outputs)") from None
        c = self.arr(carry)
        if c.shape != (TRACE_LANES, CARRY_DIM):
            raise Untranslatable(f"a carry of shape {c.shape}")
        if len(outs) != 5:
            raise Untranslatable(f"{len(outs)} outputs (five)")
        flat = []
        for o in outs:
            a = self.arr(o)
            if a.shape not in ((), (TRACE_LANES,)):
                raise Untranslatable(f"an output of shape {a.shape}")
            flat.append(a.entries[0])
        self.prog.carry = tuple(self.cast(e, "f32") for e in c.entries)
        self.prog.outs = tuple(self.cast(e, "f32") for e in flat)


def _inputs() -> Dict[str, _Arr]:
    lanes = TRACE_LANES
    return {"carry": _Arr((lanes, CARRY_DIM),
                          [Scalar("f32", name=f"c_{k}")
                           for k in range(CARRY_DIM)]),
            "arrive": _Arr((lanes,), [Scalar("f32", name="arrive")]),
            "params": _Arr((lanes, PARAM_DIM),
                           [Scalar("f32", name=f"p[{k}]")
                            for k in range(PARAM_DIM)]),
            "dt": _Arr((), [Scalar("f32", name="dt")])}


def translate(step: Callable) -> Program:
    """The scalar operations of ``step(carry, arrive, params, dt)``, or
    ``Untranslatable`` naming what has no CUDA form."""
    from torch.fx.experimental.proxy_tensor import make_fx
    lanes = TRACE_LANES
    example = (torch.zeros(lanes, CARRY_DIM), torch.zeros(lanes),
               torch.zeros(lanes, PARAM_DIM), torch.tensor(1.0))
    try:
        gm = make_fx(step, tracing_mode="fake")(*example)
    except Exception as e:      # data-dependent control flow and the like
        raise Untranslatable(f"the step does not trace "
                             f"({type(e).__name__}: {e})") from None
    try:
        return _Translator(gm).run(_inputs())
    except Untranslatable:
        raise
    except Exception as e:      # an operand or a shape the rules miss
        raise Untranslatable(f"the traced graph ({type(e).__name__}: "
                             f"{e})") from None


# ---------------------------------------------------------------------------
# CUDA source
# ---------------------------------------------------------------------------

def _c_literal(s: Scalar) -> str:
    if s.dtype == "bool":
        return "true" if s.value else "false"
    if s.dtype in _INTS:
        bits = _INT_INFO[s.dtype][0]
        v = int(s.value) & ((1 << bits) - 1)
        suffix = "u" if bits == 32 else "ull"
        return f"(({_CTYPE[s.dtype]}){v:#x}{suffix})"
    if s.dtype == "f64":
        bits = struct.unpack("<q", struct.pack("<d", float(s.value)))[0]
        return f"__longlong_as_double({bits:#x}LL)"
    s = _literal_as(s, "f32")
    bits = int(np.float32(s.value).view(np.int32))
    return f"__int_as_float({bits:#x})"


def _c(s: Scalar) -> str:
    return s.name if s.name is not None else _c_literal(s)


#: CUDA's function of each float op, float32 and float64
_FN = {"min": "fmin", "max": "fmax", "ceil": "ceil", "floor": "floor",
       "trunc": "trunc", "round": "rint", "abs": "fabs", "sqrt": "sqrt",
       "exp": "exp", "log": "log", "tanh": "tanh", "expm1": "expm1",
       "log1p": "log1p", "pow": "pow", "fmod": "fmod",
       "nextafter": "nextafter", "copysign": "copysign", "sin": "sin",
       "cos": "cos", "tan": "tan", "atan": "atan", "atan2": "atan2",
       "exp2": "exp2", "log2": "log2", "log10": "log10", "erf": "erf",
       "hypot": "hypot", "sinh": "sinh", "cosh": "cosh", "rsqrt": "rsqrt"}
_INFIX = {"add": "+", "sub": "-", "mul": "*", "div": "/", "lt": "<",
          "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_LOGICAL = {"and": ("&&", "&"), "or": ("||", "|"), "xor": ("!=", "^")}


def _fn(op: str, dt: str) -> str:
    return _FN[op] + ("f" if dt == "f32" else "")


def _divisor(ins: Instr) -> Optional[int]:
    """The literal divisor of an integer division or remainder, or None
    when it is a variable (then a zero must be caught at run time)."""
    b = ins.args[1]
    return None if b.name is not None else int(b.value)


def _c_int_expr(op: str, dt: str, a: List[str],
                divisor: Optional[int] = None) -> Optional[str]:
    """An integer operation as C++ without undefined behaviour: + - * and
    neg through the unsigned type (two's-complement wrap), shifts and
    division guarded as ATen's CPU kernels guard them (``divisor``: a
    literal divisor's value)."""
    bits, unsigned, minimum = _INT_INFO[dt]
    ct = _CTYPE[dt]
    zero = "0" if dt == "i32" else "0LL"
    if op in ("add", "sub", "mul"):
        return (f"({ct})(({unsigned}){a[0]} {_INFIX[op]} "
                f"({unsigned}){a[1]})")
    if op == "neg":
        return f"({ct})(({unsigned})0 - ({unsigned}){a[0]})"
    if op == "abs":
        return (f"{a[0]} < {zero} ? ({ct})(({unsigned})0 - "
                f"({unsigned}){a[0]}) : {a[0]}")
    if op in ("min", "max"):
        cmp = "<" if op == "min" else ">"
        return f"{a[0]} {cmp} {a[1]} ? {a[0]} : {a[1]}"
    if op == "shl":
        return (f"({a[1]} < {zero} || {a[1]} >= {bits}) ? ({ct}){zero} : "
                f"({ct})(({unsigned}){a[0]} << {a[1]})")
    if op == "shr":
        return (f"{a[0]} >> (({a[1]} < {zero} || {a[1]} >= {bits - 1}) ? "
                f"{bits - 1} : {a[1]})")
    if op in _INT_DIVISION:
        # a zero divisor sets the flag (the wrapper raises); -1 is the
        # wrap of neg (INT_MIN / -1 overflows in C++) and remainder 0; a
        # literal divisor other than 0 and -1 divides plainly
        c_op = "/" if op == "idiv" else "%"
        if divisor is not None and divisor not in (0, -1):
            return f"{a[0]} {c_op} {a[1]}"
        by_minus_one = (f"({ct})(({unsigned})0 - ({unsigned}){a[0]})"
                        if op == "idiv" else f"({ct}){zero}")
        return (f"{a[1]} == {zero} ? ({INT_DIV_FLAG} = 1, ({ct}){zero}) : "
                f"{a[1]} == -1 ? {by_minus_one} : {a[0]} {c_op} {a[1]}")
    if op in _LOGICAL:
        return f"{a[0]} {_LOGICAL[op][1]} {a[1]}"
    if op == "not":
        return f"~{a[0]}"
    return None


def _c_cast(dt: str, src: str, a: str) -> str:
    """A conversion as the CPU's PyTorch makes it: a float to an integer
    as x86's truncating conversion (cvtt*), which gives the type's
    minimum for NaN, +-inf and values out of range."""
    if dt == "bool":
        zero = {"f32": "0.0f", "f64": "0.0"}.get(src, "0")
        return f"{a} != {zero}"
    if src == "bool":
        one, zero = {"f32": ("1.0f", "0.0f"), "f64": ("1.0", "0.0")}.get(
            dt, ("1", "0"))
        return f"{a} ? ({_CTYPE[dt]}){one} : ({_CTYPE[dt]}){zero}"
    if dt in _FLOATS and src in _FLOATS:
        return (f"__double2float_rn({a})" if dt == "f32"
                else f"(double){a}")
    if dt in _FLOATS:
        return {("i32", "f32"): "__int2float_rn",
                ("i32", "f64"): "__int2double_rn",
                ("i64", "f32"): "__ll2float_rn",
                ("i64", "f64"): "__ll2double_rn"}[(src, dt)] + f"({a})"
    if src in _INTS:
        if dt == "i64":
            return f"(long long){a}"
        return f"(int)(unsigned)(unsigned long long){a}"
    # float -> integer: in range iff lo <= x < hi (NaN fails both)
    hi = "2147483648.0" if dt == "i32" else "9223372036854775808.0"
    lo = "-2147483648.0" if dt == "i32" else "-9223372036854775808.0"
    if src == "f32":
        lo_test, hi, lo = ">=", hi + "f", lo + "f"
    else:
        lo_test = ">="
        if dt == "i32":
            lo_test, lo = ">", "-2147483649.0"
    conv = {("f32", "i32"): "__float2int_rz", ("f64", "i32"):
            "__double2int_rz", ("f32", "i64"): "__float2ll_rz",
            ("f64", "i64"): "__double2ll_rz"}[(src, dt)]
    return (f"({a} {lo_test} {lo} && {a} < {hi}) ? {conv}({a}) : "
            f"{_INT_INFO[dt][2]}")


_BITCAST_FN = {"i32": "__float_as_int", "f32": "__int_as_float",
               "i64": "__double_as_longlong", "f64": "__longlong_as_double"}


def _c_expr(ins: Instr) -> str:
    a = [_c(x) for x in ins.args]
    op, dt = ins.op, ins.dtype
    if op == "cast":
        return _c_cast(dt, ins.args[0].dtype, a[0])
    if op == "bitcast":
        return f"{_BITCAST_FN[dt]}({a[0]})"
    if op == "where":
        return f"{a[0]} ? {a[1]} : {a[2]}"
    if dt in _INTS:
        expr = _c_int_expr(op, dt, a, _divisor(ins) if op in _INT_DIVISION
                           else None)
        if expr is not None:
            return expr
    if op in _LOGICAL:                         # bool
        return f"{a[0]} {_LOGICAL[op][0]} {a[1]}"
    if op in _INFIX:
        return f"{a[0]} {_INFIX[op]} {a[1]}"
    if op == "neg":
        return f"-{a[0]}"
    if op == "not":
        return f"!{a[0]}"
    if op in ("min", "max") and dt == "bool":
        return f"{a[0]} {'&&' if op == 'min' else '||'} {a[1]}"
    if op == "signbit":
        # the sign bit itself (NaN and -0.0 included)
        return (f"__float_as_int({a[0]}) < 0" if dt == "f32"
                else f"__double_as_longlong({a[0]}) < 0")
    one = "1.0f" if dt == "f32" else "1.0"
    if op == "reciprocal":
        return f"{one} / {a[0]}"
    if op == "sigmoid":
        # ATen's sigmoid on the CPU and on CUDA: 1 / (1 + exp(-x))
        return f"{one} / ({one} + {_fn('exp', dt)}(-{a[0]}))"
    if op in ("pow", "softplus"):
        a = a[:1] + [_c_literal(_literal_as(x, dt)) for x in ins.args[1:]]
    if op == "softplus":
        # ATen's softplus: x * beta > threshold ? x : log1p(exp(x * beta))
        # / beta, beta and threshold in the operand's type
        x, beta, threshold = a
        return (f"({x} * {beta}) > {threshold} ? {x} : "
                f"{_fn('log1p', dt)}({_fn('exp', dt)}({x} * {beta})) / "
                f"{beta}")
    return f"{_fn(op, dt)}({', '.join(a)})"


def emit_function(prog: Program, name: str, doc: str) -> str:
    """``prog`` as a ``__device__`` function ``name``."""
    lines = [f"// {doc}",
             f"__device__ __forceinline__ void {name}(",
             "    float c_0, float c_1, float arrive, const float* p, "
             "float dt,",
             "    float& n0, float& n1, BinOut& o) {"]
    for ins in prog.instrs:
        ctype = "bool" if ins.op in _BOOL_RESULT else _CTYPE[ins.dtype]
        lines.append(f"  const {ctype} {ins.dst} = {_c_expr(ins)};")
    lines.append(f"  n0 = {_c(prog.carry[0])};")
    lines.append(f"  n1 = {_c(prog.carry[1])};")
    lines.append("  o = BinOut{" + ", ".join(_c(s) for s in prog.outs)
                 + "};")
    lines.append("}")
    return "\n".join(lines)


def emit_header(functions: Dict[int, Tuple[str, str]]) -> str:
    """The text of ``registered_steps.cuh``: ``functions`` maps a kernel
    branch id to (function name, its source)."""
    out = ["// The lane steps of the policies added with register_policy,",
           "// translated by repro_torch/kernels/lane_codegen.py; included",
           "// by policy_scan.cu when it is built with",
           "// -DREPRO_REGISTERED_STEPS.", "#pragma once", ""]
    out += [src + "\n" for _, (_, src) in sorted(functions.items())]
    out += ["__device__ __forceinline__ void registered_step(",
            "    int branch, float c_0, float c_1, float arrive, "
            "const float* p,",
            "    float dt, float& n0, float& n1, BinOut& o) {",
            "  switch (branch) {"]
    for branch, (name, _) in sorted(functions.items()):
        out.append(f"    case {branch}: {name}(c_0, c_1, arrive, p, dt, "
                   f"n0, n1, o); break;")
    out += ["    default: break;", "  }", "}", ""]
    return "\n".join(out)


# ---------------------------------------------------------------------------
# the registry's kernels
# ---------------------------------------------------------------------------

_CACHE: Dict[tuple, Generated] = {}


def generated() -> Generated:
    """The kernels' view of the current registry (cached by the policies'
    names, indices, steps and built-in branches)."""
    specs = [policy_spec(name) for name in policy_names()]
    key = tuple((s.index, s.name, s.lane_step, s.kernel_branch)
                for s in specs)
    got = _CACHE.get(key)
    if got is not None:
        return got
    branches, refused, functions, inexact, divides = [], {}, {}, [], []
    for s in specs:
        if s.kernel_branch is not None:
            branches.append(s.kernel_branch)
            continue
        try:
            prog = translate(s.lane_step)
        except Untranslatable as e:
            branches.append(REFUSED)
            refused[s.name] = str(e)
            continue
        if any(ins.op in TRANSCENDENTAL for ins in prog.instrs):
            inexact.append(s.name)
        if any(ins.op in _INT_DIVISION and _divisor(ins) in (None, 0)
               for ins in prog.instrs):
            divides.append(s.name)
        branch = FIRST_GENERATED + s.index
        name = f"registered_step_{branch}"
        functions[branch] = (name, emit_function(
            prog, name, f"policy {s.name!r} (registry index {s.index})"))
        branches.append(branch)
    got = Generated(emit_header(functions) if functions else None,
                    tuple(branches), refused, tuple(inexact),
                    tuple(divides))
    _CACHE[key] = got
    return got


# ---------------------------------------------------------------------------
# the translation run with PyTorch operations (the CPU tests' check)
# ---------------------------------------------------------------------------

def _trunc_div(a, b):
    return torch.div(a, b, rounding_mode="trunc")


_TORCH_OP = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
             "div": torch.div, "min": torch.minimum, "max": torch.maximum,
             "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
             "eq": torch.eq, "ne": torch.ne, "and": torch.bitwise_and,
             "or": torch.bitwise_or, "xor": torch.bitwise_xor,
             "not": torch.bitwise_not, "neg": torch.neg, "abs": torch.abs,
             "ceil": torch.ceil, "floor": torch.floor, "trunc": torch.trunc,
             "round": torch.round, "sqrt": torch.sqrt, "exp": torch.exp,
             "log": torch.log, "tanh": torch.tanh, "expm1": torch.expm1,
             "log1p": torch.log1p, "sigmoid": torch.sigmoid,
             "reciprocal": torch.reciprocal, "where": torch.where,
             "shl": torch.bitwise_left_shift,
             "shr": torch.bitwise_right_shift, "idiv": _trunc_div,
             "irem": torch.fmod, "fmod": torch.fmod,
             "nextafter": torch.nextafter, "copysign": torch.copysign,
             "signbit": torch.signbit, "sin": torch.sin, "cos": torch.cos,
             "tan": torch.tan, "atan": torch.atan, "atan2": torch.atan2,
             "exp2": torch.exp2, "log2": torch.log2, "log10": torch.log10,
             "erf": torch.erf, "hypot": torch.hypot, "sinh": torch.sinh,
             "cosh": torch.cosh, "rsqrt": torch.rsqrt}


def _torch_scalar(op: str, args, scalars):
    """The operations with scalar arguments: ``pow`` by a float
    exponent, ``softplus`` by its ``beta`` and ``threshold``."""
    if op == "pow":
        return torch.pow(args[0], scalars[1])
    return torch.nn.functional.softplus(args[0], beta=scalars[1],
                                        threshold=scalars[2])


def interpret(prog: Program, carry, arrive, params, dt):
    """Run ``prog`` on a lane block with one PyTorch operation per scalar
    operation: (carry [L, CARRY_DIM], five [L] outputs). An integer
    division by zero raises as the CPU's does."""
    env = {f"c_{k}": carry[:, k] for k in range(CARRY_DIM)}
    env.update({f"p[{k}]": params[:, k] for k in range(PARAM_DIM)})
    env.update(arrive=arrive, dt=dt)

    def value(s: Scalar):
        if s.name is not None:
            return env[s.name]
        return torch.tensor(s.value, dtype=_TORCH[s.dtype])

    for ins in prog.instrs:
        args = [value(x) for x in ins.args]
        if ins.op == "cast":
            env[ins.dst] = args[0].to(_TORCH[ins.dtype])
        elif ins.op == "bitcast":
            env[ins.dst] = args[0].view(_TORCH[ins.dtype])
        elif ins.op in ("pow", "softplus"):
            env[ins.dst] = _torch_scalar(ins.op, args,
                                         [x.value for x in ins.args])
        else:
            env[ins.dst] = _TORCH_OP[ins.op](*args)
    lanes = arrive.shape[0]

    def lane(s):
        return value(s).expand(lanes).clone()
    return (torch.stack([lane(s) for s in prog.carry], dim=1),
            tuple(lane(s) for s in prog.outs))
