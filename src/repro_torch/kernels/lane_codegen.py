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

The operations whose float32 (or float64) rounding CUDA reproduces bit
for bit under the kernels' flags (``--fmad=false``, IEEE division and
square root) are translated: + - * /, neg, abs, min, max, clamp, ceil,
floor, trunc, round, sqrt, reciprocal, integer powers 2 and -1 and the
powers 0.5, -0.5, -2 and 3 (as the CPU's ``pow`` takes them: products,
square roots and quotients), comparisons, logical operations,
``where``, casts between float32, float64 and bool, constants, and the
indexing, stacking and reshaping that keep the lane dimension first. So
are ``exp``, ``log``, ``tanh``, ``expm1``, ``log1p``, ``sigmoid``,
``softplus`` (with its ``beta`` and ``threshold``) and ``pow`` with any
other scalar exponent: CUDA's functions of the operand's type (``expf``,
``logf``, ``tanhf``, ``expm1f``, ``log1pf``, ``powf``; ``exp``, ``log``,
... in float64), sigmoid as ``1 / (1 + exp(-x))`` and softplus as
``x * beta > threshold ? x : log1p(exp(x * beta)) / beta``, the formulas
of PyTorch's own kernels. These do not round as the CPU's do: a policy
whose step uses one is listed in ``Generated.transcendental``, and its
rows are held to the CPU run within an ulp bound, not bit for bit. A
step that uses anything else (a bit view, an operation across lanes,
data-dependent Python control flow) has no CUDA form: the wrappers
refuse its rows on the card, naming the operation
(``Generated.refused``), and it runs with ``device="cpu"``.

``interpret`` runs a translation with PyTorch operations, one per scalar
operation, so the CPU tests can hold the decomposition against the step
itself bit for bit.
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

_DTYPES = {torch.float32: "f32", torch.float64: "f64", torch.bool: "bool"}
_TORCH = {"f32": torch.float32, "f64": torch.float64, "bool": torch.bool}
_CTYPE = {"f32": "float", "f64": "double", "bool": "bool"}


class Untranslatable(NotImplementedError):
    """A lane step with an operation the kernels cannot reproduce."""


@dataclass(frozen=True)
class Scalar:
    """One per-lane value: a variable (``name``) or a literal (``value``),
    of dtype f32, f64, bool or, for literals only, int."""
    dtype: str
    name: Optional[str] = None
    value: object = None


@dataclass(frozen=True)
class Instr:
    """``dst = op(args)`` computed in ``dtype`` (the result's dtype; a
    comparison computes in its operands' dtype and yields bool)."""
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
    form) and ``transcendental`` (the policies whose translated step
    uses an operation of ``TRANSCENDENTAL``: ``exp``, ``log``, ``tanh``,
    ``expm1``, ``log1p``, ``sigmoid``, ``softplus`` or a ``pow`` that is
    not a product, square root or quotient)."""
    header: Optional[str]
    branches: Tuple[int, ...]
    refused: Dict[str, str]
    transcendental: Tuple[str, ...] = ()


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


def _literal_as(s: Scalar, dtype: str) -> Scalar:
    v = s.value
    if dtype == "bool":
        return Scalar("bool", value=bool(v))
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

#: ATen elementwise operations: packet name -> scalar op
_UNARY = {"neg": "neg", "abs": "abs", "ceil": "ceil", "floor": "floor",
          "trunc": "trunc", "sqrt": "sqrt", "reciprocal": "reciprocal",
          "exp": "exp", "log": "log", "tanh": "tanh", "expm1": "expm1",
          "log1p": "log1p", "sigmoid": "sigmoid",
          "logical_not": "not", "bitwise_not": "not"}
#: scalar operations that CUDA rounds otherwise than the CPU
TRANSCENDENTAL = ("exp", "log", "tanh", "expm1", "log1p", "sigmoid",
                  "softplus", "pow")
_BINARY = {"add": "add", "sub": "sub", "mul": "mul", "div": "div",
           "minimum": "min", "maximum": "max", "fmin": "min", "fmax": "max",
           "logical_and": "and", "logical_or": "or", "logical_xor": "xor",
           "bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor"}
_COMPARE = {"lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq",
            "ne": "ne"}
_IDENTITY = {"clone", "alias", "detach", "lift_fresh_copy", "contiguous",
             "view", "_unsafe_view", "reshape", "expand", "squeeze",
             "unsqueeze", "_to_copy", "to"}
_CONSTANT = {"zeros_like": 0.0, "ones_like": 1.0, "new_zeros": 0.0,
             "new_ones": 1.0, "zeros": 0.0, "ones": 1.0}


class _Translator:
    def __init__(self, gm: torch.fx.GraphModule):
        self.gm = gm
        self.prog = Program()
        self.env: Dict[torch.fx.Node, _Arr] = {}

    # -- scalar operations ---------------------------------------------
    def emit(self, op: str, dtype: str, args) -> Scalar:
        dst = f"v{len(self.prog.instrs)}"
        self.prog.instrs.append(Instr(dst, dtype, op, tuple(args)))
        out = "bool" if op in _COMPARE.values() else dtype
        return Scalar(out, name=dst)

    def cast(self, s: Scalar, dtype: str) -> Scalar:
        if s.dtype == dtype:
            return s
        if s.name is None:
            return _literal_as(s, dtype)
        return self.emit("cast", dtype, (s,))

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
        out = _dtype_of(val)
        compute = compute or out
        cols = [self.broadcast(self.arr(x), shape) for x in operands]
        entries = []
        for i in range(_n_entries(shape)):
            args = [self.cast(c[i], compute) for c in cols]
            entries.append(self.emit(op, compute, args))
        return _Arr(shape, entries)

    def constant(self, node, value) -> _Arr:
        val = node.meta["val"]
        lit = _literal_as(Scalar("f64", value=value), _dtype_of(val))
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
        return _Arr((), [_literal_as(Scalar("f64", value=t.item()),
                                     _dtype_of(t))])

    def call(self, node) -> _Arr:
        target = node.target
        packet = getattr(getattr(target, "overloadpacket", None), "__name__",
                         str(target))
        overload = getattr(target, "_overloadname", "")
        args, kw = list(node.args), dict(node.kwargs)
        if packet in _BINARY or packet in ("rsub",):
            if kw.get("alpha", 1) != 1 or len(args) > 2:
                raise Untranslatable(f"{packet} with alpha")
            if kw.get("rounding_mode") is not None:
                raise Untranslatable("div with a rounding mode")
            if packet == "rsub":
                return self.elementwise(node, "sub", args[::-1])
            return self.elementwise(node, _BINARY[packet], args)
        if packet in _COMPARE:
            compute = _DTYPES.get(torch.result_type(
                _dummy(self.meta(args[0])), _dummy(self.meta(args[1]))))
            if compute is None:
                raise Untranslatable(f"{packet} of integers")
            return self.elementwise(node, _COMPARE[packet], args, compute)
        if packet in _UNARY:
            return self.elementwise(node, _UNARY[packet], args[:1])
        if packet == "round" and overload == "default":
            return self.elementwise(node, "round", args[:1])
        if packet == "relu":
            return self.elementwise(node, "max", [args[0], 0.0])
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
            raise Untranslatable(f"a bit view (aten.view.dtype, dtype "
                                 f"{args[1]})")
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

    def with_scalars(self, node, op, x, scalars) -> _Arr:
        """``op(x, *scalars)``: the scalars kept as the step gave them
        (float64 literals; ``_c_expr`` writes them in the operand's type,
        as ATen's CUDA kernels convert them, and ``interpret`` passes
        them on as the step did)."""
        val = node.meta["val"]
        shape, out = tuple(val.shape), _dtype_of(val)
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
    if s.dtype == "f64":
        bits = struct.unpack("<q", struct.pack("<d", float(s.value)))[0]
        return f"__longlong_as_double({bits:#x}LL)"
    s = _literal_as(s, "f32")
    bits = int(np.float32(s.value).view(np.int32))
    return f"__int_as_float({bits:#x})"


def _c(s: Scalar) -> str:
    return s.name if s.name is not None else _c_literal(s)


_F32_FN = {"min": "fminf", "max": "fmaxf", "ceil": "ceilf",
           "floor": "floorf", "trunc": "truncf", "round": "rintf",
           "abs": "fabsf", "sqrt": "sqrtf", "exp": "expf", "log": "logf",
           "tanh": "tanhf", "expm1": "expm1f", "log1p": "log1pf",
           "pow": "powf"}
_F64_FN = {"min": "fmin", "max": "fmax", "ceil": "ceil", "floor": "floor",
           "trunc": "trunc", "round": "rint", "abs": "fabs", "sqrt": "sqrt",
           "exp": "exp", "log": "log", "tanh": "tanh", "expm1": "expm1",
           "log1p": "log1p", "pow": "pow"}
_INFIX = {"add": "+", "sub": "-", "mul": "*", "div": "/", "lt": "<",
          "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!=",
          "and": "&&", "or": "||", "xor": "!="}


def _c_expr(ins: Instr) -> str:
    a = [_c(x) for x in ins.args]
    op, dt = ins.op, ins.dtype
    if op in _INFIX:
        return f"{a[0]} {_INFIX[op]} {a[1]}"
    if op == "neg":
        return f"-{a[0]}"
    if op == "not":
        return f"!{a[0]}"
    if op == "reciprocal":
        return f"{'1.0f' if dt == 'f32' else '1.0'} / {a[0]}"
    if op == "where":
        return f"{a[0]} ? {a[1]} : {a[2]}"
    fn = _F32_FN if dt == "f32" else _F64_FN
    one = "1.0f" if dt == "f32" else "1.0"
    if op == "sigmoid":
        # ATen's sigmoid on the CPU and on CUDA: 1 / (1 + exp(-x))
        return f"{one} / ({one} + {fn['exp']}(-{a[0]}))"
    if op in ("pow", "softplus"):
        a = a[:1] + [_c_literal(_literal_as(x, dt)) for x in ins.args[1:]]
    if op == "softplus":
        # ATen's softplus: x * beta > threshold ? x : log1p(exp(x * beta))
        # / beta, beta and threshold in the operand's type
        x, beta, threshold = a
        return (f"({x} * {beta}) > {threshold} ? {x} : "
                f"{fn['log1p']}({fn['exp']}({x} * {beta})) / {beta}")
    if op == "cast":
        src = ins.args[0].dtype
        if dt == "bool":
            return f"{a[0]} != {'0.0f' if src == 'f32' else '0.0'}"
        if src == "bool":
            one, zero = ("1.0f", "0.0f") if dt == "f32" else ("1.0", "0.0")
            return f"{a[0]} ? {one} : {zero}"
        return (f"__double2float_rn({a[0]})" if dt == "f32"
                else f"(double){a[0]}")
    return f"{fn[op]}({', '.join(a)})"


def emit_function(prog: Program, name: str, doc: str) -> str:
    """``prog`` as a ``__device__`` function ``name``."""
    lines = [f"// {doc}",
             f"__device__ __forceinline__ void {name}(",
             "    float c_0, float c_1, float arrive, const float* p, "
             "float dt,",
             "    float& n0, float& n1, BinOut& o) {"]
    for ins in prog.instrs:
        ctype = "bool" if ins.op in _COMPARE.values() else _CTYPE[ins.dtype]
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
    branches, refused, functions, inexact = [], {}, {}, []
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
        branch = FIRST_GENERATED + s.index
        name = f"registered_step_{branch}"
        functions[branch] = (name, emit_function(
            prog, name, f"policy {s.name!r} (registry index {s.index})"))
        branches.append(branch)
    got = Generated(emit_header(functions) if functions else None,
                    tuple(branches), refused, tuple(inexact))
    _CACHE[key] = got
    return got


# ---------------------------------------------------------------------------
# the translation run with PyTorch operations (the CPU tests' check)
# ---------------------------------------------------------------------------

_TORCH_OP = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
             "div": torch.div, "min": torch.minimum, "max": torch.maximum,
             "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
             "eq": torch.eq, "ne": torch.ne, "and": torch.logical_and,
             "or": torch.logical_or, "xor": torch.logical_xor,
             "not": torch.logical_not, "neg": torch.neg, "abs": torch.abs,
             "ceil": torch.ceil, "floor": torch.floor, "trunc": torch.trunc,
             "round": torch.round, "sqrt": torch.sqrt, "exp": torch.exp,
             "log": torch.log, "tanh": torch.tanh, "expm1": torch.expm1,
             "log1p": torch.log1p, "sigmoid": torch.sigmoid,
             "reciprocal": torch.reciprocal, "where": torch.where}


def _torch_scalar(op: str, args, scalars):
    """The operations with scalar arguments: ``pow`` by a float
    exponent, ``softplus`` by its ``beta`` and ``threshold``."""
    if op == "pow":
        return torch.pow(args[0], scalars[1])
    return torch.nn.functional.softplus(args[0], beta=scalars[1],
                                        threshold=scalars[2])


def interpret(prog: Program, carry, arrive, params, dt):
    """Run ``prog`` on a lane block with one PyTorch operation per scalar
    operation: (carry [L, CARRY_DIM], five [L] outputs)."""
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
