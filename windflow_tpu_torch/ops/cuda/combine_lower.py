"""A user FFAT combine, lowered from a torch callable to the body of a
C++ functor that the FlatFAT kernels (``flatfat_query.cu``) compile in.

The reference's Pallas kernel (windflow_tpu/ops/pallas/flatfat_query.py
``_build``) traces any associative JAX combine into the kernel.  Here
:func:`lower_combine` traces ``combine(a, b)`` with
``torch.fx.symbolic_trace`` and writes each node as one f32 statement of
device code that computes what eager torch computes on the card:

* ``+ - * /`` (operators, ``torch.add``/``sub``/``mul``/``div`` and their
  methods, without ``alpha`` or ``rounding_mode``) and unary ``-``; each
  arithmetic op is one ``__fadd_rn``/``__fsub_rn``/``__fmul_rn``/
  ``__fdiv_rn``, so nvcc cannot contract two of them into an ``fma``
  and the kernel rounds every op exactly as eager torch does.  Division
  by a constant is a product with its f32 reciprocal and ``c / x`` is
  ``reciprocal(x) * c``, as torch computes both on CUDA;
* ``torch.maximum``/``minimum`` (NaN-propagating), ``torch.fmax``/
  ``fmin`` (NaN-ignoring) and ``torch.abs``;
* ``torch.where``, the comparisons, ``torch.isnan``/``isinf``, and
  ``&``, ``|``, ``~`` on masks;
* ``torch.exp``, ``log``, ``log1p``, ``expm1`` and ``sqrt`` (the
  full-precision ``expf``, ``logf``, ... that torch's own CUDA kernels
  call);
* ``torch.logaddexp``, with ATen's formula for float;
* ``torch.clamp`` (and ``clamp_min``/``clamp_max``) with constant bounds;
* Python int and float constants, each emitted as the exact f32 that
  torch rounds the scalar to (a hex float literal).

Anything else raises ``ValueError`` naming the op and this set: another
op, Python control flow on a traced value, a tensor captured from the
enclosing scope, or a result that is not one f32 value.  The body is
canonical (temporaries numbered in graph order, the operands always
``a`` and ``b``), so two equal lambdas lower to the same text and share
one compiled library (:func:`combine_key`).
"""
from __future__ import annotations

import hashlib
import operator
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

SUPPORTED = ("+ - * / and unary - (operators, torch.add/sub/mul/div and "
             "their methods), torch.maximum/minimum/fmax/fmin/abs, "
             "torch.where, comparisons, torch.isnan/isinf, & | ~ on masks, "
             "torch.exp/log/log1p/expm1/sqrt, torch.logaddexp, torch.clamp "
             "with constant bounds, Python int and float constants")


def _name(combine: Any) -> str:
    return getattr(combine, "__qualname__", None) or repr(combine)


def _unsupported(combine: Any, what: str) -> ValueError:
    return ValueError(f"the FFAT combine {_name(combine)} cannot be "
                      f"compiled into the FlatFAT kernels: {what}; a combine "
                      f"may use {SUPPORTED}")


def f32_literal(x: float) -> str:
    """The f32 that torch rounds the Python scalar ``x`` to, as an exact
    C++ literal."""
    with np.errstate(over="ignore"):  # past f32's range: +-inf, as torch
        v = np.float32(x)
    if not np.isfinite(v):
        bits = int(v.view(np.uint32))
        return f"__uint_as_float({bits:#010x}u)"
    h = float(v).hex()  # exact: every f32 is a double
    mant, exp = h.split("p")
    if "." in mant:
        mant = mant.rstrip("0").rstrip(".")
    return f"({mant}p{exp}f)"


# (kind of op, C++ template); {0}, {1}, ... are the operands' C++ text
_BINARY = {"add": "__fadd_rn({0}, {1})", "sub": "__fsub_rn({0}, {1})",
           "mul": "__fmul_rn({0}, {1})", "div": "__fdiv_rn({0}, {1})"}
_COMPARE = {"gt": ">", "lt": "<", "ge": ">=", "le": "<=", "eq": "==",
            "ne": "!="}
_UNARY_F = {"exp": "expf({0})", "log": "logf({0})", "log1p": "log1pf({0})",
            "expm1": "expm1f({0})", "sqrt": "sqrtf({0})",
            "abs": "fabsf({0})", "neg": "(-{0})"}
# torch's CUDA kernels: maximum/minimum return a NaN operand, else
# ::max/::min; fmax/fmin ignore a NaN operand
_TENSOR_PAIR = {
    "maximum": "(isnan({0}) ? {0} : (isnan({1}) ? {1} : fmaxf({0}, {1})))",
    "minimum": "(isnan({0}) ? {0} : (isnan({1}) ? {1} : fminf({0}, {1})))",
    "fmax": "fmaxf({0}, {1})", "fmin": "fminf({0}, {1})",
}

# fx targets -> op name
_FUNCTIONS: Dict[Any, str] = {
    operator.add: "add", operator.sub: "sub", operator.mul: "mul",
    operator.truediv: "div", operator.neg: "neg", operator.gt: "gt",
    operator.lt: "lt", operator.ge: "ge", operator.le: "le",
    operator.eq: "eq", operator.ne: "ne", operator.and_: "and",
    operator.or_: "or", operator.invert: "not",
    torch.add: "add", torch.sub: "sub", torch.mul: "mul", torch.div: "div",
    torch.neg: "neg", torch.abs: "abs", torch.maximum: "maximum",
    torch.minimum: "minimum", torch.fmax: "fmax", torch.fmin: "fmin",
    torch.where: "where", torch.gt: "gt", torch.lt: "lt", torch.ge: "ge",
    torch.le: "le", torch.eq: "eq", torch.ne: "ne", torch.isnan: "isnan",
    torch.isinf: "isinf", torch.exp: "exp", torch.log: "log",
    torch.log1p: "log1p", torch.expm1: "expm1", torch.sqrt: "sqrt",
    torch.logaddexp: "logaddexp", torch.clamp: "clamp",
    torch.clamp_min: "clamp_min", torch.clamp_max: "clamp_max",
    torch.logical_and: "and", torch.logical_or: "or",
    torch.logical_not: "not",
}
_METHODS = {"add", "sub", "mul", "div", "neg", "abs", "maximum", "minimum",
            "fmax", "fmin", "gt", "lt", "ge", "le", "eq", "ne", "isnan",
            "isinf", "exp", "log", "log1p", "expm1", "sqrt", "logaddexp",
            "clamp", "clamp_min", "clamp_max", "where", "logical_and",
            "logical_or", "logical_not"}
_METHOD_ALIASES = {"logical_and": "and", "logical_or": "or",
                   "logical_not": "not"}


class _Lowering:
    """One traced graph written out as SSA statements."""

    def __init__(self, combine: Any):
        self.combine = combine
        self.lines: List[str] = []
        self.values: Dict[Any, Tuple[str, str]] = {}  # node -> (text, type)

    def fail(self, what: str) -> ValueError:
        return _unsupported(self.combine, what)

    def operand(self, x) -> Tuple[str, str]:
        """(C++ text, "float" | "bool" | "const") of an fx argument."""
        if isinstance(x, torch.fx.Node):
            return self.values[x]
        if isinstance(x, bool):
            return ("true" if x else "false"), "constbool"
        if isinstance(x, (int, float)):
            return f32_literal(x), "const"
        raise self.fail(f"an operand of type {type(x).__name__} ({x!r})")

    def floats(self, op: str, args, tensors_only: bool = False):
        out = []
        for x in args:
            text, kind = self.operand(x)
            if kind == "bool" or kind == "constbool":
                raise self.fail(f"{op} on a mask")
            if tensors_only and kind == "const":
                raise self.fail(f"{op} with a constant operand (torch takes "
                                f"tensors only)")
            out.append(text)
        return out

    def masks(self, op: str, args):
        out = []
        for x in args:
            text, kind = self.operand(x)
            if kind not in ("bool", "constbool"):
                raise self.fail(f"{op} on a value that is not a mask")
            out.append(text)
        return out

    def expr(self, op: str, args, kwargs) -> Tuple[str, str]:
        if op in ("add", "sub"):
            if kwargs.get("alpha", 1) != 1:
                raise self.fail(f"torch.{op} with alpha")
            kwargs = {k: v for k, v in kwargs.items() if k != "alpha"}
        if op == "div" and kwargs.get("rounding_mode") is not None:
            raise self.fail("torch.div with a rounding_mode")
        if op == "div":
            kwargs = {k: v for k, v in kwargs.items()
                      if k != "rounding_mode"}
        if op.startswith("clamp"):
            return self.clamp(op, args, kwargs)
        if kwargs:
            raise self.fail(f"{op} with keyword arguments {sorted(kwargs)}")
        n_args = {"neg": 1, "abs": 1, "not": 1, "isnan": 1, "isinf": 1,
                  "exp": 1, "log": 1, "log1p": 1, "expm1": 1, "sqrt": 1,
                  "where": 3}.get(op, 2)
        if len(args) != n_args:
            raise self.fail(f"{op} with {len(args)} operands")
        if op in _BINARY or op == "rdiv":
            x, y = self.floats(op, args)
            if op == "rdiv":  # c / x in Python: x.reciprocal() * c
                return f"__fmul_rn(__frcp_rn({y}), {x})", "float"
            if op == "div" and self.operand(args[1])[1] == "const":
                # torch on CUDA: a tensor over a scalar is a product with
                # the scalar's f32 reciprocal
                with np.errstate(divide="ignore"):
                    inv = np.float32(1.0) / np.float32(args[1])
                return f"__fmul_rn({x}, {f32_literal(float(inv))})", "float"
            return _BINARY[op].format(x, y), "float"
        if op in _UNARY_F:
            (x,) = self.floats(op, args)
            return _UNARY_F[op].format(x), "float"
        if op in _TENSOR_PAIR:
            x, y = self.floats(op, args, tensors_only=True)
            return _TENSOR_PAIR[op].format(x, y), "float"
        if op == "logaddexp":
            x, y = self.floats(op, args, tensors_only=True)
            # ATen (LogAddExpKernel.cu): isinf(a) && a == b ? a
            #                            : max(a, b) + log1p(exp(-|a - b|))
            return (f"((isinf({x}) && {x} == {y}) ? {x} : __fadd_rn("
                    f"fmaxf({x}, {y}), log1pf(expf(-fabsf(__fsub_rn({x}, "
                    f"{y}))))))"), "float"
        if op in _COMPARE:
            x, y = self.floats(op, args)
            return f"({x} {_COMPARE[op]} {y})", "bool"
        if op in ("isnan", "isinf"):
            (x,) = self.floats(op, args)
            return f"{op}({x})", "bool"
        if op in ("and", "or"):
            x, y = self.masks(op, args)
            return f"({x} {'&&' if op == 'and' else '||'} {y})", "bool"
        if op == "not":
            (x,) = self.masks(op, args)
            return f"(!{x})", "bool"
        if op == "where":
            (c,) = self.masks(op, args[:1])
            x, y = self.floats(op, args[1:])
            return f"({c} ? {x} : {y})", "float"
        raise self.fail(f"the op {op}")  # pragma: no cover

    def clamp(self, op: str, args, kwargs) -> Tuple[str, str]:
        names = {"clamp": ("min", "max"), "clamp_min": ("min",),
                 "clamp_max": ("max",)}[op]
        if len(args) < 1 or len(args) > 1 + len(names) \
                or set(kwargs) - set(names):
            raise self.fail(f"torch.{op} with arguments {args[1:]} "
                            f"{kwargs}")
        bounds = dict(zip(names, args[1:]))
        for k, v in kwargs.items():
            if k in bounds:
                raise self.fail(f"torch.{op} with {k} given twice")
            bounds[k] = v
        bounds = {k: v for k, v in bounds.items() if v is not None}
        if not bounds:
            raise self.fail(f"torch.{op} without a bound")
        for v in bounds.values():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise self.fail(f"torch.{op} with a bound that is not a "
                                f"Python constant")
        (x,) = self.floats(op, args[:1], tensors_only=True)
        # torch (clamp_scalar on CUDA): a NaN stays, else min(max(v, lo), hi)
        body = x
        if "min" in bounds:
            body = f"fmaxf({body}, {f32_literal(bounds['min'])})"
        if "max" in bounds:
            body = f"fminf({body}, {f32_literal(bounds['max'])})"
        return f"(isnan({x}) ? {x} : {body})", "float"

    def lower(self, graph: torch.fx.Graph) -> str:
        placeholders = [n for n in graph.nodes if n.op == "placeholder"]
        if len(placeholders) != 2:
            raise self.fail(f"{len(placeholders)} operands, not 2")
        self.values[placeholders[0]] = ("a", "float")
        self.values[placeholders[1]] = ("b", "float")
        output = next(n for n in graph.nodes if n.op == "output")
        result = output.args[0]
        if not isinstance(result, torch.fx.Node):
            raise self.fail(f"a result that is not one tensor ({result!r}): "
                            f"not a scalar combine")
        live = set()
        stack = [result]
        while stack:
            n = stack.pop()
            if n in live:
                continue
            live.add(n)
            stack.extend(n.all_input_nodes)
        for node in graph.nodes:
            if node not in live or node.op == "placeholder":
                continue
            if node.op == "call_function":
                op = _FUNCTIONS.get(node.target)
                if op is None:
                    raise self.fail(f"the op {_name(node.target)}")
                args = node.args
                if node.target is operator.truediv \
                        and not isinstance(args[0], torch.fx.Node):
                    op = "rdiv"
            elif node.op == "call_method":
                if node.target not in _METHODS:
                    raise self.fail(f"the method Tensor.{node.target}")
                op = _METHOD_ALIASES.get(node.target, node.target)
                args = node.args
                if op == "where":  # x.where(cond, y) = where(cond, x, y)
                    args = (args[1], args[0]) + tuple(args[2:])
            elif node.op == "get_attr":
                raise self.fail("a tensor captured from the enclosing scope")
            else:
                raise self.fail(f"the fx node {node.op} {node.target}")
            if any(isinstance(a, (list, tuple, dict)) for a in args):
                raise self.fail(f"{op} with a sequence argument")
            text, kind = self.expr(op, args, dict(node.kwargs))
            name = f"t{len(self.lines)}"
            ctype = "bool" if kind == "bool" else "float"
            self.lines.append(f"const {ctype} {name} = {text};")
            self.values[node] = (name, kind)
        text, kind = self.values[result]
        if kind != "float":
            raise self.fail("a mask as the result: not an f32 combine")
        return " ".join(self.lines + [f"return {text};"])


def lower_combine(combine: Callable) -> str:
    """The C++ body of ``float op(float a, float b)`` that computes
    ``combine(a, b)`` as eager torch does on the card; raises
    ``ValueError`` for a combine outside the supported set."""
    if not callable(combine):
        raise _unsupported(combine, "not a callable")

    def traced(a, b):
        return combine(a, b)

    try:
        graph = torch.fx.symbolic_trace(traced).graph
    except torch.fx.proxy.TraceError as e:
        raise _unsupported(combine, f"Python control flow on a traced "
                                    f"value ({e})") from e
    except Exception as e:  # an op that fx cannot trace
        raise _unsupported(combine, f"tracing failed "
                                    f"({type(e).__name__}: {e})") from e
    return _Lowering(combine).lower(graph)


def combine_key(body: str) -> str:
    """The cache key of a lowered body: equal bodies, one library."""
    return hashlib.sha256(body.encode()).hexdigest()[:16]
