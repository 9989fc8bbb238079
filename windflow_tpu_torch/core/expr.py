"""Expression descriptors for record fields.

A tiny algebra over the tuple control-field contract (``key``, ``id``,
``ts``, ``value``) that one definition serves every execution plane:

* **scalar plane** -- ``to_callable()`` gives the plain-Python
  record function (the reference's C++ functor analog);
* **columnar plane** -- ``to_batch()`` evaluates vectorized over a
  ``TupleBatch``'s numpy columns;
* **native plane** -- ``match_*`` helpers pattern-match the expression
  onto the C++ record-pipeline stage descriptors
  (native/record_pipeline.cpp), letting source->map->filter->window->
  sink chains run record-at-a-time in C++ end-to-end.

The reference compiles arbitrary C++ functors into each operator
(meta.hpp overload sets); a Python framework cannot, so expressions are
the declared, loweable subset -- arbitrary Python callables remain
accepted everywhere and simply pin the graph to the Python planes.

Usage::

    from windflow_tpu_torch import F
    Map(F.value * 2 + 1)            # value <- value*2 + 1
    Filter(F.value % 4 == 0)        # keep when predicate holds
    Map((F.id * 1.0).as_value())    # value <- id
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

_FIELDS = ("key", "id", "ts", "value")

# binary ops: (python fn, symbol)
_OPS = {
    "add": (lambda a, b: a + b, "+"),
    "sub": (lambda a, b: a - b, "-"),
    "mul": (lambda a, b: a * b, "*"),
    "div": (lambda a, b: a / b, "/"),
    "mod": (lambda a, b: a % b, "%"),
    "eq": (lambda a, b: a == b, "=="),
    "ne": (lambda a, b: a != b, "!="),
    "lt": (lambda a, b: a < b, "<"),
    "le": (lambda a, b: a <= b, "<="),
    "gt": (lambda a, b: a > b, ">"),
    "ge": (lambda a, b: a >= b, ">="),
}
_CMPS = ("eq", "ne", "lt", "le", "gt", "ge")


class Expr:
    """Immutable expression tree node."""

    __slots__ = ("op", "a", "b")

    def __init__(self, op: str, a, b=None):
        self.op = op    # 'field' | 'const' | binary op name
        self.a = a      # field name / constant / left Expr
        self.b = b      # right Expr (binary only)

    # -- construction sugar -------------------------------------------
    def _bin(self, op, other, swap=False):
        o = other if isinstance(other, Expr) else Expr("const", other)
        return Expr(op, o, self) if swap else Expr(op, self, o)

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o, True)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, True)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return self._bin("mul", o, True)
    def __truediv__(self, o): return self._bin("div", o)
    def __mod__(self, o): return self._bin("mod", o)
    def __eq__(self, o): return self._bin("eq", o)      # type: ignore
    def __ne__(self, o): return self._bin("ne", o)      # type: ignore
    def __lt__(self, o): return self._bin("lt", o)
    def __le__(self, o): return self._bin("le", o)
    def __gt__(self, o): return self._bin("gt", o)
    def __ge__(self, o): return self._bin("ge", o)
    __hash__ = None  # mutable-compare semantics; not a dict key

    def __repr__(self):
        if self.op == "field":
            return f"F.{self.a}"
        if self.op == "const":
            return repr(self.a)
        return f"({self.a!r} {_OPS[self.op][1]} {self.b!r})"

    # -- evaluation ---------------------------------------------------
    def eval_record(self, rec) -> Any:
        if self.op == "field":
            return getattr(rec, self.a)
        if self.op == "const":
            return self.a
        return _OPS[self.op][0](self.a.eval_record(rec),
                                self.b.eval_record(rec))

    def eval_columns(self, cols) -> Any:
        """Vectorized evaluation over a dict/TupleBatch of columns."""
        if self.op == "field":
            return cols[self.a]
        if self.op == "const":
            return self.a
        return _OPS[self.op][0](self.a.eval_columns(cols),
                                self.b.eval_columns(cols))

    def to_callable(self) -> Callable[[Any], Any]:
        return self.eval_record

    # -- structure queries (used by the native matcher) ---------------
    def is_field(self, name=None) -> bool:
        return self.op == "field" and (name is None or self.a == name)

    def const_value(self) -> Optional[float]:
        return self.a if self.op == "const" else None


class _FieldNS:
    """``F.value`` / ``F.key`` / ``F.id`` / ``F.ts``."""

    def __getattr__(self, name: str) -> Expr:
        if name not in _FIELDS:
            raise AttributeError(
                f"unknown record field {name!r} (have {_FIELDS})")
        return Expr("field", name)


F = _FieldNS()


# ---------------------------------------------------------------------------
# Native-descriptor pattern matching
# ---------------------------------------------------------------------------

def match_affine(e: Expr) -> Optional[Tuple[str, float, float, bool]]:
    """Match e == field*scale + offset (or field*field*scale + offset
    with both fields 'value').  Returns (field, scale, offset, square)
    or None."""
    # invariant: original == scale * e + offset
    scale, offset = 1.0, 0.0
    while True:
        if e.op == "add" and e.b.op == "const":
            offset += scale * e.b.a
            e = e.a
        elif e.op == "add" and e.a.op == "const":
            offset += scale * e.a.a
            e = e.b
        elif e.op == "sub" and e.b.op == "const":
            offset -= scale * e.b.a
            e = e.a
        elif e.op == "sub" and e.a.op == "const":
            offset += scale * e.a.a
            scale = -scale
            e = e.b
        elif e.op == "mul" and e.b.op == "const":
            scale *= e.b.a
            e = e.a
        elif e.op == "mul" and e.a.op == "const":
            scale *= e.a.a
            e = e.b
        elif e.op == "div" and e.b.op == "const" and e.b.a != 0:
            scale /= e.b.a
            e = e.a
        else:
            break
    if e.op == "field":
        return (e.a, scale, offset, False)
    if (e.op == "mul" and e.a.is_field("value") and e.b.is_field("value")):
        return ("value", scale, offset, True)
    return None


def match_predicate(e: Expr):
    """Match a filter predicate onto a native FILTER descriptor.

    Returns one of
      ("mod_eq", field, m, r)         --  field % m == r
      (cmp, field, const)             --  field cmp const,
                                          cmp in lt/le/gt/ge/eq
    or None if not representable.
    """
    if e.op not in _CMPS:
        return None
    lhs, rhs = e.a, e.b
    if lhs.op == "const" and rhs.op != "const":
        lhs, rhs = rhs, lhs
        flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
        e_op = flip.get(e.op, e.op)
    else:
        e_op = e.op
    if rhs.op != "const":
        return None
    c = rhs.a
    # (field % m) == r
    if (e_op == "eq" and lhs.op == "mod" and lhs.a.op == "field"
            and lhs.b.op == "const"):
        return ("mod_eq", lhs.a.a, int(lhs.b.a), int(c))
    if e_op == "ne":
        return None  # no native != descriptor
    # affine(field) cmp const  ->  field cmp (const-offset)/scale
    m = match_affine(lhs)
    if m is None or m[3]:
        return None
    field, scale, offset, _ = m
    if scale == 0:
        return None
    c2 = (c - offset) / scale
    if scale < 0:
        flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
        e_op = flip.get(e_op, e_op)
    if e_op == "eq":
        return ("eq", field, c2)
    return (e_op, field, c2)
