"""Callable-signature deduction for builders.

The reference deduces tuple/result types and plain-vs-rich variants from
C++ overload sets (``wf/meta.hpp:50-766``, ``wf/meta_gpu.hpp:48-74``).
Python has runtime introspection instead: we classify user callables by
arity -- a callable taking one parameter more than the operator's base
signature is "rich" and receives a RuntimeContext as its last argument
(API file: every operator lists a plain and a rich variant).

Return-value conventions replace the reference's pointer/optional
variants (API:19-33):
* Filter: return truthy/falsy (in-place predicate) or None-vs-result
  (transforming filter) -- ``None`` drops the tuple like an empty
  ``std::optional``.
* Map: return None (in-place mutation) or a new record.
"""
from __future__ import annotations

import functools
import inspect
from typing import Any, Callable


def arity(fn: Callable) -> int:
    """Number of positional parameters of ``fn`` (functors count
    ``__call__``; bound methods exclude self)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return -1
    n = 0
    for p in sig.parameters.values():
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD):
            n += 1
        elif p.kind == inspect.Parameter.VAR_POSITIONAL:
            return -1  # *args: cannot deduce; treated as plain
    return n


def is_rich(fn: Callable, base_arity: int) -> bool:
    """True iff ``fn`` takes base_arity+1 params (the RuntimeContext)."""
    a = arity(fn)
    if a == base_arity:
        return False
    if a == base_arity + 1:
        return True
    if a == -1:
        return False
    raise TypeError(
        f"callable {fn!r} has {a} positional params; expected "
        f"{base_arity} (plain) or {base_arity + 1} (rich)")


def with_context(fn: Callable, base_arity: int, context) -> Callable:
    """Normalize plain/rich callables to the plain signature by binding
    the RuntimeContext when the callable is rich."""
    if is_rich(fn, base_arity):
        @functools.wraps(fn)
        def bound(*args):
            return fn(*args, context)
        return bound
    return fn


def default_hash(key: Any) -> int:
    """Deterministic key hash used for KEYBY routing and window
    assignment.  ``std::hash`` in the reference (standard_emitter.hpp:
    88-99); here stable across runs and processes (Python's str hash is
    salted, so route ints through identity and strings through FNV-1a)."""
    if isinstance(key, (int,)):
        return key if key >= 0 else -key
    if isinstance(key, bytes):
        data = key
    else:
        data = str(key).encode()
    h = 0xcbf29ce484222325
    for b in data:
        h = ((h ^ b) * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    return h
