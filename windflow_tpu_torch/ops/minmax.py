"""Max and min in the reference's order: XLA's rule for signed zeros.

XLA (``jnp.maximum``, ``jnp.max``, ``lax.pmax`` and their min twins)
orders -0 below +0: the max of two equal zeros is +0 when either is +0,
the min is -0 when either is -0, whatever the operands' order.  Torch
returns one of the operands instead: on the CPU ``torch.maximum(0., -0.)``
is 0. and ``torch.maximum(-0., 0.)`` is -0., and ``amax``/``amin`` keep
whichever zero their loop met first on the CPU and on the card alike.
So a fold over zeros of both signs gives other bits than the reference.
These functions give XLA's bits: NaN propagates as in ``torch.maximum``,
and a tie of zeros is settled by the sign bit.

On a CUDA tensor ``maximum`` and ``minimum`` are torch's own: its CUDA
kernel already orders zeros so (NaN checks, then ``fmaxf``/``fminf``,
the form the hand kernels' ``MaxOp``/``MinOp`` take), which the
signed-zero phase of ``chip_smoke.py`` holds on the card.  ``amax`` and
``amin`` settle a zero result on every device.

The reference's ``lax.pmax``/``lax.pmin`` over a mesh axis follow
another rule on its host devices: a fold in shard order from the
neutral with a strict comparison, so a tie keeps the earlier shard's
value and a NaN is passed over.  :func:`pmax` and :func:`pmin` give
those bits.

Host lanes (numpy, the native engine) keep numpy's order, as the
reference's host lanes do, and a user combine that calls
``torch.maximum`` in its own body keeps torch's rule.
"""
from __future__ import annotations

import torch

# the sign bit alone: the int32 bits of -0.0
_NEG_ZERO_BITS = torch.iinfo(torch.int32).min


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.maximum`` with max(+0, -0) = +0 in either order."""
    out = torch.maximum(a, b)
    if out.is_cuda:
        return out
    return torch.where(a == b, torch.where(torch.signbit(a), b, a), out)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.minimum`` with min(+0, -0) = -0 in either order."""
    out = torch.minimum(a, b)
    if out.is_cuda:
        return out
    return torch.where(a == b, torch.where(torch.signbit(a), a, b), out)


def amax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.amax(dim)`` of f32 ``x`` with +0 for a zero max of a row that
    holds a +0.  Read from the bits' own max: a row's int32 bits top out
    at exactly 0 only when it holds a +0 and nothing with a clear sign
    bit above it (no positive value, no +NaN), so its max is a zero or
    NaN, which ``abs`` settles to +0 or leaves NaN."""
    out = x.amax(dim)
    return torch.where(x.view(torch.int32).amax(dim) == 0, out.abs(), out)


def amin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.amin(dim)`` of f32 ``x`` with -0 for a zero min of a row that
    holds a -0: the bits' own min is the sign bit alone exactly when the
    row holds a -0, so its min is <= 0 or NaN, which ``-abs`` leaves but
    for the sign of a zero."""
    out = x.amin(dim)
    return torch.where(x.view(torch.int32).amin(dim) == _NEG_ZERO_BITS,
                       -out.abs(), out)


def _shard_fold(x: torch.Tensor, dim: int, wins, neutral: float):
    acc = torch.full_like(x.select(dim, 0), neutral)
    for i in range(x.shape[dim]):
        xi = x.select(dim, i)
        acc = torch.where(wins(xi, acc), xi, acc)
    return acc


def pmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The reference's ``lax.pmax`` over the shards along ``dim``: the
    shards folded in order from -inf, a shard taken only when it is
    greater (a tie keeps the earlier shard's zero; NaN is passed over,
    so a row of NaN gives -inf)."""
    return _shard_fold(x, dim, torch.gt, float("-inf"))


def pmin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The reference's ``lax.pmin`` over the shards along ``dim`` (from
    +inf, a shard taken only when it is less)."""
    return _shard_fold(x, dim, torch.lt, float("inf"))
