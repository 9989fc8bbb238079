"""Declarative frontend: select / where / window / join combinators.

A thin relational veneer over the MultiPipe algebra so event-time
queries read like the NexMark prose (docs/EVENTTIME.md "Declarative
frontend").  Each combinator appends the corresponding operator to the
wrapped pipe and returns the query, so pipelines compose left to
right::

    q = wf.query(g.add_source(src))
    (q.where(lambda t: t.value > 0)
      .select(lambda t: setattr(t, "value", t.value * RATE))
      .window(sum, size=10)
      .sink(collect))

Joins take a second query and compile the merge + side-tagging
plumbing of :mod:`windflow_tpu_torch.eventtime.joins` automatically.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..operators.basic_ops import Filter, Map, Sink
from .joins import (LEFT, RIGHT, IntervalJoin, WindowJoin, tag_side)
from .sessions import SessionWindow
from .windows import EventTimeWindow

__all__ = ["StreamQuery", "query"]


class StreamQuery:
    """A MultiPipe wrapped with relational combinators."""

    def __init__(self, pipe):
        self.pipe = pipe

    # -- stateless relational ops ------------------------------------
    def where(self, pred: Callable, parallelism: int = 1,
              name: str = "where") -> "StreamQuery":
        self.pipe.chain(Filter(pred, parallelism=parallelism, name=name))
        return self

    def select(self, fn: Callable, parallelism: int = 1,
               name: str = "select") -> "StreamQuery":
        self.pipe.chain(Map(fn, parallelism=parallelism, name=name))
        return self

    # -- event-time windows ------------------------------------------
    def window(self, agg: Callable, size: float, slide: float = None,
               lateness: float = 0.0, parallelism: int = 1,
               name: str = "window") -> "StreamQuery":
        self.pipe.add(EventTimeWindow(agg, size, slide, lateness,
                                      parallelism, name))
        return self

    def session(self, agg: Callable, gap: float, lateness: float = 0.0,
                parallelism: int = 1,
                name: str = "session") -> "StreamQuery":
        self.pipe.add(SessionWindow(agg, gap, lateness, parallelism,
                                    name))
        return self

    # -- two-input joins ---------------------------------------------
    def join(self, other: "StreamQuery", *,
             size: float = None, slide: float = None,
             lower: float = None, upper: float = None,
             join_fn: Callable = None, lateness: float = 0.0,
             parallelism: int = 1, key_of: Callable = None,
             other_key_of: Callable = None, key_col: str = None,
             other_key_col: str = None,
             name: str = "join") -> "StreamQuery":
        """Windowed join (``size=``) or interval join (``lower=`` /
        ``upper=``) of this query (LEFT) with ``other`` (RIGHT),
        re-keying either side on the join key via ``key_of`` (record
        plane) or ``key_col`` (batch plane)."""
        windowed = size is not None
        if windowed == (lower is not None or upper is not None):
            raise ValueError(
                "join() needs exactly one of size= (window join) or "
                "lower=/upper= (interval join)")
        self.pipe.chain(tag_side(LEFT, key_of=key_of, key_col=key_col,
                                 name=f"{name}_tag_left"))
        other.pipe.chain(tag_side(RIGHT, key_of=other_key_of,
                                  key_col=other_key_col,
                                  name=f"{name}_tag_right"))
        merged = self.pipe.merge(other.pipe)
        if windowed:
            merged.add(WindowJoin(size, slide, join_fn, lateness,
                                  parallelism, name))
        else:
            merged.add(IntervalJoin(
                float("-inf") if lower is None else lower,
                float("inf") if upper is None else upper,
                join_fn, lateness, parallelism, name))
        return StreamQuery(merged)

    # -- terminal ------------------------------------------------------
    def sink(self, fn: Callable, parallelism: int = 1,
             name: str = "sink") -> "StreamQuery":
        self.pipe.add_sink(Sink(fn, parallelism=parallelism, name=name))
        return self


def query(pipe) -> StreamQuery:
    """Wrap a sourced MultiPipe in the declarative combinators."""
    return StreamQuery(pipe)
