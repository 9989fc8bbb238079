"""Distributed window-id assignment arithmetic.

These pure functions reproduce -- bit-exactly, since the determinism
oracles depend on them -- the gwid/initial-id math the reference embeds
in its hot loops:

* ``first_gwid_key`` / ``initial_id``: win_seq.hpp:348-357
* last/first containing window: win_seq.hpp:381-411, wf_nodes.hpp:156-181
* WF worker multicast set: wf_nodes.hpp:182-191
* PLQ result renumbering: win_seq.hpp:483-487

They are dependency-free and unit-tested directly (SURVEY.md §4
"implication": the reference never unit-tests these; we do).
"""
from __future__ import annotations

import math
from typing import List, Tuple

from .basic import Role, WinOperatorConfig


def first_gwid_of_key(hashcode: int, cfg: WinOperatorConfig) -> int:
    """gwid of the first window of this key owned by this engine replica
    (win_seq.hpp:349)."""
    inner = (cfg.id_inner - (hashcode % cfg.n_inner) + cfg.n_inner) % cfg.n_inner
    outer = (cfg.id_outer - (hashcode % cfg.n_outer) + cfg.n_outer) % cfg.n_outer
    return inner * cfg.n_outer + outer


def initial_id_of_key(hashcode: int, cfg: WinOperatorConfig, role: Role) -> int:
    """Initial id/timestamp of the keyed substream reaching this replica
    (win_seq.hpp:350-357).  WLQ/REDUCE see renumbered inner streams, so
    only the inner offset applies."""
    outer = ((cfg.id_outer - (hashcode % cfg.n_outer) + cfg.n_outer) % cfg.n_outer) * cfg.slide_outer
    inner = ((cfg.id_inner - (hashcode % cfg.n_inner) + cfg.n_inner) % cfg.n_inner) * cfg.slide_inner
    if role in (Role.WLQ, Role.REDUCE):
        return inner
    return outer + inner


def gwid_of_lwid(first_gwid_key: int, lwid: int, cfg: WinOperatorConfig) -> int:
    """Translate a local window id to the global one (win_seq.hpp:420)."""
    return first_gwid_key + lwid * cfg.n_outer * cfg.n_inner


def last_window_of(id_: int, initial_id: int, win_len: int, slide_len: int) -> int:
    """Local id of the last window containing tuple ``id_``; -1 if (for
    hopping windows) the tuple falls in a gap (win_seq.hpp:381-411)."""
    if win_len >= slide_len:  # sliding or tumbling
        return int(math.ceil((id_ + 1 - initial_id) / slide_len)) - 1
    # hopping: windows leave gaps
    n = (id_ - initial_id) // slide_len
    off = id_ - initial_id
    if off < n * slide_len or off >= n * slide_len + win_len:
        return -1
    return n


def window_range_of(id_: int, initial_id: int, win_len: int,
                    slide_len: int) -> Tuple[int, int]:
    """[first_w, last_w] local window ids containing tuple ``id_``
    (wf_nodes.hpp:156-181); (-1,-1) if none (hopping gap)."""
    if win_len >= slide_len:
        if id_ + 1 - initial_id < win_len:
            first_w = 0
        else:
            first_w = int(math.ceil((id_ + 1 - win_len - initial_id) / slide_len))
        last_w = int(math.ceil((id_ + 1 - initial_id) / slide_len)) - 1
        return first_w, last_w
    n = (id_ - initial_id) // slide_len
    off = id_ - initial_id
    if n * slide_len <= off < n * slide_len + win_len:
        return n, n
    return -1, -1


def wf_destinations(hashcode: int, first_w: int, last_w: int,
                    pardegree: int) -> List[int]:
    """Win_Farm multicast set: window lwid ``w`` of a key whose first
    window starts at worker ``hash % pardegree`` lives on worker
    ``(hash % pardegree + w) % pardegree``; at most ``pardegree``
    distinct workers receive the tuple (wf_nodes.hpp:182-191)."""
    start = hashcode % pardegree
    out = []
    w = first_w
    while w <= last_w and len(out) < pardegree:
        out.append((start + w) % pardegree)
        w += 1
    return out


def plq_renumbered_id(hashcode: int, emit_counter: int,
                      cfg: WinOperatorConfig) -> int:
    """Id given to a PLQ pane result so the WLQ sees a dense per-key
    sequence (win_seq.hpp:484)."""
    return ((cfg.id_inner - (hashcode % cfg.n_inner) + cfg.n_inner) % cfg.n_inner) \
        + emit_counter * cfg.n_inner


def pane_length(win_len: int, slide_len: int) -> int:
    """Pane size = gcd(win, slide) (Li et al. SIGMOD'05; pane_farm.hpp)."""
    return math.gcd(win_len, slide_len)
