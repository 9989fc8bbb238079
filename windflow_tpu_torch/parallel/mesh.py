"""Device-mesh helpers for the mesh plane.

The reference builds a ``jax.sharding.Mesh`` with named axes and lets
XLA insert the collectives of one single-controller SPMD program.  The
port keeps that shape in one process: a mesh **slot** is a logical
shard, every slot of a process sits on one torch device, and the shards
of an array are one stacked tensor there, so a collective between slots
of one process is a tensor op over the stacked axis (``psum`` over
'win' a sum over that axis, a tiled ``all_gather`` a reshape, a ring
``ppermute`` a roll).  Across processes the 'key' axis spans the ranks
of a ``torch.distributed`` process group and every 'win' row stays
inside one process; an engine call computes its process's key rows and
``all_gather``s the key-sharded result (the counterpart of a global
``jax.Array``).  Axis conventions, as in the reference:

* ``key``  -- key-shard axis: per-key window state is sharded by key
  hash (the Key_Farm / Key_FFAT distribution, ≈ data parallelism);
* ``win``  -- intra-window axis: one window's tuples are striped and
  partials combined over it (the Win_MapReduce distribution).

The card is the default device: ``make_mesh()`` raises without one, and
``device="cpu"`` asks for the CPU.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.device import resolve_device


class Slot(NamedTuple):
    """One logical shard of a mesh: its global index and the rank of
    the process that holds it."""
    id: int
    process_index: int


class Mesh:
    """A 2-D mesh of slots.  ``devices`` is the ``[key, win]`` array of
    :class:`Slot`; ``shape`` maps each axis name to its size (the
    reference's ``mesh.shape["key"]``); ``device`` is the torch device
    this process's slots live on; ``group`` the process group the key
    axis spans (None: this process holds every slot)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str],
                 device: torch.device, group=None):
        if devices.ndim != 2 or len(axis_names) != 2:
            raise ValueError("a mesh is 2-D: ('key', 'win')")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))
        self.device = device
        self.group = group
        self.rank = (torch.distributed.get_rank(group)
                     if group is not None else 0)
        mine = [k for k, row in enumerate(devices)
                if row[0].process_index == self.rank]
        # this process's key rows: one contiguous block of the key axis
        self.key_rows = (mine[0], mine[-1] + 1)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def local_rows(self, x):
        """This process's rows of ``x``, whose axis 0 is split evenly
        over the key axis (all of ``x`` on a one-process mesh)."""
        if self.group is None:
            return x
        per = x.shape[0] // self.devices.shape[0]
        lo, hi = self.key_rows
        return x[lo * per: hi * per]


def _slots(n: int, win_axis: int, process_index: int = 0,
           first: int = 0) -> np.ndarray:
    arr = np.empty(n, dtype=object)
    for i in range(n):
        arr[i] = Slot(first + i, process_index)
    return arr.reshape(n // win_axis, win_axis)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, str] = ("key", "win"),
              win_axis: int = 1,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """Build a 2-D ('key', 'win') mesh of ``n_devices`` logical slots
    on one torch device (default: the CUDA card; raises without one).

    ``win_axis`` slots cooperate on each window; the remaining slots
    shard the key space.  ``n_devices=None`` takes the number of
    visible CUDA cards for a CUDA device, and ``win_axis`` (one key
    shard) for the CPU."""
    dev = resolve_device(device if device is not None else "cuda")
    if n_devices is None:
        n_devices = (torch.cuda.device_count() if dev.type == "cuda"
                     else win_axis)
    n = int(n_devices)
    if n < 1 or n % win_axis != 0:
        raise ValueError(f"{n} devices not divisible by win_axis={win_axis}")
    return Mesh(_slots(n, win_axis), axis_names, dev)


def make_multihost_mesh(win_axis: int = 1,
                        axis_names: Tuple[str, str] = ("key", "win"),
                        n_local: Optional[int] = None,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Mesh:
    """Multi-process ('key', 'win') mesh over the initialised default
    ``torch.distributed`` process group.

    Keys are independent sub-streams, so the 'key' axis is laid across
    processes; the 'win' axis carries the combines of the WMR / PF /
    ring paths, so every 'win' row stays inside one process (the
    reference's rule: bandwidth-hungry axes inside a host).  Each
    process holds ``n_local`` slots (default ``win_axis``: one 'win'
    row) on ``device`` (default the CUDA card; NCCL runs one process a
    card, gloo CPU processes with ``device="cpu"``).

    With no initialised process group, or a world of one, this is
    ``make_mesh(n_local, ...)`` (the reference's single-process rule)."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return make_mesh(n_local, axis_names, win_axis, device)
    dev = resolve_device(device if device is not None else "cuda")
    local = int(n_local) if n_local is not None else win_axis
    if local < 1 or local % win_axis != 0:
        raise ValueError(
            f"{local} local devices not divisible by win_axis={win_axis}")
    world, rank = dist.get_world_size(), dist.get_rank()
    counts = [None] * world
    dist.all_gather_object(counts, local)
    if len(set(counts)) != 1:
        raise ValueError(f"every process must hold as many slots: {counts}")
    # slots grouped by process: process r holds key rows
    # [r * local / win_axis, (r + 1) * local / win_axis)
    rows = [_slots(local, win_axis, r, r * local) for r in range(world)]
    return Mesh(np.concatenate(rows), axis_names, dev,
                group=dist.group.WORLD)


class KeySharding(NamedTuple):
    """The placement of an array whose axis 0 is split over 'key' and
    replicated over 'win' (the reference's ``NamedSharding(mesh,
    P('key', None, ...))``)."""
    mesh: Mesh
    spec: tuple

    @property
    def device_set(self) -> set:
        """Every slot that holds a shard: all of them (each 'win' slot of
        a key row holds that row's shard)."""
        return set(self.mesh.devices.flat)


def key_sharding(mesh: Mesh, rank: int = 1) -> KeySharding:
    """Axis 0 on 'key', the other ``rank - 1`` axes replicated."""
    return KeySharding(mesh, ("key",) + (None,) * (rank - 1))


def key_shards(x, sharding: KeySharding) -> Dict[Slot, torch.Tensor]:
    """A host array split into its key shards: for every slot of this
    process, the rows of its key row's block of ``x`` on the mesh's
    device (one tensor a key row, shared by its 'win' slots)."""
    mesh = sharding.mesh
    t = torch.as_tensor(np.asarray(x)).to(mesh.device)
    if t.dim() != len(sharding.spec):
        raise ValueError(f"array of rank {t.dim()} for a sharding of "
                         f"rank {len(sharding.spec)}")
    n_key = mesh.devices.shape[0]
    if t.shape[0] % n_key:
        raise ValueError(f"axis 0 ({t.shape[0]}) not divisible by the "
                         f"key axis ({n_key})")
    per = t.shape[0] // n_key
    lo, hi = mesh.key_rows
    out = {}
    for k in range(lo, hi):
        block = t[k * per: (k + 1) * per]
        for slot in mesh.devices[k]:
            out[slot] = block
    return out
