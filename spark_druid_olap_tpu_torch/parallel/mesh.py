"""Device meshes for multi-device execution, and the one merge code path.

The reference builds a `jax.sharding.Mesh` whose axes carry the two ways an
aggregation decomposes, and its single controller drives every device of
the host through it.  The port keeps the design: one process drives every
card of the host, and a `Mesh` here is a 2-D array of `torch.device`s with
the reference's axis names:

* ``data``: row shards (the historicals' analog).  Each shard aggregates its
  rows; the partial states merge.
* ``groups``: group-domain shards.  Each shard owns a slice of [0, G).
* ``slice``: on a slice mesh (`make_slice_mesh`) the outer axis of a
  virtual multi-slice topology; rows shard over (slice, data), and the merge
  tree decides whether the states merge flat or slice by slice.

A mesh may list one device several times: a *logical* mesh.  The CPU tests
build the reference's 8-device test mesh as 8 x ``cpu``, and a one-card
machine drives the mesh on the card as 4 x ``cuda:0``.

**The merge** (`reduce_states`, `gather_states`) has one code path:

1. the partial states of the shards that share a device reduce on that
   device, in fixed shard order;
2. where the shards span distinct cards, the per-card results reduce across
   them with in-process NCCL (`torch.cuda.nccl.reduce` to the first card:
   sum, min or max), the reference's `psum`/`pmin`/`pmax`;
3. a gather (the sparse rung's slot-compacted states, theta and quantile
   states) is an NCCL all-gather across distinct cards, then a fold in
   shard order on the first shard's device.

On the CPU and on one card, step 2 has nothing to do: that is the same path
with one participant, not a fallback.  `merge_tree` orders the reductions:
flat over every row shard, or, on a slice mesh, within each slice first and
then across slices.

A mesh may span processes (`parallel/multihost.hybrid_mesh`): `processes`
ranks, each holding a contiguous run of the data axis (its slice).  A
process holds only its own positions' states, so the merge gains a last
step (`across_processes`): each process's result is all-gathered over
`torch.distributed` and folded in rank order, the same bits on every rank.
Its order is the hierarchical tree's: a P-process x D-device run equals the
one-process P-slice x D slice mesh under that tree.

The reference's `shard_map_compat`, `row_sharding` and `replicated` have no
counterpart: the port places each shard on its device itself
(`parallel/distributed.py`), and there is no SPMD program to annotate.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# the only axis names any mesh of this package declares
DATA_AXIS = "data"
GROUPS_AXIS = "groups"
SLICE_AXIS = "slice"
AXIS_NAMES = (DATA_AXIS, GROUPS_AXIS)
SLICE_AXIS_NAMES = (SLICE_AXIS, DATA_AXIS)

# torch.cuda.nccl's reduction codes
_NCCL_OPS = {"sum": 0, "max": 2, "min": 3}


class Mesh:
    """A 2-D array of devices with named axes.  `shape` maps each axis name
    to its size, in axis order, like the reference's `Mesh.shape`.  Over
    several processes, `processes` ranks split the first axis into
    contiguous runs (`multihost.owned`) and this one is `rank`; the
    positions of other ranks name this process's devices and are never
    placed."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str], processes: int = 1,
                 rank: int = 0):
        if devices.ndim != 2 or len(axis_names) != 2:
            raise ValueError("a mesh is a 2-D array of devices with two axis names")
        if devices.shape[0] % processes:
            raise ValueError(f"{devices.shape[0]} rows do not split over {processes} processes")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        self.processes = int(processes)
        self.rank = int(rank)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> List[torch.device]:
        """Every position's device, row-major (the shard order)."""
        return list(self.devices.flat)

    def distinct(self) -> List[torch.device]:
        """The distinct devices, in first-listed order."""
        return list(dict.fromkeys(self.flat()))

    def describe(self) -> dict:
        d = {"axes": self.shape, "devices": [str(d) for d in self.flat()]}
        if self.processes > 1:
            d.update(processes=self.processes, rank=self.rank)
        return d

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat()]})"


def visible_devices() -> List[torch.device]:
    """Every visible CUDA card; raises without one (pass devices to run a
    mesh on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass devices (e.g. [torch.device('cpu')] * 8) "
            "to build a mesh on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _devices(devices: Optional[Sequence]) -> List[torch.device]:
    if devices is None:
        return visible_devices()
    return [torch.device(d) for d in devices]


def make_mesh(n_data: Optional[int] = None, n_groups: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, groups) mesh over `devices` (default: every visible card),
    all of them on the data axis unless `n_data` says otherwise; a longer
    device list is cut to n_data x n_groups."""
    devs = _devices(devices)
    if n_data is None:
        n_data = len(devs) // n_groups
    if n_data < 1 or n_groups < 1 or n_data * n_groups > len(devs):
        raise ValueError(f"mesh {n_data}x{n_groups} needs {max(1, n_data) * n_groups} devices, "
                         f"have {len(devs)}")
    arr = np.empty((n_data, n_groups), dtype=object)
    for i, d in enumerate(devs[: n_data * n_groups]):
        arr.flat[i] = d
    return Mesh(arr, AXIS_NAMES)


def make_slice_mesh(n_slices: int, n_data: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> Mesh:
    """A (slice, data) mesh, the virtual multi-slice topology: contiguous
    device ranges form a slice.  Rows shard over both axes."""
    devs = _devices(devices)
    if n_slices < 1:
        raise ValueError("n_slices must be >= 1")
    if n_data is None:
        n_data = len(devs) // n_slices
    if n_data < 1 or n_slices * n_data > len(devs):
        raise ValueError(f"slice mesh {n_slices}x{n_data} needs {n_slices * n_data} devices, "
                         f"have {len(devs)}")
    arr = np.empty((n_slices, n_data), dtype=object)
    for i, d in enumerate(devs[: n_slices * n_data]):
        arr.flat[i] = d
    return Mesh(arr, SLICE_AXIS_NAMES)


def row_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The axes rows shard over: (slice, data) on a slice mesh, (data,) on
    the standard mesh."""
    if SLICE_AXIS in mesh.shape:
        return (SLICE_AXIS, DATA_AXIS)
    return (DATA_AXIS,)


def merge_groups(mesh: Mesh, tree: str) -> List[List[int]]:
    """The row shards (flat indices over the row axes) each step of the
    merge reduces: one group of every shard for the flat tree; on a slice
    mesh under the hierarchical tree, one group per slice (the slice's
    shards), whose results then reduce across slices."""
    n = int(np.prod([mesh.shape[a] for a in row_axes(mesh)]))
    if tree == "hierarchical" and SLICE_AXIS in mesh.shape:
        nd = mesh.shape[DATA_AXIS]
        return [list(range(s * nd, (s + 1) * nd)) for s in range(mesh.shape[SLICE_AXIS])]
    return [list(range(n))]


def _fold(op: str) -> Callable:
    if op == "sum":
        return torch.add
    if op == "min":
        return torch.minimum
    if op == "max":
        return torch.maximum
    raise ValueError(f"unknown reduction {op!r}")


def reduce_states(parts: Sequence[torch.Tensor], op: str,
                  across_processes: bool = False) -> torch.Tensor:
    """`parts` (one per shard, in shard order, each on its shard's device)
    reduced by `op` ("sum", "min", "max") onto the first shard's device:
    on each device the shards it holds fold in shard order, then NCCL
    reduces the per-card results across distinct cards, then, with
    `across_processes`, every process's result folds in rank order
    (`multihost.process_fold`)."""
    fold = _fold(op)
    per_dev: Dict[torch.device, torch.Tensor] = {}
    for t in parts:
        acc = per_dev.get(t.device)
        per_dev[t.device] = t if acc is None else fold(acc, t)
    outs = list(per_dev.values())
    if len(outs) == 1:
        out = outs[0]
    elif any(t.device.type != "cuda" for t in outs):
        raise ValueError(f"shards on distinct non-CUDA devices: {[str(t.device) for t in outs]}")
    else:
        out = _nccl_reduce(outs, op)
    if across_processes:
        from .multihost import process_fold

        out = process_fold(out, fold)
    return out


def _nccl_reduce(outs: List[torch.Tensor], op: str) -> torch.Tensor:
    """NCCL's reduce of same-shape tensors on distinct cards onto the first:
    each card's participation is launched on its current stream, the
    first's result read after them."""
    import torch.cuda.nccl as nccl

    outs = [t.contiguous() for t in outs]
    if outs[0].dtype == torch.bool:  # NCCL has no bool reduction
        return _nccl_reduce([t.to(torch.uint8) for t in outs], op).to(torch.bool)
    result = torch.empty_like(outs[0])
    nccl.reduce(outs, output=result, root=0, op=_NCCL_OPS[op])
    return result


def gather_states(parts: Sequence[torch.Tensor],
                  across_processes: bool = False) -> List[torch.Tensor]:
    """Every shard's tensor on the first shard's device, in shard order:
    across distinct cards an NCCL all-gather of each card's shards (same
    shapes), on one device the parts as they are; with `across_processes`,
    every process's shards after this process's step, in rank order (the
    global shard order)."""
    local = _gather_local(parts)
    if not across_processes:
        return local
    from .multihost import all_gather

    per_rank = all_gather(torch.stack(local))
    return [t for block in per_rank for t in block]


def _gather_local(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    root = parts[0].device
    devs = list(dict.fromkeys(t.device for t in parts))
    if len(devs) == 1:
        return list(parts)
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"shards on distinct non-CUDA devices: {[str(d) for d in devs]}")
    import torch.cuda.nccl as nccl

    by_dev = {d: [i for i, t in enumerate(parts) if t.device == d] for d in devs}
    per = {len(v) for v in by_dev.values()}
    if len(per) != 1:
        raise ValueError("an all-gather needs as many shards on every card")
    k = per.pop()
    shape = tuple(parts[0].shape)
    dtype = parts[0].dtype
    wire = torch.uint8 if dtype == torch.bool else dtype
    ins = [torch.stack([parts[i] for i in by_dev[d]]).to(wire).contiguous() for d in devs]
    outs = [torch.empty((len(devs) * k,) + shape, dtype=wire, device=d) for d in devs]
    nccl.all_gather(ins, outs)
    got = outs[0].to(dtype)
    order = [i for d in devs for i in by_dev[d]]
    placed: List[Optional[torch.Tensor]] = [None] * len(parts)
    for pos, i in enumerate(order):
        placed[i] = got[pos]
    assert all(p is not None and p.device == root for p in placed)
    return placed  # type: ignore[return-value]


def merge_tree(mesh: Mesh, tree: str, parts: Sequence[torch.Tensor], op: str) -> torch.Tensor:
    """The row shards' `parts` reduced by `op` in the order of `tree`
    (`merge_groups`): each group reduced, then the groups' results.  Over
    processes `parts` are this process's shards, its slice: they reduce,
    then the processes' results fold in rank order (the hierarchical tree,
    whatever `tree` says: a process's shards are one group)."""
    if mesh.processes > 1:
        return reduce_states(parts, op, across_processes=True)
    groups = merge_groups(mesh, tree)
    if len(groups) == 1:
        return reduce_states([parts[i] for i in groups[0]], op)
    return reduce_states([reduce_states([parts[i] for i in g], op) for g in groups], op)
