"""Processes over `torch.distributed`: a mesh whose data axis spans
processes, each driving its own devices and placing only its own rows.

The reference forms a multi-process JAX runtime (`jax.distributed`) and
places global arrays so that each process holds the shards its devices
address; XLA's collectives merge across hosts.  The port keeps the two
halves:

* **Rendezvous** (`initialize`): `torch.distributed.init_process_group`,
  joined only when a rendezvous is given or the environment names one
  (what `torchrun` sets, `MASTER_ADDR`/`MASTER_PORT` with `RANK` and
  `WORLD_SIZE`; SLURM's `SLURM_PROCID` and `SLURM_NTASKS`; Open MPI's
  `OMPI_COMM_WORLD_RANK` and `OMPI_COMM_WORLD_SIZE`, each with the
  `MASTER_ADDR` and `MASTER_PORT` of the rendezvous).  Safe to call
  unconditionally: with no rendezvous and no marker it returns False, a
  marker without enough of the environment to form a group stays
  single-process, and a second call is a no-op.  The backend is gloo on
  the CPU, and where ranks share a card (NCCL will not put two ranks on
  one); NCCL where each rank has a card of its own.
* **Placement** (`hybrid_mesh`, `local_rows`): the mesh's data axis spans
  the processes, each over its local devices (a slice mesh of P slices,
  one per process, when the groups axis is 1).  Every process knows the
  global layout (the catalog is deterministic), and materialises and
  copies only the rows of its own mesh positions
  (`parallel/distributed.py`, `parallel/spmd_arena.py`).
* **The merge** (`all_gather`, used by `parallel/mesh.py`): each process
  folds its positions' states (per device in shard order, then across its
  cards), the processes' results are all-gathered and folded in rank
  order, so every rank holds the same bits, and a P-process x D-device run
  equals the single-process P-slice x D slice mesh under the hierarchical
  tree bit for bit.

`local_segments` deals a datasource's segments round-robin by rank (which
"historical" owns which segment) and `process_info` reports the counts.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.log import get_logger

log = get_logger("parallel.multihost")

# environment variables whose presence asks for a rendezvous
MARKERS = ("MASTER_ADDR", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE")
# how long a collective may wait for the other ranks before it raises
TIMEOUT_S = 300.0

_initialized = False
_backend: Optional[str] = None


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return None


def _resolve(coordinator_address, num_processes, process_id) -> Tuple[str, int, int]:
    """(address "host:port", world size, rank): the arguments, else the
    environment; ValueError when something is missing."""
    addr = coordinator_address
    if addr is None:
        host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not host or not port:
            raise ValueError("no rendezvous address (MASTER_ADDR and MASTER_PORT)")
        addr = f"{host}:{port}"
    world = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int(
        "RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
    if world is None or rank is None:
        raise ValueError("no world size or rank (RANK/WORLD_SIZE, SLURM_PROCID/SLURM_NTASKS "
                         "or OMPI_COMM_WORLD_RANK/OMPI_COMM_WORLD_SIZE)")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    return addr, int(world), int(rank)


def _local_rank(rank: int) -> int:
    """This process's index among the host's ranks: the launcher's, else
    its global rank (one host)."""
    v = _env_int("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK")
    return v if v is not None else rank


def _local_world(world: int) -> int:
    v = _env_int("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE", "OMPI_COMM_WORLD_LOCAL_SIZE")
    return v if v is not None else world


def default_backend(world: int) -> str:
    """NCCL where each rank of this host has a card of its own, else gloo."""
    import torch.distributed as dist

    if (torch.cuda.is_available() and dist.is_nccl_available()
            and torch.cuda.device_count() >= _local_world(world)):
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None) -> bool:
    """Join (or form) the process group.  `coordinator_address` is
    "host:port" of rank 0's rendezvous.  Returns True when a multi-process
    group is (already) up, False when this stays one process."""
    global _initialized, _backend
    if _initialized:
        return True
    import torch.distributed as dist

    if not dist.is_available():
        return False
    if dist.is_initialized():  # a launcher formed it
        _initialized, _backend = True, dist.get_backend()
        return True
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not any(k in os.environ for k in MARKERS):
        return False
    try:
        addr, world, rank = _resolve(coordinator_address, num_processes, process_id)
    except ValueError as err:
        if not explicit:
            # a marker without the rest (SLURM_JOB_ID in an interactive
            # allocation with no task variables): one process
            log.info("cluster environment not resolvable (%s); staying single-process", err)
            return False
        raise
    backend = backend or default_backend(world)
    if backend == "nccl":
        torch.cuda.set_device(_local_rank(rank) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _initialized, _backend = True, backend
    log.info("joined the process group: rank %d of %d over %s", rank, world, backend)
    return True


def shutdown() -> None:
    """Leaves the process group (a no-op without one)."""
    global _initialized, _backend
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized, _backend = False, None


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_devices() -> List[torch.device]:
    """This process's devices: its own card under NCCL, else every visible
    card; raises without one (pass devices to run on the host)."""
    if _backend == "nccl":
        return [torch.device("cuda", torch.cuda.current_device())]
    from .mesh import visible_devices

    return visible_devices()


def hybrid_mesh(n_groups: int = 1, devices: Optional[Sequence] = None):
    """The mesh over every process: the data axis spans the processes, each
    over `devices` (default `local_devices()`).  One process: `make_mesh`.
    Several, groups axis 1: a slice mesh of one slice per process; a wider
    groups axis: a (data, groups) mesh whose data rows go to the processes
    in contiguous runs.  A position of another process names this
    process's devices: only a process's own positions are ever placed."""
    from .mesh import AXIS_NAMES, SLICE_AXIS_NAMES, Mesh, make_mesh

    devs = [torch.device(d) for d in devices] if devices is not None else local_devices()
    P = process_count()
    if P <= 1:
        return make_mesh(n_groups=n_groups, devices=devs)
    rank = process_index()
    if n_groups == 1:
        arr = np.empty((P, len(devs)), dtype=object)
        for p in range(P):
            for i, d in enumerate(devs):
                arr[p, i] = d
        return Mesh(arr, SLICE_AXIS_NAMES, processes=P, rank=rank)
    nd = len(devs) // n_groups
    if nd < 1:
        raise ValueError(f"{len(devs)} local devices cannot hold a groups axis of {n_groups}")
    arr = np.empty((P * nd, n_groups), dtype=object)
    for r in range(P * nd):
        for g in range(n_groups):
            arr[r, g] = devs[(r % nd) * n_groups + g]
    return Mesh(arr, AXIS_NAMES, processes=P, rank=rank)


def owned(n: int, processes: int, rank: int) -> range:
    """The indices of `n` mesh rows (or row devices) that process `rank` of
    `processes` holds: a contiguous run, its share."""
    if n % processes:
        raise ValueError(f"{n} rows do not split over {processes} processes")
    per = n // processes
    return range(rank * per, (rank + 1) * per)


def local_rows(segs, part: Callable, lo: int, hi: int, fill, dtype=None) -> np.ndarray:
    """Rows [lo, hi) of the scope's padded concatenation (each segment's
    `part(segment)`, in canonical order), built from the segments that
    overlap them alone, `fill` past the scope's end: what a process
    materialises for its own positions, never the whole scope (the
    reference's `put_sharded`; the caller copies it to the device)."""
    out, at = [], 0
    for s in segs:
        n = s.num_rows_padded
        a, b = max(lo, at), min(hi, at + n)
        if a < b:
            out.append(np.asarray(part(s))[a - at:b - at])
        at += n
        if at >= hi:
            break
    if dtype is None:
        dtype = np.asarray(part(segs[0])).dtype if segs else np.int32
    h = np.concatenate(out) if out else np.zeros(0, dtype=dtype)
    if len(h) < hi - lo:
        h = np.concatenate([h, np.full(hi - lo - len(h), fill, dtype=h.dtype)])
    return h


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's `t`, in rank order, on `t`'s device: NCCL on the card
    under NCCL, gloo through the host otherwise.  The ranks' shapes must
    agree; they are exchanged first, so a disagreement raises on every
    rank alike instead of hanging."""
    P = process_count()
    if P <= 1:
        return [t]
    import torch.distributed as dist

    on_card = _backend == "nccl"
    dev = t.device if on_card else torch.device("cpu")
    shape = torch.tensor(list(t.shape) + [-1] * (8 - t.dim()), dtype=torch.int64, device=dev)
    shapes = [torch.empty_like(shape) for _ in range(P)]
    dist.all_gather(shapes, shape)
    if any(not torch.equal(s, shapes[0]) for s in shapes):
        raise ValueError(f"ranks disagree on a state's shape: {[s.tolist() for s in shapes]}")
    wire = t.detach().to(torch.uint8) if t.dtype == torch.bool else t.detach()
    wire = wire.to(dev).contiguous().reshape(-1)
    outs = [torch.empty_like(wire) for _ in range(P)]
    dist.all_gather(outs, wire)
    return [o.reshape(t.shape).to(device=t.device, dtype=t.dtype) for o in outs]


def process_fold(t: torch.Tensor, fold: Callable) -> torch.Tensor:
    """`t` from every rank folded in rank order (`fold(acc, next)`): the
    same bits on every rank."""
    parts = all_gather(t)
    acc = parts[0]
    for x in parts[1:]:
        acc = fold(acc, x)
    return acc


def local_segments(segments) -> list:
    """This process's share of a datasource's segments, dealt round-robin
    by rank: which rows each process owns, the same on every process
    without coordination."""
    P, r = process_count(), process_index()
    if P <= 1:
        return list(segments)
    return [s for i, s in enumerate(segments) if i % P == r]


def process_info(devices: Optional[Sequence] = None) -> Dict[str, object]:
    """The rank, the process count, and the local and global device counts
    (`devices`: this process's, default `local_devices()`, none on a host
    without a card)."""
    if devices is not None:
        local = len(devices)
    else:
        local = len(local_devices()) if _backend == "nccl" or torch.cuda.is_available() else 0
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": local,
        "global_devices": local * process_count(),
        "backend": _backend or "",
    }
