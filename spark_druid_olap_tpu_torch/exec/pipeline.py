"""Host -> device transfers: streamed row chunks, and segment columns.

The streaming executor (`exec/streaming.py`) is the one path whose input
never becomes resident: every chunk crosses the host link once, and the link
sits on the critical path.  This module holds the transfer primitive it
runs on:

* `StagingRing`: a ring of host buffers at the stream's static chunk shape,
  allocated once per stream on the consumer thread; page-locked (pinned) when
  the device is a card, since a `non_blocking` copy from pageable memory is
  a synchronous one.  The producer thread normalizes each chunk straight
  into a free slot through its numpy view, so a chunk is copied on the host
  once.
* `pipelined_put`: copies a slot's columns to the device with
  `copy_(non_blocking=True)` on the stream it is given (a dedicated copy
  stream for double buffering), records an event after the copies and
  returns the device tensors, the event and the bytes shipped.  Each device
  tensor is marked used by the compute stream (`record_stream`), so the
  caching allocator does not hand its memory to a later chunk while a
  kernel still reads it.  A slot goes back to the ring only once its
  copy's event has completed.  A ring's buffers are freed by `close()`,
  which the stream calls once its producer has stopped.

On the CPU the copy is a plain tensor copy with no stream or event.

The engine's segment loop reads a column that is not resident through
`TransferPipeline.put`, the counterpart of the reference's
`exec/pipeline.py` for segments.  With the pipeline on
(`SessionConfig.transfer_pipeline`) the column comes from a page-locked
host copy of it, made at its first copy and kept (an LRU under
PINNED_BUDGET_FRACTION of the host's memory, dropped by
`Engine.clear_cache`, and for a retired segment by `retire`), as a DMA on
the compute stream that the host does not wait for; the kernels that read it are queued behind it on the same
stream.  Off, the column comes from the segment's pageable array, a copy
the host waits for.  A scope that returns after its columns left the
card is then pure DMA at the link's rate; the first copy of a column pays
its pinning.  A column of a snapshot loaded from disk is a read-only
memmap: `pin_host` reads it from disk once, straight into the page-locked
buffer, and a later copy of it reads the buffer, never the file; with the
pipeline off it is read into an owned array (`materialize`) at each copy.
The reference's prefetch of the next segments on a copy
stream, its residency-first order and its speculative next-interval
prefetch are not ported: the port's cold loop is host-bound, and on the
H100 a prefetch of the next two segments on a copy stream ran 1.22x
slower than these pinned copies, overlapping no kernel (PERF.md; ROADMAP
queue A item 3).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..catalog.persist import materialize
from ..utils.lru import ByteBudgetCache

_BYTES_PER_ROW = 8  # the widest column a chunk ships (int64 time)
_TORCH_DTYPES = {
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
}


class StagingRing:
    """`slots` host staging slots, each holding one byte buffer of
    `chunk_rows * 8` bytes per column name, so any column of the stream fits
    at any device dtype.  Slots circulate by index through a free list."""

    def __init__(self, names, chunk_rows: int, slots: int, device: torch.device):
        pin = device.type == "cuda"
        self.chunk_rows = chunk_rows
        self.buffers = [
            {
                n: torch.empty(chunk_rows * _BYTES_PER_ROW, dtype=torch.uint8,
                               pin_memory=pin)
                for n in names
            }
            for _ in range(slots)
        ]
        self._free: "queue.Queue[int]" = queue.Queue()
        for i in range(slots):
            self._free.put(i)

    def close(self) -> None:
        """Frees the buffers.  Every copy from them must have completed and
        no thread may write them any more."""
        self.buffers = []

    def acquire(self, cancelled: threading.Event) -> Optional[int]:
        """A free slot's index, waiting for one; None once `cancelled` is
        set (the consumer is gone)."""
        while not cancelled.is_set():
            try:
                return self._free.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def release(self, slot: int) -> None:
        self._free.put(slot)

    def view(self, slot: int, name: str, dtype: np.dtype) -> torch.Tensor:
        """Column `name` of `slot` as a host tensor of `chunk_rows` values of
        `dtype`; write it through `.numpy()`."""
        dtype = np.dtype(dtype)
        nbytes = self.chunk_rows * dtype.itemsize
        return self.buffers[slot][name][:nbytes].view(_TORCH_DTYPES[dtype])


def pipelined_put(
    host: Dict[str, torch.Tensor],
    device: torch.device,
    stream: Optional["torch.cuda.Stream"] = None,
) -> Tuple[Dict[str, torch.Tensor], Optional["torch.cuda.Event"], int]:
    """Ship host tensors to `device`.  On a card the copies run on `stream`
    (the current stream when None) from pinned memory, and an event is
    recorded after them; the compute side waits on that event before it
    reads the tensors.  Returns (device tensors, event, bytes shipped)."""
    nbytes = sum(t.numel() * t.element_size() for t in host.values())
    if device.type != "cuda":
        return {k: t.clone() for k, t in host.items()}, None, nbytes
    compute = torch.cuda.current_stream(device)
    copy_stream = compute if stream is None else stream
    out: Dict[str, torch.Tensor] = {}
    with torch.cuda.stream(copy_stream):
        for k, t in host.items():
            if not t.is_pinned():
                raise ValueError(
                    f"{k}: a copy from pageable host memory would be synchronous"
                )
            d = torch.empty(t.shape, dtype=t.dtype, device=device)
            d.copy_(t, non_blocking=True)
            if copy_stream != compute:
                d.record_stream(compute)
            out[k] = d
        event = torch.cuda.Event()
        event.record(copy_stream)
    return out, event, nbytes


# -- segment columns ----------------------------------------------------------

# page-locked host copies of segment columns kept, as a share of the host's
# physical memory
PINNED_BUDGET_FRACTION = 0.125


def column_key(seg, name: Optional[str] = None) -> Tuple:
    """Residency-cache key of one segment column, or of the segment's
    validity mask when `name` is None.  The "col"/"valid" tags keep a user
    column literally named "__valid" from aliasing the mask."""
    return (seg.uid, "valid") if name is None else (seg.uid, "col", name)


def pin_host(host: np.ndarray) -> torch.Tensor:
    """A page-locked copy of `host`, filled by one host copy: a memmap is
    read from disk straight into the page-locked buffer, with no owned
    intermediate and no torch view of the read-only map."""
    dtype = torch.from_numpy(np.empty(0, dtype=host.dtype)).dtype
    out = torch.empty(host.shape, dtype=dtype, pin_memory=True)
    np.copyto(out.numpy(), host, casting="no")
    return out


class TransferPipeline:
    """An engine's copies of segment columns to the device: the setting and
    the pinned host copies."""

    def __init__(self, engine, enabled: bool = True):
        self.engine = engine
        self.enabled = bool(enabled)
        # residency key -> page-locked host copy (cards only)
        self._pinned = ByteBudgetCache(int(
            os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") * PINNED_BUDGET_FRACTION))

    def configure(self, config) -> None:
        """Applies SessionConfig's `transfer_pipeline`."""
        self.enabled = bool(config.transfer_pipeline)

    def put(self, key, host: np.ndarray) -> torch.Tensor:
        """Column `key` (its host array `host`) on the device: on a card with
        the pipeline on, from its pinned copy, on the compute stream, the
        host not waiting; else from `host` itself (a disk-backed column
        read into an owned array first)."""
        dev = self.engine.device
        if not self.enabled or dev.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(materialize(host))).to(dev)
        # the host allocator keeps the pinned copy's memory until this copy
        # is done, even if the LRU drops it first
        return self.pinned(key, host).to(dev, non_blocking=True)

    def pinned(self, key, host: np.ndarray) -> torch.Tensor:
        """The page-locked host copy of column `key`, made from `host` at its
        first use and kept: `host` is read once per pinning."""
        pinned = self._pinned.get(key)
        if pinned is None:
            pinned = pin_host(host)
            self._pinned[key] = pinned
        return pinned

    def retire(self, uids) -> None:
        """Drops the pinned host copies of the columns of retired segments."""
        for key in [k for k in self._pinned if k[0] in uids]:
            self._pinned.pop(key)

    def clear(self) -> None:
        """Drops the pinned host copies."""
        self._pinned.clear()

    def to_dict(self) -> dict:
        return {
            "enabled": self.enabled,
            "pinned_columns": len(self._pinned),
            "pinned_bytes": self._pinned.bytes_used,
        }
