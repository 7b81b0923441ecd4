"""Host -> device transfer of streamed row chunks.

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
  copy's event has completed.

On the CPU the copy is a plain tensor copy with no stream or event.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

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
