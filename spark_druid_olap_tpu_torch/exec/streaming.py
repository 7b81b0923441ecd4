"""Streaming execution: aggregate row chunks that never fit on the device
(or in host memory) at once.

BASELINE config #4 is an hourly rollup over a 1B-row event stream, far
beyond one card's memory.  The streaming executor holds O(chunk) rows on the
device at any moment:

  * chunks are normalized on a background producer thread (select the
    needed columns, cast to the device dtypes, pad to one static shape)
    straight into a slot of a pinned staging ring (`exec/pipeline.py`), so
    host work on chunk k+1 overlaps the device's work on chunk k;
  * time ships as int32 offsets plus an int64 base when a chunk's span
    allows, and validity as the row count: the card rebuilds both
    (`_prep`);
  * with double buffering on, chunk k+1's copy is issued on a dedicated
    copy stream before chunk k's compute, which waits on its own chunk's
    copy event: the link streams behind the device;
  * each chunk runs the engine's per-shard body (`engine.shard_partials`),
    and only the [G, M] partial state and the sketch states persist across
    chunks, folded in chunk order (`engine.fold_partials`), so a stream's
    frame is bit-identical with double buffering on and off.

On a mesh (`StreamExecutor(mesh=...)`, `parallel/mesh.py`) the chunk pads
to a multiple of ROW_PAD x the data-axis size and splits over the data axis:
each device gets the rows of its shards, copied from the same pinned slot
on a copy stream of its own, and each shard runs the same per-shard body at
(rows per shard, groups per shard), its kernel priced there; the shards'
states merge by the mesh's merge path
(`DistributedEngine.merge_positions`) and the merged state folds in chunk
order.

Deadlines: the consumer checkpoints before each chunk
(`streaming.chunk_loop`, with the `device_dispatch` fault site after it).
Under a partial collector an expiry stops the stream: the chunk generator
is closed at once, which cancels the producer, joins it (and raises if it
did not stop), waits for the last copy and frees the staging ring before
the partial state is fetched; the answer's coverage is unknown (a stream
declares no scope), its `rows_seen` the rows folded.  The producer thread
never checks a deadline: it stops through its `cancelled` event.

The kernel strategy is `_stream_strategy`: an engine with an explicit
strategy is honoured through its own resolution; under "auto" the cost
model picks the class at (rows per chunk, G), by the engine's cost
constants (`plan/cost.choose_kernel_strategy`): dense (the group-by kernel
on a card, at most 4096 groups; its plain version on the CPU) or the
scatter path.  Only dense states apply; the adaptive and sparse tiers are
not offered to a stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Dict, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch

from ..catalog.segment import NULL_ID, ROW_PAD, DataSource
from ..models import aggregations as A
from ..models import query as Q
from ..obs import SPAN_DEVICE_FETCH, SPAN_FINALIZE, SPAN_STREAM_CHUNK, prof, span
from ..ops.quantiles import SEGMENT_POSITION
from ..plan.cost import choose_kernel_strategy
from ..resilience import checkpoint_partial, current_partial, fire
from .engine import Engine, fold_partials, shard_partials
from .finalize import finalize_groupby, finalize_timeseries, finalize_topn
from .lowering import (
    empty_partials,
    groupby_with_time_granularity,
    timeseries_to_groupby,
    topn_to_groupby,
)
from .pipeline import StagingRing, pipelined_put

_STOP = object()


@dataclasses.dataclass
class StreamStats:
    rows: int = 0
    chunks: int = 0
    # stage seconds: normalize runs on the producer thread (overlapped with
    # the device); put and dispatch are consumer-side walls of issuing the
    # copies and the chunk's device work, not device time
    normalize_s: float = 0.0
    put_s: float = 0.0
    dispatch_s: float = 0.0
    # bytes shipped host -> device (post-normalization dtypes)
    h2d_bytes: int = 0
    strategy: str = ""  # the kernel strategy every chunk ran
    # a deadline stopped the stream before its last chunk
    truncated: bool = False
    # the producer thread was joined and the staging ring freed
    producer_joined: bool = False


class StreamExecutor:
    """Executes GroupBy, Timeseries and TopN over an iterator of host
    row-chunks.

    `chunks` yields dicts mapping column name -> numpy array (row-aligned;
    dimension columns already dictionary-encoded as int32 codes of the
    datasource's dictionaries).  Every chunk must have at most `chunk_rows`
    rows; shorter chunks are padded, and a validity mask keeps the padding
    out of every aggregate.  `double_buffer=False` issues each chunk's copy
    on the compute stream just before its compute, with no chunk held back:
    the serial counterfactual, with the same results.  `mesh` runs each
    chunk over a mesh's shards (the engine still lowers and prices)."""

    def __init__(
        self,
        engine: Optional[Engine] = None,
        prefetch: int = 2,
        double_buffer: bool = True,
        mesh=None,
    ):
        self.engine = engine or Engine()
        self.prefetch = prefetch
        self.double_buffer = double_buffer
        self.stats = StreamStats()
        self.mesh = mesh
        self._dist = None
        if mesh is not None:
            from ..parallel.distributed import DistributedEngine

            self._dist = DistributedEngine(mesh, shard_cache_bytes=0)
        devs = mesh.distinct() if mesh is not None else [self.engine.device]
        # time narrowing pays where the chunk crosses a link; on the CPU the
        # copy is a local memcpy and the narrowing's extra host passes
        # (min, max, subtract) are pure loss
        self._narrow_time = all(d.type == "cuda" for d in devs)

    def _prep(self, dev, base: int, nrows: int, time_col, chunk_rows: int, device,
              offset: int = 0):
        """Device-side chunk reconstruction on `device`: int64 time from
        int32 offsets plus the base, the validity mask from the row count
        (the rows from `offset` on: a shard's)."""
        cols = dict(dev)
        off = cols.pop("__time_off", None)
        if off is not None:
            t = off.to(torch.int64) + base
            cols[time_col] = t
            cols["__time"] = t
        elif time_col and time_col in cols:
            cols["__time"] = cols[time_col]
        cols["__valid"] = (
            torch.arange(offset, offset + chunk_rows, dtype=torch.int32, device=device)
            < nrows
        )
        return cols

    # -- public entry points -------------------------------------------------

    def execute(
        self,
        q: Q.QuerySpec,
        ds: DataSource,
        chunks: Iterable[Mapping[str, np.ndarray]],
        chunk_rows: int,
    ):
        if isinstance(q, Q.TimeseriesQuery):
            df = self._execute_groupby(
                timeseries_to_groupby(q), ds, chunks, chunk_rows
            )
            return finalize_timeseries(df, q, ds)
        if isinstance(q, Q.TopNQuery):
            df = self._execute_groupby(topn_to_groupby(q), ds, chunks, chunk_rows)
            return finalize_topn(df, q)
        if isinstance(q, Q.GroupByQuery):
            return self._execute_groupby(q, ds, chunks, chunk_rows)
        raise NotImplementedError(
            f"streaming {type(q).__name__} (scan/search need no aggregation "
            "state — iterate chunks host-side instead)"
        )

    # -- core ----------------------------------------------------------------

    def _execute_groupby(
        self,
        q: Q.GroupByQuery,
        ds: DataSource,
        chunks: Iterable[Mapping[str, np.ndarray]],
        chunk_rows: int,
    ):
        q = groupby_with_time_granularity(q)
        pad_unit = ROW_PAD
        if self.mesh is not None:
            from ..parallel.mesh import DATA_AXIS

            pad_unit = ROW_PAD * self.mesh.shape[DATA_AXIS]
        if chunk_rows % pad_unit:
            chunk_rows = -(-chunk_rows // pad_unit) * pad_unit
        if (
            any(d.dimension == "__time" or d.granularity for d in q.dimensions)
            and not q.intervals
            and ds.interval() is None
        ):
            raise ValueError(
                "streaming time-bucketed queries need explicit intervals "
                "(a schema-only datasource has no segment time range to "
                "derive buckets from)"
            )
        eng = self.engine
        lowering = eng._lowering_for(q, ds)
        la, G = lowering.la, lowering.num_groups
        root = eng.device
        if self._dist is None:
            strategy = self._stream_strategy(G, chunk_rows)
        else:
            # the kernel at the shape each shard runs
            from ..parallel.mesh import DATA_AXIS

            root = self._dist.device
            _, Gl = self._dist._groups_split(G)
            strategy = self._stream_strategy(Gl, chunk_rows // self.mesh.shape[DATA_AXIS])
        self.stats = StreamStats(strategy=strategy)
        pc = current_partial()
        if pc is not None:
            # a stream has no knowable denominator: the collector counts
            # the rows seen, and a partial answer's coverage is None
            pc.begin_pass()
        state = None
        device_chunks = self._prefetched_device_chunks(
            chunks, lowering.columns, ds, chunk_rows
        )
        # a stream cut short closes its generator here, so the producer is
        # stopped and joined before the partial state is fetched
        with contextlib.closing(device_chunks):
            for puts, base, nrows in device_chunks:
                if checkpoint_partial("streaming.chunk_loop"):
                    self.stats.truncated = True
                    break
                fire("device_dispatch")
                t0 = time.perf_counter()
                with span(SPAN_STREAM_CHUNK, chunk=self.stats.chunks), \
                        prof.device_timer(root):
                    if self._dist is None:
                        cols = self._prep(puts[0][2], base, nrows, ds.time_column, chunk_rows,
                                          puts[0][0])
                        part = shard_partials(lowering, cols, strategy)
                    else:
                        part = self._mesh_chunk(lowering, puts, base, nrows, ds.time_column,
                                                chunk_rows, strategy)
                    # the fold is in chunk order, whatever the copy order
                    state = fold_partials(la, state, part)
                self.stats.chunks += 1
                self.stats.dispatch_s += time.perf_counter() - t0
                if pc is not None:
                    pc.add_seen(1, nrows)
        if state is None:  # empty stream
            state = empty_partials(la, G, root)
        with span(SPAN_DEVICE_FETCH):
            fetcher = eng if self._dist is None else self._dist
            sums, mins, maxs, sketches, _ = fetcher._host_state(la, state)
        with span(SPAN_FINALIZE):
            return finalize_groupby(q, lowering.dims, la, sums, mins, maxs, sketches)

    def _mesh_chunk(self, lowering, puts, base: int, nrows: int, time_col,
                    chunk_rows: int, strategy: str):
        """One chunk over the mesh: every shard's state from its rows of the
        chunk (each launched before any merge), merged by the mesh's merge
        path onto the first shard's device."""
        from ..parallel.mesh import DATA_AXIS, GROUPS_AXIS

        dist = self._dist
        nd, NG = self.mesh.shape[DATA_AXIS], self.mesh.shape[GROUPS_AXIS]
        ng, Gl = dist._groups_split(lowering.num_groups)
        local = chunk_rows // nd
        on = {dev: (lo, cols) for dev, lo, cols in puts}
        grid = self.mesh.devices
        # a quantile sample hashes the chunk's row positions, as one stream does
        positions = any(isinstance(a, A.QuantilesSketch) for a in lowering.la.sketch_aggs)
        parts = []
        for i, p in enumerate(dist._positions(ng)):
            d, g = divmod(p, NG)
            lo, cols = on[grid[d, g]]
            a = d * local - lo
            shard = {k: t[a:a + local] for k, t in cols.items()}
            shard = self._prep(shard, base, nrows, time_col, local, grid[d, g], offset=d * local)
            if positions:
                shard[SEGMENT_POSITION] = torch.arange(d * local, (d + 1) * local,
                                                       dtype=torch.int32, device=grid[d, g])
            parts.append(dist._shard_state(lowering, shard, strategy, i % ng, ng, Gl))
        return dist.merge_positions(lowering, parts, ng)

    def _targets(self, chunk_rows: int):
        """(device, first row, end row) of each device a chunk is copied
        to: the whole chunk to the engine's device, or on a mesh each
        distinct device's span of data shards."""
        if self.mesh is None:
            return [(self.engine.device, 0, chunk_rows)]
        from ..parallel.mesh import DATA_AXIS, GROUPS_AXIS

        nd, NG = self.mesh.shape[DATA_AXIS], self.mesh.shape[GROUPS_AXIS]
        local = chunk_rows // nd
        grid = self.mesh.devices
        out = []
        for dev in self.mesh.distinct():
            held = [d for d in range(nd) for g in range(NG) if grid[d, g] == dev]
            out.append((dev, min(held) * local, (max(held) + 1) * local))
        return out

    def _stream_strategy(self, G: int, rows_per_dispatch: int) -> str:
        """The kernel strategy of every chunk: the engine's own when it was
        given one; under "auto" the cost model's class at the shape each
        dispatch runs, (rows_per_dispatch, G), among the dense-state
        classes (dense or segment)."""
        eng = self.engine
        if eng.strategy != "auto":
            return eng._resolve_strategy(G)
        cls = choose_kernel_strategy(rows_per_dispatch, G, eng.cost_config, device=eng.device)
        return eng._resolve_strategy(G, cls)

    # -- chunk plumbing ------------------------------------------------------

    def _normalize_chunk(
        self,
        chunk: Mapping[str, np.ndarray],
        need,
        ds: DataSource,
        chunk_rows: int,
        ring: StagingRing,
        slot: int,
    ) -> Dict:
        """Host-side, into ring slot `slot`: the needed columns cast to the
        device dtypes and padded to the static chunk shape; time as int32
        offsets plus a base where narrowing applies.  Returns the slot's
        host tensors by device column name, with "__rows", "__slot" and, for
        narrowed time, "__time_base"."""
        first = next(iter(chunk.values()))
        rows = len(first)
        if rows > chunk_rows:
            raise ValueError(f"chunk has {rows} rows > chunk_rows={chunk_rows}")
        out: Dict = {"__slot": slot, "__rows": rows}
        for n in need:
            a = np.asarray(chunk[n])[:rows]
            if n in ds.dicts:
                dtype, fill = np.int32, NULL_ID
            elif ds.time_column and n == ds.time_column:
                # a chunk's time span virtually always fits int32 ms (~24
                # days): ship base + offsets, halving the widest column
                a = a.astype(np.int64, copy=False)
                narrow = rows and self._narrow_time
                base = int(a.min()) if narrow else 0
                span = int(a.max()) - base if narrow else 1 << 31
                if span < (1 << 31):
                    t = ring.view(slot, n, np.int32)
                    v = t.numpy()
                    np.subtract(a, base, out=v[:rows], casting="unsafe")
                    v[rows:] = 0
                    out["__time_off"] = t
                    out["__time_base"] = base
                    continue
                dtype, fill = np.int64, 0
            elif a.dtype.kind in ("i", "u", "b"):
                dtype, fill = np.int32, 0
            else:
                dtype, fill = np.float32, 0
            t = ring.view(slot, n, dtype)
            v = t.numpy()
            np.copyto(v[:rows], a, casting="unsafe")
            v[rows:] = fill
            out[n] = t
        return out

    def _prefetched_device_chunks(
        self, chunks, need, ds: DataSource, chunk_rows: int
    ) -> Iterator:
        """A background thread normalizes host chunks into the staging ring;
        this (consumer) side issues the copies and every other device call,
        and yields ([(device, first row, device columns)] per target device
        (`_targets`), time base, rows) in chunk order, each chunk's copies
        waited on by their devices' compute streams."""
        targets = self._targets(chunk_rows)
        device = targets[0][0]
        # a slot for the producer, `prefetch` queued, one in the consumer's
        # hand and one whose copy may be in flight: the producer never
        # waits for a slot the consumer cannot free
        ring = StagingRing(need, chunk_rows, self.prefetch + 3, device)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        cancelled = threading.Event()

        def _put(item) -> bool:
            # bounded put that gives up when the consumer is gone, so a
            # failing query never leaves the producer parked in q.put
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for chunk in chunks:
                    slot = ring.acquire(cancelled)
                    if slot is None:
                        return
                    t0 = time.perf_counter()
                    item = self._normalize_chunk(
                        chunk, need, ds, chunk_rows, ring, slot
                    )
                    self.stats.normalize_s += time.perf_counter() - t0
                    if not _put(item):
                        return
                _put(_STOP)
            except BaseException as e:  # surfaced to (re-raised by) the consumer
                _put(e)

        def release(slot, events):
            for event in events:
                if event is not None:
                    event.synchronize()  # the copy has read the slot
            ring.release(slot)

        def ready(entry):
            puts, base, rows = entry
            for dev, _, _, event in puts:
                if event is not None:
                    torch.cuda.current_stream(dev).wait_event(event)
            return [(dev, lo, cols) for dev, lo, cols, _ in puts], base, rows

        copy_streams = {
            dev: torch.cuda.Stream(dev) if self.double_buffer and dev.type == "cuda" else None
            for dev, _, _ in targets
        }
        held = None
        in_flight = None
        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    break
                if isinstance(item, BaseException):
                    raise item
                slot = item.pop("__slot")
                rows = item.pop("__rows")
                base = item.pop("__time_base", 0)
                t0 = time.perf_counter()
                puts = []
                for dev, lo, hi in targets:  # a pinned slice per device
                    part = item if (lo, hi) == (0, chunk_rows) else {
                        k: v[lo:hi] for k, v in item.items()}
                    cols, event, nbytes = pipelined_put(part, dev, copy_streams[dev])
                    puts.append((dev, lo, cols, event))
                    self.stats.h2d_bytes += nbytes
                self.stats.put_s += time.perf_counter() - t0
                self.stats.rows += rows
                # the previous chunk's copy was issued a chunk ago
                if in_flight is not None:
                    release(*in_flight)
                in_flight = (slot, [p[3] for p in puts])
                entry = (puts, base, rows)
                if not self.double_buffer:
                    yield ready(entry)
                    continue
                # hold one back: chunk k+1's copy is issued before chunk k's
                # compute
                held, entry = entry, held
                if entry is not None:
                    yield ready(entry)
            if held is not None:
                yield ready(held)
        finally:
            cancelled.set()
            while True:  # unblock a producer stuck on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
            if t.is_alive():
                # it could still write into a slot the ring is about to free
                raise RuntimeError("the stream's producer thread did not stop within 5 s")
            if in_flight is not None:
                release(*in_flight)  # the last copy has read its slot
            ring.close()
            self.stats.producer_joined = True
