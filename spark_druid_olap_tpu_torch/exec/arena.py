"""One dispatch per query scope: the segment loop captured as a CUDA graph.

The port's warm latency is host-bound: a query's segment loop issues 20-40
small eager torch ops per segment (the row pipeline, the kernel, the fold).
The reference removes that loop by tracing the whole in-scope fold into one
program (its `exec/arena.py`, a `lax.scan` over stacked `[B, R]` columns).
Here the same role falls to a CUDA graph, captured once per query scope and
replayed with one host call.

* **What the graph captures.**  The loop body itself: `shard_partials` then
  `fold_partials` over each in-scope segment's resident columns, in
  canonical segment order, ending in the folded (sums, mins, maxs).  A
  graph binds addresses, not shapes, so nothing is stacked: no second copy
  of the scope, and segments of unequal length are covered too.  A replay
  runs the same kernels in the same order on the same inputs as the eager
  loop, so the arena on and off give the same bits.
* **When.**  A scope's first execution runs the eager loop, so a query
  that runs once is never captured.  The second captures the graph and
  replays it; later ones replay.  A capture runs the body once on its
  stream first, the usual warm-up (the lazy `DeviceConst` copies, the
  kernel's one-time `cudaFuncSetAttribute`, the allocator), so a capture
  never copies from the host even when the lowering it captures is not
  the one the first run warmed.  A replay marks the scope's columns
  recently used in the residency cache, as the loop's reads would.  On
  the CPU there is no graph: the program calls the same body eagerly, so
  plans, declines, keys and invalidation behave the same on both devices.
* **Keys.**  `arena_key`: the query's lowering-cache key, the kernel
  strategy, `key_extra` (the adaptive tier's compacted domain) and the
  in-scope segment uids.  Programs live in a count-bounded LRU
  (`ArenaCache`).  A program holds references to the columns it reads, so
  when the residency cache drops any of them (`ByteBudgetCache.on_evict`)
  or `Engine.clear_cache` runs, every program pinning it is dropped first,
  with its warm mark: the budget stays true and no graph replays freed
  memory.
* **Declines** (deterministic, each recorded in `QueryMetrics.declines`
  with the prefix "arena:"): sketch aggregations; the scatter strategy
  (`segment`), whose `nonzero` has a data-dependent size; a scope above
  `ARENA_BUDGET_FRACTION` of the residency budget; the session flag
  (`SessionConfig.arena_execution`) and the per-query opt-out
  (`arena_disabled`).  The sparse tier answers before the arena is asked
  (the engine records that decline).  A capture or replay that fails
  raises; nothing reruns through the loop.
* **Launches.**  A kernel launch recorded during capture is not counted;
  the program keeps the captured shapes and `cuda_groupby.count_replay`
  counts them at every replay.
* **Deadlines.**  A checkpoint can neither sit inside a graph (it would run
  once, at capture) nor stop one.  So under an armed deadline, or with
  fault injection armed at the loop's checkpoint site
  (`engine.segment_loop`), a scope replays in chunks of one segment: one
  graph per segment (`ChunkedProgram`, keyed apart from the whole-scope
  graph, each captured when first reached), with the checkpoint and the
  `device_dispatch` fault site on the host before each replay and the fold
  on the host between them.  The fold runs the loop's ops in the loop's
  order, so every truncation point gives the loop's bits, and a complete
  chunked run the whole-scope graph's.  A scope that has run once (its
  warm mark) or has a whole-scope program captures its chunks at once.
  Otherwise, and with no deadline, a scope stays one replay.
* **Fused micro-batches** (`serve/fusion.py`, `Engine.execute_fused`).  A
  batch of concurrent queries over resident segments is one graph: every
  member's loop over its own in-scope segments, the segments in canonical
  order outside and the members inside, so a segment's columns are read
  once and members sharing a filter mask or group ids compute them once
  (`serve.fusion.shared_row_plan`).  The graph's output is every member's
  (sums, mins, maxs) packed into one buffer, fetched in one copy.  Keyed
  ("arena-fused", the members' query keys, their strategies, their
  segment uids) in the same `ArenaCache` (and its bound), with the warm
  rule of a scope: a member set's first batch runs the fused eager loop,
  its second captures.  It is dropped with any column it reads, and with
  any member's query on a retry's eviction.  Sketch members, the scatter
  strategy and scopes over the budget decline to the fused eager loop,
  recorded.
* **Threads.**  Capture, replay and the copy out of a replay's outputs run
  under the engine's execution lock (`Engine._exec_lock`), as do the
  device half of every other execution and every eviction: the graphs
  share memory pools.  Lowering and finalizing are host work and run
  outside it, and so may another thread's CUDA calls (a delta refresh's
  frees and fetches, an append's copies): the capture runs in the
  thread-local capture mode, where only this thread's own unsafe calls,
  work on its capture stream and a whole-device synchronize (which the
  port never makes) could void it; in the global mode any CUDA call of
  another thread voided a capture, even a launch on another stream.  The
  cyclic garbage collector is off during a capture: a collection there
  that frees a CUDA graph voids the capture in either mode.
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import math
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from ..catalog.segment import row_counts
from ..obs import SPAN_ARENA_BUILD, SPAN_SEGMENT_DISPATCH, prof, span
from ..ops import cuda_groupby
from ..resilience import (
    KernelError,
    checkpoint_partial,
    current_deadline,
    current_partial,
    fire,
    site_armed,
)
from .lowering import _query_key, empty_partials
from .pipeline import column_key

# the checkpoint site of the segment loop, which the chunked replays share
SEGMENT_LOOP_SITE = "engine.segment_loop"

# a program pins every column of its scope resident; a scope above this
# share of the residency budget stays on the loop, so one query cannot
# hold the whole working set
ARENA_BUDGET_FRACTION = 0.5

# programs kept (each holds its graph's memory pool: the scope's largest
# per-segment intermediates, tens of MB at 512K-row segments)
ARENA_PROGRAM_ENTRIES = 64

_disabled: "contextvars.ContextVar[bool]" = contextvars.ContextVar(
    "arena_disabled", default=False
)


@contextlib.contextmanager
def arena_disabled():
    """Runs the enclosed executions on the eager loop (the per-query
    opt-out; `SessionConfig.arena_execution` is the session-wide one)."""
    tok = _disabled.set(True)
    try:
        yield
    finally:
        _disabled.reset(tok)


def query_disabled() -> bool:
    return _disabled.get()


def arena_key(query_key: Tuple, strategy: str, key_extra: Tuple, uids: Sequence) -> Tuple:
    """Key of one scope's program: the lowering-cache key of its query,
    the kernel strategy, `key_extra` (a compacted lowering's kept sets) and
    the in-scope segment uids.  Tagged "arena" so it never equals a
    residency key."""
    return ("arena", query_key, strategy, tuple(key_extra), tuple(uids))


def is_arena_key(key) -> bool:
    return isinstance(key, tuple) and len(key) == 5 and key[0] in ("arena", "arena-fused")


def fused_key(query_keys: Sequence, strategies: Sequence, uids: Sequence) -> Tuple:
    """Key of a fused batch's program: the members' lowering-cache keys in
    batch order, their kernel strategies and each member's segment uids."""
    return ("arena-fused", tuple(query_keys), tuple(strategies), (),
            tuple(tuple(u) for u in uids))


def chunked_replays() -> bool:
    """Does a scope replay in chunks now: a finite deadline is armed (the
    server arms an infinite one for Druid's `context.timeout: 0`), or
    fault injection is armed at the segment loop's checkpoint site?"""
    d = current_deadline()
    return (d is not None and math.isfinite(d.timeout_ms)) or site_armed(SEGMENT_LOOP_SITE)


class ArenaPlan:
    """One scope the arena covers: its program's key, the whole-scope key
    its warm mark lives under (the same key unless `chunked`), lowering,
    strategy, segments and the residency keys of the columns it reads."""

    __slots__ = ("key", "scope_key", "chunked", "lowering", "strategy", "segs", "col_keys",
                 "nbytes")

    def __init__(self, scope_key, lowering, strategy, segs, col_keys, nbytes, chunked=False):
        self.scope_key = scope_key
        self.chunked = bool(chunked)
        self.key = chunked_key(scope_key) if chunked else scope_key
        self.lowering = lowering
        self.strategy = strategy
        self.segs = list(segs)
        self.col_keys = tuple(col_keys)
        self.nbytes = int(nbytes)


def chunked_key(scope_key: Tuple) -> Tuple:
    """The key of a scope's chunked program: `key_extra` gains a marker."""
    tag, query_key, strategy, key_extra, uids = scope_key
    return (tag, query_key, strategy, ("chunked",) + tuple(key_extra), uids)


def plan_for(engine, lowering, segs, strategy: str, key_extra, ds, m) -> Optional[ArenaPlan]:
    """The arena's plan for a (non-empty) scope, or None after recording
    why it declines in `m.declines`."""
    reason = None
    if not engine.arena_execution:
        reason = "arena: arena_execution is off"
    elif query_disabled():
        reason = "arena: disabled for this query"
    elif lowering.la.sketch_aggs:
        reason = "arena: sketch aggregations are not captured"
    elif strategy == "segment":
        reason = "arena: the scatter strategy's nonzero has a data-dependent size"
    if reason is None:
        names = (*lowering.columns, None)
        nbytes = sum(
            int((s.valid if n is None else s.column(n)).nbytes) for s in segs for n in names
        )
        budget = int(engine._device_cache.budget_bytes * ARENA_BUDGET_FRACTION)
        if nbytes > budget:
            reason = (f"arena: the scope's {nbytes} bytes exceed {ARENA_BUDGET_FRACTION} "
                      f"of the residency budget ({budget})")
    if reason is not None:
        m.declines.append(reason)
        return None
    key = arena_key(_query_key(lowering.query, ds), strategy, key_extra,
                    [s.uid for s in segs])
    col_keys = [column_key(s, n) for s in segs for n in names]
    return ArenaPlan(key, lowering, strategy, segs, col_keys, nbytes, chunked=chunked_replays())


class ArenaProgram:
    """A scope's captured program: the CUDA graph and its output tensors
    on a card, the body alone on the CPU; the columns it reads; and the
    kernel launches it captured."""

    __slots__ = ("plan", "cols", "body", "graph", "outputs", "launches", "capture_ms")

    def __init__(self, plan, cols, body, graph=None, outputs=None, launches=(),
                 capture_ms=0.0):
        self.plan = plan
        self.cols = cols  # keeps the captured columns alive
        self.body = body
        self.graph = graph
        self.outputs = outputs
        self.launches = tuple(launches)
        self.capture_ms = capture_ms

    def run(self):
        """The scope's folded (sums, mins, maxs, {}): a replay, its
        launches counted and its outputs copied out (the next replay
        overwrites them); on the CPU, the body."""
        if self.graph is None:
            return self.body()
        self.graph.replay()
        cuda_groupby.count_replay(self.launches)
        return (*(t.clone() for t in self.outputs), {})


class ChunkedProgram:
    """A scope's program for chunked replays: one graph per segment (on the
    CPU the segment's body), each built when the replays first reach it,
    and the launches each captured.  The graphs share one memory pool:
    they are captured and replayed in segment order, one at a time, and
    each replay's outputs are copied out before the next, so a scope of
    115 segments holds one segment's intermediates, not 115."""

    __slots__ = ("plan", "chunks", "pool")

    def __init__(self, plan):
        self.plan = plan
        self.chunks: List[Optional[ArenaProgram]] = [None] * len(plan.segs)
        self.pool = None

    def run_chunk(self, engine, ds, i: int, m):
        """Segment i's partial state (sums, mins, maxs, {}), its graph built
        first when this is the first replay to reach it."""
        prog = self.chunks[i]
        if prog is None:
            seg = self.plan.segs[i]
            cols = engine._cols_for_segment(seg, ds, self.plan.lowering.columns, m)
            if self.pool is None and engine.device.type == "cuda":
                self.pool = torch.cuda.graph_pool_handle()
            prog = self.chunks[i] = build_arena_program(engine, self.plan, [cols], self.pool)
            if prog.graph is not None:
                m.graph_captures += 1
                m.capture_ms += prog.capture_ms
        m.graph_replays += prog.graph is not None
        return prog.run()


def _body(plan: ArenaPlan, cols_list):
    from .engine import fold_partials, shard_partials

    lowering, strategy = plan.lowering, plan.strategy

    def body():
        state = None
        for cols in cols_list:  # canonical segment order: the fold order
            state = fold_partials(lowering.la, state, shard_partials(lowering, cols, strategy))
        return state

    return body


def build_arena_program(engine, plan: ArenaPlan, cols_list, pool=None) -> ArenaProgram:
    """The program over resident columns (`cols_list`, one dict per segment
    in canonical order): on a card the body captured into a CUDA graph on
    the engine's capture stream (into the memory pool `pool`, a private one
    when None), after the compute stream's pending work and one warm-up run
    of the body on that stream; on the CPU the body alone.  A capture that
    fails raises KernelError (the `compile` fault site fires first)."""
    body = _body(plan, cols_list)
    graph, out, launches, ms = _build(engine, body, pool, "arena")
    if graph is None:
        return ArenaProgram(plan, cols_list, body)
    return ArenaProgram(plan, cols_list, body, graph, out[:3], launches, ms)


def _build(engine, body, pool, family: str):
    """(graph, outputs, launches, capture ms) of `body`: captured on a card
    (`_capture`), (None, None, (), 0.0) on the CPU."""
    fire("compile")
    if engine.device.type != "cuda":
        return None, None, (), 0.0
    try:
        with span(SPAN_ARENA_BUILD, family=family):
            graph, out, launches, ms = _capture(engine, body, pool)
    except KernelError:
        raise
    except RuntimeError as err:
        if isinstance(err, torch.cuda.OutOfMemoryError):
            raise  # transient: the retry evicts and captures again
        raise KernelError(f"CUDA graph capture failed: {err}") from err
    prof.note_compile(ms, family)
    return graph, out, launches, ms


_gc_lock = threading.Lock()
_gc_pauses = [0, True]  # captures in progress, and whether the collector ran before


@contextlib.contextmanager
def _gc_paused():
    """The cyclic garbage collector off while any thread captures: a
    collection inside a capture that frees a CUDA graph (a program left in
    a reference cycle) voids the capture, in either capture mode."""
    with _gc_lock:
        if _gc_pauses[0] == 0:
            _gc_pauses[1] = gc.isenabled()
            gc.disable()
        _gc_pauses[0] += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_pauses[0] -= 1
            if _gc_pauses[0] == 0 and _gc_pauses[1]:
                gc.enable()


def _capture(engine, body, pool):
    dev = engine.device
    t0 = time.perf_counter()
    stream = engine._capture_stream()
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        # the warm-up, on the stream that captures: whatever the body does
        # once (a DeviceConst's host copy, the kernel's attribute call, a
        # new allocator block) happens here, outside the capture.  The
        # scope's first, eager run cannot stand in for it: the lowering
        # cache may have rebuilt the lowering since, with no device copy
        # of its constants yet
        body()
    graph = torch.cuda.CUDAGraph()
    with cuda_groupby.capture_launches() as launches, torch.cuda.stream(stream), _gc_paused():
        # thread-local mode: another thread's CUDA call (a pinned or device
        # allocation, an event query, a synchronous copy) cannot void this
        # capture, as in the global mode it could; no other thread enqueues
        # work on the capture stream (it is this engine's, used under its
        # execution lock), and the port never synchronizes the whole device
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = body()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the capture is void either way; the body's error stands
            raise
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(stream)
    return graph, out, launches, (time.perf_counter() - t0) * 1e3


# -- fused micro-batches --------------------------------------------------------


class FusedPlan:
    """A fused batch the arena covers: its key (also the key its warm mark
    lives under), the members' lowerings, strategies, inner GroupBys and
    in-scope segments, the union of their segments in canonical order and
    the columns read."""

    __slots__ = ("key", "scope_key", "chunked", "lowerings", "strategies", "member_segs",
                 "inners", "segs", "names", "col_keys", "nbytes")

    def __init__(self, key, lowerings, strategies, member_segs, inners, segs, names,
                 col_keys, nbytes):
        self.key = self.scope_key = key
        self.chunked = False
        self.lowerings = list(lowerings)
        self.strategies = tuple(strategies)
        self.member_segs = [list(m) for m in member_segs]
        self.inners = list(inners)
        self.segs = list(segs)
        self.names = list(names)
        self.col_keys = tuple(col_keys)
        self.nbytes = int(nbytes)


def fused_plan_for(engine, lowerings, strategies, member_segs, inners, segs, names, ds,
                   m) -> Optional[FusedPlan]:
    """The arena's plan for a fused batch over `segs` (the union of the
    members' non-empty scopes), or None after recording why it declines in
    `m.declines` (the batch then runs the fused eager loop)."""
    reason = None
    if not engine.arena_execution:
        reason = "arena: arena_execution is off"
    elif query_disabled():
        reason = "arena: disabled for this query"
    elif any(lw.la.sketch_aggs for lw in lowerings):
        reason = "arena: sketch aggregations are not captured"
    elif "segment" in strategies:
        reason = "arena: the scatter strategy's nonzero has a data-dependent size"
    elif not segs:
        reason = "arena: no segment in the batch's scopes"
    keys = (*names, None)
    nbytes = 0
    if reason is None:
        nbytes = sum(int((s.valid if n is None else s.column(n)).nbytes)
                     for s in segs for n in keys)
        budget = int(engine._device_cache.budget_bytes * ARENA_BUDGET_FRACTION)
        if nbytes > budget:
            reason = (f"arena: the batch's {nbytes} bytes exceed {ARENA_BUDGET_FRACTION} "
                      f"of the residency budget ({budget})")
    if reason is not None:
        m.declines.append(reason)
        return None
    key = fused_key([_query_key(lw.query, ds) for lw in lowerings], strategies,
                    [[s.uid for s in ms] for ms in member_segs])
    col_keys = [column_key(s, n) for s in segs for n in keys]
    return FusedPlan(key, lowerings, strategies, member_segs, inners, segs, names, col_keys,
                     nbytes)


def fused_body(plan, cols_by_uid, device):
    """The fused batch's body: the union segments in canonical order, each
    member that scopes a segment folding its partials there (members
    sharing a mask or group ids reuse the first's, per segment), then every
    member's (sums, mins, maxs) packed into one flat float32 buffer, in
    member order.  Each member's fold runs the serial loop's ops in the
    serial loop's order, so its bits are its serial answer's."""
    from ..serve.fusion import shared_row_plan
    from .engine import fold_partials, shard_partials

    in_scope = [frozenset(s.uid for s in ms) for ms in plan.member_segs]
    share = shared_row_plan(plan.inners)

    def body():
        acc = [None] * len(plan.lowerings)
        for seg in plan.segs:  # canonical segment order: every member's fold order
            cols = cols_by_uid[seg.uid]
            memo: Dict = {}
            for i, lw in enumerate(plan.lowerings):
                if seg.uid not in in_scope[i]:
                    continue
                part = shard_partials(lw, cols, plan.strategies[i], memo=memo,
                                      share=share[i])
                acc[i] = fold_partials(lw.la, acc[i], part)
        parts = []
        for i, lw in enumerate(plan.lowerings):
            st = acc[i] if acc[i] is not None else empty_partials(lw.la, lw.num_groups, device)
            parts.extend(t.reshape(-1) for t in st[:3])
        return torch.cat(parts)

    return body


class FusedProgram:
    """A fused batch's captured program: the graph and its packed output on
    a card, the body alone on the CPU; the columns it reads and the kernel
    launches it captured."""

    __slots__ = ("plan", "cols", "body", "graph", "output", "launches", "capture_ms")

    def __init__(self, plan, cols, body, graph=None, output=None, launches=(),
                 capture_ms=0.0):
        self.plan = plan
        self.cols = cols  # keeps the captured columns alive
        self.body = body
        self.graph = graph
        self.output = output
        self.launches = tuple(launches)
        self.capture_ms = capture_ms

    def run(self) -> torch.Tensor:
        """The packed states: a replay, its launches counted; on the CPU,
        the body.  A replay's output is the graph's own buffer, which the
        next replay overwrites: the caller copies it to the host before it
        releases the engine's execution lock."""
        if self.graph is None:
            return self.body()
        self.graph.replay()
        cuda_groupby.count_replay(self.launches)
        return self.output


def build_fused_program(engine, plan: FusedPlan, cols_by_uid) -> FusedProgram:
    """The fused batch's program over resident columns: captured on a card
    as `build_arena_program` captures a scope; a failed capture raises
    KernelError."""
    body = fused_body(plan, cols_by_uid, engine.device)
    graph, out, launches, ms = _build(engine, body, None, "arena-fused")
    if graph is None:
        return FusedProgram(plan, cols_by_uid, body)
    return FusedProgram(plan, cols_by_uid, body, graph, out, launches, ms)


class ArenaCache:
    """The engine's programs (count-bounded LRU), the scopes that ran
    eagerly once and capture on their next execution (warm marks, bounded
    alike), and the index residency key -> program or warm keys that
    invalidation reads.  A key is a program or a warm mark, never both."""

    def __init__(self, entries: int = ARENA_PROGRAM_ENTRIES):
        self.entries = int(entries)
        self._programs: "OrderedDict[Tuple, ArenaProgram]" = OrderedDict()
        self._warm: "OrderedDict[Tuple, Tuple]" = OrderedDict()  # key -> col keys
        self._by_col: Dict[Tuple, Set[Tuple]] = {}
        self._lock = threading.RLock()

    def keys(self) -> List[Tuple]:
        with self._lock:
            return list(self._programs)

    def get(self, key) -> Optional[ArenaProgram]:
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                self._programs.move_to_end(key)
            return prog

    def is_warm(self, key) -> bool:
        with self._lock:
            return key in self._warm

    def scope_ran(self, plan: ArenaPlan) -> bool:
        """Has the plan's scope run before: a warm mark, or (for a chunked
        plan) the scope's whole-scope program?"""
        with self._lock:
            return plan.scope_key in self._warm or (
                plan.chunked and plan.scope_key in self._programs)

    def _unindex(self, key, col_keys) -> None:
        for ck in col_keys:
            keys = self._by_col.get(ck)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_col[ck]

    def note_warm(self, plan: ArenaPlan) -> None:
        """The scope ran eagerly: its next execution captures."""
        key = plan.scope_key
        with self._lock:
            if key in self._warm or key in self._programs:
                return
            self._warm[key] = plan.col_keys
            for ck in plan.col_keys:
                self._by_col.setdefault(ck, set()).add(key)
            while len(self._warm) > self.entries:
                self._unindex(*self._warm.popitem(last=False))

    def put(self, prog) -> None:
        """Keeps a scope's program (an ArenaProgram or a ChunkedProgram)
        in place of its warm mark; a chunked program leaves the scope's warm
        mark where it is."""
        with self._lock:
            key = prog.plan.key
            self._warm.pop(key, None)
            self._programs[key] = prog
            for ck in prog.plan.col_keys:
                self._by_col.setdefault(ck, set()).add(key)
            while len(self._programs) > self.entries:
                old_key, old = self._programs.popitem(last=False)
                self._unindex(old_key, old.plan.col_keys)

    def invalidate_uids(self, uids) -> int:
        """Drops every program and warm mark of a scope that reads a column
        of a segment in `uids` (retired segments); returns how many
        programs went."""
        with self._lock:
            return sum(self.invalidate_column(ck) for ck in
                       [ck for ck in self._by_col if ck[0] in uids])

    def invalidate_column(self, col_key) -> int:
        """Drops every program and warm mark of a scope that reads
        `col_key`; returns how many programs went."""
        with self._lock:
            keys = self._by_col.pop(col_key, ())
            dropped = 0
            for key in keys:
                prog = self._programs.pop(key, None)
                col_keys = prog.plan.col_keys if prog is not None else self._warm.pop(key)
                dropped += prog is not None
                self._unindex(key, col_keys)
            return dropped

    def invalidate_query(self, query_key) -> int:
        """Drops every program and warm mark of one query's scopes (its
        compacted lowerings' too: they keep the query's key) and of every
        fused batch it is a member of; returns how many programs went."""

        def hit(k):
            return k[1] == query_key or (k[0] == "arena-fused" and query_key in k[1])

        with self._lock:
            dropped = 0
            for key in [k for k in self._programs if hit(k)]:
                prog = self._programs.pop(key)
                self._unindex(key, prog.plan.col_keys)
                dropped += 1
            for key in [k for k in self._warm if hit(k)]:
                self._unindex(key, self._warm.pop(key))
            return dropped

    def clear(self) -> None:
        with self._lock:
            self._programs.clear()
            self._warm.clear()
            self._by_col.clear()


def run_plan(engine, ds, plan: ArenaPlan, m):
    """The scope's folded state from its program (`Engine._arena_program`),
    or None on the scope's first execution (the caller runs the eager loop,
    then `ArenaCache.note_warm`).  A whole-scope program is one replay,
    after one checkpoint (which stops it only while a partial collector
    drains) and the `device_dispatch` fault site; a chunked one replays
    segment by segment (`_run_chunks`)."""
    prog = engine._arena_program(plan, ds, m)
    if prog is None:
        return None
    if plan.chunked:
        return _run_chunks(engine, ds, plan, prog, m)
    if checkpoint_partial(SEGMENT_LOOP_SITE):
        return _empty(engine, plan)
    fire("device_dispatch")
    with span(SPAN_SEGMENT_DISPATCH, arena=len(plan.segs)), prof.device_timer(engine.device):
        state = prog.run()
    m.dispatch_count += 1
    m.arena_segments += len(plan.segs)
    m.graph_replays += prog.graph is not None
    pc = current_partial()
    if pc is not None:
        pc.add_seen(len(plan.segs), *row_counts(plan.segs))
    return state


def _empty(engine, plan: ArenaPlan):
    return empty_partials(plan.lowering.la, plan.lowering.num_groups, engine.device)


def _run_chunks(engine, ds, plan: ArenaPlan, prog: ChunkedProgram, m):
    """The chunked replays: per segment, the loop's checkpoint, the
    `device_dispatch` fault site, the segment's replay and the host-side
    fold in canonical order.  A checkpoint that stops the scope leaves the
    partials folded so far (the empty state before the first)."""
    from .engine import fold_partials

    pc = current_partial()
    la = plan.lowering.la
    state = None
    for i, seg in enumerate(plan.segs):
        if checkpoint_partial(SEGMENT_LOOP_SITE):
            break
        fire("device_dispatch")
        with span(SPAN_SEGMENT_DISPATCH, arena=1, segment=i), prof.device_timer(engine.device):
            part = prog.run_chunk(engine, ds, i, m)
        state = fold_partials(la, state, part)
        m.dispatch_count += 1
        m.arena_segments += 1
        if pc is not None:
            pc.add_seen(1, *row_counts((seg,)))
    return _empty(engine, plan) if state is None else state
