"""Micro-batch query fusion: one device execution for concurrent
compatible queries.

At dashboard scale the workload is many small concurrent queries over the
same hot datasource, and each pays its own dispatch: a graph replay, a
fetch, the host's issue of both.  Fusion amortizes that across queries:

  * The first query to arrive for a (datasource, segment-set signature)
    becomes the batch's leader: it holds the batch open for
    `SessionConfig.fusion_window_ms`, collecting compatible queries
    (GroupBy-family, same signature) up to `fusion_max_batch`.
  * The leader runs the whole batch as one fused execution
    (`Engine.execute_fused`): a member set's first batch as the fused
    eager loop (each segment's columns read once for every member), its
    second captures one CUDA graph of every member's segment loop over
    the resident segments, and later batches of the set replay it; one
    host fetch returns every member's state.
  * Results demultiplex per member: each waiter receives its own
    finalized frame and QueryMetrics stamped with its own query_id and the
    batch size (`fused_batch`).

Compatibility is the segment-set signature (`lowering.schema_signature`:
name, dictionary content, segment uids).  A re-registration between
enqueue and dispatch changes it; the leader sees the mismatch at dispatch
and invalidates the batch: every member runs alone on its own thread,
against the current snapshot and under its own deadline and partial
scopes.  A batch of one (no concurrency inside the window) also goes back
to the member's serial path: there is nothing to amortize.  A deadline
that expires in the fused execution, or a transient failure, sends every
member back to its serial path, which owns retries and partial answers
per query, as does an error of one member's query; a fault of the card or
the kernel (`resilience.device_fault`: a kernel or a graph capture that
fails, a sticky CUDA error) is raised to every member, never rerouted.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from collections import deque

from ..obs import SPAN_FUSED_BATCH, current_query_id, prof, span, span_event
from ..resilience import device_fault
from ..utils.log import get_logger

log = get_logger("serve.fusion")

# a member blocked on its batch leader must never hang the request
# thread forever if the leader dies mid-delivery; past this it falls
# back to its own serial execution
_MEMBER_WAIT_S = 300.0


def shared_row_plan(inners) -> tuple:
    """Common subexpressions of a fused batch's member lowerings.

    Dashboard members of one batch often share the row pipeline's
    expensive prefixes: the filter mask (intervals and filter over the
    same virtual columns) and the group-id pipeline (the same dimensions
    and granularity).  Returns one `(mask_group, gid_group)` pair per
    member, each the index of the first member with an identical
    sub-lowering signature: inside the fused execution, later members
    reuse that member's mask or gid of each segment
    (`GroupByLowering.row_arrays(cols, mask=, gid=)`).  Signatures come
    from the canonical wire JSON of the inner GroupBy, so two members
    share a group only when the subexpression is value-identical."""
    import json as _json

    def _sig(val):
        return _json.dumps(val, sort_keys=True, default=str)

    mask_groups: Dict[tuple, int] = {}
    gid_groups: Dict[tuple, int] = {}
    plan = []
    for i, q in enumerate(inners):
        d = q.to_druid()
        vsig = _sig(d.get("virtualColumns") or [])
        isig = _sig(d.get("intervals"))
        msig = (vsig, _sig(d.get("filter")), isig)
        # intervals belong in the gid signature too: a time-bucketed
        # dimension's codes close over the query's interval span (bucket
        # origin and cardinality), so equal dimensions over shifted
        # intervals compute different gids
        gsig = (
            vsig,
            _sig(d.get("dimensions") or []),
            _sig(d.get("granularity")),
            isig,
        )
        plan.append(
            (
                mask_groups.setdefault(msig, i),
                gid_groups.setdefault(gsig, i),
            )
        )
    return tuple(plan)


# delivery verdicts
_OK = "ok"
_RETRY = "retry"  # re-execute individually on the member's own thread
_ERROR = "error"  # raise the batch's static error on the member's thread


class _Member:
    __slots__ = ("query", "query_id", "strategy", "event", "verdict", "payload")

    def __init__(self, query, query_id: str, strategy=None):
        self.query = query
        self.query_id = query_id
        self.strategy = strategy  # the member's own plan (None: the engine's)
        self.event = threading.Event()
        self.verdict: Optional[str] = None
        self.payload = None

    def deliver(self, verdict: str, payload=None) -> None:
        self.verdict = verdict
        self.payload = payload
        self.event.set()


class _Batch:
    __slots__ = ("batch_id", "signature", "members", "closed", "engine")

    def __init__(self, batch_id: int, signature, engine=None):
        self.batch_id = batch_id
        self.signature = signature
        self.members: List[_Member] = []
        self.closed = False
        # the executing engine (None: the context's own); the signature
        # carries its backend label ("device" or "mesh"), so a mesh-routed
        # query and a single-device one never share a batch
        self.engine = engine


class FusionScheduler:
    """Leader-based micro-batcher over one context's engine.

    `execute` returns `(df, state, metrics)` when the query ran fused, or
    None when the caller must run it on its serial path (fusion disabled,
    a batch of one, a batch invalidated by a re-registration, a deadline,
    a transient failure or a query error in the fused execution); it
    raises a device fault of the fused execution."""

    def __init__(
        self,
        window_ms: float = 0.0,
        max_batch: int = 16,
        adaptive: bool = False,
        max_window_ms: float = 0.0,
    ):
        self.window_ms = float(window_ms)
        self.max_batch = max(2, int(max_batch))
        # adaptive window: armed from the observed arrival rate; an idle
        # queue pays no wait (the static window taxes every solo query the
        # full window for nothing), a burst holds up to max_window_ms so
        # more members share the dispatch.  The decision is a
        # `fusion_window` span event on the leader's trace.
        self.adaptive = bool(adaptive)
        self.max_window_ms = (
            float(max_window_ms) if max_window_ms else 4.0 * float(window_ms)
        )
        self._arrivals: deque = deque(maxlen=64)
        self.window_decisions: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._open: Dict[Tuple, _Batch] = {}
        self._ids = itertools.count(1)
        # observability: fused batches executed / member outcomes
        self.batches_fused = 0
        self.members_fused = 0
        self.invalidated = 0

    @property
    def enabled(self) -> bool:
        return self.window_ms > 0

    def _decide_window_ms(self, now: float) -> Tuple[float, str, int]:
        """(window_ms, mode, recent_arrivals) for a leader arriving at
        `now` — BEFORE its own arrival is recorded, so the decision
        reads only the queue's recent history.  idle: no arrival within
        8 windows -> no wait; burst: >=3 arrivals within 2 windows ->
        hold up to max_window_ms; base: the configured window."""
        if not self.adaptive:
            return self.window_ms, "static", 0
        horizon = 8.0 * self.window_ms / 1e3
        burst_horizon = 2.0 * self.window_ms / 1e3
        with self._lock:
            recent = [t for t in self._arrivals if now - t <= horizon]
        if not recent:
            return 0.0, "idle", 0
        burst = sum(1 for t in recent if now - t <= burst_horizon)
        if burst >= 3:
            return (
                min(self.max_window_ms, 2.0 * self.window_ms),
                "burst",
                len(recent),
            )
        return self.window_ms, "base", len(recent)

    def _note_arrival(self, now: float) -> None:
        with self._lock:
            self._arrivals.append(now)

    def configure(self, window_ms: float, max_batch: int, adaptive: bool,
                  max_window_ms: float) -> None:
        """`SET` on a fusion flag: later batches use the new settings."""
        with self._lock:
            self.window_ms = float(window_ms)
            self.max_batch = max(2, int(max_batch))
            self.adaptive = bool(adaptive)
            self.max_window_ms = (
                float(max_window_ms) if max_window_ms else 4.0 * float(window_ms)
            )

    def execute(self, ctx, q, ds, engine=None, strategy=None):
        """Join (or lead) the micro-batch for `q` over the `ds` snapshot.
        Returns (df, state, metrics) or None (the serial path); raises
        the fused execution's device fault.  `engine` is the executing
        engine (None: ctx.engine); `strategy` the member's own (its plan's
        class; None: the engine's), which it keeps inside the batch."""
        if not self.enabled:
            return None
        from ..exec.lowering import schema_signature

        if engine is None or engine is ctx.engine:
            engine, backend = None, "device"
        else:
            backend = "mesh"
        now = time.monotonic()
        window_ms, mode, n_recent = self._decide_window_ms(now)
        self._note_arrival(now)
        sig = (ds.name, backend, schema_signature(ds))
        me = _Member(q, current_query_id(), strategy)
        with self._lock:
            batch = self._open.get(sig)
            if (
                batch is None
                or batch.closed
                or len(batch.members) >= self.max_batch
            ):
                batch = _Batch(next(self._ids), sig, engine=engine)
                self._open[sig] = batch
                leader = True
            else:
                leader = False
            batch.members.append(me)
        if leader:
            # the arrival-rate decision: the span event says what the
            # scheduler chose and why ("why did my solo query not wait")
            with self._lock:
                self.window_decisions[mode] = (
                    self.window_decisions.get(mode, 0) + 1
                )
            span_event(
                "fusion_window",
                window_ms=round(window_ms, 3),
                mode=mode,
                recent_arrivals=n_recent,
            )
            self._lead(ctx, batch, ds, window_ms=window_ms)
        else:
            if not me.event.wait(_MEMBER_WAIT_S):
                log.warning(
                    "fused-batch member timed out waiting for its "
                    "leader; executing serially"
                )
                return None
        if me.verdict == _ERROR:
            raise me.payload
        if me.verdict != _OK:
            return None
        df, state, m = me.payload
        # receipt attribution: every member's scope records the batch
        # size it rode (the leader's was stamped inside execute_fused)
        prof.note_fusion(len(batch.members))
        if not leader:
            # a non-leader member's trace records that this query rode a
            # fused batch (the leader's trace holds the fused_batch span
            # around the execution itself); the batch id and the member
            # query ids link the traces
            with span(
                SPAN_FUSED_BATCH,
                batch=batch.batch_id,
                members=len(batch.members),
            ):
                span_event(
                    "fused_members",
                    query_ids=",".join(
                        x.query_id for x in batch.members
                    ),
                )
        return df, state, m

    def _lead(self, ctx, batch: _Batch, ds, window_ms: Optional[float] = None) -> None:
        """Leader protocol: hold the window open (the adaptive decision
        when one was made), close the batch, and either run it fused or
        invalidate it (every member then runs alone on its own thread)."""
        from ..exec.lowering import schema_signature

        hold_ms = self.window_ms if window_ms is None else window_ms
        if hold_ms > 0:
            time.sleep(hold_ms / 1e3)
        engine = batch.engine or ctx.engine
        with self._lock:
            batch.closed = True
            if self._open.get(batch.signature) is batch:
                del self._open[batch.signature]
            members = list(batch.members)
        # canonical member order: thread arrival order varies per wave,
        # and the fused graph is keyed on the member sequence; an
        # order-sensitive key would capture the same dashboard set again
        # for every permutation (members are independent, so order is free)
        import json as _json

        members.sort(
            key=lambda m: (_json.dumps(
                m.query.to_druid(), sort_keys=True, default=str
            ), str(m.strategy))
        )
        try:
            if len(members) == 1:
                # nothing joined: fusing would only add demux work; the
                # member runs its serial path
                members[0].deliver(_RETRY)
                return
            current = ctx.catalog.get(ds.name)
            if current is None or (
                (ds.name, batch.signature[1], schema_signature(current))
                != batch.signature
            ):
                # a re-registration published a new segment set between
                # enqueue and dispatch: the batch's snapshot is stale, so
                # each member runs alone against the current one, under
                # its own scopes
                with self._lock:
                    self.invalidated += 1
                log.info(
                    "fused batch %d invalidated by a new segment set on %r; "
                    "%d members run alone",
                    batch.batch_id, ds.name, len(members),
                )
                for m in members:
                    m.deliver(_RETRY)
                return
            with span(
                SPAN_FUSED_BATCH,
                batch=batch.batch_id,
                members=len(members),
            ):
                span_event(
                    "fused_members",
                    query_ids=",".join(m.query_id for m in members),
                )
                results = engine.execute_fused(
                    [m.query for m in members],
                    current,
                    query_ids=[m.query_id for m in members],
                    strategies=[m.strategy for m in members],
                )
            with self._lock:
                self.batches_fused += 1
                self.members_fused += len(members)
            for m, payload in zip(members, results):
                m.deliver(_OK, payload)
        except Exception as err:
            if device_fault(err):
                # a kernel, a capture or the card that fails is not
                # rerouted: every member raises it
                log.error("fused batch %d failed (%s: %s)", batch.batch_id,
                          type(err).__name__, err)
                for m in members:
                    if not m.event.is_set():
                        m.deliver(_ERROR, err)
            else:
                # a deadline, a transient failure or one member's query
                # error: every member runs its serial path, which owns
                # retries, breaker accounting, partial answers and error
                # taxonomy per query
                log.warning(
                    "fused batch %d failed (%s: %s); %d members run alone",
                    batch.batch_id, type(err).__name__, err, len(members),
                )
                for m in members:
                    if not m.event.is_set():
                        m.deliver(_RETRY)
        finally:
            # defensive: no member may ever be left waiting
            for m in members:
                if not m.event.is_set():
                    m.deliver(_RETRY)

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "window_ms": self.window_ms,
                "adaptive": self.adaptive,
                "max_window_ms": self.max_window_ms,
                "window_decisions": dict(self.window_decisions),
                "max_batch": self.max_batch,
                "batches_fused": self.batches_fused,
                "members_fused": self.members_fused,
                "invalidated": self.invalidated,
            }
