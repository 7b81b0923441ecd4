"""The broker: covered queries scatter to historicals, their states merge.

`ClusterClient` rides a normal `TPUOlapContext`: `attach()` sets
`ctx.cluster`, and the SQL and native paths (`serve/core.py`) send every
query it `covers` here.  The contract is the JAX package's:

* **Assignment.**  The rendezvous-hashed segment -> replica chain map
  (`assignment.py`) with a replication factor, its epoch bumped and its
  manifest saved on every membership change.  The broker's own delta
  segments (appended after the map was built) are residual: they run in
  this process and their state joins the merge, so a fresh append never
  waits for a rebalance.
* **Scatter.**  One RPC per replica group (`POST /druid/v2/cluster/partial`)
  on a thread pool, each attempt under `cluster_rpc_timeout_ms`, failing
  over along the chain (and `cluster_rpc_retries` walks more), hedged to
  the next replica past `cluster_hedge_ms`, behind a breaker per
  historical: an open node is skipped, not waited on.
* **Gather.**  The states merge with `Engine.merge_groupby_states` in
  assignment-chain order, never in arrival order: a failover changes who
  computed a group's state, not where it lands in the float fold, so the
  answer stays the same bits through replica changes.  A replica's state
  computed at another snapshot version than the assignment pinned is a
  failed replica, never merged.
* **Degradation.**  A failed replica fails over; a replica group that lost
  every replica marks the partial collector, so the answer ships
  coverage-stamped through the partial machinery instead of failing.  With
  partial answers off the query raises `ReplicaSetLost` (the JAX package
  answers without the lost rows, unstamped).
  Metadata and health never come here, so they serve through any breaker
  state.

Tracing: the scatter span hands its (trace, span) pair to the pool workers
(`obs.span_in`; a pool thread sees no active trace), so every attempt opens
a `cluster_rpc` span with its node, outcome and hedge.  Each request carries
`X-Druid-Query-Id` and `X-Sdol-Parent-Span`; the historical traces under the
same id and sends its rendered subtree back, which grafts under the
attempt's span, so `/druid/v2/trace/{id}` serves one tree over the cluster
and the receipt attributes time per historical.  A torn or oversized trace
degrades to an `untraced` stub, never a failed replica.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Dict, List, Optional, Tuple

from ..catalog.segment import DeltaSegment
from ..exec.metrics import QueryMetrics
from ..models import query as Q
from ..obs import (
    SPAN_CLUSTER_MERGE,
    SPAN_CLUSTER_RPC,
    SPAN_GATHER,
    SPAN_SCATTER,
    current_query_id,
    current_trace,
    record_cluster_health,
    record_cluster_rpc,
    record_query_metrics,
    span,
    span_event,
    span_in,
)
from ..obs.otlp import rpc_span_id
from ..resilience import CircuitBreaker, checkpoint, classify_error, current_partial, injector
from ..utils.log import get_logger
from .assignment import Assignment, build_assignment, load_assignment, save_assignment
from .wire import WireDecodeError, decode_state, decode_trace, trace_headers

log = get_logger("cluster.broker")

__all__ = ["ClusterClient", "ReplicaSetLost"]


class ReplicaSetLost(RuntimeError):
    """Every replica of one scatter group failed: its segments are missing
    from the answer (which is coverage-stamped, never a 500)."""


class ClusterClient:
    """The broker's half: membership, assignment, scatter and gather."""

    def __init__(self, ctx, nodes: Optional[Dict[str, str]] = None,
                 replication: Optional[int] = None):
        self.ctx = ctx
        self._lock = threading.Lock()
        self._nodes: Dict[str, str] = {k: v.rstrip("/") for k, v in (nodes or {}).items()}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._last_ok: Dict[str, float] = {}
        self.assignment: Optional[Assignment] = None
        self.last_metrics: Optional[QueryMetrics] = None
        # the constructor's replication stands until `SET cluster_replication`
        self.replication = int(replication or ctx.config.cluster_replication)
        self._cfg_replication = int(ctx.config.cluster_replication)
        self.configure(ctx.config)
        # a restarted broker continues the epoch sequence of its manifest
        self._epoch_floor = 0
        if getattr(ctx, "storage", None) is not None:
            prev = load_assignment(ctx.storage.root)
            if prev is not None:
                self._epoch_floor = prev.epoch
        self._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="sdol-scatter")
        if self._nodes:
            self.rebalance()

    def configure(self, cfg) -> None:
        """The session's seven `cluster_*` flags (`SET` reaches them through
        `TPUOlapContext.apply_config`): the timeouts, retries and hedge at
        the next attempt, the breakers' threshold and cooldown at once, and
        a changed replication by a rebalance."""
        self.rpc_timeout_s = float(cfg.cluster_rpc_timeout_ms) / 1e3
        self.retries = max(0, int(cfg.cluster_rpc_retries))
        self.hedge_s = float(cfg.cluster_hedge_ms) / 1e3
        self.scrape_timeout_s = float(cfg.cluster_scrape_timeout_ms) / 1e3
        self._breaker_failures = int(cfg.cluster_breaker_failures)
        self._breaker_cooldown_ms = float(cfg.cluster_breaker_cooldown_ms)
        with self._lock:
            for br in self._breakers.values():
                br.failure_threshold = max(1, self._breaker_failures)
                br.cooldown_ms = self._breaker_cooldown_ms
        if int(cfg.cluster_replication) != self._cfg_replication:
            self._cfg_replication = self.replication = int(cfg.cluster_replication)
            if self.assignment is not None:
                self.rebalance()

    # -- membership and assignment -------------------------------------------

    def attach(self) -> "ClusterClient":
        self.ctx.cluster = self
        return self

    def detach(self) -> None:
        if self.ctx.cluster is self:
            self.ctx.cluster = None

    def close(self) -> None:
        self.detach()
        self._pool.shutdown(wait=False)

    def nodes(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._nodes)

    def add_node(self, node_id: str, url: str) -> Assignment:
        with self._lock:
            self._nodes[node_id] = url.rstrip("/")
        return self.rebalance()

    def remove_node(self, node_id: str) -> Assignment:
        with self._lock:
            self._nodes.pop(node_id, None)
        return self.rebalance()

    def set_node_url(self, node_id: str, url: str) -> None:
        """The same member at a new address (a restarted node on a new
        port): no epoch bump, the map keys on node ids."""
        with self._lock:
            if node_id not in self._nodes:
                raise KeyError(f"unknown node {node_id!r}")
            self._nodes[node_id] = url.rstrip("/")

    def _new_breaker(self, node_id: str) -> CircuitBreaker:
        return CircuitBreaker(failure_threshold=self._breaker_failures,
                              cooldown_ms=self._breaker_cooldown_ms,
                              backend=f"historical:{node_id}")

    def _assignable(self) -> Tuple[Dict[str, List[str]], Dict[str, int]]:
        """({datasource: [segment_id, ...]} of the persisted segments, which
        every historical's boot serves; the snapshot versions the map pins).
        Delta segments stay residual: only this process has them until a
        flush."""
        seg_ids: Dict[str, List[str]] = {}
        versions: Dict[str, int] = {}
        storage = getattr(self.ctx, "storage", None)
        for name in sorted(self.ctx.catalog.tables()):
            ds = self.ctx.catalog.get(name)
            if ds is None:
                continue
            snap = storage.snapshot_version(name) if storage is not None else None
            versions[name] = int(ds.version) if snap is None else snap
            seg_ids[name] = [s.segment_id for s in ds.segments
                             if not isinstance(s, DeltaSegment)]
        return seg_ids, versions

    def rebalance(self) -> Assignment:
        """The map over the current membership and catalog at the next
        epoch (deterministic, minimal movement, its manifest saved): after
        every membership change, and when a restarted node rejoins."""
        with self._lock:
            seg_ids, versions = self._assignable()
            epoch = max(self._epoch_floor, self.assignment.epoch if self.assignment else 0) + 1
            asg = build_assignment(seg_ids, self._nodes, self.replication, epoch=epoch,
                                   versions=versions)
            self.assignment = asg
            for nid in self._nodes:
                if nid not in self._breakers:
                    self._breakers[nid] = self._new_breaker(nid)
            for nid in list(self._breakers):
                if nid not in self._nodes:
                    del self._breakers[nid]
            if getattr(self.ctx, "storage", None) is not None:
                save_assignment(self.ctx.storage.root, asg)
        log.info("assignment epoch %d: %d nodes, %d segments, replication %d",
                 asg.epoch, len(asg.nodes), len(asg.segment_map), asg.replication)
        self._publish_health()
        return asg

    def _breaker(self, node_id: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(node_id)
            if br is None:
                br = self._breakers[node_id] = self._new_breaker(node_id)
            return br

    # -- health ----------------------------------------------------------------

    def _live_nodes(self) -> List[str]:
        with self._lock:
            ids = list(self._nodes)
        return [n for n in ids if self._breaker(n).state != "open"]

    def state(self) -> dict:
        """The /status/health cluster section: each historical's liveness
        (breaker and last successful contact), the assignment epoch and the
        replication deficit."""
        asg = self.assignment
        live = self._live_nodes()
        under, lost = asg.deficit(live) if asg else (0, 0)
        with self._lock:
            nodes = {
                nid: {
                    "url": url,
                    "live": nid in live,
                    "breaker": self._breakers[nid].to_dict() if nid in self._breakers else None,
                    "last_ok_ms_ago": (round((time.monotonic() - self._last_ok[nid]) * 1e3)
                                       if nid in self._last_ok else None),
                    "assigned_segments": len(asg.segments_for(nid)) if asg else 0,
                }
                for nid, url in sorted(self._nodes.items())
            }
        doc = {
            "nodes": nodes,
            "live": len(live),
            "epoch": asg.epoch if asg else 0,
            "replication": self.replication,
            "replication_deficit": under,
            "segments_lost": lost,
        }
        self._publish_health(live=len(live), under=under, lost=lost)
        return doc

    def _publish_health(self, live=None, under=None, lost=None) -> None:
        asg = self.assignment
        if live is None or under is None or lost is None:
            lv = self._live_nodes()
            live = len(lv)
            under, lost = asg.deficit(lv) if asg else (0, 0)
        record_cluster_health(live=live, total=len(self.nodes()),
                              epoch=asg.epoch if asg else 0, deficit=under, lost=lost)

    # -- federated observability -----------------------------------------------

    def federated_metrics(self) -> str:
        """The `/status/metrics?cluster=1` body: every historical's text
        node-labelled and merged with the broker's own (`node="broker"`);
        an unreachable node is absent and stamped stale."""
        from ..obs import get_registry
        from .federation import merge_prometheus, scrape_nodes

        sections: Dict[str, Optional[str]] = dict(
            scrape_nodes(self.nodes(), "/status/metrics", self.scrape_timeout_s, pool=self._pool))
        sections["broker"] = get_registry().render_prometheus()
        return merge_prometheus(sections)

    def federated_profile(self, local_doc: Optional[dict] = None) -> dict:
        """The `/status/profile?cluster=1` document: the broker's profile and
        every historical's under its node id; an unreachable node is
        {"stale": true} and listed in `stale`."""
        from .federation import scrape_nodes_json

        docs = scrape_nodes_json(self.nodes(), "/status/profile", self.scrape_timeout_s,
                                 pool=self._pool)
        return {
            "cluster": True,
            "broker": local_doc or {},
            "nodes": {nid: (doc if doc is not None else {"stale": True})
                      for nid, doc in docs.items()},
            "stale": sorted(nid for nid, doc in docs.items() if doc is None),
        }

    # -- coverage --------------------------------------------------------------

    def covers(self, q, ds) -> bool:
        """Does the broker scatter this query?  The GroupBy family with a
        mergeable dense state (the engine's fusion gate), no wire subtotals,
        no time-bucketed dimension, and a historical to send it to.
        Anything else (metadata, the sparse and adaptive tiers' shapes,
        grouping sets, DATE_TRUNC groups) runs locally."""
        if not self._nodes or self.assignment is None:
            return False
        if not isinstance(q, (Q.GroupByQuery, Q.TimeseriesQuery, Q.TopNQuery)):
            return False
        if isinstance(q, Q.GroupByQuery) and q.subtotals:
            return False
        dims = (q.dimension,) if isinstance(q, Q.TopNQuery) else getattr(q, "dimensions", ())
        if any(d.granularity for d in dims):
            # a time-bucketed dimension (SQL's DATE_TRUNC) has no wire form: a
            # historical would decode one bucket, and every state would fail
            # the merge
            return False
        try:
            return bool(self.ctx.engine.fusable(q, ds))
        except Exception:  # a query the gate cannot lower stays local
            return False

    # -- scatter ---------------------------------------------------------------

    def _rpc(self, url: str, payload: bytes, headers: Optional[Dict[str, str]] = None) -> dict:
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        req = urllib.request.Request(url + "/druid/v2/cluster/partial", data=payload,
                                     headers=hdrs, method="POST")
        with urllib.request.urlopen(req, timeout=self.rpc_timeout_s) as resp:
            raw = resp.read()
        # fault site: partial mode truncates the body the broker reads, as
        # a connection dying mid-transfer; the strict decode fails over
        frac = injector().partial_fraction("cluster.torn_response")
        if frac is not None:
            raw = raw[: int(len(raw) * frac)]
        try:
            return json.loads(raw)
        except ValueError as e:
            raise WireDecodeError(f"torn response body: {e}") from e

    def _attempt(self, node: str, payload: bytes, expect_version: int, attempts: list,
                 trace=None, parent=None, qid: str = "", hedge: bool = False) -> dict:
        """One replica attempt: the breaker, the RPC, the strict decode and
        the version check, under its own `cluster_rpc` span on the trace
        handle it was given.  A good answer's subtree grafts under the span;
        a failure leaves an error span.  Appends (node, ms, outcome) to
        `attempts`; raises on any failure."""
        seq = len(attempts)
        span_otlp = rpc_span_id(qid, node, seq)
        with span_in(trace, parent, SPAN_CLUSTER_RPC, node=node, attempt=seq, hedge=hedge,
                     otlp_span_id=span_otlp) as s:
            br = self._breaker(node)
            if not br.allow():
                attempts.append((node, 0.0, "breaker_open"))
                record_cluster_rpc(node, "breaker_open")
                if s is not None:
                    s.attrs.update(outcome="breaker_open", error=True)
                raise ReplicaSetLost(f"breaker open for {node}")
            url = self.nodes().get(node)
            if url is None:
                attempts.append((node, 0.0, "removed"))
                if s is not None:
                    s.attrs.update(outcome="removed", error=True)
                raise ReplicaSetLost(f"node {node} left the membership")
            t0 = time.perf_counter()
            try:
                # fault site: an error is a refused or timed-out connection,
                # a delay a slow network path
                checkpoint("cluster.rpc")
                doc = self._rpc(url, payload, headers=trace_headers(qid, span_otlp))
                ver = int(doc.get("version", -1))
                if expect_version and ver != expect_version:
                    raise WireDecodeError(f"version skew: replica at {ver}, assignment epoch "
                                          f"expects {expect_version}")
                state = decode_state(doc.get("state"))
            except Exception as e:
                ms = (time.perf_counter() - t0) * 1e3
                br.record_failure()
                outcome = type(e).__name__
                attempts.append((node, ms, outcome))
                record_cluster_rpc(node, classify_error(e), ms,
                                   query_id=current_query_id() or qid, failover=True)
                if s is not None:
                    s.attrs.update(outcome=outcome, ms=round(ms, 3), error=True)
                raise
            ms = (time.perf_counter() - t0) * 1e3
            br.record_success()
            with self._lock:
                self._last_ok[node] = time.monotonic()
            record_cluster_rpc(node, "ok", ms, query_id=current_query_id() or qid)
            segments = list(doc.get("segments") or ())
            if s is not None and trace is not None:
                s.attrs.update(outcome="ok", ms=round(ms, 3), segments=len(segments))
                graft = decode_trace(doc.get("trace"), node)
                if graft.get("attrs", {}).get("untraced") and isinstance(doc.get("receipt"), dict):
                    # a receipt shipped beside a torn trace keeps the node's
                    # attribution
                    graft["receipt"] = doc["receipt"]
                trace.graft(s, graft)
            return {"node": node, "ms": ms, "version": ver, "state": state,
                    "rows": int(doc.get("rows", 0)), "segments": segments,
                    "receipt": doc.get("receipt")}

    def _fetch_group(self, chain: Tuple[str, ...], payload: bytes, expect_version: int,
                     trace=None, parent=None, qid: str = "") -> dict:
        """One replica group's state, on a pool thread: the chain walked
        with failover (and `cluster_rpc_retries` walks more), the primary
        hedged past `cluster_hedge_ms`."""
        attempts: list = []
        if self.hedge_s > 0 and len(chain) > 1:
            r = self._fetch_hedged(chain, payload, expect_version, attempts, trace=trace,
                                   parent=parent, qid=qid)
            if r is not None:
                r["attempts"] = attempts
                return r
            walk = list(chain[2:]) + list(chain) * self.retries
        else:
            walk = list(chain) * (1 + self.retries)
        last: Optional[Exception] = None
        for node in walk:
            # fault site and deadline check before every attempt
            checkpoint("cluster.scatter")
            try:
                r = self._attempt(node, payload, expect_version, attempts, trace=trace,
                                  parent=parent, qid=qid)
                r["attempts"] = attempts
                return r
            except Exception as e:
                last = e
        raise ReplicaSetLost(
            f"every replica of chain {chain} failed: {[a[2] for a in attempts]}") from last

    def _fetch_hedged(self, chain, payload, expect_version, attempts, trace=None, parent=None,
                      qid: str = ""):
        """The first of two: the primary at once, the secondary after
        `cluster_hedge_ms` without an answer, the first success taken.
        None when both fail (the caller walks the rest of the chain)."""
        import queue as queue_mod

        results: "queue_mod.Queue" = queue_mod.Queue()

        def run(node, hedged):
            try:
                results.put(("ok", self._attempt(node, payload, expect_version, attempts,
                                                 trace=trace, parent=parent, qid=qid,
                                                 hedge=hedged)))
            except Exception as e:  # collected; the caller walks on
                results.put(("err", e))

        threading.Thread(target=run, args=(chain[0], False), daemon=True).start()
        launched = 1
        try:
            kind, val = results.get(timeout=self.hedge_s)
        except queue_mod.Empty:
            record_cluster_rpc(chain[0], "hedged", hedged=True)
            threading.Thread(target=run, args=(chain[1], True), daemon=True).start()
            launched = 2
            kind, val = results.get(timeout=self.rpc_timeout_s * 2 + 1)
        got = 1
        while kind != "ok" and got < launched:
            kind, val = results.get(timeout=self.rpc_timeout_s * 2 + 1)
            got += 1
        return val if kind == "ok" else None

    # -- execute: scatter, gather, finalize ------------------------------------

    def execute(self, q, ds):
        """One covered query through the cluster: the assigned segments
        scatter to their chains, the residual ones (deltas, and anything
        the assignment predates) run here, every state merges in chain
        order, and the merged state finalizes as a local execution's."""
        from ..exec.engine import segments_in_scope

        t0 = time.perf_counter()
        engine = self.ctx.engine
        asg = self.assignment
        segs = segments_in_scope(q, ds)
        groups: Dict[Tuple[str, ...], list] = {}
        residual: list = []
        for s in segs:
            chain = asg.replicas(s.segment_id) if asg is not None else ()
            if chain:
                groups.setdefault(chain, []).append(s)
            else:
                residual.append(s)
        expect_version = int(asg.versions.get(ds.name, 0)) if asg else 0

        # the residual first: the engine's partial accounting begins the pass
        # (begin_pass resets the collector), so the scattered scope is added
        # after it
        state, m_local = engine.groupby_partials_host(
            q, ds, within_uids=frozenset(s.uid for s in residual))
        pc = current_partial()
        if pc is not None and groups:
            pc.add_scope(sum(len(g) for g in groups.values()),
                         *_group_rows([s for g in groups.values() for s in g]))

        qdoc = q.to_druid()
        qid = current_query_id() or ""

        def _payload(g):
            # the group's own segment ids: two groups never overlap, so the
            # merge never counts a row twice
            return json.dumps({
                "query": qdoc,
                "segments": [s.segment_id for s in g],
                "version": expect_version or None,
                "context": {"queryId": qid},
            }).encode()

        results: list = []
        lost: list = []
        tr = current_trace()
        with span(SPAN_SCATTER, groups=len(groups), nodes=len(self.nodes())) as scatter_span:
            futs = {
                self._pool.submit(self._fetch_group, chain, _payload(g), expect_version, tr,
                                  scatter_span, qid): (chain, g)
                for chain, g in sorted(groups.items())
            }
            for fut in as_completed(futs):
                chain, g = futs[fut]
                try:
                    r = fut.result()
                except Exception as e:
                    lost.append((chain, g, e))
                    span_event("rpc", node="|".join(chain), ms=0.0, outcome="lost",
                               segments=len(g))
                    continue
                results.append((chain, r, g))

        gathered_rows = 0
        with span(SPAN_GATHER, groups=len(results), lost=len(lost)):
            # chain order, never arrival order: see the module docstring
            for chain, r, g in sorted(results, key=lambda t: t[0]):
                checkpoint("cluster.gather")
                if expect_version and int(r["version"]) != expect_version:
                    lost.append((chain, g, ReplicaSetLost("version skew at gather")))
                    continue
                try:
                    with span(SPAN_CLUSTER_MERGE):
                        state = engine.merge_groupby_states(q, ds, state, r["state"])
                except ValueError as e:
                    # the dictionary domain drifted: a lost group, never a bad merge
                    lost.append((("merge",), g, e))
                    continue
                gathered_rows += int(r["rows"])
                if pc is not None:
                    pc.add_seen(len(g), *_group_rows(g))

        if lost:
            for chain, g, e in lost:
                log.warning("replica group %s lost (%d segments): %s", chain, len(g), e)
            if pc is None:
                # no partial answer was asked for: an answer missing the
                # lost groups' rows would pass for the whole one
                raise ReplicaSetLost(f"{len(lost)} replica groups lost and partial results "
                                     "are off") from lost[0][2]
            # the answer degrades to a stamped partial; coverage already
            # leaves the lost rows out
            pc.trigger("cluster.scatter")

        df = engine.finalize_groupby_state(q, ds, state)
        m = QueryMetrics(
            query_type=type(q).__name__,
            strategy="cluster",
            datasource=ds.name,
            device=str(engine.device),
            query_id=current_query_id() or "",
            executor="cluster",
            distributed=True,
            rows_scanned=int(m_local.rows_scanned) + gathered_rows,
            segments=len(segs),
            total_ms=(time.perf_counter() - t0) * 1e3,
        )
        if pc is not None and pc.is_partial:
            m.partial = True
            m.coverage = pc.coverage()
        self.last_metrics = m
        record_query_metrics(m, outcome="partial" if m.partial else "ok")
        return df


def _group_rows(g) -> Tuple[int, int]:
    """(rows, delta rows) of a list of segments."""
    return (sum(s.num_rows for s in g),
            sum(s.num_rows for s in g if isinstance(s, DeltaSegment)))
