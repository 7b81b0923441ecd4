"""ServingCore: one context's serving machinery.

Owns the fusion scheduler, the result cache, the wire plan cache and the
lane classification of SQL text (a native query classifies from its
decoded QuerySpec; SQL from its planned rewrite, through the plan cache,
so a repeated dashboard statement pays planning once).

The api layer and the server's native route call `answer(q, ds, key,
fusable, post)` for one query's answer: the result cache (a hit at the
datasource's version, no device work; after appends, a delta refresh,
`_delta_refresh`: the cached partial state merged with the partials of the
appended segments alone), else micro-batch fusion, else the engine alone,
keeping the merged host partial state when a later delta refresh could
use it; the answer is post-processed and stored at the version of the
snapshot it was computed on.  A refresh that cannot run records why, and
the reason is appended to the metrics of the full execution that follows.
Only these deterministic declines route a query on; any error of the
refresh (the engine's, the kernel's) raises.

The degraded and partial routes ask `cached_result(rw, ds, key)` or
`cached_native(q, ds)` for a complete answer alone.  The server calls
`decode_native`, `native_key` and `lane_for_sql`, and
`serve.lanes.classify_native` to route admission through
`ResilienceState.lanes`.
"""

from __future__ import annotations

import time
from typing import Optional

from ..obs import current_query_id, get_registry, prof, record_query_metrics
from ..utils.log import get_logger
from .fusion import FusionScheduler
from .lanes import LANE_INTERACTIVE, classify_rewrite
from .result_cache import ResultCache

log = get_logger("serve.core")


class ServingCore:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg = ctx.config
        self.fusion = FusionScheduler(
            window_ms=cfg.fusion_window_ms,
            max_batch=cfg.fusion_max_batch,
            adaptive=cfg.fusion_adaptive_window,
            max_window_ms=cfg.fusion_window_max_ms,
        )
        self.result_cache = ResultCache(entries=cfg.result_cache_entries,
                                        delta_reuse=cfg.result_cache_delta_reuse)
        # the decoded-QuerySpec cache of the wire path: dashboards post the
        # identical body every refresh, so a hit skips `query_from_druid`.
        # Decoding is a pure function of the body (no catalog input), so
        # entries never need invalidation
        from ..utils.lru import CountBudgetCache

        self.wire_plan_cache = CountBudgetCache(256)

    def configure(self, config) -> None:
        """`SET` on a serving flag reaches the cache and the scheduler."""
        if self.result_cache.entries != max(int(config.result_cache_entries), 0):
            self.result_cache.resize(config.result_cache_entries)
        self.result_cache.delta_reuse = bool(config.result_cache_delta_reuse)
        self.fusion.configure(config.fusion_window_ms, config.fusion_max_batch,
                              config.fusion_adaptive_window, config.fusion_window_max_ms)

    # -- wire plan cache -------------------------------------------------------

    def decode_native(self, body: dict):
        """One native query body decoded into its QuerySpec through the
        body-hash plan cache (`sdol_plan_cache_total{outcome}`)."""
        import hashlib
        import json as _json

        from ..models.wire import query_from_druid

        ctr = get_registry().counter(
            "sdol_plan_cache_total",
            "decoded-QuerySpec plan cache on the wire path, by outcome",
            labels=("outcome",),
        )
        try:
            # the context carries per-request noise (queryId, timeout,
            # ...) that the server consumes outside the decode: strip
            # exactly those keys, so every refresh of one query hits.  The
            # rest stays in the key: skipEmptyBuckets and outputName shape
            # a decoded Timeseries, and unknown keys are kept (a miss is
            # cheap; a false hit serves the wrong spec)
            noise = ("queryId", "timeout", "progressive", "partialResults")
            qctx = body.get("context")
            canon_body = {k: v for k, v in body.items() if k != "context"}
            if isinstance(qctx, dict):
                kept = {k: v for k, v in qctx.items() if k not in noise}
                if kept:
                    canon_body["context"] = kept
            canon = _json.dumps(canon_body, sort_keys=True)
        except (TypeError, ValueError):
            ctr.labels(outcome="uncacheable").inc()
            return query_from_druid(body)
        key = hashlib.sha1(canon.encode()).digest()
        hit = self.wire_plan_cache.get(key)
        if hit is not None:
            ctr.labels(outcome="hit").inc()
            return hit
        q = query_from_druid(body)  # decode errors keep their 400 path
        self.wire_plan_cache[key] = q
        ctr.labels(outcome="miss").inc()
        return q

    # -- result cache ----------------------------------------------------------

    def cached_result(self, rw, ds, key):
        """`rw`'s complete answer from the cache at `ds`'s version (post-
        processed as stored), or None: the degraded and partial routes'
        lookup, which counts no miss (the JAX package counts none there)
        and runs no delta refresh (it would dispatch to the device they are
        avoiding, or be cut short)."""
        return self._cached(rw.query, ds, key, allow_delta=False)[0]

    def native_key(self, q, ds):
        """Result-cache key of one wire-native QuerySpec, or None when it is
        not cacheable (other query types; a wire subtotalsSpec, whose
        expansion runs through the grouping-set machinery)."""
        import json as _json

        from ..exec.lowering import _dict_signature
        from ..models import query as Q

        if not isinstance(q, (Q.GroupByQuery, Q.TimeseriesQuery, Q.TopNQuery)):
            return None
        if isinstance(q, Q.GroupByQuery) and q.subtotals:
            return None
        return (
            "native",
            _json.dumps(q.to_druid(), sort_keys=True, default=str),
            ds.name,
            _dict_signature(ds),
            repr(self.ctx.config),
        )

    def cached_native(self, q, ds):
        """The native degraded route's lookup, as `cached_result`: None on
        a miss or for an uncacheable type."""
        return self._cached(q, ds, self.native_key(q, ds), allow_delta=False)[0]

    def _cached(self, q, ds, key, allow_delta=True, post=None, strategy=None, engine=None):
        """(answer or None, the declines of its delta refresh).  A lookup
        that may refresh (`allow_delta`) counts its miss; a refresh runs
        under `strategy`, the cached run's, on `engine` (None: the
        context's)."""
        cfg = self.ctx.config
        if key is None or cfg.result_cache_entries <= 0:
            return None, []
        hit = self.result_cache.get(key, ds.version)
        if hit is not None:
            self._stamp_hit_metrics(q, ds)
            return hit, []
        declines = []
        if allow_delta and cfg.result_cache_delta_reuse:
            entry, decline = self.result_cache.reusable_entry(
                key, ds.version, (s.uid for s in ds.segments))
            if entry is not None:
                out, decline = self._delta_refresh(q, ds, key, entry, post, strategy, engine)
                if out is not None:
                    return out, []
            if decline:
                declines.append(decline)
        if allow_delta:
            self.result_cache.note_miss()
        return None, declines

    def answer(self, q, ds, key, fusable: bool, post=None, execute=None, strategy=None,
               engine=None):
        """One query's answer through the serving core.  `key` is its
        result-cache key (None: the cache is not used); `fusable` whether
        it may ride a fused micro-batch; `post` the host post-processing of
        the engine's frame; `execute` the engine call for a query that is
        neither fused nor plain (grouping sets); `strategy` the execution's
        (the plan's class; None: the engine's); `engine` the executing engine
        (None: the context's single-device one; the mesh's when the plan
        took the mesh).

        A cache hit or a delta refresh answers at once.  Otherwise the
        query runs fused, else through `execute`, else on the engine alone,
        which keeps its merged host partial state when the cache could
        refresh the entry from it after an append.  The refresh's declines
        go onto the metrics of this execution, and a complete answer is
        stored at the executed snapshot's own version (never the live
        catalog's: an append racing this write must read as a version
        mismatch); a deadline-truncated one never is (it would be served
        back as the exact answer)."""
        from ..resilience import current_partial

        cfg = self.ctx.config
        if cfg.result_cache_entries <= 0:
            key = None
        hit, declines = self._cached(q, ds, key, post=post, strategy=strategy, engine=engine)
        if hit is not None:
            return hit
        cluster = getattr(self.ctx, "cluster", None)
        if execute is None and cluster is not None and cluster.covers(q, ds):
            return self._cluster_answer(cluster, q, ds, key, post)
        engine = engine or self.ctx.engine
        state = None
        fused = (self.fused_execute(q, ds, engine=engine, strategy=strategy)
                 if fusable and self.fusion.enabled else None)
        if fused is not None:
            df, state, m = fused
            self.ctx._stamp_metrics(m)
        elif execute is not None:
            df = execute()
        elif fusable and key is not None and cfg.result_cache_delta_reuse:
            # the merged host state rides beside the answer: the next
            # append refreshes the entry by scanning its deltas alone
            with engine.state_capture() as cap:
                df = engine.execute(q, ds, strategy)
            state = cap["state"]
        else:
            df = engine.execute(q, ds, strategy)
        m = self.ctx.last_metrics
        if key is not None and m is not None:
            m.result_cache = "miss"
            m.declines.extend(declines)
        if post is not None:
            df = post(df)
        pc = current_partial()
        if pc is None or not pc.triggered:
            self.store_result(q, ds, key, df, state)
        return df

    def store_result(self, rw, ds, key, df, state=None) -> None:
        """Publish one computed answer (`rw` the rewrite or spec it answers,
        `state` its mergeable partial state or None) at the executed
        snapshot's own version, never the live catalog's: an append racing
        this write must read as a version mismatch.  No-op without a key or
        with the cache off."""
        if key is None or self.ctx.config.result_cache_entries <= 0:
            return
        self.result_cache.put(key, df, version=ds.version,
                              uids=frozenset(s.uid for s in ds.segments), state=state)

    def store_native(self, q, ds, df, state=None, key=None) -> None:
        """Publish one wire-native answer under `key` (default `native_key`),
        unless it is uncacheable or deadline-truncated (a partial frame must
        never be served back as the exact answer).  No-op with the cache off
        (its floor of one entry must not keep what a later SET would
        serve)."""
        from ..resilience import current_partial

        if self.ctx.config.result_cache_entries <= 0:
            return
        key = key if key is not None else self.native_key(q, ds)
        pc = current_partial()
        if key is None or (pc is not None and pc.triggered):
            return
        self.store_result(q, ds, key, df, state)

    def _cluster_answer(self, cluster, q, ds, key, post):
        """A broker's answer (`cluster/broker.py`): the historicals' states
        merged with the broker's own delta segments'.  The result cache
        rides the broker (a hit never scatters), fusion stays local, and
        the answer is cached as a frame alone (no local state to refresh
        from), never when it is a coverage-stamped partial."""
        from ..resilience import current_partial

        df = cluster.execute(q, ds)
        self.ctx._stamp_metrics(cluster.last_metrics)
        if post is not None:
            df = post(df)
        pc = current_partial()
        if pc is None or not pc.triggered:
            self.store_result(q, ds, key, df)
        return df

    def _delta_refresh(self, q, ds, key, entry, post=None, strategy=None, engine=None):
        """(cached partial state) merged with (the partials of the segments
        appended since): the engine scans only the segments the entry did
        not cover, the states merge, and the answer is finalized (with the
        SQL surface's host post-processing), cached at the new version and
        returned as (df, "").  Deterministic declines return (None,
        reason): a deadline cut the delta scan (a truncated state must not
        be cached as the exact answer), or the states' shapes differ.  Any
        other failure raises: a device fault is never hidden behind a full
        execution."""
        from ..catalog.segment import row_counts
        from ..resilience import current_partial

        t0 = time.perf_counter()
        engine = engine or self.ctx.engine
        fresh = [s for s in ds.segments if s.uid not in entry.uids]
        delta_state, dm = engine.groupby_partials_host(
            q, ds, within_uids=frozenset(s.uid for s in fresh), strategy=strategy)
        pc = current_partial()
        if pc is not None and pc.triggered:
            return None, "result-cache: a deadline cut the delta scan"
        if delta_state["sums"].shape != entry.state["sums"].shape:
            return None, (f"result-cache: partial states do not merge "
                          f"({entry.state['sums'].shape} vs {delta_state['sums'].shape})")
        merged = engine.merge_groupby_states(q, ds, entry.state, delta_state)
        df = engine.finalize_groupby_state(q, ds, merged)
        if post is not None:
            df = post(df)
        self.store_result(q, ds, key, df, merged)
        self.result_cache.note_delta_hit(entry)
        m = self._stamp_hit_metrics(q, ds, outcome="delta")
        for f in ("strategy", "rows_scanned", "bytes_scanned", "segments", "num_groups",
                  "h2d_bytes", "h2d_ms", "dispatch_count", "arena_segments",
                  "graph_captures", "graph_replays", "capture_ms", "declines"):
            setattr(m, f, getattr(dm, f))
        m.strategy = "result-cache-delta"
        m.delta_rows_seen = row_counts(fresh)[1]
        m.total_ms = (time.perf_counter() - t0) * 1e3
        log.info("delta refresh on %r: %d appended segments (%d rows) merged onto the "
                 "cached partial state", ds.name, len(fresh), dm.rows_scanned)
        return df.copy(), ""

    def _stamp_hit_metrics(self, q, ds, outcome: str = "hit"):
        """QueryMetrics of a cache-served answer (the wire query type, so
        the hit lands on the same series as executed siblings), stamped as
        the context's most recent metrics.  `outcome` "hit" (no device
        work) or "delta" (a delta refresh)."""
        from ..exec.metrics import QueryMetrics

        try:
            qt = q.to_druid().get("queryType", type(q).__name__)
        except Exception:  # labelling must not fail a hit
            qt = type(q).__name__
        m = QueryMetrics(
            query_type=qt,
            strategy="result-cache",
            executor="device",
            datasource=ds.name,
            query_id=current_query_id(),
            result_cache=outcome,
        )
        self.ctx._stamp_metrics(m)
        record_query_metrics(m, "ok")
        prof.note_result_cache(outcome)
        return m

    # -- fusion ----------------------------------------------------------------

    def fused_execute(self, q, ds, engine=None, strategy=None) -> Optional[tuple]:
        """Micro-batch fusion: (df, state, metrics), or None for the serial
        path.  The member runs under `strategy` (None: the engine's)."""
        if not self.fusion.enabled:
            return None
        return self.fusion.execute(self.ctx, q, ds, engine=engine, strategy=strategy)

    # -- lanes -----------------------------------------------------------------

    def lane_for_sql(self, sql_text: str) -> str:
        """Admission lane of one SQL statement, from its planned rewrite
        (through the plan cache, so `ctx.sql` then hits the same entry).
        Anything unplannable (commands, fallback shapes, parse errors)
        classifies interactive; real errors surface on the execution path
        with their own taxonomy."""
        ctx = self.ctx
        try:
            from ..sql.commands import parse_command

            if parse_command(sql_text) is not None:
                return LANE_INTERACTIVE
            key = ctx._plan_cache_key(sql_text)
            cached = ctx._plan_cache.get(key)
            if cached is not None:
                rw, _lp = cached
            else:
                from ..sql.parser import parse_sql

                lp, explain, _ = parse_sql(sql_text, views=ctx.views)
                if explain:
                    return LANE_INTERACTIVE
                rw = ctx._planner().plan(lp)
                ctx._plan_cache[key] = (rw, lp)
            return classify_rewrite(rw, ctx.catalog, ctx.config)
        except Exception:  # lane routing must never fail a query
            return LANE_INTERACTIVE

    def to_dict(self) -> dict:
        return {
            "fusion": self.fusion.to_dict(),
            "result_cache": self.result_cache.to_dict(),
            "wire_plan_cache_entries": len(self.wire_plan_cache),
        }
