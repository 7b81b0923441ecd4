"""ServingCore: one context's serving machinery.

Owns the fusion scheduler, the result cache, the wire plan cache and the
lane classification of SQL text (a native query classifies from its
decoded QuerySpec; SQL from its planned rewrite, through the plan cache,
so a repeated dashboard statement pays planning once).

The api layer calls in at three points:

  * `cached_result(rw, ds, key)`: a hit at the datasource's version (no
    device work), or None;
  * `fused_execute(q, ds)`: micro-batch fusion for GroupBy-family queries
    (None: the caller runs its serial path);
  * `store_result(rw, ds, key, df)`: publish one computed answer at the
    version of the snapshot it was computed on.

The server calls `decode_native`, `cached_native`, `store_native` and
`lane_for_sql`, and `serve.lanes.classify_native` to route admission
through `ResilienceState.lanes`.
"""

from __future__ import annotations

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
        self.result_cache = ResultCache(entries=cfg.result_cache_entries)
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

    def cached_result(self, rw, ds, key, count_miss: bool = True):
        """`rw`'s answer from the cache at `ds`'s version (post-processed
        when it was stored), or None.  `count_miss=False` on the degraded
        and partial routes, which ask the cache only for a complete answer
        to serve instead of a fallback or a drain (the JAX package counts
        no miss there)."""
        return self._cached(rw.query, ds, key, count_miss)

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

    def cached_native(self, q, ds, key=None, count_miss: bool = True):
        """The native route's cache lookup: None on a miss or for an
        uncacheable type.  `key` lets the caller compute the key once for
        lookup and store."""
        key = key if key is not None else self.native_key(q, ds)
        if key is None:
            return None
        return self._cached(q, ds, key, count_miss)

    def _cached(self, q, ds, key, count_miss=True):
        if key is None or self.ctx.config.result_cache_entries <= 0:
            return None
        hit = self.result_cache.get(key, ds.version)
        if hit is not None:
            self._stamp_hit_metrics(q, ds)
            return hit
        if count_miss:
            self.result_cache.note_miss()
        return None

    def _stamp_hit_metrics(self, q, ds):
        """QueryMetrics of a cache-served answer (the wire query type, so
        the hit lands on the same series as executed siblings), stamped as
        the context's most recent metrics."""
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
            result_cache="hit",
        )
        self.ctx._stamp_metrics(m)
        record_query_metrics(m, "ok")
        prof.note_result_cache("hit")
        return m

    def store_result(self, rw, ds, key, df) -> None:
        """Publish one computed answer at the executed snapshot's own
        version (never the live catalog's: a re-registration racing this
        write must read as a version mismatch)."""
        if key is None or self.ctx.config.result_cache_entries <= 0:
            return
        self.result_cache.put(key, df, version=ds.version,
                              uids=frozenset(s.uid for s in ds.segments))

    def store_native(self, q, ds, df, key=None) -> None:
        """Publish one native answer; a deadline-truncated frame is never
        stored (it would be served back as the exact answer)."""
        from ..resilience import current_partial

        if self.ctx.config.result_cache_entries <= 0:
            return
        key = key if key is not None else self.native_key(q, ds)
        if key is None:
            return
        pc = current_partial()
        if pc is not None and pc.triggered:
            return
        self.result_cache.put(key, df, version=ds.version,
                              uids=frozenset(s.uid for s in ds.segments))

    # -- fusion ----------------------------------------------------------------

    def fused_execute(self, q, ds, engine=None) -> Optional[tuple]:
        """Micro-batch fusion: (df, state, metrics), or None for the serial
        path."""
        if not self.fusion.enabled:
            return None
        return self.fusion.execute(self.ctx, q, ds, engine=engine)

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
