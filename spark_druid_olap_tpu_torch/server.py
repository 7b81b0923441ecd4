"""The serving surface: HTTP endpoints for BI tools and Druid clients.

The surface speaks the protocol Druid's own broker speaks, so Druid clients
and dashboards can point at it:

    POST /druid/v2                        native Druid query JSON -> Druid-shaped results
    POST /druid/v2/sql                    {"query": "SELECT ..."} -> array of row objects
    GET  /druid/v2/datasources            -> ["lineorder", ...]
    GET  /druid/v2/datasources/{name}     -> {"dimensions": .., "metrics": ..}
    GET  /druid/v2/trace/{query_id}       -> span tree (and cost receipt) of a recent query
    POST /druid/v2/ingest/{datasource}    streamed rows -> {"appended", "datasourceVersion", "totalRows"}
    POST /druid/v2/cluster/partial        a historical's partial state over given segments (cluster/)
    GET  /status, /status/health          -> liveness, breakers, admission, storage, cluster, last metrics
    GET  /status/metrics[?cluster=1]      -> Prometheus text exposition (a broker's: every node's)
    GET  /status/profile[?cluster=1]      -> the rolling workload profile (a broker's: every node's)
    GET  /status/kernels                  -> this process's group-by kernel launches, by shape

Every query response carries `X-Druid-Query-Id` (the client's
`context.queryId` when set, generated otherwise); the id keys the query's
span tree in the trace ring (`obs/`).  `context.timeout` (ms; 0 for none)
arms the query's deadline and `context.partialResults` its partial-answer
collector; a partial answer and, on a sampled query, the cost receipt ride
`X-Druid-Response-Context`.  Errors are Druid's structured error objects:
400 for a malformed query, 404 for an unknown route or trace, 500 with
nothing internal in it (the traceback goes to the log), 503 with
Retry-After when admission or a lane is full, the device breaker is open
and the query cannot degrade, or the node is replaying its WAL at boot,
504 on an expired deadline.

A context with a `ClusterClient` attached is a broker: a native or SQL
query it covers scatters to the historicals and their states merge
(`cluster/broker.py`).  A historical answers the broker's
`POST /druid/v2/cluster/partial` ({"query", "segments", "version"}) with
its partial state over exactly those segments, 409 when its snapshot
version or segment ids disagree with the broker's assignment, and 503 while
it replays its WAL.

    POST /druid/v2/ingest/{datasource}    {"rows": [...]} | {"columns": {...}} -> ack

appends streamed rows (`TPUOlapContext.ingest.append_rows`) behind the
ingest admission pool (503 with Retry-After when it is full), and the
rows are in the next query's answer.

Native queries bypass the SQL planner (they are its output language) and
go through the serving core: the result cache, micro-batch fusion, then
the engine; SQL goes through `ctx.sql`.  Admission is per route and lane
first (`serve/lanes.py`), then the global pool.  Standard library only
(ThreadingHTTPServer); one process serves one TPUOlapContext, whose engine
runs device work one query at a time (`Engine._exec_lock`).

    from spark_druid_olap_tpu_torch.server import OlapServer
    OlapServer(ctx, port=8082).serve_forever()     # or .start(), then .shutdown()
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from .models import query as Q
from .models.wire import (  # noqa: F401  (the envelope, re-exported)
    WireError,
    _jsonable,
    _result_timestamp,
    _rows,
    druid_result_shape,
    query_from_druid,
)
from .obs import (
    SPAN_ADMISSION,
    SPAN_LANE,
    default_tracer,
    get_registry,
    new_query_id,
    span,
)
from .resilience import (
    CircuitOpenError,
    DeadlineExceeded,
    classify_error,
    current_partial,
    deadline_scope,
    partial_scope,
)
from .utils.log import get_logger

log = get_logger("server")


def _route_label(path: str) -> str:
    """Coarse route label for the http-requests counter: bounded label
    cardinality (per-datasource / per-query-id suffixes collapse)."""
    for prefix in (
        "/druid/v2/trace",
        "/druid/v2/datasources",
        "/druid/v2/sql",
        "/druid/v2/ingest",
        "/druid/v2/cluster",
        "/druid/v2",
        "/status/metrics",
        "/status/health",
        "/status/profile",
        "/status/kernels",
        "/status",
    ):
        if path == prefix or path.startswith(prefix + "/"):
            return prefix
    return "other"


class _Handler(BaseHTTPRequestHandler):
    # chunked transfer-encoding (the progressive streaming path) is only
    # defined for HTTP/1.1 — the stdlib default of HTTP/1.0 would make
    # spec-compliant clients read the hex chunk-size lines as body bytes.
    # Safe to enable: every buffered response carries Content-Length
    # (_begin_response) and every chunked one ends with the terminal
    # 0-chunk, so keep-alive connections can never hang.
    protocol_version = "HTTP/1.1"
    ctx = None  # set by OlapServer
    server_version = "sdol-tpu-torch/0.2"
    _query_id: Optional[str] = None  # per-request; set by do_POST
    _req_t0: Optional[float] = None
    # trace-before-response contract (see do_POST): while a query trace
    # is open, buffered responses are captured here and written only
    # after the trace publishes to the ring
    _defer_buffered = False
    _buffered_response: Optional[tuple] = None

    # -- plumbing ------------------------------------------------------------

    def log_message(self, fmt, *args):
        # library etiquette: no stderr output; stdlib-internal messages
        # (malformed request lines and such) surface at DEBUG
        log.debug("http %s", (fmt % args) if args else fmt)

    def log_request(self, code="-", size="-"):
        """Structured access log at DEBUG: method, path, status, query_id,
        duration (the queryId-tagged request log Druid keeps)."""
        import time as _time

        dur_ms = (
            (_time.perf_counter() - self._req_t0) * 1e3
            if self._req_t0 is not None
            else -1.0
        )
        log.debug(
            "access method=%s path=%s status=%s query_id=%s "
            "duration_ms=%.2f",
            self.command, self.path, code, self._query_id or "-", dur_ms,
        )

    # -- response writer ----------------------------------------------------
    # one writer serves the buffered and the chunked (progressive) paths:
    # status and headers, the X-Druid-Query-Id echo among them, come from
    # `_begin_response` for both, and the http-requests counter fires once
    # per response in `_finish_response`

    def _begin_response(
        self,
        code: int,
        content_type: str,
        headers: Optional[dict] = None,
        length: Optional[int] = None,
    ):
        """Status line + headers.  `length=None` switches the body to
        chunked transfer-encoding (`_write_chunk`/`_finish_response`);
        otherwise the caller writes exactly `length` bytes."""
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        if length is not None:
            self.send_header("Content-Length", str(length))
        else:
            self.send_header("Transfer-Encoding", "chunked")
        if self._query_id:
            # Druid parity: every query response (success OR error, buffered
            # OR streamed) echoes the query's id so clients can correlate
            # logs and traces
            self.send_header("X-Druid-Query-Id", self._query_id)
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()

    def _write_chunk(self, data: bytes):
        self.wfile.write(b"%x\r\n" % len(data))
        self.wfile.write(data)
        self.wfile.write(b"\r\n")
        self.wfile.flush()

    def _finish_response(self, code: int, chunked: bool = False):
        if chunked:
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        get_registry().counter(
            "sdol_http_requests_total",
            "HTTP responses by method/route/status",
            labels=("method", "route", "code"),
        ).labels(
            method=self.command or "-",
            route=_route_label(self.path.split("?")[0].rstrip("/")),
            code=str(code),
        ).inc()

    def _send(self, code: int, payload: Any, headers: Optional[dict] = None):
        body = json.dumps(payload, default=_jsonable).encode()
        self._send_bytes(code, body, "application/json", headers)

    def _send_bytes(
        self,
        code: int,
        body: bytes,
        content_type: str,
        headers: Optional[dict] = None,
    ):
        if self._defer_buffered:
            # a query trace is open: capture the response; do_POST writes
            # it after the trace publishes so /druid/v2/trace/{id} can
            # never 404 on a query whose response was already read
            self._buffered_response = (code, body, content_type, headers)
            return
        self._begin_response(code, content_type, headers, length=len(body))
        self.wfile.write(body)
        self._finish_response(code)

    def _error(
        self,
        code: int,
        msg: str,
        error_class: str = "QueryInterruptedException",
        headers: Optional[dict] = None,
    ):
        # Druid's structured error object: `error` stays the readable
        # message (clients and older tests read it), `errorMessage` /
        # `errorClass` carry the structure Druid clients dispatch on
        self._send(
            code,
            {"error": msg, "errorMessage": msg, "errorClass": error_class},
            headers=headers,
        )

    def _body(self) -> Optional[dict]:
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            return None
        # valid JSON that isn't an object (`[1,2]`, `"x"`) is equally a
        # client error, not a 500 from a surprised .get()
        return body if isinstance(body, dict) else None

    # -- routes --------------------------------------------------------------

    def _resilience(self):
        return getattr(self.ctx, "resilience", None)

    def _tracer(self):
        return getattr(self.ctx, "tracer", None) or default_tracer()

    def _cluster_scrape(self):
        """The broker's ClusterClient when the GET asked `?cluster=1`."""
        from urllib.parse import parse_qs, urlparse

        cluster = getattr(self.ctx, "cluster", None)
        if cluster is None:
            return None
        qs = parse_qs(urlparse(self.path).query)
        return cluster if qs.get("cluster", ["0"])[0] in ("1", "true") else None

    def do_GET(self):
        import time as _time

        # keep-alive: clear the previous request's query id (GETs have
        # none) so health/metrics/trace responses never echo a stale
        # X-Druid-Query-Id from an earlier POST on this connection
        self._query_id = None
        self._req_t0 = _time.perf_counter()
        path = self.path.split("?")[0].rstrip("/")
        if path in ("/status/health", ""):
            res = self._resilience()
            if res is None:
                return self._send(200, True)
            # breaker state + slots in use: a load balancer (or the
            # concurrent-serving test) reads degradation from here
            doc = res.health()
            # the durable tier: WAL sequence, snapshot version, replay in
            # progress, dirty deltas (what a restart would replay)
            storage = getattr(self.ctx, "storage", None)
            doc["storage"] = storage.state() if storage is not None else {"enabled": False}
            # a broker's: each historical's liveness and breaker, the
            # assignment epoch and the replication deficit, served through
            # any breaker state
            cluster = getattr(self.ctx, "cluster", None)
            if cluster is not None:
                doc["cluster"] = cluster.state()
            return self._send(200, doc)
        if path == "/status/metrics":
            # Prometheus text exposition of the process registry (engine,
            # resilience, serving, http counters, phase histograms);
            # ?cluster=1 on a broker merges every historical's under a
            # `node` label, a dead one stamped stale (cluster/federation.py)
            cluster = self._cluster_scrape()
            if cluster is not None:
                return self._send_bytes(
                    200, cluster.federated_metrics().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            return self._send_bytes(
                200,
                get_registry().render_prometheus().encode(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        if path == "/status/profile":
            # the workload profiler (obs/prof.py): top-K queries by device
            # time, capture totals per family, per-lane SLO burn rate; ?k=
            # and ?window_s= override the configured defaults
            from urllib.parse import parse_qs, urlparse

            from .obs.prof import profile_doc

            qs = parse_qs(urlparse(self.path).query)

            def _num(name, cast):
                try:
                    return cast(qs[name][0])
                except (KeyError, IndexError, TypeError, ValueError):
                    return None

            local = profile_doc(
                config=getattr(self.ctx, "config", None),
                top_k=_num("k", int),
                window_s=_num("window_s", float),
            )
            cluster = self._cluster_scrape()
            if cluster is not None:
                return self._send(200, cluster.federated_profile(local))
            return self._send(200, local)
        if path == "/status/kernels":
            # the hand-written kernel's launches in this process, by shape
            # and with the most rows one took (how a historical reports
            # what it ran to the process that checks the shapes)
            from .ops import cuda_groupby

            return self._send(200, cuda_groupby.launch_record())
        if path.startswith("/druid/v2/trace/"):
            qid = path.rsplit("/", 1)[1]
            tr = self._tracer().ring.get(qid)
            if tr is None:
                return self._error(
                    404, f"no trace for query id {qid!r} (ring holds the "
                    "most recent traces only)", "NotFound",
                )
            return self._send(200, tr)
        if path == "/status":
            m = self.ctx.last_metrics
            res = self._resilience()
            return self._send(
                200,
                {
                    "service": "spark-druid-olap-tpu-torch",
                    "datasources": sorted(self.ctx.catalog.tables()),
                    "last_query_metrics": m.to_dict() if m else None,
                    "resilience": res.health() if res else None,
                    # serving core (serve/): fusion and result-cache stats
                    "serving": (
                        self.ctx.serve.to_dict()
                        if getattr(self.ctx, "serve", None) is not None
                        else None
                    ),
                    # registry summary: counter/gauge values + histogram
                    # p50/p95/p99 (full series live at /status/metrics)
                    "metrics": get_registry().to_dict(),
                    # the __sys telemetry sampler (obs/telemetry.py)
                    "sys_sampler": (
                        self.ctx.sys_sampler.status()
                        if getattr(self.ctx, "sys_sampler", None) is not None
                        else None
                    ),
                },
            )
        if path == "/druid/v2/datasources":
            return self._send(200, sorted(self.ctx.catalog.tables()))
        if path.startswith("/druid/v2/datasources/"):
            name = path.rsplit("/", 1)[1]
            ds = self.ctx.catalog.get(name)
            if ds is None:
                return self._error(404, f"unknown datasource {name!r}")
            return self._send(
                200,
                {
                    "dimensions": [
                        c.name for c in ds.columns if c.kind == "dimension"
                    ],
                    "metrics": [
                        c.name for c in ds.columns if c.kind == "metric"
                    ],
                    "timeColumn": ds.time_column,
                    "numRows": ds.num_rows,
                    "segments": len(ds.segments),
                },
            )
        return self._error(404, f"no route {path!r}")

    def do_POST(self):
        import time as _time

        # per-request state: with HTTP/1.1 keep-alive the SAME handler
        # instance serves every request on the connection — a stale id
        # from the previous query must never echo on this response
        self._query_id = None
        self._req_t0 = _time.perf_counter()
        path = self.path.split("?")[0].rstrip("/")
        body = self._body()
        if body is None:
            return self._error(
                400, "invalid JSON body", "BadJsonQueryException"
            )
        if path.startswith("/druid/v2/ingest/"):
            return self._ingest(path.rsplit("/", 1)[1], body)
        if path == "/druid/v2/cluster/partial":
            return self._cluster_partial(body)
        if path not in ("/druid/v2", "/druid/v2/sql"):
            return self._error(404, f"no route {path!r}", "NotFound")
        # A non-dict context is client noise, not a server error: ignore it.
        qctx = body.get("context")
        qctx = qctx if isinstance(qctx, dict) else {}
        # query_id is born HERE, the server boundary: honor Druid's
        # `context.queryId` when the client set one, generate otherwise.
        # Echoed on every response as X-Druid-Query-Id (_send_bytes) and
        # carried through the whole execution by the active trace.
        client_qid = qctx.get("queryId")
        self._query_id = (
            str(client_qid) if client_qid else new_query_id()
        )
        cfg = getattr(self.ctx, "config", None)
        res = self._resilience()
        self._buffered_response = None
        self._defer_buffered = True
        try:
            with self._tracer().query_trace(
                query_id=self._query_id,
                query_type="native" if path == "/druid/v2" else "sql",
                slow_ms=cfg.slow_query_ms if cfg else 0.0,
            ):
                return self._handle_query(path, body, qctx, res, cfg)
        finally:
            # trace-before-response contract: the buffered response was
            # CAPTURED by _send_bytes during the query scope and is
            # written HERE — after the trace published to the ring — so
            # a client that reads it and immediately fetches
            # /druid/v2/trace/{id} can never race the publish
            self._defer_buffered = False
            pending = self._buffered_response
            if pending is not None:
                self._buffered_response = None
                try:
                    self._send_bytes(*pending)
                except OSError:
                    pass  # client disconnected before the body landed
            # a streamed (chunked) response gets the same guarantee from
            # its terminal 0-chunk, deferred to HERE — the client's read
            # completes only on that chunk
            code = getattr(self, "_pending_chunked_finish", None)
            if code is not None:
                self._pending_chunked_finish = None
                try:
                    self._finish_response(code, chunked=True)
                except OSError:
                    # client disconnected mid-stream: the terminal
                    # 0-chunk has no socket to land on — not an error
                    pass

    def _ingest(self, name: str, body: dict):
        """POST /druid/v2/ingest/{datasource}: a streamed row append (the
        realtime node's push).  Body: {"rows": [row objects]} or
        {"columns": {name: [values]}}.  Gated on the ingest admission pool
        (503 with Retry-After when it is full), so appends and queries
        cannot starve each other, and under the deadline queries get
        (`context.timeout`).  Answers the acknowledgement with 200; 400 for
        a malformed body or an unknown datasource; 504 on an expired
        deadline."""
        res = self._resilience()
        cfg = getattr(self.ctx, "config", None)
        qctx = body.get("context")
        qctx = qctx if isinstance(qctx, dict) else {}
        client_qid = qctx.get("queryId")
        self._query_id = str(client_qid) if client_qid else new_query_id()
        rows = body.get("rows", body.get("columns"))
        if rows is None:
            return self._error(
                400,
                'body must carry "rows" (row objects) or "columns" '
                "(column arrays)",
                "BadQueryException",
            )
        with span(SPAN_ADMISSION):
            admitted = res is None or res.ingest_admission.acquire()
        if not admitted:
            return self._error(
                503,
                "ingest capacity exceeded; retry later",
                "QueryCapacityExceededException",
                headers={
                    "Retry-After": res.ingest_admission.retry_after_s()
                },
            )
        try:
            # tolerate a malformed context.timeout exactly like the query
            # route: client noise means "no timeout", never a 500
            if "timeout" in qctx:
                try:
                    timeout_ms = float(qctx["timeout"])
                except (TypeError, ValueError):
                    timeout_ms = 0
            else:
                timeout_ms = cfg.query_timeout_ms if cfg else 0
            if timeout_ms <= 0:
                timeout_ms = float("inf")
            with self._tracer().query_trace(
                query_id=self._query_id,
                query_type="ingest",
                slow_ms=cfg.slow_query_ms if cfg else 0.0,
            ), deadline_scope(timeout_ms):
                ack = self.ctx.ingest.append_rows(name, rows)
            return self._send(200, ack)
        except KeyError as e:
            return self._error(
                400, f"unknown dataSource: {e}", "BadQueryException"
            )
        except ValueError as e:
            # malformed client payload (ragged columns, unknown columns,
            # unparseable time values): 400, not a server error
            return self._error(400, str(e), "BadQueryException")
        except DeadlineExceeded as e:
            if res is not None:
                res.note_deadline_exceeded()
            return self._error(504, str(e), "QueryTimeoutException")
        except Exception as e:  # nothing internal in the 500's body
            log.error("ingest failed: %s", type(e).__name__, exc_info=True)
            if res is not None:
                res.note_server_error(e)
            return self._error(
                500, "ingest failed; see server logs", type(e).__name__
            )
        finally:
            if res is not None:
                res.ingest_admission.release()

    def _cluster_partial(self, body: dict):
        """POST /druid/v2/cluster/partial: a historical's scatter route.
        Body: {"query": a native query, "segments": [segment_id, ...] or
        null (the whole scope), "version": the snapshot version the
        broker's assignment expects, "context": {...}}.  Answers the host
        partial state over exactly those segments, wire-encoded, with the
        snapshot version, the segment ids served, this node's receipt and
        its rendered trace (which the broker grafts under its attempt's
        span).  503 with Retry-After while the WAL replays; 409 when the
        version or a segment id disagrees with the catalog (the broker
        fails over, never merges a wrong state)."""
        from .cluster.wire import HEADER_PARENT_SPAN, HEADER_QUERY_ID, encode_state, encode_trace
        from .resilience import fire

        res = self._resilience()
        cfg = getattr(self.ctx, "config", None)
        qctx = body.get("context")
        qctx = qctx if isinstance(qctx, dict) else {}
        client_qid = qctx.get("queryId") or self.headers.get(HEADER_QUERY_ID)
        self._query_id = str(client_qid) if client_qid else new_query_id()
        parent_span = str(self.headers.get(HEADER_PARENT_SPAN) or "")
        storage = getattr(self.ctx, "storage", None)
        if storage is not None and storage.replay_in_progress:
            return self._error(
                503, "node is recovering (WAL replay in progress); retry later",
                "QueryUnavailableException",
                headers={"Retry-After": res.admission.retry_after_s() if res is not None else 1},
            )
        qdoc = body.get("query")
        if not isinstance(qdoc, dict):
            return self._error(400, 'body must carry a native "query" object',
                               "BadQueryException")
        if not self._admit(res):
            return None
        try:
            # fault site: an armed error is this historical dying while it
            # serves (the broker fails over); a delay is a slow replica
            fire("cluster.historical_kill")
            q = query_from_druid(qdoc)
            ds = self.ctx.catalog.get(q.datasource)
            if ds is None:
                return self._error(400, f"unknown dataSource {q.datasource!r}",
                                   "BadQueryException")
            # the snapshot version, the same in every process that booted
            # this store (the live version is this process's own)
            have = storage.snapshot_version(q.datasource) if storage is not None else None
            if have is None:
                have = int(ds.version)
            expect = body.get("version")
            if expect is not None and have != int(expect):
                return self._error(
                    409,
                    f"datasource {q.datasource!r} at snapshot version {have}, the broker's "
                    f"assignment expects {int(expect)}; rebalance and retry",
                    "VersionMismatchException",
                )
            want = body.get("segments")
            by_id = {s.segment_id: s.uid for s in ds.segments}
            if want is None:
                uids = None
                served = sorted(by_id)
            else:
                missing = [sid for sid in want if sid not in by_id]
                if missing:
                    return self._error(
                        409, f"unknown segments {missing[:4]} (assignment and catalog "
                        "disagree); rebalance and retry", "VersionMismatchException")
                uids = frozenset(by_id[sid] for sid in want)
                served = [str(sid) for sid in want]
            node = getattr(self.ctx, "cluster_node_id", "")
            with self._tracer().query_trace(
                query_id=self._query_id, query_type="cluster_partial",
                slow_ms=cfg.slow_query_ms if cfg else 0.0, parent_span_id=parent_span,
            ) as tr:
                tr.root.attrs["node"] = node
                self.ctx._sync_engine_resilience(self.ctx.engine)
                state, m = self.ctx.engine.groupby_partials_host(q, ds, within_uids=uids)
            doc = {
                "node": node,
                "version": int(have),
                "rows": int(m.rows_scanned),
                "segments": served,
                "state": encode_state(state),
            }
            if tr.receipt:
                # folded into the broker's receipt under this node
                doc["receipt"] = tr.receipt
            subtree = encode_trace(tr.to_dict())
            if subtree is not None:
                doc["trace"] = subtree
            return self._send(200, doc)
        except (WireError, ValueError) as e:
            return self._error(400, str(e), "BadQueryException")
        except DeadlineExceeded as e:
            if res is not None:
                res.note_deadline_exceeded()
            return self._error(504, str(e), "QueryTimeoutException")
        except Exception as e:
            log.error("cluster partial failed: %s", type(e).__name__, exc_info=True)
            if res is not None:
                res.note_server_error(e)
            return self._error(500, "cluster partial failed; see server logs",
                               type(e).__name__)
        finally:
            if res is not None:
                res.admission.release()

    def _handle_query(self, path, body, qctx, res, cfg):
        # a recovering node is busy, not wedged: while boot replay applies
        # the WAL, an answer would read a state between the snapshot and
        # the acknowledged tail, so 503 with Retry-After, as a full pool
        storage = getattr(self.ctx, "storage", None)
        if storage is not None and storage.replay_in_progress:
            return self._error(
                503,
                "node is recovering (WAL replay in progress); retry later",
                "QueryUnavailableException",
                headers={"Retry-After": res.admission.retry_after_s() if res is not None else 1},
            )
        # admission is per-route and LANE-FIRST (serve/lanes.py): the
        # query takes its priority lane's slot before the global pool,
        # so a heavy query queued on a full heavy lane never sits on a
        # global slot while waiting — that ordering is what keeps the
        # interactive lane's capacity reachable under a heavy storm
        try:
            # Druid-native per-query deadline: `context.timeout` (ms)
            # overrides the session default — including `timeout: 0`,
            # Druid's explicit "no timeout".  The scope set HERE is the
            # outermost, so ctx.sql's own scope defers to it.
            if "timeout" in qctx:
                try:
                    timeout_ms = float(qctx["timeout"])
                except (TypeError, ValueError):
                    timeout_ms = 0
                if timeout_ms <= 0:
                    # explicit opt-out: arm an INFINITE deadline so the
                    # session default inside ctx.sql (which defers to any
                    # outer scope) cannot re-arm a budget the client
                    # declined
                    timeout_ms = float("inf")
            else:
                timeout_ms = cfg.query_timeout_ms if cfg else 0
            # partial-result collection: session default, overridable per
            # request via context.partialResults (Druid-style context
            # flag).  The scope armed HERE is the outermost, so ctx.sql's
            # own scope joins it and the response headers can read the
            # collector after execution.
            p_enabled = bool(cfg.partial_results) if cfg else False
            pflag = qctx.get("partialResults")
            if isinstance(pflag, bool):
                p_enabled = pflag
            with deadline_scope(timeout_ms), partial_scope(p_enabled):
                if path == "/druid/v2":
                    return self._native_query(body, qctx)
                return self._sql_query(body, qctx)
        except WireError as e:
            return self._error(400, str(e), "BadQueryException")
        except KeyError as e:
            return self._error(400, f"missing field: {e}", "BadQueryException")
        except Q.QueryValidationError as e:
            # validation of a decoded query (unknown orderBy column,
            # __time ordering on a timeless table): client error.  Plain
            # ValueError stays a 500 — internal invariants are not the
            # client's fault
            return self._error(400, str(e), "BadQueryException")
        except CircuitOpenError as e:
            # native wire queries have no logical plan to degrade to the
            # host fallback with: an open breaker fails them FAST (503 +
            # Retry-After) instead of burning retry budget on a device
            # known to be down
            return self._error(
                503, str(e), "QueryUnavailableException",
                headers={
                    "Retry-After": res.admission.retry_after_s()
                    if res is not None
                    else 1
                },
            )
        except DeadlineExceeded as e:
            # the api layer counts SQL deadline expiry itself; only count
            # here when the exception arrives uncounted (the native path)
            if res is not None and not getattr(e, "_sdol_counted", False):
                res.note_deadline_exceeded()
            return self._error(504, str(e), "QueryTimeoutException")
        except Exception as e:
            # a 500 must not leak raw exception text (internals, paths,
            # data values) to clients: structured Druid-style error out,
            # full traceback to the server log, failure recorded on the
            # resilience counters + the query's metrics
            log.error("query failed: %s", type(e).__name__, exc_info=True)
            # the failing query's OWN metrics already carry error_class
            # (the engine retry loop stamps it); stamping last_metrics here
            # would pollute an unrelated earlier query when the failure
            # precedes execution (e.g. a parse error)
            if res is not None:
                res.note_server_error(e)
            return self._error(
                500,
                "query execution failed; see server logs",
                type(e).__name__,
            )

    def _admit(self, res) -> bool:
        """The GLOBAL admission pool — acquired AFTER the lane slot (a
        query waiting out a full lane must not hold global capacity
        while it waits).  A bounded slot pool with a queue-wait timeout
        answers 503 + Retry-After instead of piling handler threads
        behind a slow device until the process wedges."""
        with span(SPAN_ADMISSION):
            admitted = res is None or res.admission.acquire()
        if not admitted:
            self._error(
                503,
                "query capacity exceeded; retry later",
                "QueryCapacityExceededException",
                headers={"Retry-After": res.admission.retry_after_s()},
            )
        return admitted

    def _partial_headers(self) -> Optional[dict]:
        """X-Druid-Response-Context carrying the partial-answer contract:
        when the answer about to be sent is deadline-bounded, the header
        holds {"partial": true, "coverage": ..., rows seen and total}, in
        Druid's own response-context header.  A sampled query also carries
        its cost receipt under "receipt" (device time from CUDA events on
        a card).  Absent otherwise."""
        from .obs.prof import live_receipt, profiled

        rctx = {}
        pc = current_partial()
        if pc is not None and pc.is_partial:
            rctx.update(pc.to_dict())
        if profiled():
            rc = live_receipt()
            if rc is not None:
                rctx["receipt"] = rc
        if not rctx:
            return None
        return {
            "X-Druid-Response-Context": json.dumps(rctx, default=_jsonable)
        }

    # query types that never dispatch device work: answered from catalog
    # metadata, so breaker state is irrelevant to them
    _METADATA_QUERIES = (
        Q.TimeBoundaryQuery,
        Q.DataSourceMetadataQuery,
        Q.SegmentMetadataQuery,
    )

    def _acquire_lane(self, lane_name: str):
        """Gate one query on its priority lane's slot pool (serve/lanes):
        returns True when admitted, or sends the 503 (naming the lane,
        with the lane's OWN observed-load Retry-After) and returns False.
        A context without resilience state admits everything."""
        res = self._resilience()
        if res is None or not getattr(res, "lanes", None):
            return True
        pool = res.lane(lane_name)
        with span(SPAN_LANE, lane=lane_name):
            admitted = pool.acquire()
        if not admitted:
            self._error(
                503,
                f"{lane_name} lane capacity exceeded; retry later",
                "QueryCapacityExceededException",
                headers={"Retry-After": pool.retry_after_s()},
            )
        return admitted

    def _release_lane(self, lane_name: Optional[str]):
        res = self._resilience()
        if lane_name and res is not None and getattr(res, "lanes", None):
            res.lane(lane_name).release()

    def _native_query(self, body: dict, qctx: dict):
        res = self._resilience()
        serve = getattr(self.ctx, "serve", None)
        try:
            # the decoded-QuerySpec plan cache: dashboards post the same
            # body every refresh, and a hit skips the decode
            if serve is not None:
                q = serve.decode_native(body)
            else:
                q = query_from_druid(body)
        except ValueError as e:
            # decode-time ValueErrors (unsupported filter type, malformed
            # interval timestamps) are malformed CLIENT input — 400, same
            # as WireError; execution-time ValueErrors stay 500
            raise WireError(str(e)) from e
        ds = self.ctx.catalog.get(q.datasource)
        if ds is None:
            return self._error(400, f"unknown dataSource {q.datasource!r}")
        # priority lanes (serve/lanes.py): a cheap dashboard query takes
        # an interactive slot an SF100-scale scan cannot starve; heavy
        # work gates on its own small pool with a per-lane Retry-After
        from .obs.prof import note_lane
        from .serve.lanes import classify_native

        lane_name = classify_native(
            q, ds, getattr(self.ctx, "config", None)
        )
        note_lane(lane_name)  # the workload profiler's SLO burn key
        if not self._acquire_lane(lane_name):
            return None
        try:
            if not self._admit(res):
                return None
            try:
                return self._native_query_admitted(q, ds, body, qctx, res)
            finally:
                if res is not None:
                    res.admission.release()
        finally:
            self._release_lane(lane_name)

    def _native_query_admitted(self, q, ds, body: dict, qctx: dict, res):
        needs_device = not isinstance(q, self._METADATA_QUERIES)
        serve = getattr(self.ctx, "serve", None)
        if (
            needs_device
            and res is not None
            and not res.breaker_for("device").allow()
        ):
            # an open circuit must not cost a cached answer (as on the SQL
            # path): a hit needs no device
            if serve is not None:
                hit = serve.cached_native(q, ds)
                if hit is not None:
                    return self._send(
                        200, druid_result_shape(q, hit),
                        headers=self._partial_headers(),
                    )
            # the device breaker is open: the wire query degrades through
            # the native->logical fallback interpreter; shapes it cannot
            # cover fail fast with 503
            return self._native_degraded(q, None, "circuit_open")
        progressive = (
            bool(qctx.get("progressive"))
            and isinstance(
                q, (Q.GroupByQuery, Q.TimeseriesQuery, Q.TopNQuery)
            )
            and not (isinstance(q, Q.GroupByQuery) and q.subtotals)
        )
        if progressive:
            return self._progressive_query(q, ds)
        def run():
            if isinstance(q, Q.GroupByQuery) and q.subtotals:
                # wire subtotalsSpec: same grouping-set expansion the SQL
                # path uses — the engine alone would silently run only
                # the full set
                from .api import execute_grouping_sets

                df = execute_grouping_sets(
                    dataclasses.replace(q, subtotals=()), q.subtotals, ds,
                    self.ctx.engine,
                )
                # internal bitmask column; real Druid events don't carry it
                return df.drop(columns=["__grouping_id"])
            # the serving core's native path (serve/): the result cache
            # (a hit does no device work), then micro-batch fusion, then
            # the engine alone, the answer stored back
            if serve is None:
                return self.ctx.engine.execute(q, ds)
            return serve.answer(q, ds, serve.native_key(q, ds), self.ctx.engine.fusable(q, ds))

        try:
            self.ctx._sync_engine_resilience(self.ctx.engine)
            try:
                df = run()
            except Exception as err:
                # a deadline expiry outside the partial-capable loops (a
                # blocking fetch, a ladder rung, the fused batch): the
                # drain the SQL surface runs in
                # api._execute_with_resilience; the collector is triggered
                # so every checkpoint stops at once, and the rerun yields
                # the coverage-stamped answer instead of a 504
                pc = current_partial()
                if pc is None or classify_error(err) != "deadline":
                    raise
                pc.trigger(getattr(err, "site", "") or "deadline")
                log.warning(
                    "deadline expired outside a partial-capable loop "
                    "(%s); draining a best-effort native answer", err,
                )
                df = run()
            # the native surface publishes a deadline-bounded answer (the
            # partial span, sdol_partial_results_total, the coverage
            # histogram) as ctx.sql does; _partial_headers below only adds
            # the wire header.  The cost receipt rides the same stamp
            df = self.ctx._stamp_receipt(self.ctx._stamp_partial(df))
        except Exception as err:
            # a transient device failure that survived the engine's retry
            # budget degrades exactly like the SQL path does; static
            # errors and deadlines keep their taxonomy (handled above)
            if res is None or classify_error(err) != "transient":
                raise
            return self._native_degraded(q, err, "device_failed")
        self._send(
            200, druid_result_shape(q, df),
            headers=self._partial_headers(),
        )

    def _native_degraded(self, q, err, reason: str):
        """Degrade one wire-native query to the host fallback through the
        QuerySpec->logical interpreter.  Unsupported shapes fail fast (503
        on an open circuit, the original error otherwise): a wrong degraded
        answer is worse than none."""
        from .exec.wire_fallback import WireFallbackUnsupported
        from .plan.transforms import RewriteError

        try:
            df = self.ctx.execute_native_degraded(q, err, reason=reason)
        except (WireFallbackUnsupported, NotImplementedError, RewriteError) as e:
            # RewriteError covers config.fallback_execution=False: the
            # degraded route is off, so an open breaker answers 503 with
            # Retry-After (not a 500 through the generic handler)
            if err is None:
                raise CircuitOpenError(
                    "device circuit open and this native query cannot "
                    f"degrade to the host fallback ({e}) — retry after "
                    "the breaker's cooldown"
                ) from e
            raise err
        self._send(
            200, druid_result_shape(q, df),
            headers=self._partial_headers(),
        )

    def _progressive_query(self, q, ds):
        """Chunked progressive response: one NDJSON line per refinement,
        {"sequence", "coverage", "partial", "final", "result"}, converging
        to the exact answer as segments complete.  The FIRST refinement is computed before the
        status line commits, so pre-execution errors still produce
        normal structured error responses; mid-stream failures emit a
        terminal {"error": ...} line (the status is already on the
        wire)."""
        self.ctx._sync_engine_resilience(self.ctx.engine)
        gen = self.ctx.engine.execute_progressive(q, ds)
        return self._stream_refinements(gen, lambda df: druid_result_shape(q, df))

    def _stream_refinements(self, gen, shape):
        """Drive one refinement generator onto the wire as chunked NDJSON,
        for the native and the SQL route alike (the line protocol, the
        error handling and the deferred terminal chunk).  `shape` renders a
        refinement frame into the route's result payload."""
        from .obs import SPAN_STREAM_FLUSH, span

        item = next(gen)  # may raise -> structured error path
        self._begin_response(200, "application/x-ndjson")
        try:
            while True:
                df, info = item
                line = {
                    "sequence": info["sequence"],
                    "coverage": info["coverage"],
                    "partial": bool(info.get("partial", False)),
                    "final": bool(info["final"]),
                    "rows_seen": info.get("rows_seen"),
                    "rows_total": info.get("rows_total"),
                    "result": shape(df),
                }
                if line["final"]:
                    # the final refinement carries the stream's cost
                    # receipt, as a buffered answer's df.attrs does
                    from .obs.prof import live_receipt

                    rc = live_receipt()
                    if rc is not None:
                        line["receipt"] = rc
                with span(SPAN_STREAM_FLUSH, sequence=info["sequence"]):
                    self._write_chunk(
                        json.dumps(line, default=_jsonable).encode()
                        + b"\n"
                    )
                if info["final"]:
                    break
                item = next(gen)
        except OSError as e:
            # the CLIENT went away mid-stream (broken pipe / reset):
            # there is no socket to write a terminal line to, and a
            # disconnect is not a server error — swallow it here so it
            # neither attempts a second response through _error(500) nor
            # inflates the /status/health server-error counters
            log.info(
                "progressive client disconnected mid-stream: %s",
                type(e).__name__,
            )
        except Exception as e:  # fault-ok: status already sent; emit a terminal error line
            log.error(
                "progressive stream failed: %s", type(e).__name__,
                exc_info=True,
            )
            try:
                self._write_chunk(
                    json.dumps(
                        {
                            "error": "progressive stream failed; see "
                            "server logs",
                            "errorClass": type(e).__name__,
                            "final": True,
                        }
                    ).encode()
                    + b"\n"
                )
            except OSError:
                pass  # dead socket: the log line above is the record
        finally:
            # the terminal 0-chunk is DEFERRED to do_POST, past the
            # query_trace exit: the client's read() completes only on
            # that chunk, so the finished trace is guaranteed to be in
            # the ring before the client can ask /druid/v2/trace for it
            self._pending_chunked_finish = 200

    def _sql_query(self, body: dict, qctx: dict):
        sql = body.get("query")
        if not sql:
            return self._error(400, 'body must be {"query": "SELECT ..."}')
        # priority lanes: SQL classifies from its planned rewrite (via
        # the plan cache, so repeated dashboard statements pay planning
        # once); anything unplannable gates interactive
        serve = getattr(self.ctx, "serve", None)
        lane_name = serve.lane_for_sql(sql) if serve is not None else None
        if lane_name is not None:
            from .obs.prof import note_lane

            note_lane(lane_name)
        if lane_name is not None and not self._acquire_lane(lane_name):
            return None
        res = self._resilience()
        try:
            if not self._admit(res):
                return None
            try:
                if qctx.get("progressive"):
                    # progressive SQL: chunked NDJSON refinements, the
                    # native route's line protocol; shapes that cannot
                    # stream answer buffered
                    gen = self.ctx.sql_progressive(sql)
                    if gen is not None:
                        return self._stream_refinements(gen, _rows)
                df = self.ctx.sql(sql)
                self._send(
                    200, _rows(df), headers=self._partial_headers()
                )
            finally:
                if res is not None:
                    res.admission.release()
        finally:
            self._release_lane(lane_name)


class _OlapHTTPServer(ThreadingHTTPServer):
    # the stdlib listen backlog is 5: a burst of concurrent dashboard
    # connections (the workload the serving core exists for) overflows
    # it, the kernel drops the SYN, and the client retries after ~1 s —
    # a full second of invisible latency the handler never sees.  128
    # accommodates hammer-scale connection bursts.
    request_queue_size = 128


class OlapServer:
    """Threaded HTTP server over one TPUOlapContext.

    Queries run on handler threads: their host work (decoding, planning,
    the response) runs side by side, their device work one query at a
    time under the engine's execution lock, and concurrent compatible
    queries can share one fused execution (`fusion_window_ms`).  The
    context's engine runs on CUDA unless it was built with
    `device="cpu"`.  Bind `port=0` for a free port (`.port` reads it).
    """

    def __init__(self, ctx, host: str = "127.0.0.1", port: int = 8082):
        handler = type("BoundHandler", (_Handler,), {"ctx": ctx})
        self.httpd = _OlapHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "OlapServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
