"""The HTTP server of the PyTorch port (`spark_druid_olap_tpu_torch/server.py`)
against the JAX reference's, both on CPU contexts over the same SSB and
TPC-H (lineitem) scale-0.01 data, each bound to port 0 and shut down in the
fixture's `finally`; every request has a 30 s timeout.

* Responses: the same request bodies (native Druid JSON and SQL) give equal
  status codes and Druid response shapes; keys and counts exact, floats
  within rtol 1e-6.
* Errors: equal structured error objects for 400 and 404; 503 with
  Retry-After when admission is full, and per lane while the other lane
  admits; 504 on an expired deadline; 200 with the partial coverage header
  under `partialResults`; 500 leaks nothing internal.  The cluster's
  scatter route answers a body without a query as the reference's does
  (`test_torch_cluster.py` holds it); the ingest route acknowledges as the
  reference's does (`test_torch_ingest.py` holds it).
* Observability: `X-Druid-Query-Id` echoes `context.queryId`, the trace is
  served with the reference's span-name tree, `/status/metrics` counts the
  requests, `/status` and `/status/health` carry the reference's keys.
* Serving: result-cache hits, the degraded native route while the device
  breaker is open, progressive NDJSON, and six concurrent clients whose
  answers all equal the serial ones, fusion on.
"""

import concurrent.futures
import json
import math
import urllib.error
import urllib.request

import pytest

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu import resilience as jres
from spark_druid_olap_tpu.server import OlapServer as RefServer
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu.workloads import tpch as jtpch
from spark_druid_olap_tpu_torch import resilience as tres
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.server import OlapServer
from spark_druid_olap_tpu_torch.workloads import ssb as tssb
from spark_druid_olap_tpu_torch.workloads import tpch as ttpch

from test_torch_sql import reference_config

RTOL = 1e-6
TIMEOUT_S = 30

NATIVE = {
    "q1_1": tssb.NATIVE_QUERIES["q1_1"].to_druid(),
    "q4_1": tssb.NATIVE_QUERIES["q4_1"].to_druid(),
    "timeseries": tssb.TIMESERIES_QUERY.to_druid(),
    "topn": tssb.TOPN_QUERY.to_druid(),
    "tpch_q1": ttpch.NATIVE_QUERIES["q1"].to_druid(),
    "scan": {"queryType": "scan", "dataSource": "lineorder",
             "columns": ["lo_orderdate", "lo_revenue", "c_city"],
             "filter": {"type": "selector", "dimension": "c_region", "value": "ASIA"},
             "intervals": ["1992-01-01/1999-01-01"], "limit": 50},
    "search": {"queryType": "search", "dataSource": "lineorder",
               "searchDimensions": ["c_city"], "query": {"type": "contains", "value": "united"},
               "intervals": ["1992-01-01/1999-01-01"]},
    "time_boundary": {"queryType": "timeBoundary", "dataSource": "lineorder"},
}
SQL = {
    "q1_1": tssb.QUERIES["q1_1"],
    "q3_2": tssb.QUERIES["q3_2"],
    "tpch_q1": ttpch.QUERIES["q1"],
    "scan": "SELECT lo_revenue, c_city FROM lineorder WHERE c_region = 'ASIA' LIMIT 20",
}


@pytest.fixture(scope="module", autouse=True)
def _forget_reference_profile():
    """The reference's workload profiler is process-wide: drop the queries
    this module added, so a later file's profile window (`GET
    /status/profile`) holds its own."""
    yield
    from spark_druid_olap_tpu.obs import prof as jprof

    jprof.workload_profiler()._entries.clear()


def _register(ctx, ssb, tpch, st, tt):
    ssb.register(ctx, tables=st, rows_per_segment=16384)
    cols, dicts = tpch.flat_columns(tt)
    ctx.register_table("lineitem", cols, dimensions=tpch.FLAT_DIMS,
                       metrics=tpch.FLAT_METRICS, time_column="l_shipdate",
                       dicts=dicts, rows_per_segment=16384)
    return ctx


@pytest.fixture(scope="module")
def servers():
    """(reference URL, port URL, reference context, port context): the
    result cache off in both, so every request executes."""
    st, tt = jssb.gen_tables(scale=0.01, seed=11), jtpch.gen_tables(scale=0.01)
    ref = _register(sd.TPUOlapContext(reference_config()), jssb, jtpch, st, tt)
    port = _register(TPUOlapContext(SessionConfig(result_cache_entries=0), device="cpu"),
                     tssb, ttpch, st, tt)
    ref.sql("SET result_cache_entries = 0")
    rsrv = RefServer(ref, port=0).start()
    try:
        psrv = OlapServer(port, port=0).start()
        try:
            yield (f"http://127.0.0.1:{rsrv.port}", f"http://127.0.0.1:{psrv.port}", ref, port)
        finally:
            psrv.shutdown()
    finally:
        rsrv.shutdown()


def _call(base, path, body=None, raw=None):
    """(status, headers, decoded body) of one request."""
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            status, headers, payload = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, headers, payload = e.code, dict(e.headers), e.read()
    ctype = headers.get("Content-Type", "")
    if "ndjson" in ctype:
        return status, headers, [json.loads(x) for x in payload.splitlines() if x]
    if "json" in ctype:
        return status, headers, json.loads(payload)
    return status, headers, payload.decode()


def _canon(x):
    """Lists of objects sorted on their non-float content, so group order
    does not matter where the query sets none."""
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, list):
        items = [_canon(v) for v in x]
        if items and all(isinstance(v, dict) for v in items):
            items.sort(key=lambda v: json.dumps(_keys_only(v), sort_keys=True))
        return items
    return x


def _keys_only(x):
    if isinstance(x, dict):
        return {k: _keys_only(v) for k, v in x.items() if not isinstance(v, float)}
    if isinstance(x, list):
        return [_keys_only(v) for v in x]
    return x


def _close(got, want, path="$"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), (path, got, want)
        assert math.isclose(got, want, rel_tol=RTOL, abs_tol=1e-9), (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("route,name", [("native", n) for n in NATIVE] + [("sql", n) for n in SQL])
def test_responses_equal_the_reference(servers, route, name):
    rbase, pbase, _, _ = servers
    path, body = (("/druid/v2", NATIVE[name]) if route == "native"
                  else ("/druid/v2/sql", {"query": SQL[name]}))
    rs, _, rbody = _call(rbase, path, body)
    ps, ph, pbody = _call(pbase, path, body)
    assert ps == rs == 200, (pbody, rbody)
    _close(_canon(pbody), _canon(rbody))
    assert ph["X-Druid-Query-Id"]


ERRORS = {
    "bad_json": ("/druid/v2", None, b"{not json"),
    "not_an_object": ("/druid/v2", None, b"[1, 2]"),
    "no_sql": ("/druid/v2/sql", {"context": {}}, None),
    "unknown_type": ("/druid/v2", {"queryType": "nope", "dataSource": "lineorder"}, None),
    "unknown_datasource": ("/druid/v2", dict(NATIVE["timeseries"], dataSource="nope"), None),
    "unknown_route": ("/druid/v3", {"query": "x"}, None),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_errors_equal_the_reference(servers, name):
    rbase, pbase, _, _ = servers
    path, body, raw = ERRORS[name]
    rs, _, rbody = _call(rbase, path, body, raw)
    ps, _, pbody = _call(pbase, path, body, raw)
    assert ps == rs and ps in (400, 404), (ps, rs, pbody, rbody)
    assert set(pbody) == set(rbody) == {"error", "errorMessage", "errorClass"}
    assert pbody["errorClass"] == rbody["errorClass"]


@pytest.mark.parametrize("path", ["/druid/v2/trace/none", "/druid/v2/datasources/none", "/nope"])
def test_get_404s_equal_the_reference(servers, path):
    rbase, pbase, _, _ = servers
    (rs, _, rbody), (ps, _, pbody) = _call(rbase, path), _call(pbase, path)
    assert ps == rs == 404 and set(pbody) == set(rbody)


def test_unported_routes_answer_501(servers):
    rbase, pbase, _, _ = servers
    # the cluster's scatter route is ported: a body without a native query
    # is a 400, as the reference's (tests/test_torch_cluster.py holds it)
    path = "/druid/v2/cluster/partial"
    (rs, _, rbody), (ps, _, pbody) = _call(rbase, path, {"rows": []}), _call(pbase, path, {"rows": []})
    assert ps == rs == 400 and pbody["errorClass"] == rbody["errorClass"] == "BadQueryException"
    # the ingest route is ported: an empty append acknowledges as the
    # reference's does (tests/test_torch_ingest.py holds the route)
    path = "/druid/v2/ingest/lineorder"
    (rs, _, rbody), (ps, _, pbody) = _call(rbase, path, {"rows": []}), _call(pbase, path, {"rows": []})
    assert ps == rs == 200 and pbody["appended"] == rbody["appended"] == 0


def test_admission_and_lanes_answer_503_with_retry_after(servers):
    rbase, pbase, ref, port = servers
    body = {"query": SQL["q1_1"]}
    for base, ctx in ((rbase, ref), (pbase, port)):
        adm = ctx.resilience.admission
        adm.queue_timeout_ms = 50
        held = [adm.acquire() for _ in range(adm.max_concurrent)]
        try:
            status, headers, err = _call(base, "/druid/v2/sql", body)
        finally:
            for _ in held:
                adm.release()
            adm.queue_timeout_ms = 2000
        assert status == 503 and int(headers["Retry-After"]) >= 1, err
        assert err["errorClass"] == "QueryCapacityExceededException"
        heavy = ctx.resilience.lane("heavy")
        heavy.queue_timeout_ms = 50
        held = [heavy.acquire() for _ in range(heavy.max_concurrent)]
        ctx.config.lane_heavy_rows = 1000
        try:
            status, headers, err = _call(base, "/druid/v2", NATIVE["scan"])
            assert status == 503 and "heavy lane" in err["error"]
            assert int(headers["Retry-After"]) >= 1
            assert _call(base, "/druid/v2", NATIVE["topn"])[0] == 200  # interactive
        finally:
            for _ in held:
                heavy.release()
            heavy.queue_timeout_ms = 2000
            ctx.config.lane_heavy_rows = 4 << 20


@pytest.mark.parametrize("partial", [False, True])
def test_deadlines_answer_504_or_partial_like_the_reference(servers, partial):
    rbase, pbase, _, _ = servers
    body = dict(NATIVE["q4_1"], context={"timeout": 60000, "partialResults": partial})
    out = []
    # the reference checkpoints once per two segments on the CPU, the port
    # once per segment: skip=1 there is skip=2 here
    for base, res, skip in ((rbase, jres, 1), (pbase, tres, 2)):
        res.injector().arm("engine.segment_loop", error_type=res.InjectedDeadline,
                           times=1, skip=skip)
        try:
            out.append(_call(base, "/druid/v2", body))
        finally:
            res.injector().disarm()
    (rs, rh, rbody), (ps, ph, pbody) = out
    assert ps == rs == (200 if partial else 504), (pbody, rbody)
    if partial:
        rctx = json.loads(ph["X-Druid-Response-Context"])
        want = json.loads(rh["X-Druid-Response-Context"])
        assert rctx["partial"] is True and rctx["coverage"] == want["coverage"] < 1
        _close(_canon(pbody), _canon(rbody))
    else:
        assert pbody["errorClass"] == rbody["errorClass"] == "QueryTimeoutException"


def test_a_500_leaks_nothing(servers):
    _, pbase, _, _ = servers
    tres.injector().arm("device_dispatch", error_type=ValueError, times=1)
    try:
        status, _, body = _call(pbase, "/druid/v2", NATIVE["q1_1"])
    finally:
        tres.injector().disarm()
    assert status == 500 and body["error"] == "query execution failed; see server logs"
    assert body["errorClass"] == "ValueError"


def test_query_id_trace_and_status(servers):
    rbase, pbase, ref, port = servers
    ref.sql("SET arena_execution = false")
    port.sql("SET arena_execution = false")
    try:
        trees = []
        for base in (rbase, pbase):
            body = dict(NATIVE["q1_1"], context={"queryId": "trace-me"})
            status, headers, _ = _call(base, "/druid/v2", body)
            assert status == 200 and headers["X-Druid-Query-Id"] == "trace-me"
            status, _, doc = _call(base, "/druid/v2/trace/trace-me")
            assert status == 200 and doc["query_id"] == "trace-me" and "receipt" in doc
            trees.append(_names(doc["spans"]))
    finally:
        ref.sql("SET arena_execution = true")
        port.sql("SET arena_execution = true")
    assert trees[1] == trees[0]
    keys = []
    for base in (rbase, pbase):
        st, _, doc = _call(base, "/status")
        hs, _, health = _call(base, "/status/health")
        ds, _, names = _call(base, "/druid/v2/datasources")
        one, _, meta = _call(base, "/druid/v2/datasources/lineorder")
        assert st == hs == ds == one == 200
        keys.append((set(doc), set(health), names, meta))
    assert keys[1][0] == keys[0][0]
    assert keys[1][1] <= keys[0][1] and {"breakers", "admission", "lanes"} <= keys[1][1]
    assert keys[1][2] == keys[0][2] and keys[1][3] == keys[0][3]
    assert _call(pbase, "/status/profile")[2]["queries_observed"] >= 1


def _names(node):
    """The span-name tree, with repeated siblings of one name collapsed (a
    loop's per-segment or per-batch spans) and without `h2d`: the reference
    opens it around every residency lookup, the port only around a copy."""
    kids = []
    for c in node.get("children", ()):
        if c["name"] == "h2d":
            continue
        t = _names(c)
        if not kids or kids[-1] != t:
            kids.append(t)
    return (node["name"], tuple(kids))


def _requests_ok(base):
    text = _call(base, "/status/metrics")[2]
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith("sdol_http_requests_total{")
               and 'route="/druid/v2"' in ln and 'code="200"' in ln)


def test_metrics_count_the_requests(servers):
    _, pbase, _, _ = servers
    before = _requests_ok(pbase)
    for _ in range(3):
        assert _call(pbase, "/druid/v2", NATIVE["topn"])[0] == 200
    assert _requests_ok(pbase) == before + 3


def test_result_cache_hits_over_http(servers):
    rbase, pbase, ref, port = servers
    for base, ctx in ((rbase, ref), (pbase, port)):
        ctx.sql("SET result_cache_entries = 64")
        try:
            first = _call(base, "/druid/v2", NATIVE["q4_1"])
            second = _call(base, "/druid/v2", NATIVE["q4_1"])
            assert ctx.last_metrics.strategy == "result-cache"
        finally:
            ctx.sql("SET result_cache_entries = 0")
        assert first[0] == second[0] == 200 and first[2] == second[2]


def test_degraded_native_route_matches_the_reference(servers):
    rbase, pbase, ref, port = servers
    out = []
    for base, ctx in ((rbase, ref), (pbase, port)):
        br = ctx.resilience.breaker_for("device")
        for _ in range(br.failure_threshold):
            br.record_failure()
        try:
            out.append(_call(base, "/druid/v2", NATIVE["q4_1"]))
        finally:
            br.record_success()
        assert ctx.last_metrics.degraded
    (rs, _, rbody), (ps, _, pbody) = out
    assert ps == rs == 200
    _close(_canon(pbody), _canon(rbody))


def test_progressive_refinements_end_in_the_buffered_answer(servers):
    _, pbase, _, _ = servers
    buffered = _call(pbase, "/druid/v2", NATIVE["q4_1"])[2]
    status, headers, lines = _call(pbase, "/druid/v2",
                                   dict(NATIVE["q4_1"], context={"progressive": True}))
    assert status == 200 and "ndjson" in headers["Content-Type"]
    assert [ln["sequence"] for ln in lines] == list(range(len(lines)))
    assert lines[-1]["final"] and lines[-1]["result"] == buffered and "receipt" in lines[-1]
    status, _, lines = _call(pbase, "/druid/v2/sql",
                             {"query": SQL["q1_1"], "context": {"progressive": True}})
    assert status == 200 and lines[-1]["final"]
    assert lines[-1]["result"] == _call(pbase, "/druid/v2/sql", {"query": SQL["q1_1"]})[2]


def test_concurrent_clients_get_the_serial_answers(servers):
    _, pbase, _, port = servers
    reqs = [("/druid/v2", NATIVE[n]) for n in ("q1_1", "q4_1", "timeseries", "topn", "tpch_q1")]
    reqs += [("/druid/v2/sql", {"query": SQL[n]}) for n in ("q1_1", "tpch_q1")]
    want = [_call(pbase, p, b)[2] for p, b in reqs]
    port.sql("SET fusion_window_ms = 2")
    try:
        with concurrent.futures.ThreadPoolExecutor(6) as pool:
            futs = [(i, pool.submit(_call, pbase, *reqs[i]))
                    for k in range(6) for i in ((k + j) % len(reqs) for j in range(len(reqs)))]
            for i, f in futs:
                status, _, body = f.result(timeout=120)
                assert status == 200 and body == want[i], reqs[i][1]
    finally:
        port.sql("SET fusion_window_ms = 0")
