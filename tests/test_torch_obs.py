"""Observability of the PyTorch port (`spark_druid_olap_tpu_torch/obs/`),
against the JAX reference's `obs/` on the CPU.

* Span traces: the same SQL query (arena off, result cache off, one
  segment per query) gives both packages the same span-name tree; the
  query_id reaches `QueryMetrics.query_id`; the tracer's overhead is
  counted in clock calls; the ring, the slow-query log and the OTLP export
  behave as the reference's.
* Cost receipts: the reference's keys, plus `device_timing`; a sampled
  query's dispatch spans carry their device time, an unsampled one adds no
  sync (`obs.prof.SYNCS` does not move).
* Metrics: every Prometheus family the port records has the reference's
  name and label set, after the same workload in both packages.
"""

import json
import logging

import pytest

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu import obs as jobs
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu_torch import obs as tobs
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.obs import prof as tprof
from spark_druid_olap_tpu_torch.workloads import ssb as tssb

from test_torch_sql import reference_config

QUERIES = ["q1_1", "q1_2", "q4_1"]  # G <= 4096: the same path in both packages


@pytest.fixture(scope="module", autouse=True)
def _forget_reference_profile():
    """The reference's workload profiler is process-wide: drop the queries
    this module added, so a later file's profile window (`GET
    /status/profile`) holds its own."""
    yield
    from spark_druid_olap_tpu.obs import prof as jprof

    jprof.workload_profiler()._entries.clear()



@pytest.fixture(scope="module")
def ctxs():
    """(reference, port) contexts over the same SSB scale-0.01 tables, one
    segment each, arena and result cache off: the layers both packages
    run the same way."""
    tables = jssb.gen_tables(scale=0.01, seed=11)
    ref = sd.TPUOlapContext(reference_config())
    jssb.register(ref, tables=tables, rows_per_segment=1 << 20)
    port = TPUOlapContext(device="cpu")
    tssb.register(port, tables=tables, rows_per_segment=1 << 20)
    for c in (ref, port):
        c.sql("SET arena_execution = false")
        c.sql("SET result_cache_entries = 0")
    return ref, port


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


@pytest.mark.parametrize("name", QUERIES)
def test_span_trees_equal_the_reference(ctxs, name):
    ref, port = ctxs
    ref.sql(jssb.QUERIES[name])
    port.sql(tssb.QUERIES[name])
    want = ref.tracer.last_trace_dict()
    got = port.tracer.last_trace_dict()
    assert _names(got["spans"]) == _names(want["spans"])
    assert got["query_type"] == want["query_type"] == "sql"
    assert port.last_metrics.query_id == got["query_id"]
    assert port.tracer.ring.get(got["query_id"]) is not None


def test_receipt_keys_equal_the_reference(ctxs):
    ref, port = ctxs
    want = ref.sql(jssb.QUERIES["q1_1"]).attrs["receipt"]
    got = port.sql(tssb.QUERIES["q1_1"]).attrs["receipt"]
    assert set(got) == set(want) | {"device_timing"}
    assert set(got["cache"]) == set(want["cache"])
    assert got["sampled"] is False and got["syncs"] == 0
    assert got["device_timing"] == "span"
    assert port.last_metrics.receipt["query_id"] == got["query_id"]


def test_sampled_query_times_its_dispatches(ctxs):
    _, port = ctxs
    before = tprof.SYNCS
    port.sql(tssb.QUERIES["q4_1"])
    assert tprof.SYNCS == before  # the default rate adds no sync
    port.tracer.force_sample_next()
    df = port.sql(tssb.QUERIES["q4_1"])
    rc = df.attrs["receipt"]
    assert rc["sampled"] is True
    disp = [s for s in _walk(port.tracer.last_trace_dict()["spans"])
            if s["name"] == "segment_dispatch"]
    assert disp and all(s["attrs"]["timing"] == "host" for s in disp)
    assert all(s["attrs"]["device_ms"] >= 0 for s in disp)
    # on the CPU there are no events to wait on: still no sync
    assert tprof.SYNCS == before and rc["syncs"] == 0


def _walk(node):
    yield node
    for c in node.get("children", ()):
        yield from _walk(c)


class _Clock:
    def __init__(self):
        self.calls = 0

    def __call__(self):
        self.calls += 1
        return self.calls * 1e-3


@pytest.mark.parametrize("pkg", [jobs, tobs], ids=["reference", "port"])
def test_tracer_costs_two_clock_reads_a_span(pkg):
    clock = _Clock()
    tracer = pkg.Tracer(clock=clock, capacity=2)
    with tracer.query_trace(query_id="a", query_type="sql"):
        start = clock.calls
        for _ in range(10):
            with pkg.span(pkg.SPAN_PLAN):
                pass
        assert clock.calls - start == 20
    with pkg.span(pkg.SPAN_PLAN):  # no trace: no clock read
        pass
    for qid in ("b", "c"):
        with tracer.query_trace(query_id=qid):
            pass
    assert tracer.ring.ids() == ["b", "c"] and tracer.ring.get("a") is None


@pytest.mark.parametrize("sampled", [False, True], ids=["unsampled", "sampled"])
def test_dispatch_sync_equals_the_reference(sampled):
    """`prof.dispatch_sync` on the CPU: the result back untouched; on a
    sampled query one counted sync and the span split into `enqueue_ms`
    and `device_ms`, as the reference splits it; unsampled nothing."""
    import jax.numpy as jnp
    import torch

    from spark_druid_olap_tpu.obs import prof as jprof

    seen = []
    for pkg, prof, result in ((jobs, jprof, jnp.arange(4)), (tobs, tprof, torch.arange(4))):
        tracer = pkg.Tracer()
        if sampled:
            tracer.force_sample_next()
        with tracer.query_trace(query_id="q", query_type="native"):
            with pkg.span(pkg.SPAN_SEGMENT_DISPATCH):
                args = (result, 0.0) if prof is jprof else (result, 0.0, torch.device("cpu"))
                assert prof.dispatch_sync(*args) is result
        doc = tracer.last_trace_dict()
        attrs = next(c for c in _walk(doc["spans"]) if c["name"] == "segment_dispatch").get("attrs", {})
        seen.append((sorted(k for k in attrs if k in ("enqueue_ms", "device_ms")),
                     doc["receipt"]["syncs"]))
    assert seen[0] == seen[1]
    assert seen[1] == ((["device_ms", "enqueue_ms"], 1) if sampled else ([], 0))


def test_tracers_render_the_same_document():
    docs = []
    for pkg in (jobs, tobs):
        tracer = pkg.Tracer(clock=_Clock())
        with tracer.query_trace(query_id="q", query_type="native"):
            with pkg.span(pkg.SPAN_EXECUTE, segments=3):
                pkg.span_event("breaker_state", state="closed")
                with pkg.span(pkg.SPAN_SEGMENT_DISPATCH):
                    pass
        doc = tracer.last_trace_dict()
        docs.append({k: doc[k] for k in ("query_id", "query_type", "total_ms", "spans")})
    assert docs[0] == docs[1]


def test_slow_query_log_and_otlp_export(tmp_path, caplog):
    path = tmp_path / "spans.jsonl"
    tracer = tobs.Tracer(otlp_path=str(path))
    with caplog.at_level(logging.WARNING, logger="spark_druid_olap_tpu_torch.obs.trace"):
        with tracer.query_trace(query_id="slow", slow_ms=1e-9):
            with tobs.span(tobs.SPAN_PLAN):
                pass
    assert any("slow query slow" in r.getMessage() for r in caplog.records)
    line = json.loads(path.read_text().strip())
    spans = line["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert [s["name"] for s in spans] == ["query", "plan"]
    assert spans[1]["parentSpanId"] == spans[0]["spanId"]


@pytest.mark.parametrize("rate,fired", [(0.0, 0), (0.25, 2), (1.0, 8)])
def test_rate_sampler_matches_the_reference(rate, fired):
    got = tprof.RateSampler(rate)
    want = jobs.prof.RateSampler(rate)
    seq = [got.take() for _ in range(8)]
    assert seq == [want.take() for _ in range(8)] and sum(seq) == fired


def _families(text):
    """{family: {label-name sets}} of a Prometheus text exposition."""
    hists = {ln.split()[2] for ln in text.splitlines()
             if ln.startswith("# TYPE ") and ln.endswith(" histogram")}
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, _, labels = line.split(" ", 1)[0].partition("{")
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in hists:
                name = name[: -len(suffix)]
        keys = frozenset(kv.split("=", 1)[0] for kv in labels.rstrip("}").split(",") if kv)
        out.setdefault(name, set()).add(keys - {"le"})
    return out


def test_metric_families_equal_the_reference(ctxs):
    ref, port = ctxs
    for c, w in ((ref, jssb), (port, tssb)):
        c.sql(w.QUERIES["q3_1"])
        c.sql("SELECT c_region, q FROM (SELECT c_region, sum(lo_quantity) AS q "
              "FROM lineorder GROUP BY c_region) t WHERE q > 0")  # the host fallback
    got = _families(tobs.get_registry().render_prometheus())
    want = _families(jobs.get_registry().render_prometheus())
    assert {"sdol_queries_total", "sdol_query_phase_ms", "sdol_rows_scanned_total"} <= set(got)
    # a family the reference has not recorded in this process (another
    # test's workload) must still be one the reference's code names
    import pathlib

    src = "".join(p.read_text() for p in pathlib.Path(sd.__file__).parent.rglob("*.py"))
    missing = sorted(n for n in set(got) - set(want) if f'"{n}"' not in src)
    assert not missing, missing
    for name, labels in got.items():
        if name in want:
            assert labels <= want[name], name
    text = tobs.get_registry().render_prometheus().splitlines()
    q = [ln for ln in text if ln.startswith('sdol_queries_total{query_type="fallback"')]
    assert q and float(q[0].rsplit(" ", 1)[1]) >= 1
    resident = [ln for ln in text if ln.startswith('sdol_resident_bytes{datasource="lineorder"}')]
    assert resident and float(resident[0].rsplit(" ", 1)[1]) > 0


def test_stream_producer_thread_sees_no_trace():
    import threading

    seen = []
    with tobs.Tracer().query_trace(query_id="outer"):
        t = threading.Thread(target=lambda: seen.append(tobs.current_query_id()))
        t.start()
        t.join()
        assert tobs.current_query_id() == "outer"
    assert seen == [""]


@pytest.mark.parametrize("sql,fallback", [
    (tssb.QUERIES["q1_1"], False),
    ("SELECT c_region, q FROM (SELECT c_region, sum(lo_quantity) AS q "
     "FROM lineorder GROUP BY c_region) t WHERE q > 0", True),
], ids=["device", "fallback"])
def test_explain_analyze_sections_equal_the_reference(ctxs, sql, fallback):
    ref, port = ctxs
    want_df, want = ref.explain_analyze(sql)
    got_df, got = port.explain_analyze(sql)

    def sections(text):
        return [ln for ln in text.splitlines() if ln.startswith("== ")]

    assert sections(got) == sections(want)
    assert ("== Host Fallback ==" in got) == fallback
    assert got.split("== Span Tree ==")[1].split()[0] == "query"
    assert list(got_df.columns) == list(want_df.columns) and len(got_df) == len(want_df)
