"""Deadline-bounded partial answers of the PyTorch port against the JAX
reference's, on the CPU, under injected deadlines (`InjectedDeadline` armed
at a loop's checkpoint site with `skip=K`): no assertion reads the clock.

Cadence: on the CPU the reference dispatches two segments a batch and
checkpoints once per batch; the port checkpoints once per segment.  So the
reference's `skip=K` is compared with the port's `skip=2K` at the group-by
loops (the main path, the tiers, the progressive loop), where both stop on
the same segment boundary.  Scan, Search, the stream and the fallback's
decode checkpoint once per segment or chunk in both.

At each matched boundary: the same coverage and rows seen, frames within
rtol 1e-6, the partial flag below the full scope.  Inside the port: the
chunked arena replays give the loop's bits at every K; a truncated stream
has joined its producer and freed its staging ring; `partial_results =
false` raises instead; and `sql_progressive`'s last refinement is `sql`'s
frame.
"""

import dataclasses

import pandas as pd
import pytest
from test_torch_engine import assert_frames_match, to_reference
from test_torch_sparse import HIGH_G, _engines
from test_torch_sql import reference_config

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu import resilience as jres
from spark_druid_olap_tpu.exec import streaming as jstreaming
from spark_druid_olap_tpu.models import wire as jwire
from spark_druid_olap_tpu.utils import datagen as jdatagen
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu.workloads import tpch as jtpch
from spark_druid_olap_tpu_torch import resilience as tres
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.exec import pipeline as tpipeline
from spark_druid_olap_tpu_torch.exec import streaming as tstreaming
from spark_druid_olap_tpu_torch.exec.engine import Engine
from spark_druid_olap_tpu_torch.models import wire as twire
from spark_druid_olap_tpu_torch.utils import datagen
from spark_druid_olap_tpu_torch.workloads import ssb as tssb
from spark_druid_olap_tpu_torch.workloads import tpch as ttpch

RTOL = 1e-6
Q41 = tssb.QUERIES["q4_1"]


@pytest.fixture(autouse=True)
def _disarm():
    jres.injector().disarm()
    tres.injector().disarm()
    yield
    jres.injector().disarm()
    tres.injector().disarm()


def _deadline_at(site, ref_skip, port_skip):
    """Arms an injected deadline at `site` in both packages."""
    jres.injector().arm(site, error_type=jres.InjectedDeadline, skip=ref_skip, times=1)
    tres.injector().arm(site, error_type=tres.InjectedDeadline, skip=port_skip, times=1)


def _assert_same_partial(got, want):
    for key in ("partial", "coverage", "rows_seen", "rows_total", "site"):
        assert got.attrs.get(key) == want.attrs.get(key), key
    assert_frames_match(got, want, RTOL)


@pytest.fixture(scope="module")
def ssb_ctxs():
    tables = jssb.gen_tables(scale=0.01, seed=11)
    ref = sd.TPUOlapContext(dataclasses.replace(reference_config(), result_cache_entries=0))
    jssb.register(ref, tables=tables, rows_per_segment=4096)
    port = TPUOlapContext(SessionConfig(result_cache_entries=0), device="cpu")
    tssb.register(port, tables=tables, rows_per_segment=4096)
    return ref, port


# -- the main path -------------------------------------------------------------------


@pytest.mark.parametrize("arena_on", [True, False], ids=["arena", "loop"])
@pytest.mark.parametrize("k", [0, 1, 3, 7])
def test_main_path_sweep_matches_reference(ssb_ctxs, k, arena_on):
    ref, port = ssb_ctxs
    port.sql(f"SET arena_execution = {str(arena_on).lower()}")
    try:
        full = port.sql(Q41)
        port.sql(Q41)  # the scope is warm: the armed run replays in chunks
        _deadline_at("engine.segment_loop", k, 2 * k)
        want, got = ref.sql(Q41), port.sql(Q41)
        _assert_same_partial(got, want)
        m = port.last_metrics
        segs = m.segments
        assert got.attrs["partial"] and m.partial and m.coverage == got.attrs["coverage"]
        assert got.attrs["segments_seen"] == 2 * k < segs
        if arena_on:
            assert m.arena_segments == 2 * k and m.dispatch_count == 2 * k
        # the loop's bits: the same truncation with the arena off
        with_loop = _port_loop_run(port, "engine.segment_loop", 2 * k)
        pd.testing.assert_frame_equal(got, with_loop, check_exact=True)
        # unarmed, the same scope answers completely, the whole-scope bits
        pd.testing.assert_frame_equal(port.sql(Q41), full, check_exact=True)
        assert not port.last_metrics.partial
    finally:
        port.sql("SET arena_execution = true")


def _port_loop_run(port, site, skip):
    from spark_druid_olap_tpu_torch.exec.arena import arena_disabled

    tres.injector().arm(site, error_type=tres.InjectedDeadline, skip=skip, times=1)
    with arena_disabled():
        return port.sql(Q41)


def test_chunked_replays_run_every_segment_when_nothing_expires(ssb_ctxs):
    _, port = ssb_ctxs
    full = port.sql(Q41)
    port.sql(Q41)
    tres.injector().arm("engine.segment_loop", error_type=tres.InjectedDeadline, skip=10_000)
    got = port.sql(Q41)
    m = port.last_metrics
    assert m.arena_segments == m.segments == m.dispatch_count and not m.partial
    assert not got.attrs.get("partial")
    pd.testing.assert_frame_equal(got, full, check_exact=True)


def test_partial_results_off_raises(ssb_ctxs):
    ref, port = ssb_ctxs
    for ctx in (ref, port):
        ctx.sql("SET partial_results = false")
    try:
        _deadline_at("engine.segment_loop", 1, 2)
        with pytest.raises(jres.DeadlineExceeded):
            ref.sql(Q41)
        with pytest.raises(tres.DeadlineExceeded):
            port.sql(Q41)
        assert port.last_metrics.deadline_exceeded and not port.last_metrics.partial
    finally:
        for ctx in (ref, port):
            ctx.sql("SET partial_results = true")


def test_deadline_at_resolve_drains_a_complete_answer(ssb_ctxs):
    ref, port = ssb_ctxs
    full = port.sql(Q41)
    _deadline_at("engine.resolve", 0, 0)
    want, got = ref.sql(Q41), port.sql(Q41)
    assert not got.attrs.get("partial") and not want.attrs.get("partial")
    pd.testing.assert_frame_equal(got, full, check_exact=True)


# -- the high-cardinality tiers ----------------------------------------------------------


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("strategy,site", [("adaptive", "engine.segment_loop"),
                                           ("sparse", "sparse.segment_loop")])
@pytest.mark.parametrize("name", HIGH_G["ssb"][3:5])
def test_tier_sweep_matches_reference(ssb_ctxs, name, strategy, site, k):
    ref, port = ssb_ctxs
    jrw, trw = ref.plan_sql(tssb.QUERIES[name]), port.plan_sql(tssb.QUERIES[name])
    jds, tds = ref.catalog.get(jrw.datasource), port.catalog.get(trw.datasource)
    je, te = _engines(strategy)
    _deadline_at(site, k, 2 * k)
    with jres.partial_scope(True) as jpc:
        want = je.execute(jrw.query, jds)
    with tres.partial_scope(True) as tpc:
        got = te.execute(trw.query, tds)
    assert te.last_metrics.strategy == je.last_metrics.strategy
    assert tpc.triggered and jpc.triggered
    assert tpc.coverage() == pytest.approx(jpc.coverage(), abs=1e-12)
    assert tpc.rows_seen == jpc.rows_seen and tpc.is_partial == jpc.is_partial
    assert_frames_match(got, want, RTOL)


def test_adaptive_presence_deadline_declines_for_this_run_only(ssb_ctxs):
    ref, port = ssb_ctxs
    trw = port.plan_sql(tssb.QUERIES["q3_1"])
    tds = port.catalog.get(trw.datasource)
    te = Engine(device="cpu", strategy="adaptive")
    tres.injector().arm("adaptive.presence_loop", error_type=tres.InjectedDeadline, times=1)
    with tres.partial_scope(True) as pc:
        got = te.execute(trw.query, tds)
    assert pc.is_partial and pc.coverage() == 0.0 and len(got) == 0
    assert "adaptive: the deadline expired in the presence pass" in te.last_metrics.declines
    assert not te._adaptive_declined  # not memoized: the next run is adaptive
    te.execute(trw.query, tds)
    assert te.last_metrics.strategy == "adaptive"


# -- Scan and Search -------------------------------------------------------------------

SCAN = {"queryType": "scan", "dataSource": "lineorder",
        "columns": ["c_nation", "lo_revenue", "lo_discount"],
        "filter": {"type": "bound", "dimension": "lo_discount", "lower": "8",
                   "ordering": "numeric"}}
ORDERED_SCAN = dict(SCAN, orderBy=[{"columnName": "lo_revenue", "order": "descending"}],
                    limit=25)
SEARCH = {"queryType": "search", "dataSource": "lineorder",
          "searchDimensions": ["c_region", "s_nation"],
          "query": {"type": "insensitive_contains", "value": "a"}}


@pytest.mark.parametrize("k", [0, 2, 5])
@pytest.mark.parametrize("name,body,site", [
    ("scan", SCAN, "engine.scan_loop"),
    ("ordered_scan", ORDERED_SCAN, "engine.scan_loop"),
    ("search", SEARCH, "engine.search_loop"),
])
def test_scan_and_search_sweep_match_reference(ssb_ctxs, name, body, site, k):
    ref, port = ssb_ctxs
    jq, tq = jwire.query_from_druid(dict(body)), twire.query_from_druid(dict(body))
    _deadline_at(site, k, k)
    with jres.partial_scope(True) as jpc:
        want = ref.engine.execute(jq, ref.catalog.get("lineorder"))
    with tres.partial_scope(True) as tpc:
        got = port.engine.execute(tq, port.catalog.get("lineorder"))
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert tpc.to_dict() == {key: v for key, v in jpc.to_dict().items() if key in tpc.to_dict()}
    assert tpc.is_partial and port.last_metrics.partial
    assert port.last_metrics.segments == k


# -- grouping sets ---------------------------------------------------------------------


@pytest.mark.parametrize("k", [0, 2])
def test_cube_per_set_coverage_matches_reference(ssb_ctxs, k):
    ref, port = ssb_ctxs
    sql = tssb.SKETCH_QUERIES["cube_hll"]
    _deadline_at("engine.segment_loop", k, 2 * k)
    want, got = ref.sql(sql), port.sql(sql)
    assert got.attrs["partial"] and want.attrs["partial"]
    assert got.attrs["coverage"] == want.attrs["coverage"]
    keys = ("set", "coverage", "segments_seen", "segments_total", "rows_seen", "rows_total")
    assert ([{x: r[x] for x in keys} for r in got.attrs["sets"]]
            == [{x: r[x] for x in keys} for r in want.attrs["sets"]])
    assert len(got.attrs["sets"]) == 8
    assert_frames_match(got, want, RTOL)


# -- the stream ----------------------------------------------------------------------

CHUNK = 4096


@pytest.fixture(scope="module")
def stream_inputs():
    chunks = [datagen.gen_event_chunk(i, CHUNK) for i in range(6)]
    return chunks, datagen.event_stream_schema(), jdatagen.event_stream_schema()


@pytest.mark.parametrize("double_buffer", [True, False])
@pytest.mark.parametrize("k", [0, 3])
def test_stream_truncation_matches_reference_and_joins_producer(stream_inputs, k,
                                                                double_buffer, monkeypatch):
    from spark_druid_olap_tpu_torch.models.aggregations import Count, DoubleMax, DoubleSum
    from spark_druid_olap_tpu_torch.models.dimensions import DimensionSpec
    from spark_druid_olap_tpu_torch.models.query import GroupByQuery

    chunks, schema, jschema = stream_inputs
    q = GroupByQuery(datasource="events", dimensions=(DimensionSpec("site", "site"),),
                     aggregations=(Count("n"), DoubleSum("v", "value"),
                                   DoubleMax("hi", "latency")))
    jex = jstreaming.StreamExecutor()
    tex = tstreaming.StreamExecutor(engine=Engine(device="cpu"), double_buffer=double_buffer)
    rings = []

    class Ring(tpipeline.StagingRing):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rings.append(self)

    monkeypatch.setattr(tstreaming, "StagingRing", Ring)
    threads_before = _producer_threads()
    _deadline_at("streaming.chunk_loop", k, k)
    with jres.partial_scope(True) as jpc:
        want = jex.execute(to_reference(q), jschema, iter(chunks), CHUNK)
    with tres.partial_scope(True) as tpc:
        got = tex.execute(q, schema, iter(chunks), CHUNK)
    assert_frames_match(got, want, RTOL)
    assert tpc.is_partial == jpc.is_partial is True
    assert tpc.coverage() is None and jpc.coverage() is None
    assert tpc.rows_seen == jpc.rows_seen == k * CHUNK
    assert tex.stats.truncated and tex.stats.chunks == k
    assert tex.stats.producer_joined
    assert rings and all(r.buffers == [] for r in rings)  # the ring was freed
    assert _producer_threads() <= threads_before


def _producer_threads():
    import threading

    return sum(1 for t in threading.enumerate() if t.daemon and t.is_alive())


def test_stream_producer_that_does_not_stop_raises(stream_inputs, monkeypatch):
    """A producer still alive after the join would write into a freed slot:
    the stream raises instead of going on."""
    import threading

    chunks, schema, _ = stream_inputs
    from spark_druid_olap_tpu_torch.models.aggregations import Count
    from spark_druid_olap_tpu_torch.models.query import GroupByQuery

    q = GroupByQuery(datasource="events", dimensions=(), aggregations=(Count("n"),))
    tex = tstreaming.StreamExecutor(engine=Engine(device="cpu"))
    monkeypatch.setattr(threading.Thread, "is_alive", lambda self: True)
    tres.injector().arm("streaming.chunk_loop", error_type=tres.InjectedDeadline, skip=1,
                        times=1)
    with tres.partial_scope(True), pytest.raises(RuntimeError, match="did not stop"):
        tex.execute(q, schema, iter(chunks), CHUNK)


# -- the host fallback -------------------------------------------------------------------

DERIVED = ("SELECT l_returnflag, q, n FROM (SELECT l_returnflag, sum(l_quantity) AS q, "
           "count(*) AS n FROM lineitem GROUP BY l_returnflag) t WHERE n > 0 "
           "ORDER BY l_returnflag")


@pytest.fixture(scope="module")
def tpch_tables():
    return jtpch.gen_tables(scale=0.004)


def _tpch_ctxs(tables):
    """Fresh contexts (fresh segment uids: a cold decode cache)."""
    ref = sd.TPUOlapContext(dataclasses.replace(reference_config(), result_cache_entries=0))
    jtpch.register(ref, tables=tables, rows_per_segment=4096)
    port = TPUOlapContext(SessionConfig(result_cache_entries=0), device="cpu")
    ttpch.register(port, tables=tables, rows_per_segment=4096)
    return ref, port


@pytest.mark.parametrize("k", [0, 1, 3])
def test_fallback_decode_sweep_matches_reference(tpch_tables, k):
    ref, port = _tpch_ctxs(tpch_tables)
    _deadline_at("fallback.decode", k, k)
    want, got = ref.sql(DERIVED), port.sql(DERIVED)
    _assert_same_partial(got, want)
    m = port.last_metrics
    assert m.executor == "fallback" and m.partial and got.attrs["segments_seen"] == k


@pytest.mark.parametrize("skip", [0, 2])
def test_fallback_drain_rerun_matches_reference(tpch_tables, skip):
    ref, port = _tpch_ctxs(tpch_tables)
    _deadline_at("fallback.interp", skip, skip)
    want, got = ref.sql(DERIVED), port.sql(DERIVED)
    for key in ("partial", "coverage", "rows_seen"):
        assert got.attrs.get(key) == want.attrs.get(key), key
    assert_frames_match(got, want, RTOL)
    assert port.resilience.breaker_for("fallback").state == "closed"


IN_SUBQUERY = ("SELECT l_returnflag, sum(l_quantity) AS q FROM lineitem WHERE l_orderkey IN "
               "(SELECT l_orderkey FROM lineitem GROUP BY l_orderkey "
               "HAVING sum(l_quantity) > 150.0) GROUP BY l_returnflag ORDER BY l_returnflag")


@pytest.mark.parametrize("skip,plans", [(1, 2), (4, 1)], ids=["in_subquery", "after_it"])
def test_fallback_drain_takes_answered_subqueries(tpch_tables, monkeypatch, skip, plans):
    """A drain takes the subqueries its first run answered (`drain_memo`),
    their collector counts added again: the reference's partial attrs and
    frame, which reruns them; an expiry inside the subquery computes it
    again in the drain."""
    from spark_druid_olap_tpu_torch.exec import fallback as tfallback

    ref, port = _tpch_ctxs(tpch_tables)
    built = []
    inner_plan = tfallback._inner_plan
    monkeypatch.setattr(tfallback, "_inner_plan",
                        lambda *a: (built.append(1), inner_plan(*a))[1])
    _deadline_at("fallback.interp", skip, skip)
    want, got = ref.sql(IN_SUBQUERY), port.sql(IN_SUBQUERY)
    _assert_same_partial(got, want)
    assert got.attrs["partial"] and len(built) == plans


# -- progressive execution -------------------------------------------------------------


def test_sql_progressive_last_refinement_is_sql(ssb_ctxs):
    ref, port = ssb_ctxs
    final = port.sql(Q41)
    steps = list(port.sql_progressive(Q41))
    segs = port.last_metrics.segments
    assert len(steps) == segs
    assert [info["sequence"] for _, info in steps] == list(range(segs))
    last, info = steps[-1]
    assert info["final"] and info["coverage"] == 1.0 and not info["partial"]
    pd.testing.assert_frame_equal(last, final, check_exact=True)
    assert "arena: progressive (each refinement fetches; nothing to capture)" in (
        port.last_metrics.declines)
    ref_last = list(ref.sql_progressive(Q41))[-1][0]
    assert_frames_match(last, ref_last, RTOL)
    # coverage rises with every refinement
    covs = [info["coverage"] for _, info in steps]
    assert covs == sorted(covs)


@pytest.mark.parametrize("k", [1, 3])
def test_sql_progressive_under_deadline_matches_reference(ssb_ctxs, k):
    ref, port = ssb_ctxs
    _deadline_at("engine.progressive_loop", k, 2 * k)
    # the reference's generator arms no collector of its own (its server
    # does); the port's arms the session's, which an outer scope overrides
    with jres.partial_scope(True):
        want = list(ref.sql_progressive(Q41))
    with tres.partial_scope(True):
        got = list(port.sql_progressive(Q41))
    (wdf, winfo), (gdf, ginfo) = want[-1], got[-1]
    assert ginfo["partial"] and winfo["partial"] and ginfo["final"]
    for key in ("coverage", "rows_seen", "rows_total"):
        assert ginfo[key] == pytest.approx(winfo[key]), key
    assert_frames_match(gdf, wdf, RTOL)
    assert len(got) == 2 * k + 1
