"""One dispatch per query scope (`exec/arena.py`) on the CPU, against the
JAX reference's arena.

On the CPU there is no CUDA graph: an arena program calls the captured
body eagerly, so these cases hold what does not need the card (the card
tests in `test_torch_cuda.py` hold the capture itself):

* parity: the same seeded SSB and TPC-H segments through the reference
  `Engine` (arena on, its default) and the port's (arena on): frames equal
  (keys and counts exact, float aggregates within rtol 1e-6); the port's
  first (eager), second (program built) and third (program run) frames and
  its arena-off frame bit-identical;
* dispatch: a scope's first execution runs a pass per segment, later ones
  one program run covering every segment;
* declines, each recorded in `QueryMetrics.declines`: sketch aggregations,
  the sparse tier, the scatter strategy, a scope above
  ARENA_BUDGET_FRACTION of the residency budget, the session flag and the
  per-query opt-out;
* keys and invalidation: a compacted lowering's kept sets are part of the
  key; eviction of any column of a scope, and `clear_cache`, drop its
  program and its warm mark; the program cache is count-bounded; a
  lowering rebuilt between a scope's first and second execution is the
  one its program runs; a replay keeps the scope's columns recent in the
  residency cache, so a replayed scope outlives a colder one;
* grouping sets go through `Engine.execute_groupby_batch`: every set is
  dispatched before any is fetched, and the frames equal serial runs bit
  for bit.
"""

import dataclasses

import pandas as pd
import pytest
from test_torch_engine import CASES, assert_frames_match, to_reference

from spark_druid_olap_tpu.catalog import segment as jseg
from spark_druid_olap_tpu.exec.engine import Engine as JaxEngine
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu.workloads import tpch as jtpch
from spark_druid_olap_tpu_torch.api import TPUOlapContext, grouping_set_queries
from spark_druid_olap_tpu_torch.catalog.segment import datasource_from_numpy, datasource_to_numpy
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.exec import arena
from spark_druid_olap_tpu_torch.exec.engine import Engine
from spark_druid_olap_tpu_torch.exec.metrics import QueryMetrics
from spark_druid_olap_tpu_torch.exec.pipeline import column_key
from spark_druid_olap_tpu_torch.models import aggregations as A
from spark_druid_olap_tpu_torch.models.filters import And, Selector
from spark_druid_olap_tpu_torch.workloads import ssb

MULTI = [c for c in CASES if c[1] in ("q1_1", "q2_1", "q3_2", "q4_1", "q1", "timeseries", "topn")]


def card_priced(eng: Engine) -> Engine:
    """`eng` pricing with the card's constants (the class defaults): the
    adaptive tier's compacted pass takes the kernel's class, as on a card,
    so the arena captures it (the CPU profile would take the scatter,
    which it declines)."""
    eng.cost_config = SessionConfig()
    return eng


@pytest.fixture(scope="module")
def datasources():
    """Reference datasources of a few segments each and the port's copies
    of the very same segments."""
    cols, dicts = jssb.flat_columns(jssb.gen_tables(0.005, seed=7))
    ssb_ds = jseg.build_datasource(
        "lineorder", cols, jssb.FLAT_DIMS, jssb.FLAT_METRICS,
        time_col="lo_orderdate", rows_per_segment=4096, dicts=dicts,
    )
    cols, dicts = jtpch.flat_columns(jtpch.gen_tables(0.002))
    tpch_ds = jseg.build_datasource(
        "lineitem", cols, jtpch.FLAT_DIMS, jtpch.FLAT_METRICS,
        time_col="l_shipdate", rows_per_segment=4096, dicts=dicts,
    )
    ref = {"ssb": ssb_ds, "tpch": tpch_ds}
    return ref, {k: datasource_from_numpy(datasource_to_numpy(v)) for k, v in ref.items()}


def _exact(a, b):
    pd.testing.assert_frame_equal(a.reset_index(drop=True), b.reset_index(drop=True),
                                  check_exact=True)


def _arena_declines(m):
    return [d for d in m.declines if d.startswith("arena:")]


@pytest.mark.parametrize("workload,name,spec", MULTI, ids=[c[1] for c in MULTI])
def test_arena_matches_reference_and_the_loop(datasources, workload, name, spec):
    ref, port = datasources
    want = JaxEngine().execute(to_reference(spec), ref[workload])
    eng = card_priced(Engine(device="cpu"))
    runs = []
    for _ in range(3):
        runs.append(eng.execute(spec, port[workload]))
    m = eng.last_metrics
    assert m.segments > 1 and not _arena_declines(m), m.describe()
    assert (m.dispatch_count, m.arena_segments, m.graph_replays) == (1, m.segments, 0)
    with arena.arena_disabled():
        off = eng.execute(spec, port[workload])
    for got in runs:
        _exact(got, off)
    assert_frames_match(runs[-1], want)


@pytest.mark.parametrize("kind", ["filter", "interval", "filtered_agg"])
def test_filtered_and_interval_scopes_stay_identical(datasources, kind):
    _, port = datasources
    q = ssb.NATIVE_QUERIES["q4_1"]
    ds = port["ssb"]
    lo, hi = ds.interval()
    if kind == "filter":
        q = dataclasses.replace(q, filter=Selector("c_region", "ASIA"))
    elif kind == "interval":
        q = dataclasses.replace(q, intervals=((lo, (lo + hi) // 2),))
    else:
        q = dataclasses.replace(q, aggregations=q.aggregations + (
            A.FilteredAgg(Selector("s_region", "ASIA"), A.DoubleMax("mx", "lo_revenue")),))
    on, off = Engine(device="cpu"), Engine(device="cpu")
    with arena.arena_disabled():
        want = off.execute(q, ds)
    for _ in range(3):
        _exact(on.execute(q, ds), want)
    assert on.last_metrics.dispatch_count == 1


def test_dispatch_count_collapses_to_one(datasources):
    _, port = datasources
    eng = Engine(device="cpu")
    q, ds = ssb.NATIVE_QUERIES["q4_1"], port["ssb"]
    counts = []
    for _ in range(3):
        eng.execute(q, ds)
        counts.append((eng.last_metrics.dispatch_count, eng.last_metrics.arena_segments))
    n = eng.last_metrics.segments
    assert n > 1 and counts == [(n, 0), (1, n), (1, n)]
    assert len(eng._arena.keys()) == 1 and arena.is_arena_key(eng._arena.keys()[0])


def _theta_query():
    q = ssb.NATIVE_QUERIES["q4_1"]
    return dataclasses.replace(q, aggregations=q.aggregations + (
        A.ThetaSketch("th", "lo_custkey", size=4096),))


@pytest.mark.parametrize("case,want", [
    ("sketch", "arena: sketch aggregations are not captured"),
    ("sparse", "arena: the sparse tier answered (its ladders read counts per pass)"),
    ("segment", "arena: the scatter strategy's nonzero has a data-dependent size"),
    ("budget", "arena: the scope's"),
    ("session_flag", "arena: arena_execution is off"),
    ("query_optout", "arena: disabled for this query"),
])
def test_declines_are_recorded(datasources, case, want):
    _, port = datasources
    ds = port["ssb"]
    q = {"sketch": _theta_query(), "sparse": ssb.NATIVE_QUERIES["q3_2"]}.get(
        case, ssb.NATIVE_QUERIES["q4_1"])
    eng = Engine(device="cpu", strategy={"sparse": "sparse", "segment": "segment"}.get(case, "auto"))
    if case == "budget":
        eng._device_cache.budget_bytes = 1 << 16  # every scope is above half of it
    if case == "session_flag":
        eng.configure_pipeline(SessionConfig(arena_execution=False))
    for _ in range(3):
        if case == "query_optout":
            with arena.arena_disabled():
                got = eng.execute(q, ds)
        else:
            got = eng.execute(q, ds)
        m = eng.last_metrics
        declined = _arena_declines(m)
        assert len(declined) == 1 and declined[0].startswith(want), m.describe()
        assert m.arena_segments == 0 and m.dispatch_count >= m.segments > 0
    assert eng._arena.keys() == []
    with arena.arena_disabled():
        _exact(got, Engine(device="cpu", strategy=eng.strategy).execute(q, ds))


def test_plan_covers_the_scope_under_the_budget_fraction(datasources):
    _, port = datasources
    ds = port["ssb"]
    eng = Engine(device="cpu")
    q = ssb.NATIVE_QUERIES["q4_1"]
    low = eng._lowering_for(q, ds)
    segs = list(ds.segments)
    m = QueryMetrics()
    plan = arena.plan_for(eng, low, segs, "dense", (), ds, m)
    assert plan is not None and m.declines == [] and len(plan.segs) == len(segs)
    assert len(plan.col_keys) == len(segs) * (len(low.columns) + 1)
    eng._device_cache.budget_bytes = int(plan.nbytes / arena.ARENA_BUDGET_FRACTION)
    assert arena.plan_for(eng, low, segs, "dense", (), ds, m) is not None
    eng._device_cache.budget_bytes -= 2
    assert arena.plan_for(eng, low, segs, "dense", (), ds, m) is None
    assert len(m.declines) == 1 and m.declines[0].startswith("arena: the scope's")
    # the key: the query, the strategy, the compacted domain, the scope
    other = arena.plan_for(eng, low, segs[:2], "dense", ("adaptive", b"x"), ds, QueryMetrics())
    assert other.key[:3] == plan.key[:3] and other.key[3:] != plan.key[3:]


def test_session_flag_wires_through_the_context(datasources):
    _, port = datasources
    assert TPUOlapContext(SessionConfig(arena_execution=False), device="cpu").engine.arena_execution is False
    ctx = TPUOlapContext(device="cpu")
    ctx.register_datasource(port["ssb"], star_schema=ssb.STAR_SCHEMA)
    assert ctx.engine.arena_execution is True
    sql = ssb.QUERIES["q4_1"]
    on = [ctx.sql(sql) for _ in range(3)]
    assert ctx.last_metrics.arena_segments == ctx.last_metrics.segments
    ctx.sql("SET arena_execution = false")
    assert ctx.engine.arena_execution is False
    off = ctx.sql(sql)
    assert _arena_declines(ctx.last_metrics) == ["arena: arena_execution is off"]
    for f in on:
        _exact(f, off)


@pytest.mark.parametrize("how", ["pop", "budget", "clear_cache"])
def test_invalidation_drops_the_program_and_its_warm_mark(datasources, how):
    _, port = datasources
    ds = port["ssb"]
    q = ssb.NATIVE_QUERIES["q4_1"]
    eng = Engine(device="cpu")
    want = eng.execute(q, ds)
    eng.execute(q, ds)
    (key,) = eng._arena.keys()
    prog = eng._arena.get(key)
    if how == "pop":
        eng._device_cache.pop(prog.plan.col_keys[-1])
    elif how == "budget":  # another scope's columns push this one's out
        budget = eng._device_cache.budget_bytes
        eng._device_cache.budget_bytes = eng.bytes_resident()
        eng.execute(ssb.NATIVE_QUERIES["q1_1"], ds)
        eng._device_cache.budget_bytes = budget
    else:
        eng.clear_cache()
    assert key not in eng._arena.keys() and not eng._arena.is_warm(key)
    _exact(eng.execute(q, ds), want)
    m = eng.last_metrics
    assert (m.dispatch_count, m.arena_segments) == (m.segments, 0)  # eager again
    _exact(eng.execute(q, ds), want)
    assert eng.last_metrics.arena_segments == m.segments


def _scope(q, segs, a: int, b: int):
    """`q` over segments a..b: an interval's end is its successor's start,
    so the range starts just past segment a's start."""
    return dataclasses.replace(q, intervals=((segs[a].interval[0] + 1, segs[b].interval[1]),))


def test_a_rebuilt_lowering_is_the_one_the_program_runs(datasources):
    """The lowering cache drops the scope's lowering between its first
    (eager) and second execution: the second builds the program over the
    rebuilt lowering (on a card its capture warms that lowering's
    constants first), with the same bits, and the third runs it."""
    _, port = datasources
    ds = port["ssb"]
    q = ssb.NATIVE_QUERIES["q4_1"]
    eng = Engine(device="cpu")
    want = eng.execute(q, ds)
    (first,) = [eng._lowering_cache.get(k) for k in list(eng._lowering_cache._od)]
    eng._lowering_cache.clear()
    for _ in range(2):
        _exact(eng.execute(q, ds), want)
        m = eng.last_metrics
        assert (m.dispatch_count, m.arena_segments) == (1, m.segments)
    (key,) = eng._arena.keys()
    (rebuilt,) = [eng._lowering_cache.get(k) for k in list(eng._lowering_cache._od)]
    assert eng._arena.get(key).plan.lowering is rebuilt and rebuilt is not first


def test_a_replayed_scope_outlives_a_colder_one(datasources):
    """A replay reads its columns through the graph, not the residency
    cache, and still marks them recently used: when a new scope needs
    room, the scope read longest ago goes, not the one replayed last."""
    _, port = datasources
    ds = port["ssb"]
    segs = ds.segments
    q = ssb.NATIVE_QUERIES["q4_1"]
    hot, other, new = (_scope(q, segs, a, a + 1) for a in (0, 2, 4))
    eng = Engine(device="cpu")
    want = eng.execute(hot, ds)
    eng.execute(hot, ds)  # the program is built
    (key,) = eng._arena.keys()
    eng.execute(other, ds)
    eng.execute(hot, ds)  # a replay, after `other` read its columns
    assert eng.last_metrics.arena_segments == 2
    eng._device_cache.budget_bytes = eng.bytes_resident() + 1  # full
    eng.execute(new, ds)
    assert key in eng._arena.keys()
    assert all(k in eng._device_cache for k in eng._arena.get(key).plan.col_keys)
    assert not any(column_key(s) in eng._device_cache for s in segs[2:4])
    _exact(eng.execute(hot, ds), want)
    assert eng.last_metrics.arena_segments == 2


def test_program_cache_is_count_bounded(datasources):
    _, port = datasources
    ds = port["ssb"]
    eng = Engine(device="cpu")
    eng._arena = arena.ArenaCache(entries=2)
    names = ["q1_1", "q1_2", "q4_1"]
    for name in names:
        for _ in range(2):
            eng.execute(ssb.NATIVE_QUERIES[name], ds)
    assert len(eng._arena.keys()) == 2
    eng.execute(ssb.NATIVE_QUERIES["q1_1"], ds)  # its program was dropped: eager
    assert eng.last_metrics.arena_segments == 0


def test_compacted_programs_are_keyed_by_their_kept_sets(datasources):
    """Two filters of one grouping give two kept sets: each replays only
    its own program, and both equal the loop."""
    _, port = datasources
    ds = port["ssb"]
    eng = card_priced(Engine(device="cpu"))
    base = ssb.NATIVE_QUERIES["q3_2"]
    for nation in ("UNITED STATES", "CHINA"):
        q = dataclasses.replace(base, intervals=(), filter=And(
            (Selector("c_nation", nation), Selector("s_nation", nation))))
        with arena.arena_disabled():
            want = card_priced(Engine(device="cpu")).execute(q, ds)
        for _ in range(3):
            _exact(eng.execute(q, ds), want)
        m = eng.last_metrics
        assert (m.strategy, m.inner_strategy, m.arena_segments) == ("adaptive", "dense", m.segments)
    extras = {k[3] for k in eng._arena.keys()}
    assert len(extras) == 2 and all(e[0] == "adaptive" for e in extras)


def test_grouping_sets_dispatch_every_set_before_fetching(datasources):
    _, port = datasources
    # the card's constants (the class defaults): the sets plan the kernel's
    # class, as the serial engine runs them
    ctx = TPUOlapContext(SessionConfig(), device="cpu")
    ctx.register_datasource(port["ssb"], star_schema=ssb.STAR_SCHEMA)
    events = []
    eng = ctx.engine
    dispatch, fetch = eng._dispatch_groupby_once, eng._host_state
    eng._dispatch_groupby_once = lambda *a: (events.append("dispatch"), dispatch(*a))[1]
    eng._host_state = lambda la, st: (events.append("fetch"), fetch(la, st))[1]
    sql = ("SELECT c_region, s_region, d_year, sum(lo_revenue) AS revenue "
           "FROM lineorder GROUP BY CUBE (c_region, s_region, d_year)")
    got = ctx.sql(sql)
    assert events == ["dispatch"] * 8 + ["fetch"] * 8
    del eng._dispatch_groupby_once, eng._host_state
    rw = ctx.plan_sql(sql)
    subs = grouping_set_queries(rw.query, rw.grouping_sets)
    with arena.arena_disabled():
        serial = [Engine(device="cpu").execute(q, port["ssb"]) for q in subs]
    for a, b in zip(eng.execute_groupby_batch(subs, port["ssb"]), serial):
        _exact(a, b)
    assert len(got) == sum(len(f) for f in serial)
