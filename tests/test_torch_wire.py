"""Druid wire JSON through the PyTorch port, against the JAX reference.

* Decode parity: for every request body of `test_wire_goldens.py`, every
  native spec of `test_wire_fallback.py`, a set of bodies that reaches every
  decoder (aggregators, post-aggregators, extractions, filters, having,
  limitSpec, subtotalsSpec, virtualColumns, every query type), and
  `q.to_druid()` of every planned SSB and TPC-H query, the port's
  `query_from_druid(body).to_druid()` equals the reference's.  Malformed
  bodies raise WireError in the port; the reference raises the ValueError
  its server reports as WireError.
* Goldens without HTTP: the four-row dataset of `test_wire_goldens.py`, each
  golden's request decoded, run through the port's engine and its
  `druid_result_shape`, equals `tests/goldens/*.json` byte for byte.
* A wire `subtotalsSpec` runs through `execute_grouping_sets` as the
  reference's server runs it, with the reference's frame.
* The wire fallback: `execute_native_degraded` gives the reference's frame
  (values and dtypes; both run on the host) on the parity specs of
  `test_wire_fallback.py`, and both raise WireFallbackUnsupported on the
  shapes outside the interpreter's coverage.
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu.exec.wire_fallback import (
    WireFallbackUnsupported as RefUnsupported,
)
from spark_druid_olap_tpu.models import wire as jwire
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu.workloads import tpch as jtpch
from spark_druid_olap_tpu_torch.api import TPUOlapContext, execute_grouping_sets
from spark_druid_olap_tpu_torch.exec.wire_fallback import WireFallbackUnsupported
from spark_druid_olap_tpu_torch.models import wire as twire
from spark_druid_olap_tpu_torch.plan.planner import RewriteError

from test_wire_fallback import _GROUPBY, _TIMESERIES, _TOPN, _make_ctx

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
IV = ["2021-01-01T00:00:00.000Z/2021-01-03T00:00:00.000Z"]
AGG = [{"type": "doubleSum", "name": "rev", "fieldName": "v"}]
DAY = 86_400_000

# the request bodies of tests/test_wire_goldens.py, by golden file
GOLDEN_BODIES = {
    "groupby.json": {
        "queryType": "groupBy", "dataSource": "g", "dimensions": ["city"],
        "granularity": "all", "aggregations": AGG, "intervals": IV,
    },
    "timeseries.json": {
        "queryType": "timeseries", "dataSource": "g", "granularity": "day",
        "aggregations": AGG, "intervals": IV,
    },
    "topn.json": {
        "queryType": "topN", "dataSource": "g", "dimension": "city",
        "metric": "rev", "threshold": 2, "granularity": "all",
        "aggregations": AGG, "intervals": IV,
    },
    "scan_compacted.json": {
        "queryType": "scan", "dataSource": "g", "columns": ["city", "v"],
        "intervals": IV, "resultFormat": "compactedList",
    },
    "search.json": {
        "queryType": "search", "dataSource": "g", "searchDimensions": ["city"],
        "query": {"type": "insensitive_contains", "value": "s"}, "intervals": IV,
    },
}

_EV_IV = ["1970-01-01T00:00:00Z/1970-01-08T00:00:00Z"]

# the native specs of tests/test_wire_fallback.py besides its three module
# constants: query-level granularity, the scan ordered by time, the bare
# time dimension, and the extraction dimension the interpreter refuses
FALLBACK_SPECS = {
    "groupBy": _GROUPBY,
    "topN": _TOPN,
    "timeseries": _TIMESERIES,
    "granularity_groupBy": {
        "queryType": "groupBy", "dataSource": "ev", "granularity": "day",
        "dimensions": ["city"],
        "aggregations": [{"type": "count", "name": "n"},
                         {"type": "doubleSum", "name": "s", "fieldName": "v"}],
        "intervals": _EV_IV,
    },
    "granularity_topN": {
        "queryType": "topN", "dataSource": "ev", "granularity": "day",
        "dimension": "city", "metric": "s", "threshold": 2,
        "aggregations": [{"type": "doubleSum", "name": "s", "fieldName": "v"}],
        "intervals": _EV_IV,
    },
    "scan_order_by_time": {
        "queryType": "scan", "dataSource": "ev", "columns": ["__time", "city", "v"],
        "intervals": ["1970-01-01T00:00:00Z/1970-01-15T00:00:00Z"],
        "order": "ascending", "limit": 7,
    },
    "bare_time_dimension": {
        "queryType": "groupBy", "dataSource": "ev", "granularity": "all",
        "dimensions": ["city", {"type": "default", "dimension": "__time",
                                "outputName": "t"}],
        "aggregations": [{"type": "count", "name": "n"}],
        "intervals": ["1970-01-01T00:00:00Z/1970-01-15T00:00:00Z"],
    },
}
_EXTRACTION = dict(_GROUPBY, dimensions=[{
    "type": "extraction", "dimension": "city", "outputName": "c0",
    "extractionFn": {"type": "substring", "index": 0, "length": 1},
}])


def _gb(**kw):
    return {"queryType": "groupBy", "dataSource": "ev", "granularity": "all",
            "dimensions": ["city"], "aggregations": [{"type": "count", "name": "n"}],
            **kw}


# bodies that reach every decoder of models/wire.py
SURFACE_BODIES = {
    "aggregators": _gb(aggregations=[
        {"type": "count", "name": "n"},
        {"type": "longSum", "name": "ls", "fieldName": "v"},
        {"type": "floatSum", "name": "fs", "fieldName": "v"},
        {"type": "longMin", "name": "lmin", "fieldName": "v"},
        {"type": "floatMin", "name": "fmin", "fieldName": "v"},
        {"type": "doubleMax", "name": "dmax", "fieldName": "v"},
        {"type": "floatMax", "name": "fmax", "fieldName": "v"},
        {"type": "hyperUnique", "name": "hu", "fieldName": "tier", "precision": 12},
        {"type": "cardinality", "name": "card", "fields": ["city", "tier"],
         "byRow": True},
        {"type": "thetaSketch", "name": "th", "fieldName": "tier", "size": 1024},
        {"type": "quantilesDoublesSketch", "name": "qs", "fieldName": "v", "k": 128},
        {"type": "dimCodeMax", "name": "dcm", "fieldName": "tier"},
        {"type": "javascript", "name": "js", "expression": "v * (1 - v / 100)",
         "base": "doubleMax"},
    ]),
    "post_aggregators": _gb(
        aggregations=[
            {"type": "doubleSum", "name": "s", "fieldName": "v"},
            {"type": "count", "name": "n"},
            {"type": "hyperUnique", "name": "hu", "fieldName": "tier"},
            {"type": "thetaSketch", "name": "ta", "fieldName": "tier"},
            {"type": "thetaSketch", "name": "tb", "fieldName": "city"},
            {"type": "quantilesDoublesSketch", "name": "qs", "fieldName": "v"},
        ],
        postAggregations=[
            {"type": "arithmetic", "name": "avg", "fn": "/", "fields": [
                {"type": "fieldAccess", "fieldName": "s"},
                {"type": "arithmetic", "name": "inner", "fn": "+", "fields": [
                    {"type": "fieldAccess", "name": "nn", "fieldName": "n"},
                    {"type": "constant", "name": "one", "value": 1}]}]},
            {"type": "hyperUniqueCardinality", "name": "hc", "fieldName": "hu"},
            {"type": "thetaSketchEstimate", "name": "te",
             "field": {"type": "fieldAccess", "fieldName": "ta"}},
            {"type": "thetaSketchEstimate", "name": "tu", "field": {
                "type": "thetaSketchSetOp", "func": "INTERSECT",
                "fields": [{"type": "fieldAccess", "fieldName": "ta"},
                           {"type": "fieldAccess", "fieldName": "tb"}]}},
            {"type": "quantilesDoublesSketchToQuantile", "name": "p90",
             "field": {"type": "fieldAccess", "fieldName": "qs"}, "fraction": 0.9},
            {"type": "expression", "name": "ratio", "expression": "s / (n + 1)"},
        ]),
    "extractions": _gb(dimensions=[
        "tier",
        {"type": "default", "dimension": "city", "outputName": "c"},
        {"type": "extraction", "dimension": "city", "outputName": "sub",
         "extractionFn": {"type": "substring", "index": 1}},
        {"type": "extraction", "dimension": "city", "outputName": "up",
         "extractionFn": {"type": "upper"}},
        {"type": "extraction", "dimension": "city", "outputName": "lo",
         "extractionFn": {"type": "lower"}},
        {"type": "extraction", "dimension": "city", "outputName": "re",
         "extractionFn": {"type": "regex", "expr": "([A-Z])", "index": 1}},
        {"type": "extraction", "dimension": "city", "outputName": "lk",
         "extractionFn": {"type": "lookup", "name": "l1", "retainMissingValue": True,
                          "lookup": {"type": "map", "map": {"NY": "east", "SF": "west"}}}},
        {"type": "extraction", "dimension": "city", "outputName": "fmt",
         "extractionFn": {"type": "stringFormat", "format": "city %s (100%%)"}},
        {"type": "extraction", "dimension": "city", "outputName": "len",
         "extractionFn": {"type": "strlen"}},
        {"type": "extraction", "dimension": "city", "outputName": "cas",
         "extractionFn": {"type": "cascade", "extractionFns": [
             {"type": "lower"}, {"type": "substring", "index": 0, "length": 1}]}},
        {"type": "extraction", "dimension": "__time", "outputName": "yr",
         "extractionFn": {"type": "timeFormat", "format": "%Y"}},
        {"type": "extraction", "dimension": "__time", "outputName": "ym",
         "extractionFn": {"type": "timeFormat", "format": "%Y-%m",
                          "granularity": "month"}},
    ]),
    "filters": _gb(filter={"type": "and", "fields": [
        {"type": "selector", "dimension": "city", "value": "NY"},
        {"type": "selector", "dimension": "tier", "value": None},
        {"type": "in", "dimension": "tier", "values": ["gold", None]},
        {"type": "bound", "dimension": "v", "lower": "10", "upper": "90",
         "lowerStrict": True, "ordering": "numeric"},
        {"type": "regex", "dimension": "city", "pattern": "^N"},
        {"type": "like", "dimension": "city", "pattern": "N%"},
        {"type": "or", "fields": [
            {"type": "search", "dimension": "city",
             "query": {"type": "insensitive_contains", "value": "y"}},
            {"type": "search", "dimension": "tier",
             "query": {"type": "contains", "value": "o.l", "caseSensitive": False}},
        ]},
        {"type": "not", "field": {"type": "interval", "dimension": "__time",
                                  "intervals": _EV_IV}},
        {"type": "expression", "expression": "v * 2 > 10"},
        {"type": "columnComparison", "dimensions": ["city", "tier"]},
    ]}),
    "having_limit_subtotals": _gb(
        dimensions=["city", "tier"],
        aggregations=[{"type": "doubleSum", "name": "s", "fieldName": "v"},
                      {"type": "count", "name": "n"}],
        having={"type": "and", "havingSpecs": [
            {"type": "greaterThan", "aggregation": "n", "value": 1},
            {"type": "or", "havingSpecs": [
                {"type": "lessThan", "aggregation": "s", "value": 1e6},
                {"type": "not", "havingSpec": {
                    "type": "equalTo", "aggregation": "n", "value": 3}}]}]},
        limitSpec={"type": "default", "limit": 5, "offset": 2, "columns": [
            "city", {"dimension": "s", "direction": "descending"}]},
        subtotalsSpec=[["city", "tier"], ["city"], []],
        virtualColumns=[
            {"type": "expression", "name": "w", "expression": "v * 2",
             "outputType": "DOUBLE"},
            {"type": "expression", "name": "k", "expression": "v + 1",
             "outputType": "LONG"}],
        intervals=["-146136543-09-08T08:23:32.096Z/146140482-04-24T15:36:27.903Z"],
        dataSource={"type": "table", "name": "ev"},
        granularity={"type": "period", "period": "P1D"}),
    "topn_inverted": {
        "queryType": "topN", "dataSource": "ev", "dimension": "city",
        "metric": {"type": "inverted", "metric": "s"}, "threshold": 2,
        "aggregations": [{"type": "doubleSum", "name": "s", "fieldName": "v"}],
        "granularity": {"type": "all"},
    },
    "topn_dimension_desc": {
        "queryType": "topN", "dataSource": "ev", "dimension": "city",
        "metric": {"type": "inverted", "metric": {"type": "dimension"}},
        "threshold": 3, "aggregations": [{"type": "count", "name": "n"}],
    },
    "topn_dimension_asc": {
        "queryType": "topN", "dataSource": "ev", "dimension": "city",
        "metric": {"type": "lexicographic"}, "threshold": 3,
        "aggregations": [{"type": "count", "name": "n"}],
    },
    "timeseries_context": {
        "queryType": "timeseries", "dataSource": "ev", "granularity": "hour",
        "descending": True, "aggregations": [{"type": "count", "name": "n"}],
        "intervals": ["1970-01-01T00:00:00Z/1970-01-02T00:00:00Z"],
        "context": {"skipEmptyBuckets": True, "outputName": "ts"},
    },
    "scan": {
        "queryType": "scan", "dataSource": "ev", "columns": ["city", "w"],
        "virtualColumns": [{"type": "expression", "name": "w",
                            "expression": "v * 2"}],
        "filter": {"type": "selector", "dimension": "tier", "value": "gold"},
        "orderBy": [{"columnName": "w", "order": "descending"},
                    {"columnName": "city"}],
        "limit": 10, "offset": 3, "resultFormat": "compactedList",
    },
    "scan_legacy_order": {
        "queryType": "scan", "dataSource": "ev", "columns": ["v"],
        "order": "descending",
    },
    "search": {
        "queryType": "search", "dataSource": "ev",
        "searchDimensions": ["city", "tier"], "limit": 3,
        "filter": {"type": "selector", "dimension": "tier", "value": "gold"},
        "query": {"type": "insensitive_contains", "value": "o"},
        "intervals": _EV_IV,
    },
    "time_boundary": {"queryType": "timeBoundary", "dataSource": "ev",
                      "bound": "maxTime"},
    "datasource_metadata": {"queryType": "dataSourceMetadata", "dataSource": "ev"},
    "segment_metadata": {"queryType": "segmentMetadata", "dataSource": "ev",
                         "intervals": _EV_IV},
}

MALFORMED = {
    "trailing_expression_input": _gb(aggregations=[
        {"type": "javascript", "name": "x", "expression": "v * 2 bogus"}]),
    "expression_does_not_parse": _gb(virtualColumns=[
        {"type": "expression", "name": "w", "expression": "v * * 2"}]),
    "bad_interval": _gb(intervals=["2021-13-45T00:00:00Z/2021-01-01T00:00:00Z"]),
    "interval_without_end": _gb(intervals=["2021-01-01T00:00:00Z"]),
    "unknown_filter_type": _gb(filter={"type": "spatial", "dimension": "city"}),
    "unknown_query_type": {"queryType": "select", "dataSource": "ev"},
    "unknown_aggregator": _gb(aggregations=[{"type": "longFirst", "name": "x"}]),
    "unknown_having": _gb(having={"type": "dimSelector"}),
    "subtotals_unknown_dimension": _gb(subtotalsSpec=[["nope"]]),
    "topn_numeric_ordering": {
        "queryType": "topN", "dataSource": "ev", "dimension": "city",
        "metric": {"type": "dimension", "ordering": "numeric"}, "threshold": 1,
        "aggregations": [],
    },
}


def _canon(spec) -> str:
    return json.dumps(spec, sort_keys=True, default=str)


@pytest.fixture(scope="module")
def planned_bodies():
    """`to_druid()` of the reference's plan of every SSB and TPC-H query."""
    ctx = sd.TPUOlapContext()
    jssb.register(ctx, tables=jssb.gen_tables(scale=0.001, seed=11), rows_per_segment=16384)
    bodies = {f"ssb:{k}": ctx.plan_sql(v).query.to_druid() for k, v in jssb.QUERIES.items()}
    ctx = sd.TPUOlapContext()
    jtpch.register(ctx, tables=jtpch.gen_tables(scale=0.001))
    bodies.update({f"tpch:{k}": ctx.plan_sql(v).query.to_druid()
                   for k, v in jtpch.QUERIES.items()})
    return bodies


DECODE_CASES = (
    [f"golden:{k}" for k in GOLDEN_BODIES]
    + [f"fallback:{k}" for k in FALLBACK_SPECS] + ["fallback:extraction"]
    + [f"surface:{k}" for k in SURFACE_BODIES]
)


def _body(case):
    kind, name = case.split(":", 1)
    if kind == "golden":
        return GOLDEN_BODIES[name]
    if kind == "fallback":
        return _EXTRACTION if name == "extraction" else FALLBACK_SPECS[name]
    return SURFACE_BODIES[name]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_matches_reference(case):
    body = copy.deepcopy(_body(case))
    want = jwire.query_from_druid(body).to_druid()
    got = twire.query_from_druid(body)
    assert _canon(got.to_druid()) == _canon(want)
    # the decoded spec round-trips: printed and decoded again, it prints
    # the same JSON
    assert _canon(twire.query_from_druid(got.to_druid()).to_druid()) == _canon(want)


def test_planned_queries_decode_as_the_reference_decodes(planned_bodies):
    assert len(planned_bodies) == len(jssb.QUERIES) + len(jtpch.QUERIES)
    for name, body in planned_bodies.items():
        got = twire.query_from_druid(json.loads(json.dumps(body)))
        want = jwire.query_from_druid(json.loads(json.dumps(body)))
        assert _canon(got.to_druid()) == _canon(want.to_druid()) == _canon(body), name


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_bodies_raise_wire_error(case):
    body = MALFORMED[case]
    with pytest.raises(ValueError) as ref_err:
        jwire.query_from_druid(body)
    with pytest.raises(twire.WireError) as err:
        twire.query_from_druid(body)
    # the reference's own WireErrors keep their message
    if isinstance(ref_err.value, jwire.WireError):
        assert str(err.value) == str(ref_err.value)


# -- goldens, without HTTP -----------------------------------------------------


def _golden_columns():
    t0 = int(np.datetime64("2021-01-01", "ms").astype(np.int64))
    return {
        "city": np.array(["NY", "SF", "NY", "SF"], dtype=object),
        "v": np.array([1.0, 2.0, 3.0, 4.0], np.float32),
        "ts": np.array([t0, t0, t0 + DAY, t0 + DAY], np.int64),
    }


@pytest.fixture(scope="module")
def golden_ctx():
    ctx = TPUOlapContext(device="cpu")
    ctx.register_table("g", _golden_columns(), dimensions=["city"], metrics=["v"],
                       time_column="ts")
    return ctx


@pytest.mark.parametrize("golden", list(GOLDEN_BODIES))
def test_golden_response_bytes(golden_ctx, golden):
    q = twire.query_from_druid(json.loads(json.dumps(GOLDEN_BODIES[golden])))
    df = golden_ctx.engine.execute(q, golden_ctx.catalog.get(q.datasource))
    got = json.dumps(twire.druid_result_shape(q, df), sort_keys=True)
    with open(os.path.join(GOLDEN_DIR, golden)) as f:
        want = json.dumps(json.load(f), sort_keys=True)
    assert got == want


# -- the ev table of test_wire_fallback.py in both packages --------------------


def _ev_columns():
    """The `ev` table of `test_wire_fallback._make_ctx` (same seed)."""
    n = 8_000
    rng = np.random.default_rng(3)
    return {
        "city": rng.choice(np.array(["NY", "SF", "LA", "CHI"], dtype=object), n),
        "tier": rng.choice(np.array(["gold", "free"], dtype=object), n),
        "v": rng.integers(1, 100, n).astype(np.float32),
        "ts": (rng.integers(0, 14, n) * DAY).astype(np.int64),
    }


@pytest.fixture(scope="module")
def ev_ctxs():
    """(reference context of `_make_ctx`, port context) over `ev`."""
    ref = _make_ctx()
    port = TPUOlapContext(device="cpu")
    port.register_table("ev", _ev_columns(), dimensions=["city", "tier"], metrics=["v"],
                        time_column="ts", rows_per_segment=1 << 10)
    ref_frame = ref.sql("SELECT city, tier, v, ts FROM ev")
    port_frame = port.sql("SELECT city, tier, v, ts FROM ev")
    pd.testing.assert_frame_equal(port_frame, ref_frame, check_exact=True)
    return ref, port


def test_subtotals_spec_runs_as_grouping_sets(ev_ctxs):
    """A wire subtotalsSpec runs through `execute_grouping_sets` on the
    query without subtotals, `__grouping_id` dropped, as the reference's
    server runs it."""
    ref, port = ev_ctxs
    body = _gb(dimensions=["city", "tier"],
               aggregations=[{"type": "doubleSum", "name": "s", "fieldName": "v"},
                             {"type": "count", "name": "n"}],
               subtotalsSpec=[["city", "tier"], ["tier"], []])
    frames = []
    for ctx, wire, run in ((ref, jwire, sd.api.execute_grouping_sets),
                           (port, twire, execute_grouping_sets)):
        q = wire.query_from_druid(body)
        df = run(dataclasses.replace(q, subtotals=()), q.subtotals,
                 ctx.catalog.get("ev"), ctx.engine)
        frames.append((q, df.drop(columns=["__grouping_id"])))
    (_, want), (q, got) = frames
    assert len(got) == 4 * 2 + 2 + 1
    keys = ["city", "tier"]
    got = got.sort_values(keys, kind="stable").reset_index(drop=True)
    want = want.sort_values(keys, kind="stable").reset_index(drop=True)
    pd.testing.assert_frame_equal(got, want, check_dtype=False, rtol=1e-6)
    assert [r["event"]["n"] for r in twire.druid_result_shape(q, got)] == list(got["n"])


# -- the wire fallback --------------------------------------------------------


@pytest.mark.parametrize("name", list(FALLBACK_SPECS))
def test_native_degraded_matches_reference(ev_ctxs, name):
    ref, port = ev_ctxs
    body = FALLBACK_SPECS[name]
    want = ref.execute_native_degraded(jwire.query_from_druid(body), None, reason="test")
    q = twire.query_from_druid(body)
    got = port.execute_native_degraded(q)
    assert port.last_metrics.executor == "fallback"
    pd.testing.assert_frame_equal(got.reset_index(drop=True), want.reset_index(drop=True),
                                  check_exact=True)
    # the host answer has the device answer's columns and rows
    healthy = port.engine.execute(q, port.catalog.get("ev"))
    assert set(got.columns) == set(healthy.columns) and len(got) == len(healthy)


def test_native_degraded_obeys_the_fallback_flag(ev_ctxs):
    """The host path a caller asks for by name is gated by the session's
    `fallback_execution`, as the SQL path's fallback is."""
    _, port = ev_ctxs
    port.sql("SET fallback_execution = false")
    try:
        with pytest.raises(RewriteError, match="fallback execution is disabled"):
            port.execute_native_degraded(twire.query_from_druid(_TOPN))
    finally:
        port.sql("SET fallback_execution = true")


UNSUPPORTED = {
    "extraction_dimension": _EXTRACTION,
    "virtual_columns": dict(_GROUPBY, virtualColumns=[
        {"type": "expression", "name": "w", "expression": "v * 2"}]),
    "subtotals": _gb(subtotalsSpec=[["city"], []]),
    "week_granularity": _gb(granularity="week", intervals=_EV_IV),
    "search": SURFACE_BODIES["search"],
    "scan_virtual_columns": SURFACE_BODIES["scan"],
    "theta_set_operation": SURFACE_BODIES["post_aggregators"],
}


@pytest.mark.parametrize("name", list(UNSUPPORTED))
def test_native_degraded_refuses_what_the_reference_refuses(ev_ctxs, name):
    ref, port = ev_ctxs
    body = UNSUPPORTED[name]
    with pytest.raises(RefUnsupported):
        ref.execute_native_degraded(jwire.query_from_druid(body), None, reason="test")
    with pytest.raises(WireFallbackUnsupported):
        port.execute_native_degraded(twire.query_from_druid(body))
