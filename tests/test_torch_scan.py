"""Scan, Search and the metadata queries of the PyTorch port, against the
JAX reference on the same columns.

* Scan (native specs): unordered LIMIT (the loop stops early), ordered
  LIMIT with OFFSET (each segment's top rows kept before the concat, ties
  included), virtual columns, intervals, filters, the legacy time `order`,
  `compactedList`, nulls, and the two QueryValidationError cases.  Rows,
  their order and dtypes equal the reference's frame exactly.
* Search with and without a filter and intervals, and with a `limit` that
  cuts across dimensions: counts exact.
* TimeBoundary (`bound` None, minTime, maxTime), DataSourceMetadata and
  SegmentMetadata: the reference's frames.
* A non-aggregate SQL SELECT plans to the reference's ScanQuery JSON and
  returns its frame (`tests/test_sql.py::test_rewrite_types`' scan case
  among them).
"""

import json

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu.models import query as JQ
from spark_druid_olap_tpu.models import wire as jwire
from spark_druid_olap_tpu.server import druid_result_shape as ref_shape
from spark_druid_olap_tpu.utils import datagen
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.models import query as TQ
from spark_druid_olap_tpu_torch.models import wire as twire

IV_1995 = ["1995-01-01T00:00:00.000Z/1996-01-01T00:00:00.000Z"]
COLS = ["l_returnflag", "l_quantity", "l_extendedprice"]
Q45 = {"type": "bound", "dimension": "l_quantity", "lower": "45",
       "lowerStrict": True, "ordering": "numeric"}


def _nulls_columns():
    """A timeless table with null dimension values."""
    rng = np.random.default_rng(9)
    n = 3000
    return {
        "k": rng.choice(np.array(["a", "b", None, "c"], dtype=object), n),
        "kk": rng.choice(np.array(["x", None], dtype=object), n),
        "m": rng.integers(0, 20, n).astype(np.float32),
    }


def _register(ctx, lineitem_cols):
    ctx.register_table("lineitem", lineitem_cols, dimensions=datagen.LINEITEM_DIMS,
                       metrics=datagen.LINEITEM_METRICS, time_column="l_shipdate",
                       rows_per_segment=4096)
    ctx.register_table("nt", _nulls_columns(), dimensions=["k", "kk"], metrics=["m"],
                       rows_per_segment=1024)
    return ctx


@pytest.fixture(scope="module")
def ctxs(lineitem_cols):
    """(reference context, port context) over the same tables."""
    return (_register(sd.TPUOlapContext(), lineitem_cols),
            _register(TPUOlapContext(device="cpu"), lineitem_cols))


def _scan(**kw):
    return {"queryType": "scan", "dataSource": "lineitem", "columns": COLS, **kw}


SCANS = {
    "unordered_limit": _scan(filter=Q45, limit=50),
    "unordered_limit_offset": _scan(filter=Q45, limit=40, offset=4100),
    "ordered_limit_offset": _scan(
        filter=Q45, orderBy=[{"columnName": "l_extendedprice", "order": "descending"}],
        limit=20, offset=5),
    # ties on the first key: each segment keeps every row tied at its cut
    "ordered_ties": _scan(
        orderBy=[{"columnName": "l_quantity", "order": "descending"},
                 {"columnName": "l_extendedprice", "order": "ascending"}],
        limit=30, offset=2),
    "ordered_limit_zero": _scan(orderBy=[{"columnName": "l_quantity"}], limit=0),
    "ordered_by_time": _scan(
        columns=["__time", "l_returnflag", "l_tax"],
        orderBy=[{"columnName": "__time"}, {"columnName": "l_tax", "order": "descending"}],
        limit=25),
    "ordered_by_dimension": _scan(
        orderBy=[{"columnName": "l_returnflag", "order": "descending"},
                 {"columnName": "l_quantity"}],
        limit=12),
    "ordered_no_limit": _scan(
        filter={"type": "selector", "dimension": "l_linestatus", "value": "O"},
        intervals=IV_1995, orderBy=[{"columnName": "l_discount"}],
        columns=["l_discount", "l_linestatus"]),
    "virtual_columns": _scan(
        columns=["l_returnflag", "rev", "q2"],
        virtualColumns=[
            {"type": "expression", "name": "rev",
             "expression": "l_extendedprice * (1 - l_discount)"},
            {"type": "expression", "name": "q2",
             "expression": "l_extendedprice / l_quantity"}],
        orderBy=[{"columnName": "rev", "order": "descending"}], limit=15),
    "intervals": _scan(intervals=IV_1995, filter=Q45,
                       columns=["l_shipdate", "l_linestatus", "l_orderkey"]),
    "legacy_order": _scan(order="descending", limit=9, columns=["__time", "l_quantity"]),
    "compacted_list": _scan(filter=Q45, limit=11, resultFormat="compactedList"),
    "matches_nothing": _scan(filter={"type": "selector", "dimension": "l_returnflag",
                                     "value": "Z"}, limit=5),
    "no_segment": _scan(intervals=["2030-01-01T00:00:00.000Z/2031-01-01T00:00:00.000Z"]),
    "nulls": {"queryType": "scan", "dataSource": "nt", "columns": ["k", "kk", "m"],
              "orderBy": [{"columnName": "m", "order": "descending"}], "limit": 40},
    "nulls_unordered": {"queryType": "scan", "dataSource": "nt", "columns": ["kk", "k"],
                        "filter": {"type": "not", "field": {
                            "type": "selector", "dimension": "k", "value": None}}},
}


def _run(ctx, wire, body):
    q = wire.query_from_druid(json.loads(json.dumps(body)))
    return q, ctx.engine.execute(q, ctx.catalog.get(q.datasource))


@pytest.mark.parametrize("name", list(SCANS))
def test_scan_matches_reference(ctxs, name):
    ref, port = ctxs
    qr, want = _run(ref, jwire, SCANS[name])
    q, got = _run(port, twire, SCANS[name])
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert (json.dumps(twire.druid_result_shape(q, got), sort_keys=True)
            == json.dumps(ref_shape(qr, want), sort_keys=True))
    m = port.last_metrics
    assert m.query_type == "scan" and m.d2h_bytes > 0 or len(got) == 0


def test_unordered_limit_stops_early(ctxs):
    _, port = ctxs
    _run(port, twire, _scan(limit=10))
    m = port.last_metrics
    assert m.segments == 1 and m.rows_scanned == 4096
    # the ten rows of the three columns, compacted before the copy
    assert m.d2h_bytes == 10 * (1 + 4 + 4)
    _run(port, twire, SCANS["ordered_limit_offset"])
    assert port.last_metrics.segments == len(port.catalog.get("lineitem").segments)


@pytest.mark.parametrize("body, match", [
    ({"queryType": "scan", "dataSource": "nt", "columns": ["k"],
      "order": "ascending"}, "no time column"),
    (_scan(orderBy=[{"columnName": "l_nope"}]), "unknown column"),
], ids=["time_order_on_timeless_table", "unknown_order_by"])
def test_scan_validation_errors(ctxs, body, match):
    ref, port = ctxs
    with pytest.raises(JQ.QueryValidationError, match=match):
        _run(ref, jwire, body)
    with pytest.raises(TQ.QueryValidationError, match=match):
        _run(port, twire, body)


def _search(**kw):
    return {"queryType": "search", "dataSource": "lineitem",
            "searchDimensions": ["l_returnflag", "l_linestatus"],
            "query": {"type": "insensitive_contains", "value": ""}, **kw}


SEARCHES = {
    "all_values": _search(),
    "filtered": _search(filter=Q45, intervals=IV_1995),
    "needle": _search(query={"type": "insensitive_contains", "value": "n"}),
    "limit_across_dimensions": _search(limit=4),
    "limit_in_first_dimension": _search(limit=2, filter={
        "type": "selector", "dimension": "l_linestatus", "value": "F"}),
    "matches_nothing": _search(query={"type": "insensitive_contains", "value": "zz"}),
    "nulls": {"queryType": "search", "dataSource": "nt", "searchDimensions": ["kk", "k"],
              "query": {"type": "insensitive_contains", "value": ""},
              "filter": {"type": "bound", "dimension": "m", "upper": "10",
                         "ordering": "numeric"}},
}


@pytest.mark.parametrize("name", list(SEARCHES))
def test_search_matches_reference(ctxs, name):
    ref, port = ctxs
    qr, want = _run(ref, jwire, SEARCHES[name])
    q, got = _run(port, twire, SEARCHES[name])
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert (json.dumps(twire.druid_result_shape(q, got), sort_keys=True)
            == json.dumps(ref_shape(qr, want), sort_keys=True))


def test_search_counts_equal_a_bincount(ctxs, lineitem_cols):
    _, port = ctxs
    _, got = _run(port, twire, _search(filter=Q45))
    keep = lineitem_cols["l_quantity"] > 45
    want = {}
    for dim in ("l_returnflag", "l_linestatus"):
        vals, counts = np.unique(lineitem_cols[dim][keep].astype(str), return_counts=True)
        want.update({(dim, v): int(c) for v, c in zip(vals, counts)})
    assert dict(zip(zip(got["dimension"], got["value"]), got["count"])) == want


METADATA = {
    "time_boundary": {"queryType": "timeBoundary", "dataSource": "lineitem"},
    "time_boundary_min": {"queryType": "timeBoundary", "dataSource": "lineitem",
                          "bound": "minTime"},
    "time_boundary_max": {"queryType": "timeBoundary", "dataSource": "lineitem",
                          "bound": "maxTime"},
    "time_boundary_timeless": {"queryType": "timeBoundary", "dataSource": "nt"},
    "datasource_metadata": {"queryType": "dataSourceMetadata", "dataSource": "lineitem"},
    "segment_metadata": {"queryType": "segmentMetadata", "dataSource": "lineitem"},
    "segment_metadata_intervals": {"queryType": "segmentMetadata",
                                   "dataSource": "lineitem", "intervals": IV_1995},
    "segment_metadata_timeless": {"queryType": "segmentMetadata", "dataSource": "nt"},
}


@pytest.mark.parametrize("name", list(METADATA))
def test_metadata_matches_reference(ctxs, name):
    ref, port = ctxs
    qr, want = _run(ref, jwire, METADATA[name])
    q, got = _run(port, twire, METADATA[name])
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert (json.dumps(twire.druid_result_shape(q, got), sort_keys=True)
            == json.dumps(ref_shape(qr, want), sort_keys=True))


SQL = {
    # tests/test_sql.py::test_rewrite_types
    "rewrite_types": "SELECT l_returnflag FROM lineitem WHERE l_quantity > 49",
    "limit": "SELECT l_returnflag, l_quantity FROM lineitem WHERE l_quantity > 49 LIMIT 5",
    "order_offset": (
        "SELECT l_orderkey, l_extendedprice FROM lineitem WHERE l_returnflag = 'R' "
        "ORDER BY l_extendedprice DESC LIMIT 10 OFFSET 3"),
    "projection_interval": (
        "SELECT l_returnflag, l_extendedprice * (1 - l_discount) AS rev FROM lineitem "
        "WHERE l_shipdate >= DATE '1995-01-01' AND l_shipdate < DATE '1995-02-01' "
        "ORDER BY rev DESC LIMIT 7"),
    "order_by_physical": (
        "SELECT l_returnflag, l_linestatus FROM lineitem ORDER BY l_tax, l_quantity DESC "
        "LIMIT 6"),
    "star": "SELECT * FROM nt WHERE k = 'a' LIMIT 8",
}


@pytest.mark.parametrize("name", list(SQL))
def test_sql_scan_matches_reference(ctxs, name):
    ref, port = ctxs
    want_rw = ref.plan_sql(SQL[name])
    rw = port.plan_sql(SQL[name])
    assert isinstance(rw.query, TQ.ScanQuery) and rw.is_scan
    assert rw.to_json() == want_rw.to_json()
    want = ref.sql(SQL[name])
    got = port.sql(SQL[name])
    assert len(want) > 0
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert "strategy=scan" in port.explain(SQL[name])
