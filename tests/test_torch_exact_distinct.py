"""Exact COUNT(DISTINCT) (count_distinct_mode = 'exact') and SELECT DISTINCT
in the PyTorch port, against the JAX reference.

Every case of the reference's `tests/test_exact_distinct.py` runs through
the port's `TPUOlapContext(SessionConfig(count_distinct_mode="exact"),
device="cpu")` and the reference's context with its routing pinned to the
port's (`test_torch_sql.reference_config`): frames equal (keys and distinct
counts exact, sums within rtol 1e-6), the same planned inner query, the
same RewriteErrors.  Also: the exact-distinct SSB queries of `chip_smoke.py`
phase 8 over `ssb.key_dimension_datasource` (the inner grouping by c_city
and lo_custkey) against the reference over the same rows registered with
lo_custkey as a dimension, and against the exact oracle; and TPC-H's
COUNT(DISTINCT l_shipmode), once a gap of the port.
"""

import json

import numpy as np
import pandas as pd
import pytest
from test_torch_sql import reference_config

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu.catalog.segment import DimensionDict
from spark_druid_olap_tpu.plan.planner import RewriteError as JaxRewriteError
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu.workloads import tpch as jtpch
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.plan.planner import RewriteError
from spark_druid_olap_tpu_torch.workloads import ssb as tssb
from spark_druid_olap_tpu_torch.workloads import tpch as ttpch

RTOL = 1e-6


def _exact_ref():
    cfg = reference_config()
    cfg.count_distinct_mode = "exact"
    return sd.TPUOlapContext(cfg)


@pytest.fixture(scope="module")
def data():
    n = 30_000
    rng = np.random.default_rng(17)
    return {
        "region": rng.choice(np.array(["EU", "US", "APAC"], dtype=object), n),
        "city": rng.choice(np.array([f"c{i}" for i in range(200)], dtype=object), n),
        "user": rng.choice(np.array([f"u{i}" for i in range(5_000)], dtype=object), n),
        "v": rng.random(n).astype(np.float32),
    }


@pytest.fixture(scope="module")
def ctxs(data):
    """(reference, port) contexts in exact mode over the same `ev` table."""
    ref, port = _exact_ref(), TPUOlapContext(SessionConfig(count_distinct_mode="exact"), device="cpu")
    for c in (ref, port):
        c.register_table("ev", data, dimensions=["region", "city", "user"], metrics=["v"])
    return ref, port


def assert_same(got, want):
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(
        got.reset_index(drop=True), want.reset_index(drop=True),
        check_dtype=False, check_exact=False, rtol=RTOL,
    )


CASES = {
    "global": "SELECT count(DISTINCT user) AS u FROM ev",
    "grouped_with_other_aggs": (
        "SELECT region, count(DISTINCT city) AS cities, sum(v) AS total, "
        "count(*) AS n, avg(v) AS mean FROM ev GROUP BY region ORDER BY region"),
    "two_distincts_filter_having": (
        "SELECT region, count(DISTINCT city) AS c, count(DISTINCT user) AS u "
        "FROM ev WHERE city <> 'c0' GROUP BY region "
        "HAVING count(DISTINCT city) > 0 ORDER BY u DESC LIMIT 2"),
    "select_distinct": "SELECT DISTINCT region FROM ev ORDER BY region",
    "select_distinct_two_cols": "SELECT DISTINCT region, city FROM ev",
    "output_order_matches_approx": (
        "SELECT region, count(DISTINCT city) AS d, sum(v) AS s "
        "FROM ev GROUP BY region ORDER BY region"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_exact_distinct_matches_reference(ctxs, data, name):
    ref, port = ctxs
    sql = CASES[name]
    jrw, trw = ref.plan_sql(sql), port.plan_sql(sql)
    assert (jrw.exact_distinct is None) == (trw.exact_distinct is None)
    assert json.dumps(trw.query.to_druid(), sort_keys=True, default=str) == json.dumps(
        jrw.query.to_druid(), sort_keys=True, default=str)
    got = port.sql(sql)
    if "DISTINCT region, city" in sql:  # no ORDER BY: compare as sets
        got = got.sort_values(list(got.columns)).reset_index(drop=True)
        want = ref.sql(sql).sort_values(list(got.columns)).reset_index(drop=True)
    else:
        want = ref.sql(sql)
    assert_same(got, want)
    frame = pd.DataFrame(data)
    if name == "global":
        assert int(got["u"][0]) == frame["user"].nunique()
    if name == "output_order_matches_approx":
        approx = TPUOlapContext(device="cpu")
        approx.register_table("ev", data, dimensions=["region", "city", "user"], metrics=["v"])
        assert list(approx.sql(sql).columns) == list(got.columns) == ["region", "d", "s"]
        assert approx.plan_sql(sql).exact_distinct is None


REJECTED = {
    "mix_with_approx": "SELECT count(DISTINCT city) AS c, approx_count_distinct(user) AS u FROM ev",
    "sum_distinct": (
        "SELECT region, count(DISTINCT city) AS d, sum(DISTINCT v) AS s FROM ev GROUP BY region"),
    "over_expression": "SELECT count(DISTINCT v * 2) AS c FROM ev",
    "with_cube": "SELECT region, count(DISTINCT user) AS u FROM ev GROUP BY CUBE (region)",
    "over_metric": "SELECT region, count(DISTINCT v) AS u FROM ev GROUP BY region",
}


@pytest.mark.parametrize("name", list(REJECTED))
def test_exact_distinct_rejects_what_the_reference_rejects(ctxs, name):
    ref, port = ctxs
    with pytest.raises(JaxRewriteError) as want:
        ref.plan_sql(REJECTED[name])
    with pytest.raises(RewriteError) as got:
        port.plan_sql(REJECTED[name])
    assert str(got.value) == str(want.value)


def test_exact_count_distinct_over_tpch(ctxs):
    """COUNT(DISTINCT l_shipmode) over TPC-H lineitem: exact in both."""
    tables = jtpch.gen_tables(scale=0.01)
    ref, port = _exact_ref(), TPUOlapContext(SessionConfig(count_distinct_mode="exact"), device="cpu")
    jtpch.register(ref, tables=tables)
    ttpch.register(port, tables=tables)
    sql = ("SELECT l_returnflag, count(DISTINCT l_shipmode) AS m FROM lineitem "
           "GROUP BY l_returnflag ORDER BY l_returnflag")
    got = port.sql(sql)
    assert_same(got, ref.sql(sql))
    assert (got["m"] == 7).all()


@pytest.fixture(scope="module")
def ssb_keyed():
    """SSB with lo_custkey a dimension: the reference registered from the
    flat columns, the port through `ssb.key_dimension_datasource` over its
    own registration; and the oracle frame."""
    tables = jssb.gen_tables(scale=0.01, seed=11)
    n_keys = len(tables["customer"]["c_custkey"])
    ref = _exact_ref()
    cols, dicts = jssb.flat_columns(tables)
    ref.register_table(
        "lineorder", cols, dimensions=jssb.FLAT_DIMS + ["lo_custkey"],
        metrics=[m for m in jssb.FLAT_METRICS if m != "lo_custkey"],
        time_column="lo_orderdate", star_schema=tssb.KEYED_STAR_SCHEMA.to_json(), rows_per_segment=16384,
        dicts={**dicts, "lo_custkey": DimensionDict(values=tuple(range(n_keys)))},
        sort_by=["lo_orderdate"],
    )
    plain = TPUOlapContext(device="cpu")
    tssb.register(plain, tables=tables, rows_per_segment=16384)
    port = TPUOlapContext(device="cpu")
    port.register_datasource(
        tssb.key_dimension_datasource(plain.catalog.get("lineorder"), n_keys),
        star_schema=tssb.KEYED_STAR_SCHEMA)
    port.sql("SET count_distinct_mode = 'exact'")
    return ref, port, tssb.flat_frame(tables)


@pytest.mark.parametrize("name", list(tssb.EXACT_DISTINCT_QUERIES))
def test_ssb_exact_distinct_matches_reference_and_oracle(ssb_keyed, name):
    ref, port, frame = ssb_keyed
    sql = tssb.EXACT_DISTINCT_QUERIES[name]
    got = port.sql(sql)
    assert_same(got, ref.sql(sql))
    tssb.check_sketch_answer(name, got, tssb.sketch_oracle(frame, name))
    m = port.last_metrics  # the inner grouping's
    if m.num_groups > 4096:  # the CPU takes adaptive, else scatter after a decline
        assert m.strategy == "adaptive" or (m.strategy == "segment" and m.tier_declines)
    pd.testing.assert_frame_equal(port.sql(sql), got)
