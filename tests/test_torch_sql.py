"""SQL path of the PyTorch port end to end, against the JAX reference.

* `TPUOlapContext(device="cpu").sql(q)` gives the reference's frame for the
  13 SSB queries and every TPC-H query (joined SQL over the normalized
  star) under the parity contract: keys and counts exact, sums within
  rtol 1e-6, and the float64 oracle within rtol 2e-5.  A second run is
  bit-identical.
* Sketch and grouping-set SQL (the five `SKETCH_QUERIES`, a ROLLUP, and
  COUNT(DISTINCT) and CUBE over TPC-H lineitem) plans to the reference's
  JSON and gives its frames: sketch columns (distinct counts, quantiles)
  and keys exact, sums within rtol 1e-6; the SSB ones also hold against
  their exact oracles within the sketches' error bounds.
* Commands (CREATE TABLE ... OPTIONS, CREATE VIEW, SET, SHOW TABLES,
  DESCRIBE) give the reference's frames.  The catalog's star schemas, the
  SSB flat frame of a fact chunk, its foreign-key row index and the merge
  of per-chunk oracles equal the reference's.
* What the port does not execute yet raises where the reference answers:
  SET on a flag of a tier the port does not have (KeyError).  A subquery
  and a SELECT over a view, once such gaps, plan to a RewriteError and run
  on the host fallback, with the reference's frame; a non-aggregate scan,
  once a gap too, plans to a Scan query and gives the reference's frame
  (the Scan is held to the reference in `test_torch_scan.py`) (the fallback is held to the reference in
  `test_torch_fallback.py`; exact COUNT(DISTINCT) in
  `test_torch_exact_distinct.py`).  `TPUOlapContext()` with no GPU and no
  device raises.
"""

import json


import numpy as np
import pandas as pd
import pytest
import torch

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu.workloads import tpch as jtpch
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.plan.planner import RewriteError
from spark_druid_olap_tpu_torch.workloads import ssb as tssb
from spark_druid_olap_tpu_torch.workloads import tpch as ttpch

RTOL = 1e-6  # against the reference (float32 partial sums on both sides)
ORACLE_RTOL = 2e-5  # against the float64 oracle

CASES = [("ssb", k) for k in tssb.QUERIES] + [("tpch", k) for k in ttpch.QUERIES]


@pytest.fixture(scope="module")
def tables():
    return {
        "ssb": jssb.gen_tables(scale=0.01, seed=11),
        "tpch": jtpch.gen_tables(scale=0.01),
    }


def reference_config():
    """Reference session flags that route every group-by as the port's
    engine does: its dense one-hot path at G <= 4096 (what the port's CPU
    twin reproduces bit for bit), plain scatter above, on one device.  The
    reference otherwise prices its sparse, adaptive and mesh tiers, which
    add the same float32 values in another order (a ~1e-6 relative
    difference at these row counts, outside the parity rtol)."""
    from spark_druid_olap_tpu.config import SessionConfig as JaxConfig

    return JaxConfig(
        dense_max_groups=4096,
        cost_per_row_dense=1e-9,
        cost_per_row_sparse=1e6,
        cost_dispatch_us=1e12,
        prefer_distributed=False,
    )


def port_config() -> SessionConfig:
    """`reference_config`'s constants in the port: under equal constants
    the port's cost model routes every group-by as the reference's does."""
    return SessionConfig(
        dense_max_groups=4096,
        cost_per_row_dense=1e-9,
        cost_per_row_sparse=1e6,
        cost_dispatch_us=1e12,
    )


@pytest.fixture(scope="module")
def ctxs(tables):
    """(reference context, port context) over the same tables."""
    ref = sd.TPUOlapContext(reference_config())
    jssb.register(ref, tables=tables["ssb"], rows_per_segment=16384)
    jtpch.register(ref, tables=tables["tpch"])
    port = TPUOlapContext(port_config(), device="cpu")
    tssb.register(port, tables=tables["ssb"], rows_per_segment=16384)
    ttpch.register(port, tables=tables["tpch"])
    return ref, port


@pytest.fixture(scope="module")
def frames(tables):
    return {
        "ssb": tssb.flat_frame(tables["ssb"]),
        "tpch": ttpch.flat_frame(tables["tpch"]),
    }


def _keys(df):
    return [c for c in df.columns if df[c].dtype.kind != "f"]


def assert_frames_match(got, want, rtol):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    keys = _keys(want)
    if keys:
        got = got.sort_values(keys, kind="stable").reset_index(drop=True)
        want = want.sort_values(keys, kind="stable").reset_index(drop=True)
    for c in want.columns:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if c in keys:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=c)
        else:
            np.testing.assert_allclose(
                g.astype(np.float64), w.astype(np.float64), rtol=rtol, err_msg=c
            )


def assert_matches_oracle(got, want):
    if isinstance(want, float):  # a single-row global aggregate
        np.testing.assert_allclose(float(got.iloc[0, -1]), want, rtol=ORACLE_RTOL)
        return
    got = got[list(want.columns)]
    # the oracle's key columns are its non-float ones; counts are exact too
    assert_frames_match(got, want.reset_index(drop=True), ORACLE_RTOL)


@pytest.mark.parametrize("workload,name", CASES)
def test_sql_frame_matches_reference_and_oracle(ctxs, frames, workload, name):
    ref, port = ctxs
    mod = tssb if workload == "ssb" else ttpch
    got = port.sql(mod.QUERIES[name])
    want = ref.sql(mod.QUERIES[name])
    assert_frames_match(got, want, RTOL)
    # ORDER BY ... LIMIT shapes: the same rows in the same order
    if "LIMIT" in mod.QUERIES[name] or "ORDER BY" in mod.QUERIES[name]:
        for c in _keys(want):
            np.testing.assert_array_equal(
                np.asarray(got[c]).astype(np.asarray(want[c]).dtype),
                np.asarray(want[c]), err_msg=c,
            )
    assert_matches_oracle(got, mod.oracle(frames[workload], name))
    pd.testing.assert_frame_equal(port.sql(mod.QUERIES[name]), got)


SKETCH_CASES = [("ssb", k, q) for k, q in tssb.SKETCH_QUERIES.items()] + [
    ("ssb", "rollup",
     "SELECT c_region, d_year, sum(lo_revenue) AS revenue, "
     "approx_count_distinct_ds_theta(lo_custkey, 256) AS uniq, "
     "APPROX_QUANTILE(lo_quantity, 0.25) AS q25 "
     "FROM lineorder GROUP BY ROLLUP (c_region, d_year) ORDER BY c_region, d_year"),
    ("tpch", "approx_count_distinct",
     "SELECT l_returnflag, count(DISTINCT l_shipmode) AS m FROM lineitem "
     "GROUP BY l_returnflag"),
    ("tpch", "cube",
     "SELECT l_returnflag, l_linestatus, sum(l_quantity) AS q FROM lineitem "
     "GROUP BY CUBE (l_returnflag, l_linestatus)"),
]
SKETCH_FLOATS = {"p50", "p90", "q25"}  # quantile estimates: exact, not summed


def assert_sketch_frames_match(got, want):
    """Keys, counts and sketch columns exact; sums within RTOL."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    keys = [c for c in want.columns if want[c].dtype.kind != "f"]
    got = got.sort_values(keys, kind="stable", na_position="last").reset_index(drop=True)
    want = want.sort_values(keys, kind="stable", na_position="last").reset_index(drop=True)
    for c in want.columns:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if c in keys or c in SKETCH_FLOATS:
            np.testing.assert_array_equal(g, w, err_msg=c)
        else:
            np.testing.assert_allclose(g.astype(float), w.astype(float), rtol=RTOL, err_msg=c)


@pytest.mark.parametrize("workload,name,sql", SKETCH_CASES, ids=[c[1] for c in SKETCH_CASES])
def test_sketch_sql_matches_reference(ctxs, frames, workload, name, sql):
    ref, port = ctxs
    assert json.dumps(port.plan_sql(sql).query.to_druid(), sort_keys=True, default=str) == (
        json.dumps(ref.plan_sql(sql).query.to_druid(), sort_keys=True, default=str)
    )
    got, want = port.sql(sql), ref.sql(sql)
    assert_sketch_frames_match(got, want)
    pd.testing.assert_frame_equal(port.sql(sql), got)
    if name in tssb.SKETCH_QUERIES:
        tssb.check_sketch_answer(name, got, tssb.sketch_oracle(frames[workload], name))


def test_star_schemas_equal_the_reference(ctxs):
    ref, port = ctxs
    got, want = port.catalog.star_schemas(), ref.catalog.star_schemas()
    assert sorted(got) == sorted(want) == ["lineitem", "lineorder"]
    assert {k: v.to_json() for k, v in got.items()} == {k: v.to_json() for k, v in want.items()}
    got.clear()  # a copy: the catalog keeps its schemas
    assert port.catalog.star_schemas().keys() == want.keys()


def _fact_chunks(tables, n=3):
    lo = tables["lineorder"]
    return [{k: v[idx] for k, v in lo.items()}
            for idx in np.array_split(np.arange(len(lo["lo_orderdate"])), n)]


def test_flat_frame_chunks_and_row_index_equal_the_reference(tables):
    t = tables["ssb"]
    for chunk in _fact_chunks(t):
        pd.testing.assert_frame_equal(tssb.flat_frame_chunk(t, chunk),
                                      jssb.flat_frame_chunk(t, chunk))
    pd.testing.assert_frame_equal(tssb.flat_frame(t), jssb.flat_frame(t))
    for attr, (table, fk) in tssb.DIM_ATTRS.items():
        got, want = tssb._dim_row_index(t, fk, table), jssb._dim_row_index(t, fk, table)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=attr)


@pytest.mark.parametrize("name", list(jssb.QUERIES))
def test_merge_oracle_parts_equals_the_reference(tables, name):
    t = tables["ssb"]
    frames = [tssb.flat_frame_chunk(t, c) for c in _fact_chunks(t)]
    got = tssb.merge_oracle_parts([tssb.oracle(f, name) for f in frames])
    want = jssb.merge_oracle_parts([jssb.oracle(f, name) for f in frames])
    whole = tssb.oracle(tssb.flat_frame(t), name)
    if isinstance(want, float):
        assert got == want
        np.testing.assert_allclose(got, whole, rtol=1e-12)
        return
    pd.testing.assert_frame_equal(got.reset_index(drop=True), want.reset_index(drop=True))
    assert_frames_match(got, whole.reset_index(drop=True), 1e-12)


def test_repeated_text_is_planned_once(ctxs):
    _, port = ctxs
    sql = tssb.QUERIES["q2_1"]
    port.sql(sql)
    assert port.plan_cached(sql) is port.plan_cached(sql)
    n = len(port._plan_cache)
    port.sql(sql)
    assert len(port._plan_cache) == n


def test_explain_statement_returns_the_plan(ctxs):
    _, port = ctxs
    df = port.sql("EXPLAIN " + ttpch.QUERIES["q1"])
    assert "== Physical Plan ==" in list(df["plan"])


# -- commands ----------------------------------------------------------------


def _command_script(tmp_path):
    rng = np.random.default_rng(5)
    n = 500
    pd.DataFrame({
        "ts": pd.date_range("2024-01-01", periods=n, freq="h").astype(str),
        "region": rng.choice(["east", "north", "west"], n),
        "device": rng.choice(["phone", "tablet"], n),
        "clicks": rng.integers(0, 20, n).astype(np.float64),
    }).to_csv(tmp_path / "events.csv", index=False)
    return [
        f"CREATE TABLE events USING csv OPTIONS (path '{tmp_path / 'events.csv'}', "
        "timeColumn 'ts', dimensions 'region,device', metrics 'clicks', "
        "rowsPerSegment '128')",
        "CREATE VIEW busy AS SELECT region, device, clicks FROM events "
        "WHERE clicks > 5",
        "SET max_result_cardinality = 100000",
        "SHOW TABLES",
        "DESCRIBE events",
        "DESCRIBE busy",
        "SELECT device, count(*) AS n, max(clicks) AS top FROM events "
        "WHERE ts >= '2024-01-05' GROUP BY device ORDER BY device",
    ]


def test_commands_match_reference(tmp_path):
    ref = sd.TPUOlapContext()
    port = TPUOlapContext(device="cpu")
    for stmt in _command_script(tmp_path):
        want, got = ref.sql(stmt), port.sql(stmt)
        pd.testing.assert_frame_equal(
            got.reset_index(drop=True), want.reset_index(drop=True),
            check_dtype=False, obj=stmt,
        )
    assert port.config.max_result_cardinality == 100000
    # a SELECT over a view is a derived table, which the planner does not
    # rewrite: both packages answer it on their host fallback
    view_sql = "SELECT region, sum(clicks) AS total FROM busy GROUP BY region"
    with pytest.raises(RewriteError, match="SubqueryScan"):
        port.plan_sql(view_sql)
    want = ref.sql(view_sql)
    assert len(want) == 3 and ref.last_metrics.executor == "fallback"
    pd.testing.assert_frame_equal(port.sql(view_sql), want, check_exact=True)
    assert port.last_metrics.executor == "fallback"


# -- gaps fail loudly -------------------------------------------------------

GAPS = {
    # no longer a gap: the planner raises RewriteError and the host
    # fallback answers, as the reference does (exception None: the frames
    # must be equal)
    "subquery": (
        "SELECT l_returnflag, sum(l_quantity) AS q FROM lineitem WHERE "
        "l_orderkey IN (SELECT l_orderkey FROM lineitem WHERE l_quantity > 49) "
        "GROUP BY l_returnflag",
        None,
    ),
    # no longer a gap either: a Scan query on the engine (exception
    # "device": the frames must be equal)
    "scan": (
        "SELECT l_returnflag, l_quantity FROM lineitem WHERE l_quantity > 49 "
        "LIMIT 5",
        "device",
    ),
    # a flag the reference declares and nothing reads, which the port
    # leaves out (the cluster's flags are ported and apply)
    "unported_flag": ("SET enable_timeseries_rewrite = true", KeyError),
}


@pytest.mark.parametrize("name", list(GAPS))
def test_unported_shapes_raise_where_the_reference_answers(ctxs, name):
    ref, port = ctxs
    sql, exc = GAPS[name]
    want = ref.sql(sql)
    assert len(want) > 0
    if exc is None:
        with pytest.raises(RewriteError, match="subqueries"):
            port.plan_sql(sql)
        pd.testing.assert_frame_equal(port.sql(sql), want, check_exact=True)
        return
    if exc == "device":
        assert port.plan_sql(sql).to_json() == ref.plan_sql(sql).to_json()
        pd.testing.assert_frame_equal(port.sql(sql), want, check_exact=True)
        assert port.last_metrics.executor == "device"
        return
    with pytest.raises(exc):
        port.sql(sql)


def test_context_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPUOlapContext()
