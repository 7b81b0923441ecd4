"""The host fallback of the PyTorch port (`exec/fallback.py`, routed by
`api._run_fallback`) against the JAX reference's.

The same SQL, over tables made from the same seed, goes through the
reference `spark_druid_olap_tpu.TPUOlapContext()` and the port's
`TPUOlapContext(device="cpu")`:

* the shapes of the reference's `test_fallback.py`, `test_window.py`,
  `test_setops.py` and `test_tpch_extended.py` (TPC-H at scale 0.004,
  8192-row segments), each one the reference answers on its fallback
  (its `last_metrics.executor` is checked).  With the assist off on both
  sides (the tables are under `device_assist_min_rows`), both interpret
  in float64 on the host: the frames must be EQUAL, values and dtypes.
* the same shapes with the assist pinned on in both
  (`device_assist_force`, `device_assist_min_rows = 0`): Aggregate
  subtrees run on the engine in float32, so keys and counts exact and
  sums within rtol 1e-6.
* the extended TPC-H classes against the port's float64 oracle
  (`tpch.extended_oracle`), assist on and off.
* the SQL fuzz generator of `test_fuzz_differential.py` under
  `enable_rewrites = False` on both sides: every query on the fallback,
  equal to the reference's frame and to the fuzz oracle.
* routing: a RewritePolicyError raises, `fallback_execution = False`
  re-raises, `fallback_max_rows` raises FallbackSizeError (subqueries
  included), `executor`, `assist_subplans` and the declines are set, and
  an engine failure inside an assisted subtree raises out of `ctx.sql`.
"""

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu.config import SessionConfig as JaxSessionConfig
from spark_druid_olap_tpu.workloads import tpch as jtpch
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.catalog.segment import datasource_from_numpy, datasource_to_numpy
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.exec import engine as tengine
from spark_druid_olap_tpu_torch.exec import fallback as tfallback
from spark_druid_olap_tpu_torch.plan.planner import RewriteError
from spark_druid_olap_tpu_torch.plan.transforms import RewritePolicyError
from spark_druid_olap_tpu_torch.workloads import tpch as ttpch
from test_fuzz_differential import _gen_case, _run_case, fallback_world, world  # noqa: F401

RTOL = 1e-6  # assisted subtrees: float32 partial sums on both sides
ORACLE_RTOL = 2e-5
TPCH_SCALE = 0.004  # ~24K lineitem rows


def _register_small(c):
    """The tables of the reference's fallback, window and set-operation
    tests, from their seeds."""
    rng = np.random.default_rng(7)
    n = 5_000
    c.register_table("fact", {
        "k": rng.integers(0, 50, n),
        "mode": rng.choice(np.array(["A", "B", "C"], dtype=object), n),
        "v": (rng.random(n) * 100).astype(np.float32),
    }, dimensions=["k", "mode"], metrics=["v"])
    c.register_table("other", {
        "ok": np.arange(50, dtype=np.int64),
        "label": np.array([f"label{i % 7}" for i in range(50)], dtype=object),
    })
    rng = np.random.default_rng(11)
    n = 400
    g = rng.choice(np.array(["a", "b", "c", None], dtype=object), n)
    s = rng.choice(np.array(["x", "y"], dtype=object), n)
    v = np.where(rng.random(n) < 0.1, np.nan, rng.integers(0, 40, n))
    c.register_table("w", {"g": g, "s": s, "v": v.astype(np.float64)},
                     dimensions=["g", "s"], metrics=["v"])
    c.register_table("t1", {
        "g": np.array(["a", "a", "b", "b", "c", None], dtype=object),
        "x": np.array([1, 1, 2, 3, 4, 5], dtype=np.int64),
    }, dimensions=["g", "x"])
    c.register_table("t2", {
        "g": np.array(["a", "b", "c", "c", None], dtype=object),
        "x": np.array([1, 2, 4, 4, 5], dtype=np.int64),
    }, dimensions=["g", "x"])
    c.register_table("nl", {"j": np.array([1.0, np.nan, 3.0])})
    c.register_table("f2", {"k": np.array([1.0, 2.0, 3.0, 4.0])})


def _contexts(tables, ref_cfg=None, port_cfg=None):
    ref = sd.TPUOlapContext(config=ref_cfg)
    port = TPUOlapContext(config=port_cfg, device="cpu")
    jtpch.register(ref, tables=tables, rows_per_segment=8192)
    ref.register_table("rawline", tables["lineitem"], time_column="l_shipdate")
    ref.register_table("partsupp", ttpch.partsupp_columns(tables))
    ttpch.register(port, tables=tables, rows_per_segment=8192, extended=True)
    for c in (ref, port):
        _register_small(c)
    return ref, port


@pytest.fixture(scope="module")
def tables():
    return jtpch.gen_tables(scale=TPCH_SCALE)


@pytest.fixture(scope="module")
def host_ctxs(tables):
    """Assist off on both sides: every table is under the row floor."""
    ref, port = _contexts(tables)
    rows = max(port.catalog.get(t).num_rows for t in port.catalog.tables())
    assert rows < port.config.device_assist_min_rows == ref.config.device_assist_min_rows
    return ref, port


@pytest.fixture(scope="module")
def assist_ctxs(tables):
    """The assist pinned on in both packages."""
    ref_cfg, port_cfg = JaxSessionConfig(), SessionConfig()
    for cfg in (ref_cfg, port_cfg):
        cfg.device_assist_force = True
        cfg.device_assist_min_rows = 0
    return _contexts(tables, ref_cfg, port_cfg)


# the reference tests' shapes, each answered on the reference's fallback
SHAPES = {
    # test_fallback.py
    "unconforming_join": "SELECT label, sum(v) AS s, count(*) AS n FROM fact "
                         "JOIN other ON k = ok GROUP BY label ORDER BY label",
    "filters_order_limit": "SELECT label, max(v) AS m FROM fact JOIN other ON k = ok "
                           "WHERE mode = 'A' AND v > 10 GROUP BY label "
                           "HAVING count(*) >= 5 ORDER BY m DESC LIMIT 3",
    "exact_distinct_avg": "SELECT mode, count(DISTINCT k) AS dk, avg(v) AS av FROM fact "
                          "JOIN other ON k = ok GROUP BY mode ORDER BY mode",
    "rollup_post_expr": "SELECT label, sum(v) + 1 AS s1 FROM fact JOIN other ON k = ok "
                        "GROUP BY ROLLUP (label)",
    "hidden_having": "SELECT label, max(v) AS m FROM fact JOIN other ON k = ok "
                     "GROUP BY label HAVING count(*) >= 1",
    "select_star": "SELECT * FROM fact JOIN other ON k = ok WHERE label = 'label1' LIMIT 5",
    "order_unselected": "SELECT sum(v) AS s FROM fact JOIN other ON k = ok "
                        "GROUP BY label ORDER BY label",
    "agg_over_agg": "SELECT avg(s) AS mean_s, count(*) AS groups FROM "
                    "(SELECT k, sum(v) AS s FROM fact GROUP BY k) sub",
    "derived_filter_sort": "SELECT k, s FROM (SELECT k, sum(v) AS s FROM fact GROUP BY k) x "
                           "WHERE s > 9000 ORDER BY s DESC LIMIT 5",
    "derived_alias": "SELECT j FROM (SELECT k AS j FROM fact) x LIMIT 3",
    "union_all": "SELECT mode AS m, sum(v) AS s FROM fact GROUP BY mode UNION ALL "
                 "SELECT label, max(v) FROM fact JOIN other ON k = ok GROUP BY label "
                 "ORDER BY s DESC LIMIT 4",
    "union_all_offset": "SELECT k FROM fact UNION ALL SELECT k FROM fact OFFSET 100",
    "union_all_ordinal": "SELECT mode AS m, sum(v) AS s FROM fact GROUP BY mode "
                         "UNION ALL SELECT mode, min(v) FROM fact GROUP BY mode "
                         "ORDER BY 2 DESC LIMIT 3",
    "in_subquery": "SELECT count(*) AS n FROM fact "
                   "WHERE k IN (SELECT ok FROM other WHERE label = 'label0')",
    "not_in_subquery": "SELECT count(*) AS n FROM fact "
                       "WHERE k NOT IN (SELECT ok FROM other WHERE label = 'label0')",
    "not_in_nulls": "SELECT count(*) AS n FROM f2 WHERE k NOT IN (SELECT j FROM nl)",
    "in_nulls": "SELECT count(*) AS n FROM f2 WHERE k IN (SELECT j FROM nl)",
    "kleene_not_not_in": "SELECT count(*) AS n FROM f2 WHERE NOT (k NOT IN (SELECT j FROM nl))",
    "scalar_subquery": "SELECT count(*) AS n FROM fact WHERE v > (SELECT avg(v) FROM fact)",
    "scalar_in_select": "SELECT max(v) - (SELECT avg(v) FROM fact) AS spread FROM fact",
    "scalar_zero_rows": "SELECT count(*) AS n FROM fact "
                        "WHERE v > (SELECT max(v) FROM fact WHERE v > 1e9)",
    "correlated_in": "SELECT count(*) AS n FROM fact f "
                     "WHERE k IN (SELECT ok FROM other WHERE f.v > 10)",
    "alias_collision": "SELECT count(*) AS n FROM fact f JOIN other o ON k = ok "
                       "WHERE f.k IN (SELECT ok FROM other f)",
    "exists": "SELECT count(*) AS n FROM fact "
              "WHERE EXISTS (SELECT ok FROM other WHERE label = 'label0')",
    "not_exists": "SELECT count(*) AS n FROM fact "
                  "WHERE NOT EXISTS (SELECT ok FROM other WHERE label = 'nope')",
    "exists_and": "SELECT count(*) AS n FROM fact WHERE mode = 'A' AND EXISTS (SELECT ok FROM other)",
    "kleene_null_scalar": "SELECT count(*) AS n FROM fact "
                          "WHERE NOT (v > (SELECT max(v) FROM fact WHERE v > 1e9))",
    "null_scalar_eq": "SELECT count(*) AS n FROM fact "
                      "WHERE v = (SELECT max(v) FROM fact WHERE v > 1e9)",
    # unary functions and casts in post-expressions, rows and aggregates
    "unary_post_expr": "SELECT g, round(sum(v) / 3) AS r, sqrt(sum(v)) AS q2 "
                       "FROM w JOIN t1 ON g = g GROUP BY g",
    "unary_rows": "SELECT g, sqrt(v) AS s, abs(v - 20) AS a, CAST(v AS double) AS c "
                  "FROM w WHERE v IN (SELECT x FROM t1)",
    "unary_in_agg": "SELECT k, sum(sqrt(v)) AS s FROM fact WHERE k IN (SELECT x FROM t1) "
                    "GROUP BY k ORDER BY k",
    # test_window.py
    "ranks": "SELECT g, v, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v) AS rn, "
             "RANK() OVER (PARTITION BY g ORDER BY v) AS rk, "
             "DENSE_RANK() OVER (PARTITION BY g ORDER BY v) AS dr FROM w",
    "window_sums": "SELECT g, v, SUM(v) OVER (PARTITION BY g) AS tot, "
                   "SUM(v) OVER (PARTITION BY g ORDER BY v) AS cum, "
                   "COUNT(*) OVER (PARTITION BY g) AS cnt FROM w",
    "rows_frame": "SELECT g, v, AVG(v) OVER (PARTITION BY g ORDER BY v "
                  "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS ma FROM w",
    "lag_lead": "SELECT g, v, LAG(v) OVER (PARTITION BY g ORDER BY v) AS pv, "
                "LEAD(v, 2, -1.0) OVER (PARTITION BY g ORDER BY v) AS nv FROM w",
    "ntile_first_last": "SELECT v, NTILE(4) OVER (ORDER BY v) AS q, "
                        "FIRST_VALUE(v) OVER (ORDER BY v) AS fv, "
                        "LAST_VALUE(v) OVER (ORDER BY v ROWS BETWEEN UNBOUNDED "
                        "PRECEDING AND UNBOUNDED FOLLOWING) AS lv FROM w",
    "top_n_per_group": "SELECT g, s, sum(v) AS sv, "
                       "RANK() OVER (PARTITION BY g ORDER BY sum(v) DESC) AS r "
                       "FROM w GROUP BY g, s ORDER BY g, r",
    "window_filter": "SELECT g, COUNT(*) FILTER (WHERE v > 20) OVER (PARTITION BY g) AS big FROM w",
    "share_of_total": "SELECT v, 100 * v / SUM(v) OVER () AS pct FROM w",
    "window_in_expr": "SELECT v - AVG(v) OVER (PARTITION BY g) AS c1, "
                      "AVG(v) OVER (PARTITION BY g) AS c2 FROM w",
    "window_scalar_subquery": "SELECT v, (SELECT max(x) FROM t1) AS mx, "
                              "ROW_NUMBER() OVER (ORDER BY v) AS rn FROM w",
    "window_in_subquery": "SELECT v, ROW_NUMBER() OVER (ORDER BY v) AS rn FROM w "
                          "WHERE v IN (SELECT x * 10 FROM t1)",
    "window_group_alias": "SELECT g AS grp, s, sum(v) AS sv, "
                          "RANK() OVER (PARTITION BY g ORDER BY sum(v) DESC) AS r "
                          "FROM w GROUP BY g, s",
    "window_expr_partition": "SELECT length(s) AS ls, sum(v) AS sv, "
                             "RANK() OVER (PARTITION BY length(s) ORDER BY sum(v)) AS r "
                             "FROM w GROUP BY length(s)",
    "window_over_alias": "SELECT g, sum(v) AS sv, RANK() OVER (ORDER BY sv) AS r "
                         "FROM w GROUP BY g",
    "percent_rank_nth": "SELECT v, PERCENT_RANK() OVER (ORDER BY v) AS pr, "
                        "CUME_DIST() OVER (ORDER BY v) AS cd, "
                        "NTH_VALUE(v, 2) OVER (ORDER BY v ROWS BETWEEN UNBOUNDED "
                        "PRECEDING AND UNBOUNDED FOLLOWING) AS n2 FROM w",
    # test_setops.py
    "union": "SELECT g, x FROM t1 UNION SELECT g, x FROM t2",
    "union_all_bag": "SELECT g, x FROM t1 UNION ALL SELECT g, x FROM t2",
    "intersect": "SELECT g, x FROM t1 INTERSECT SELECT g, x FROM t2",
    "intersect_all": "SELECT g, x FROM t1 INTERSECT ALL SELECT g, x FROM t2",
    "except": "SELECT g, x FROM t1 EXCEPT SELECT g, x FROM t2",
    "except_all": "SELECT g, x FROM t2 EXCEPT ALL SELECT g, x FROM t1",
    "setop_precedence": "SELECT g FROM t1 EXCEPT SELECT g FROM t2 UNION SELECT g FROM t1",
    "setop_chain": "SELECT g, x FROM t1 UNION ALL SELECT g, x FROM t2 EXCEPT SELECT g, x FROM t2",
    "setop_aggregates": "SELECT g, count(*) AS n FROM t1 GROUP BY g "
                        "INTERSECT SELECT g, count(*) AS n FROM t2 GROUP BY g ORDER BY g",
}
# test_tpch_extended.py: every class but q9, which stays on the device
SHAPES.update({f"tpch_{n}": q for n, q in ttpch.EXTENDED_QUERIES.items() if n != "q9"})

# statements both packages reject on the fallback, with the same error
REJECTED = {
    "derived_scope": ("SELECT v FROM (SELECT k FROM fact) x", KeyError),
    "scalar_many_rows": ("SELECT count(*) AS n FROM fact WHERE v > (SELECT v FROM fact)",
                         ValueError),
}


def _keys(frame):
    return [c for c in frame.columns if frame[c].dtype.kind not in "fc"]


def _sorted(frame, keys):
    if not keys:
        return frame.reset_index(drop=True)
    k = frame[keys].astype(object).where(frame[keys].notna(), "\x00null").astype(str)
    order = np.lexsort([k[c].to_numpy() for c in reversed(keys)])
    return frame.iloc[order].reset_index(drop=True)


def assert_close(got, want, rtol=RTOL, what=""):
    """Keys and counts exact, float columns within rtol, rows compared
    after sorting by the non-float columns."""
    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want), what
    keys = _keys(want)
    got, want = _sorted(got, keys), _sorted(want, keys)
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if c in keys:
            assert list(pd.Series(g).astype(object).where(pd.notna(g), None)) == list(
                pd.Series(w).astype(object).where(pd.notna(w), None)), (what, c)
        else:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=rtol,
                                       equal_nan=True, err_msg=f"{what} {c}")


@pytest.mark.parametrize("name", list(SHAPES))
def test_host_fallback_equals_reference(host_ctxs, name):
    """Both packages interpret on the host in float64: equal frames."""
    ref, port = host_ctxs
    want = ref.sql(SHAPES[name])
    assert ref.last_metrics.executor == "fallback", name
    got = port.sql(SHAPES[name])
    m = port.last_metrics
    assert (m.executor, m.query_type, m.strategy, m.assist_subplans) == (
        "fallback", "fallback", "host-pandas", 0)
    pd.testing.assert_frame_equal(got, want, check_exact=True, obj=name)


@pytest.mark.parametrize("name", list(SHAPES))
def test_assisted_fallback_matches_reference(assist_ctxs, name):
    """The assist pinned on in both: Aggregate subtrees on the engine."""
    ref, port = assist_ctxs
    want = ref.sql(SHAPES[name])
    assert ref.last_metrics.executor in ("fallback", "device+fallback"), name
    got = port.sql(SHAPES[name])
    m = port.last_metrics
    assert m.executor == ("device+fallback" if m.assist_subplans else "fallback"), name
    assert_close(got, want, what=name)


@pytest.mark.parametrize("name", list(REJECTED))
def test_fallback_rejects_what_the_reference_rejects(host_ctxs, name):
    ref, port = host_ctxs
    sql, exc = REJECTED[name]
    with pytest.raises(exc):
        ref.sql(sql)
    with pytest.raises(exc):
        port.sql(sql)


@pytest.mark.parametrize("name", list(ttpch.EXTENDED_QUERIES))
@pytest.mark.parametrize("assist", ["off", "on"])
def test_extended_tpch_matches_oracle(host_ctxs, assist_ctxs, tables, name, assist):
    """The extended TPC-H classes against their float64 oracle; q9 stays
    on the device, the rest run on the fallback."""
    _, port = host_ctxs if assist == "off" else assist_ctxs
    got = port.sql(ttpch.EXTENDED_QUERIES[name])
    m = port.last_metrics
    if name == "q9":
        assert m.executor == "device"
    else:
        assert m.executor in ("fallback", "device+fallback")
        assert (m.assist_subplans > 0) == (m.executor == "device+fallback")
    assert_close(got, ttpch.extended_oracle(tables, name), rtol=ORACLE_RTOL, what=name)


def test_extended_tpch_assists_on_the_engine(assist_ctxs):
    """With the assist pinned on, the GROUP BY subtrees the planner rewrites
    run on the engine: q2's under the window, q15's two derived tables,
    q4's EXISTS inner grouping, q16's and q20's outer groupings."""
    _, port = assist_ctxs
    assisted = {}
    for name in ("q2", "q4", "q15", "q16", "q20"):
        port.sql(ttpch.EXTENDED_QUERIES[name])
        assisted[name] = port.last_metrics.assist_subplans
    assert assisted == {"q2": 1, "q4": 1, "q15": 2, "q16": 1, "q20": 1}


# -- the SQL fuzz generator on the fallback ----------------------------------


@pytest.fixture(scope="module")
def port_fuzz(fallback_world):
    """The fuzz world's data in a port context whose planner is disabled,
    as the reference's `fallback_world` is.  The port gets its own copies
    of the reference's segments: segment uids key the port's caches, and
    the reference's uids come from another counter."""
    ref, df = fallback_world
    port = TPUOlapContext(config=SessionConfig(enable_rewrites=False), device="cpu")
    for t in ("f", "aux"):
        port.register_datasource(datasource_from_numpy(datasource_to_numpy(ref.catalog.get(t))))
    return ref, port, df


@pytest.mark.parametrize("seed", list(range(30)) + [100, 127])
def test_fuzz_fallback_matches_reference_and_oracle(port_fuzz, seed):
    ref, port, df = port_fuzz
    _run_case(port, df, seed)
    q = _gen_case(df, seed)[0]
    got = port.sql(q)
    assert port.last_metrics.executor == "fallback"
    want = ref.sql(q)
    assert ref.last_metrics.executor == "fallback"
    pd.testing.assert_frame_equal(got, want, check_exact=True, obj=q)


# -- routing ------------------------------------------------------------------


# the assist's cost gate priced to assist every subtree (an interpreted row
# costs more than any engine run): the routing cases below hold the rules
# around it; `test_torch_cost.py` holds the gate
ASSIST_ANY = {"cost_per_row_interp": 1e9}


def _routing_ctx(cfg=None):
    c = TPUOlapContext(config=cfg or SessionConfig(**ASSIST_ANY), device="cpu")
    _register_small(c)
    return c


def test_policy_error_and_disabled_fallback_raise():
    c = _routing_ctx(SessionConfig(count_distinct_mode="error"))
    with pytest.raises(RewritePolicyError):
        c.sql("SELECT mode, count(DISTINCT k) AS d FROM fact GROUP BY mode")
    c = _routing_ctx(SessionConfig(fallback_execution=False))
    with pytest.raises(RewriteError, match="subqueries"):
        c.sql(SHAPES["in_subquery"])
    c.sql("SET fallback_execution = true")
    assert int(c.sql(SHAPES["in_subquery"]).n.iloc[0]) > 0


def test_size_guard_covers_subqueries():
    c = _routing_ctx()
    c.sql("SET fallback_max_rows = 1000")
    with pytest.raises(tfallback.FallbackSizeError, match="fallback_max_rows"):
        c.sql(SHAPES["unconforming_join"])  # 5050 rows
    with pytest.raises(tfallback.FallbackSizeError):
        c.sql("SELECT count(*) AS n FROM t1 WHERE x IN (SELECT k FROM fact)")
    c.sql("SET fallback_max_rows = 0")  # 0 disables the guard
    assert len(c.sql(SHAPES["unconforming_join"])) == 7


def test_metrics_record_executor_assists_and_declines():
    c = _routing_ctx()
    c.sql(SHAPES["top_n_per_group"])
    m = c.last_metrics
    assert (m.executor, m.assist_subplans, m.rows_scanned, m.datasource) == (
        "fallback", 0, 400, "w")
    assert m.declines == ["assist: 400 input rows < device_assist_min_rows 262144"]
    assert m.total_ms > 0
    c.sql("SET device_assist_min_rows = 0")
    for name, want in (
        ("top_n_per_group", []),
        ("agg_over_agg", ["assist: cannot rewrite plan node SubqueryScan under Aggregate"]),
        # the outer Aggregate's hidden max(v) is not in the rewrite's frame
        ("scalar_in_select", ["assist: the rewrite's frame lacks ['__agg0']"]),
    ):
        c.sql(SHAPES[name])
        m = c.last_metrics
        assert (m.executor, m.assist_subplans, m.declines) == ("device+fallback", 1, want), name
    # a Timeseries rewrite under 2^23 rows declines unless forced
    c.register_table("ev", {"ts": np.arange(100, dtype=np.int64) * 3_600_000,
                            "v": np.arange(100, dtype=np.float32)}, time_column="ts")
    sql = ("SELECT max(s) AS m FROM (SELECT date_trunc('day', ts) AS d, sum(v) AS s "
           "FROM ev GROUP BY date_trunc('day', ts)) x")
    c.sql(sql)
    m = c.last_metrics
    assert (m.assist_subplans, m.declines) == (0, [
        "assist: cannot rewrite plan node SubqueryScan under Aggregate",
        "assist: TimeseriesQuery over 100 rows < 8388608"])
    c.sql("SET device_assist_force = true")
    c.sql(sql)
    assert c.last_metrics.assist_subplans == 1
    # a device query after a fallback one reports the engine's metrics
    c.sql("SELECT mode, sum(v) AS s FROM fact GROUP BY mode")
    assert c.last_metrics.executor == "device" and c.last_metrics.query_type == "groupBy"


def test_engine_failure_in_an_assisted_subtree_raises(monkeypatch):
    """No silent fallback: an engine error inside the assist propagates."""
    c = _routing_ctx(SessionConfig(device_assist_min_rows=0, **ASSIST_ANY))

    def broken(self, q, ds, strategy=None):
        raise RuntimeError("engine failure")

    monkeypatch.setattr(tengine.Engine, "execute", broken)
    with pytest.raises(RuntimeError, match="engine failure"):
        c.sql(SHAPES["top_n_per_group"])


def test_drop_table_and_clear_cache_evict_decoded_segments():
    c = _routing_ctx()
    c.sql(SHAPES["top_n_per_group"])
    uids = {s.uid for s in c.catalog.get("w").segments}
    cache = tfallback._decoded_segment_cache()
    assert uids & {k[0] for k in cache}
    c.drop_table("w")
    assert not uids & {k[0] for k in cache}
    c.sql(SHAPES["union"])
    uids = {s.uid for t in ("t1", "t2") for s in c.catalog.get(t).segments}
    assert uids & {k[0] for k in cache}
    c.clear_cache()
    assert not uids & {k[0] for k in cache}


def test_scans_still_raise_not_implemented(host_ctxs):
    """A plain non-aggregate SELECT plans to a Scan query, in both packages
    answered on the device, not on the host fallback (the port raised
    NotImplementedError before it executed scans)."""
    ref, port = host_ctxs
    sql = "SELECT k, v FROM fact WHERE v > 99 LIMIT 5"
    want = ref.sql(sql)
    assert len(want) == 5
    assert port.plan_sql(sql).is_scan
    pd.testing.assert_frame_equal(port.sql(sql), want, check_exact=True)
    assert port.last_metrics.executor == "device"


def test_wire_aggregator_registry_matches_reference():
    from spark_druid_olap_tpu.exec.fallback import WIRE_AGG_FALLBACK as REF

    assert {c.__name__: f for c, f in tfallback.WIRE_AGG_FALLBACK.items()} == {
        c.__name__: f for c, f in REF.items()}


SCALAR_VALUES = {
    "all_null": [None, None],
    "floats_nan": [1.0, None, np.nan],
    "ints": [1, 2, None],
    "int_at_2_53": [1, 2**53],
    "int_below_2_53": [1, -2**53 + 1],
    "mixed": [1.5, 2],
    "big_int_and_float": [2**60, 1.0],
    "bools": [True, 1],
    "strings": ["a", 1],
    "numpy_int": [np.int64(3), None],
    "float32_and_huge": [np.float32(1.5), 2**70],
}


@pytest.mark.parametrize("name", list(SCALAR_VALUES))
def test_correlated_scalar_column_types_match_reference(name):
    """A correlated scalar subquery's per-row values become float64 where
    that is exact, as the reference's `_correlated_series` decides."""
    from spark_druid_olap_tpu.exec import fallback as jfallback
    from spark_druid_olap_tpu.plan import expr as jexpr
    from spark_druid_olap_tpu_torch.plan import expr as texpr

    vals = SCALAR_VALUES[name]
    out = np.empty(len(vals), dtype=object)
    out[:] = vals
    frame = pd.DataFrame(index=range(len(vals)))
    want = jfallback._correlated_series(
        jexpr.ScalarSubquery.__new__(jexpr.ScalarSubquery), out.copy(), frame)
    got = tfallback._correlated_series(
        texpr.ScalarSubquery.__new__(texpr.ScalarSubquery), out.copy(), frame)
    pd.testing.assert_series_equal(got, want)
