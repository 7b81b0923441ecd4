"""Sketch aggregators of the PyTorch port end to end, against the JAX
reference and the truth.

The single-device cases of `tests/test_sketches.py` and
`tests/test_quantiles.py`, run through the port: each native spec runs on
the reference's engine and the port's over the very same segments, and the
frames must be equal (sketch estimates exact, since the states are the same
bits), and within each sketch's error bound of the exact answer.  Also a
native TopN ranked by `hyperUniqueCardinality`, FILTER masks on sketches,
and the SQL surface: APPROX_QUANTILE end to end, its argument checks, the
sharing of one sketch by several fractions, and the DataSketches variants
of approx_count_distinct.
"""

import numpy as np
import pandas as pd
import pytest
from test_torch_engine import to_reference
from test_torch_sql import reference_config

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu.catalog.segment import build_datasource
from spark_druid_olap_tpu.exec.engine import Engine as JaxEngine
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.catalog.segment import (
    DimensionDict,
    datasource_from_numpy,
    datasource_to_numpy,
)
from spark_druid_olap_tpu_torch.exec.engine import Engine
from spark_druid_olap_tpu_torch.models import aggregations as A
from spark_druid_olap_tpu_torch.models.dimensions import DimensionSpec
from spark_druid_olap_tpu_torch.models.filters import Bound
from spark_druid_olap_tpu_torch.models.query import GroupByQuery, TopNQuery
from spark_druid_olap_tpu_torch.plan.planner import RewriteError


def _sk_ds(n=50_000, groups=4, card=3000, seed=0, segs=4):
    """test_sketches.py's data: the distinct domain differs per group."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, groups, size=n)
    v = np.empty(n, dtype=np.int64)
    for i in range(groups):
        m = g == i
        v[m] = rng.integers(0, card * (i + 1), size=int(m.sum()))
    w = rng.integers(0, 100, size=n).astype(np.float32)
    cols = {"g": g.astype(np.int32), "v": v, "w": w}
    return cols, dict(dimension_cols=["g"], metric_cols=["v", "w"], rows_per_segment=n // segs)


def _qt_ds(n=40_000, groups=8, seed=5, segs=3):
    """test_quantiles.py's data."""
    rng = np.random.default_rng(seed)
    cols = {"g": rng.integers(0, groups, n), "v": (rng.random(n) * 100).astype(np.float32)}
    return cols, dict(
        dimension_cols=["g"], metric_cols=["v"], rows_per_segment=n // segs,
        dicts={"g": DimensionDict(values=tuple(range(groups)))},
    )


def _q(*aggs, post=()):
    return GroupByQuery("t", (DimensionSpec("g"),), tuple(aggs), post_aggregations=tuple(post))


def _nunique(cols, where=None):
    df = pd.DataFrame({"g": cols["g"], "v": cols["v"]})
    return (df if where is None else df[where]).groupby("g").v.nunique()


def _quantile_rank(cols, g, est):
    grp = np.sort(np.asarray(cols["v"], np.float64)[np.asarray(cols["g"]) == int(g)])
    return np.searchsorted(grp, est) / len(grp)


def _within(rel):
    def check(got, cols, col="d"):
        truth = _nunique(cols)
        for g, x in zip(got.g, got[col]):
            assert abs(x - truth[int(g)]) / truth[int(g)] < rel, (g, x, truth[int(g)])
    return check


def _check_filtered(got, cols):
    truth = _nunique(cols, cols["w"] >= 50)
    full = _nunique(cols)
    for g, th, hu in zip(got.g, got.th, got.hu):
        t = float(truth[int(g)])
        assert abs(th - t) / t < 0.01 and abs(hu - t) / t < 0.08
        assert abs(th - full[int(g)]) / full[int(g)] > 0.1  # the filter applied


def _check_quantiles(frac, tol):
    def check(got, cols):
        for g, est in zip(got.g, got.q):
            assert abs(_quantile_rank(cols, g, est) - frac) < tol, (g, est)
    return check


def _check_exact_median(got, cols):
    df = pd.DataFrame({"g": cols["g"], "v": cols["v"].astype(np.float64)})
    np.testing.assert_allclose(got.q.values, df.groupby("g")["v"].quantile(0.5).values, rtol=1e-6)


def _check_card(got, cols):
    truth = len(pd.DataFrame({"a": cols["a"], "b": cols["b"]}).drop_duplicates())
    assert abs(got.pairs[0] - truth) / truth < 0.08


def _card_ds():
    rng = np.random.default_rng(9)
    n = 30_000
    cols = {
        "a": rng.integers(0, 50, n).astype(np.int32),
        "b": rng.integers(0, 40, n).astype(np.int32),
        "m": np.ones(n, np.float32),
    }
    return cols, dict(dimension_cols=["a", "b"], metric_cols=["m"])


def _quantile_q(frac, k=1024):
    return _q(A.Count("n"), A.QuantilesSketch("q__qsk", "v", size=k),
              post=(A.QuantileFromSketch("q", "q__qsk", frac),))


_FILTER = Bound("w", lower="50", ordering="numeric")
CASES = {
    "hll_accuracy": (_sk_ds, _q(A.HyperUnique("d", "v", precision=11), A.Count("n")), _within(0.10)),
    "theta_exact_below_k": (lambda: _sk_ds(card=300), _q(A.ThetaSketch("d", "v", size=4096)), _within(1e-9)),
    "theta_above_k": (lambda: _sk_ds(n=120_000, card=20_000, segs=3),
                      _q(A.ThetaSketch("d", "v", size=2048)), _within(0.09)),
    "cardinality_byrow": (_card_ds, GroupByQuery("t", (), (
        A.CardinalityAgg("pairs", ("a", "b"), by_row=True, precision=12),)), _check_card),
    "cardinality_union": (_card_ds, GroupByQuery("t", (), (
        A.CardinalityAgg("pairs", ("a", "b"), precision=12),)), None),
    "filtered_sketches": (lambda: _sk_ds(n=20_000, groups=3, card=2000, segs=3), _q(
        A.FilteredAgg(_FILTER, A.HyperUnique("hu", "v")),
        A.FilteredAgg(_FILTER, A.ThetaSketch("th", "v", size=4096)),
        A.FilteredAgg(_FILTER, A.QuantilesSketch("qs", "w", size=64)),
    ), _check_filtered),
    "quantile_exact_when_group_fits": (lambda: _qt_ds(n=6_000), _quantile_q(0.5), _check_exact_median),
    "quantile_rank_p10": (lambda: _qt_ds(n=200_000, groups=4, segs=4), _quantile_q(0.1), _check_quantiles(0.1, 0.06)),
    "quantile_rank_p90": (lambda: _qt_ds(n=200_000, groups=4, segs=4), _quantile_q(0.9), _check_quantiles(0.9, 0.06)),
    "quantile_sketch_reports_true_n": (lambda: _qt_ds(n=100_000, groups=4, segs=4), _q(
        A.Count("n"), A.QuantilesSketch("sk", "v", size=256)),
        lambda got, cols: np.testing.assert_array_equal(got.sk.values, got.n.values)),
    "topn_hyper_unique_cardinality": (_sk_ds, TopNQuery(
        "t", DimensionSpec("g"), "card", 3,
        (A.HyperUnique("hu", "v"), A.Count("n")),
        post_aggregations=(A.HyperUniqueCardinality("card", "hu"),),
    ), lambda got, cols: _within(0.10)(got, cols, "card")),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sketch_spec_matches_reference_and_truth(name):
    make, spec, check = CASES[name]
    cols, kw = make()
    ref = build_datasource("t", cols, **kw)
    port = datasource_from_numpy(datasource_to_numpy(ref))
    want = JaxEngine().execute(to_reference(spec), ref)
    eng = Engine(device="cpu")
    got = eng.execute(spec, port)
    pd.testing.assert_frame_equal(got, want, check_dtype=False)
    pd.testing.assert_frame_equal(eng.execute(spec, port), got)
    if check is not None:
        check(got.sort_values(list(got.columns[:1])).reset_index(drop=True), cols)


@pytest.mark.parametrize("kind", ["hll", "theta", "quantiles"])
def test_one_segment_equals_eight(kind):
    """Segment count changes nothing for HLL and theta (register max and KMV
    union are lossless); for quantiles it moves row positions and so the
    sampled rows, but each layout stays in the rank bound."""
    rng = np.random.default_rng(5)
    n = 40_000
    cols = {"g": rng.integers(0, 3, n).astype(np.int32),
            "v": rng.integers(0, 5000, n).astype(np.int64)}
    agg = {"hll": A.HyperUnique("x", "v"), "theta": A.ThetaSketch("x", "v", size=1024),
           "quantiles": A.QuantilesSketch("x", "v", size=256)}[kind]
    q = _q(agg, post=(A.QuantileFromSketch("p", "x", 0.5),) if kind == "quantiles" else ())
    outs = []
    for segs in (1, 8):
        ref = build_datasource("t", dict(cols), ["g"], ["v"], rows_per_segment=n // segs)
        got = Engine(device="cpu").execute(q, datasource_from_numpy(datasource_to_numpy(ref)))
        want = JaxEngine().execute(to_reference(q), ref)
        pd.testing.assert_frame_equal(got, want, check_dtype=False)
        outs.append(got.sort_values("g").reset_index(drop=True))
    if kind == "quantiles":
        for out in outs:
            for g, est in zip(out.g, out.p):
                assert abs(_quantile_rank(cols, g, est) - 0.5) < 0.06
    else:
        pd.testing.assert_frame_equal(outs[0], outs[1])


# -- SQL ----------------------------------------------------------------------


def _contexts(cols, **kw):
    ref, port = sd.TPUOlapContext(reference_config()), TPUOlapContext(device="cpu")
    for c in (ref, port):
        c.register_table("t", dict(cols), **kw)
    return ref, port


SQL_CASES = {
    "approx_quantile_by_group": (
        "SELECT d, APPROX_QUANTILE(v, 0.9) AS p90, count(*) AS n FROM t GROUP BY d ORDER BY d"),
    "quantile_filter_clause": "SELECT APPROX_QUANTILE(v, 0.5) FILTER (WHERE v < 5) AS med FROM t",
    "two_fractions_stay_distinct": (
        "SELECT APPROX_QUANTILE(v, 0.1) AS p10, APPROX_QUANTILE(v, 0.9) AS p90 FROM t"),
    "ds_theta_with_size": "SELECT APPROX_COUNT_DISTINCT_DS_THETA(u, 2048) AS d FROM t",
    "ds_hll_with_precision": "SELECT APPROX_COUNT_DISTINCT_DS_HLL(u, 12) AS d FROM t",
}


@pytest.fixture(scope="module")
def sql_ctxs():
    rng = np.random.default_rng(3)
    n = 20_000
    cols = {"d": rng.integers(0, 5, n), "u": rng.integers(0, 5_000, n),
            "v": (rng.random(n) * 10).astype(np.float32)}
    return cols, _contexts(cols, dimensions=["d", "u"], metrics=["v"])


@pytest.mark.parametrize("name", list(SQL_CASES))
def test_sketch_sql_matches_reference(sql_ctxs, name):
    cols, (ref, port) = sql_ctxs
    sql = SQL_CASES[name]
    got = port.sql(sql)
    pd.testing.assert_frame_equal(got, ref.sql(sql), check_dtype=False)
    if name == "quantile_filter_clause":
        assert 2.0 < float(got.med.iloc[0]) < 3.0
    elif name == "two_fractions_stay_distinct":
        assert 0.5 < float(got.p10.iloc[0]) < 1.5 and 8.5 < float(got.p90.iloc[0]) < 9.5
    elif name.startswith("ds_"):
        true = len(np.unique(cols["u"]))
        assert abs(int(got.d.iloc[0]) - true) / true < 0.1
    else:
        for d, est in zip(got.d, got.p90):
            assert abs(_quantile_rank({"g": cols["d"], "v": cols["v"]}, d, est) - 0.9) < 0.06


def test_sketch_sql_plans_and_policy(sql_ctxs):
    _, (_, port) = sql_ctxs
    (a,) = port.plan_sql(SQL_CASES["ds_theta_with_size"]).query.aggregations
    assert isinstance(a, A.ThetaSketch) and a.size == 2048
    (a,) = port.plan_sql(SQL_CASES["ds_hll_with_precision"]).query.aggregations
    assert isinstance(a, A.HyperUnique) and a.precision == 12
    rw = port.plan_sql(
        "SELECT APPROX_QUANTILE(v, 0.1) AS p10, APPROX_QUANTILE(v, 0.5) AS p50, "
        "APPROX_QUANTILE(v, 0.9) AS p90 FROM t"
    )
    assert len([a for a in rw.query.aggregations if isinstance(a, A.QuantilesSketch)]) == 1
    assert len(rw.query.post_aggregations) == 3
    for sql, msg in [
        ("SELECT APPROX_QUANTILE(v, 1.5) AS x FROM t", "fraction must be in"),
        ("SELECT APPROX_QUANTILE(d, 0.5) AS x FROM t", "numeric metric column"),
        ("SELECT APPROX_QUANTILE(v, 0.5, 0) AS x FROM t", "k must be >= 1"),
        ("SELECT APPROX_COUNT_DISTINCT_DS_HLL(u, 3) AS x FROM t", "precision must be in"),
    ]:
        with pytest.raises(RewriteError, match=msg):
            port.plan_sql(sql)
    # the sketch flags are settable; the DataSketches variants stay allowed
    # under count_distinct_mode='error'
    ctx = TPUOlapContext(device="cpu")
    ctx.register_table("t", {"u": np.arange(6_000) % 5_000}, dimensions=["u"])
    for stmt in ("SET approx_count_distinct_sketch = 'theta'", "SET theta_size = 512"):
        ctx.sql(stmt)
    (a,) = ctx.plan_sql("SELECT approx_count_distinct(u) AS d FROM t").query.aggregations
    assert a == A.ThetaSketch("d", "u", size=512)
    ctx.sql("SET count_distinct_mode = 'error'")
    assert int(ctx.sql("SELECT APPROX_COUNT_DISTINCT_DS_THETA(u) AS d FROM t").d.iloc[0]) > 4000
    with pytest.raises(RewriteError, match="disabled by config"):
        ctx.plan_sql("SELECT count(DISTINCT u) AS d FROM t")
