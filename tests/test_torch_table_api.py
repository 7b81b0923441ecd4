"""Lookups and the TableQuery API of the PyTorch port, against the JAX
reference: the cases of `tests/test_lookups.py` and
`tests/test_dataframe_api.py`, each run through both packages on the same
columns.  Keys and counts exact, float32 sums within rtol 1e-6."""

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu.models import wire as jwire
from spark_druid_olap_tpu.plan import expr as JE
from spark_druid_olap_tpu.plan.planner import RewriteError as RefRewriteError
from spark_druid_olap_tpu_torch import api as tapi
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.models import aggregations as TA
from spark_druid_olap_tpu_torch.models import dimensions as TD
from spark_druid_olap_tpu_torch.models import query as TQ
from spark_druid_olap_tpu_torch.models import wire as twire
from spark_druid_olap_tpu_torch.plan import expr as TE
from spark_druid_olap_tpu_torch.plan.planner import RewriteError

RTOL = 1e-6

NATION_TO_REGION = {
    "FRANCE": "EUROPE", "GERMANY": "EUROPE",
    "CHINA": "ASIA", "JAPAN": "ASIA",
    "BRAZIL": "AMERICA",
}


def assert_same(got, want, sort=None):
    """Same columns and rows; non-float columns exact, floats within RTOL."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    if sort:
        got = got.sort_values(sort, kind="stable", na_position="last").reset_index(drop=True)
        want = want.sort_values(sort, kind="stable", na_position="last").reset_index(drop=True)
    for c in want.columns:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=RTOL, err_msg=c)
        else:
            assert list(g) == list(w), c


# -- lookups (tests/test_lookups.py) -------------------------------------------


def _nation_columns():
    rng = np.random.default_rng(4)
    n = 20_000
    nations = np.array(sorted(NATION_TO_REGION) + ["ATLANTIS"], dtype=object)
    return {"nation": rng.choice(nations, n), "v": rng.random(n).astype(np.float32)}


def _lookup_ctx(ctx):
    ctx.register_table("t", _nation_columns(), dimensions=["nation"], metrics=["v"])
    ctx.register_lookup("n2r", NATION_TO_REGION)
    return ctx


@pytest.fixture(scope="module")
def lookup_ctxs():
    # the port routed by the card's constants (the class defaults): the
    # kernel's class, as before the cost model (the CPU profile's scatter
    # adds a group's rows in another order than the reference)
    return (_lookup_ctx(sd.TPUOlapContext()),
            _lookup_ctx(TPUOlapContext(SessionConfig(), device="cpu")))


LOOKUP_SQL = {
    "group_by": (
        "SELECT LOOKUP(nation, 'n2r') AS region, sum(v) AS s, count(*) AS n "
        "FROM t GROUP BY LOOKUP(nation, 'n2r') ORDER BY region"),
    "replace_missing_third_arg": (
        "SELECT LOOKUP(nation, 'n2r', 'UNKNOWN') AS region, count(*) AS n "
        "FROM t GROUP BY LOOKUP(nation, 'n2r', 'UNKNOWN') ORDER BY region"),
}


@pytest.mark.parametrize("name", list(LOOKUP_SQL))
def test_lookup_sql_matches_reference(lookup_ctxs, name):
    ref, port = lookup_ctxs
    sql = LOOKUP_SQL[name]
    assert port.plan_sql(sql).to_json() == ref.plan_sql(sql).to_json()
    want, got = ref.sql(sql), port.sql(sql)
    assert_same(got, want)
    # ATLANTIS is unmapped: the null group, or the replacement
    atlantis = int((_nation_columns()["nation"] == "ATLANTIS").sum())
    region = got["region"]
    nulls = got[region.isna()] if name == "group_by" else got[region == "UNKNOWN"]
    assert int(nulls["n"].iloc[0]) == atlantis


def test_unknown_lookup_raises(lookup_ctxs):
    ref, port = lookup_ctxs
    sql = ("SELECT LOOKUP(nation, 'nope') AS r, count(*) AS n "
           "FROM t GROUP BY LOOKUP(nation, 'nope')")
    with pytest.raises(RefRewriteError, match="unknown lookup"):
        ref.plan_sql(sql)
    with pytest.raises(RewriteError, match="unknown lookup"):
        port.plan_sql(sql)
    # a policy error: the host fallback does not swallow it
    with pytest.raises(RewriteError, match="unknown lookup"):
        port.sql(sql)


def test_lookup_registration_invalidates_plan_cache(lookup_ctxs):
    ref, port = lookup_ctxs
    sql = ("SELECT LOOKUP(nation, 'n2r') AS region, count(*) AS n "
           "FROM t GROUP BY LOOKUP(nation, 'n2r')")
    before = port.sql(sql)
    for ctx in (ref, port):
        ctx.register_lookup("n2r", {k: "X" for k in NATION_TO_REGION})
    try:
        want, after = ref.sql(sql), port.sql(sql)
        assert set(after["region"].dropna()) == {"X"} and after["region"].isna().any()
        assert len(before) > len(after)
        assert_same(after, want, sort=["region"])
    finally:
        for ctx in (ref, port):
            ctx.register_lookup("n2r", NATION_TO_REGION)


def test_clear_cache_drops_lookups():
    """CLEAR CACHE drops the lookup tables with the catalog (the reference
    keeps them)."""
    ctx = _lookup_ctx(TPUOlapContext(device="cpu"))
    assert ctx.catalog.lookup("n2r") == NATION_TO_REGION
    version = ctx.catalog.version
    ctx.sql("CLEAR CACHE")
    assert ctx.catalog.lookup("n2r") is None and ctx.catalog.version > version


def test_lookup_wire_roundtrip(lookup_ctxs):
    ref, port = lookup_ctxs
    sql = ("SELECT LOOKUP(nation, 'n2r') AS region, sum(v) AS s "
           "FROM t GROUP BY LOOKUP(nation, 'n2r')")
    rw = port.plan_sql(sql)
    q2 = twire.query_from_druid(rw.query.to_druid())
    # the decoded spec equals the planned one (same lookup name, same
    # normalized mapping), so the engine's caches take them as one query
    assert q2 == rw.query
    got = port.engine.execute(q2, port.catalog.get("t"))
    want_q = jwire.query_from_druid(ref.plan_sql(sql).query.to_druid())
    want = ref.engine.execute(want_q, ref.catalog.get("t"))
    assert_same(got, want, sort=["region"])


def test_lookup_unmapped_to_null_without_retain(lookup_ctxs):
    """No retain and no replacement: unmapped values become the null
    group."""
    from spark_druid_olap_tpu.models import aggregations as JA
    from spark_druid_olap_tpu.models import dimensions as JD
    from spark_druid_olap_tpu.models import query as JQ

    ref, port = lookup_ctxs
    frames = []
    for ctx, A, D, Q in ((ref, JA, JD, JQ), (port, TA, TD, TQ)):
        ex = D.LookupExtraction("n2r", tuple(sorted(NATION_TO_REGION.items())),
                                retain_missing=False)
        q = Q.GroupByQuery(datasource="t",
                           dimensions=(D.DimensionSpec("nation", "region", extraction=ex),),
                           aggregations=(A.Count("n"),))
        frames.append(ctx.engine.execute(q, ctx.catalog.get("t")))
    want, got = frames
    assert_same(got, want, sort=["region"])
    assert "ATLANTIS" not in set(got["region"].dropna())
    assert int(got[got["region"].isna()]["n"].iloc[0]) == int(
        (_nation_columns()["nation"] == "ATLANTIS").sum())


# -- TableQuery (tests/test_dataframe_api.py) ----------------------------------


def _sales_columns():
    rng = np.random.default_rng(5)
    n = 10_000
    return {
        "region": rng.choice(np.array(["na", "emea", "apac"], dtype=object), n),
        "sku": rng.choice(np.array([f"sku{i}" for i in range(40)], dtype=object), n),
        "price": (rng.random(n) * 90 + 10).astype(np.float32),
        "qty": rng.integers(1, 9, n).astype(np.float32),
    }


def _sales_ctx(ctx):
    ctx.register_table("sales", _sales_columns(), dimensions=["region", "sku"],
                       metrics=["price", "qty"])
    return ctx


@pytest.fixture(scope="module")
def sales_ctxs():
    return _sales_ctx(sd.TPUOlapContext()), _sales_ctx(TPUOlapContext(device="cpu"))


def _both(sales_ctxs, build):
    """`build(ctx, E)` run against the reference and the port; returns
    (reference frame, port frame)."""
    ref, port = sales_ctxs
    return build(ref, JE).collect(), build(port, TE).collect()


def _grouped(ctx, E):
    return (
        ctx.table("sales")
        .where(E.col("region").eq("na") | E.col("region").eq("emea"))
        .group_by("region", "sku")
        .agg(rev=("sum", E.col("price") * E.col("qty")), n=("count", None))
        .having(E.col("n") > 50)
        .order_by("rev", ascending=False)
        .limit(10)
    )


def test_grouped_agg_with_having_and_order(sales_ctxs):
    want, got = _both(sales_ctxs, _grouped)
    assert list(got.columns) == ["region", "sku", "rev", "n"]
    assert_same(got, want)
    f = pd.DataFrame(_sales_columns())
    f = f[f.region.isin(["na", "emea"])].assign(rev=f.price.astype(float) * f.qty)
    oracle = f.groupby(["region", "sku"]).agg(rev=("rev", "sum"), n=("rev", "size"))
    oracle = oracle[oracle.n > 50].sort_values("rev", ascending=False).head(10)
    np.testing.assert_allclose(got["rev"].astype(float), oracle["rev"].values, rtol=2e-5)


def test_projection_select(sales_ctxs):
    want, got = _both(sales_ctxs, lambda c, E: c.table("sales").where(
        E.col("qty") >= 8).select("region", revenue=E.col("price") * E.col("qty")).limit(5))
    assert list(got.columns) == ["region", "revenue"] and len(got) == 5
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    want, got = _both(sales_ctxs, lambda c, E: c.table("sales").where(
        E.col("qty") >= 8).select("region"))
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert len(got) == int((_sales_columns()["qty"] >= 8).sum())


def test_chaining_is_immutable(sales_ctxs):
    _, port = sales_ctxs
    base = port.table("sales").group_by("region").agg(n=("count", None))
    a = base.having(TE.col("n") > 100)
    b = base.order_by("n")
    assert base._having is None and len(base._sort) == 0
    assert a._having is not None and len(b._sort) == 1
    assert len(a.collect()) <= 3 and len(b.collect()) == 3


def test_offset_and_explain(sales_ctxs):
    ref, port = sales_ctxs

    def q(ctx):
        return (ctx.table("sales").group_by("region").agg(n=("count", None))
                .order_by("n", ascending=False))

    full = q(port).collect()
    skip = q(port).limit(10, offset=1).collect()
    assert list(skip["region"]) == list(full["region"][1:])
    assert_same(skip, q(ref).limit(10, offset=1).collect())
    text = q(port).explain()
    assert "== Rewrite: GroupByQuery ==" in text and "Logical Plan" in text


def test_select_with_groups_rejected(sales_ctxs):
    _, port = sales_ctxs
    with pytest.raises(ValueError, match="non-aggregate"):
        port.table("sales").select("region").group_by("region").agg(
            n=("count", None))._logical()
    with pytest.raises(ValueError, match="having"):
        port.table("sales").having(TE.col("n") > 1)._logical()


def test_dsl_fallback_routing(sales_ctxs):
    """A plan the planner refuses (a NULL-producing CASE in the filter) runs
    on the host fallback, as the SQL path routes it."""
    def build(ctx, E):
        nullif = E.IfExpr(E.Comparison("==", E.col("qty"), E.lit(1.0)),
                          E.Literal(None), E.col("qty"))
        return (ctx.table("sales").where(E.Comparison("==", nullif, E.lit(2.0)))
                .group_by("region").agg(n=("count", None)))

    want, got = _both(sales_ctxs, build)
    assert sales_ctxs[1].last_metrics.executor == "fallback"
    assert_same(got, want, sort=["region"])
    f = pd.DataFrame(_sales_columns())
    assert dict(zip(got["region"], got["n"].astype(int))) == (
        f[f.qty == 2.0].groupby("region").size().to_dict())


def test_arrow_in_and_out():
    """Arrow in and Arrow out: NULL dimension values are Arrow nulls."""
    pa = pytest.importorskip("pyarrow")
    t = pa.table({"g": pa.array(["a", "b", None, "a"]), "v": pa.array([1.0, 2.0, 3.0, 4.0])})
    outs = []
    for c in (sd.TPUOlapContext(), TPUOlapContext(device="cpu")):
        c.register_table("arr", t, dimensions=["g"], metrics=["v"])
        out = c.sql_arrow("SELECT g, sum(v) AS s FROM arr GROUP BY g ORDER BY g")
        out2 = c.table("arr").group_by("g").agg(n=("count", None)).collect_arrow()
        assert isinstance(out, pa.Table) and out2.num_rows == 3
        outs.append((out.to_pydict(), out2.to_pydict()))
    (want, want2), (got, got2) = outs
    assert got == want and got2 == want2
    assert got["s"] == [5.0, 2.0, 3.0] and got["g"] == ["a", "b", None]


def test_module_level_context_runs_on_the_card(monkeypatch):
    """`register_table`, `sql`, `table` and `explain` of the module use one
    default context, which runs on the card: without one it raises."""
    import torch

    monkeypatch.setattr(tapi, "_default_ctx", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.sql("SELECT 1")
    cpu = TPUOlapContext(device="cpu")
    monkeypatch.setattr(tapi, "_default_ctx", cpu)
    tapi.register_table("sales", _sales_columns(), dimensions=["region", "sku"],
                        metrics=["price", "qty"])
    sql = "SELECT region, count(*) AS n FROM sales GROUP BY region"
    got = tapi.sql(sql)
    assert tapi.default_context() is cpu and int(got["n"].sum()) == 10_000
    assert tapi.table("sales").group_by("region").agg(n=("count", None)).collect().equals(got)
    assert "GroupByQuery" in tapi.explain(sql)
