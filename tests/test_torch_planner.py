"""SQL front end of the PyTorch port against the JAX reference: parser and
planner parity, and the strategy hand-off to the engine.

* For every SQL string of the port's SQL tests, the port's `parse_sql`
  logical plan equals the reference's (a structural dump: class names and
  fields, recursively).
* The planned Druid JSON (`plan_sql(sql).query.to_druid()`) is equal
  between the packages for the rewrite-golden cases (and equals
  `tests/goldens/rewrites.json`), the 13 SSB queries and every TPC-H query;
  the SSB and TPC-H Q1 plans also equal the port's own native specs.
* On the SQL path the engine resolves the same group-by strategy as the
  native path for the same spec, and on a card no SQL query reaches the
  kernel's plain twin (`dense_partial_aggregate`): checked by making the
  engine resolve strategies for a CUDA device while it runs on the CPU.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu.sql.parser import parse_sql as jparse
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu.workloads import tpch as jtpch
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.exec import engine as tengine
from spark_druid_olap_tpu_torch.ops import cuda_groupby as tcuda
from spark_druid_olap_tpu_torch.ops import groupby as tgroupby
from spark_druid_olap_tpu_torch.sql.parser import parse_sql as tparse
from spark_druid_olap_tpu_torch.workloads import ssb as tssb
from spark_druid_olap_tpu_torch.workloads import tpch as ttpch

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "rewrites.json")

# the rewrite-golden cases of tests/test_rewrite_goldens.py, over `li`
GOLDEN_CASES = {
    "basic_groupby": (
        "SELECT flag, sum(price) AS rev, count(*) AS n FROM li GROUP BY flag"
    ),
    "filters_and_interval": (
        "SELECT flag, sum(price) AS rev FROM li "
        "WHERE mode IN ('AIR', 'MAIL') AND qty < 25 "
        "AND ts >= '1995-03-01' AND ts < '1995-06-01' GROUP BY flag"
    ),
    "topn": (
        "SELECT mode, sum(price) AS rev FROM li GROUP BY mode "
        "ORDER BY rev DESC LIMIT 2"
    ),
    "timeseries_month": (
        "SELECT date_trunc('month', ts) AS m, sum(qty) AS q FROM li "
        "GROUP BY date_trunc('month', ts)"
    ),
    "avg_rewrite_and_having": (
        "SELECT flag, avg(price) AS ap FROM li GROUP BY flag "
        "HAVING count(*) > 10"
    ),
    "expression_agg": (
        "SELECT flag, sum(price * (1 - qty / 100)) AS disc FROM li "
        "GROUP BY flag"
    ),
    "not_in_null_list": (
        "SELECT count(*) AS n FROM li WHERE mode NOT IN ('AIR', NULL)"
    ),
    "strfunc_filter": (
        "SELECT count(*) AS n FROM li WHERE LENGTH(mode) = 3"
    ),
}

# the statements the port's SQL tests send besides the workload queries
OTHER_SQL = {
    "subquery": (
        "SELECT flag, sum(price) AS rev FROM li WHERE mode IN "
        "(SELECT mode FROM li WHERE qty > 40) GROUP BY flag"
    ),
    "count_distinct": "SELECT flag, count(DISTINCT mode) AS m FROM li GROUP BY flag",
    "cube": (
        "SELECT flag, mode, sum(price) AS rev FROM li "
        "GROUP BY CUBE (flag, mode)"
    ),
    "scan": "SELECT flag, qty FROM li WHERE qty > 45 LIMIT 5",
    "view_select": "SELECT flag, sum(rev) AS total FROM v GROUP BY flag",
}

ALL_SQL = {
    **{f"golden:{k}": v for k, v in GOLDEN_CASES.items()},
    **{f"ssb:{k}": v for k, v in jssb.QUERIES.items()},
    **{f"tpch:{k}": v for k, v in jtpch.QUERIES.items()},
    **{f"other:{k}": v for k, v in OTHER_SQL.items()},
}
VIEWS = {"v": "SELECT flag, sum(price) AS rev FROM li GROUP BY flag, mode"}


def li_columns():
    """The `li` table of tests/test_rewrite_goldens.py."""
    n = 1000
    rng = np.random.default_rng(3)
    ts = (
        np.datetime64("1995-01-01", "ms").astype(np.int64)
        + rng.integers(0, 365, n) * 86_400_000
    )
    return {
        "flag": rng.choice(np.array(["A", "N", "R"], dtype=object), n),
        "mode": rng.choice(np.array(["AIR", "MAIL", "SHIP"], dtype=object), n),
        "qty": rng.integers(1, 50, n).astype(np.float32),
        "price": (rng.random(n) * 1000).astype(np.float32),
        "ts": ts,
    }


def register_all(ctx, ssb_mod, tpch_mod, ssb_tables, tpch_tables):
    ctx.register_table(
        "li", li_columns(), dimensions=["flag", "mode"],
        metrics=["qty", "price"], time_column="ts",
    )
    ssb_mod.register(ctx, tables=ssb_tables, rows_per_segment=16384)
    tpch_mod.register(ctx, tables=tpch_tables)
    return ctx


@pytest.fixture(scope="module")
def ctxs():
    """(reference context, port context) over the same data."""
    st = jssb.gen_tables(scale=0.01, seed=11)
    tt = jtpch.gen_tables(scale=0.01)
    ref = register_all(sd.TPUOlapContext(), jssb, jtpch, st, tt)
    port = register_all(TPUOlapContext(device="cpu"), tssb, ttpch, st, tt)
    return ref, port


def dump(obj):
    """Structural dump of a parse tree: class names and fields, recursively
    (module paths differ between the packages; everything else must not)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [type(obj).__name__, {
            f.name: dump(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        }]
    if isinstance(obj, (list, tuple)):
        return [type(obj).__name__, [dump(x) for x in obj]]
    if isinstance(obj, dict):
        return {str(k): dump(v) for k, v in obj.items()}
    if isinstance(obj, np.generic):
        return [type(obj).__name__, obj.item()]
    return [type(obj).__name__, obj]


def _json(rw):
    return json.dumps(rw.query.to_druid(), sort_keys=True, default=str)


@pytest.mark.parametrize("name", list(ALL_SQL))
def test_parse_tree_matches_reference(name):
    sql = ALL_SQL[name]
    want = jparse(sql, views=VIEWS)
    got = tparse(sql, views=VIEWS)
    assert json.dumps(dump(got), default=str) == json.dumps(dump(want), default=str)


@pytest.mark.parametrize("name", list(GOLDEN_CASES))
def test_golden_rewrite_matches_reference(ctxs, name):
    ref, port = ctxs
    got = _json(port.plan_sql(GOLDEN_CASES[name]))
    assert got == _json(ref.plan_sql(GOLDEN_CASES[name]))
    with open(GOLDEN) as f:
        assert got == json.dumps(json.load(f)[name], sort_keys=True)


@pytest.mark.parametrize(
    "workload,name",
    [("ssb", k) for k in jssb.QUERIES] + [("tpch", k) for k in jtpch.QUERIES],
)
def test_workload_rewrite_matches_reference(ctxs, workload, name):
    ref, port = ctxs
    sql = (tssb if workload == "ssb" else ttpch).QUERIES[name]
    assert sql == (jssb if workload == "ssb" else jtpch).QUERIES[name]
    rw = port.plan_sql(sql)
    assert _json(rw) == _json(ref.plan_sql(sql))
    natives = (tssb if workload == "ssb" else ttpch).NATIVE_QUERIES
    if name in natives:
        assert _json(rw) == json.dumps(
            natives[name].to_druid(), sort_keys=True, default=str
        )


def test_star_join_collapses_onto_the_flat_datasource(ctxs):
    _, port = ctxs
    rw = port.plan_sql(tssb.QUERIES["q4_1"])
    assert rw.datasource == "lineorder"
    rw = port.plan_sql(ttpch.QUERIES["q10"])
    assert rw.datasource == "lineitem"
    # FD grouping pruning: c_name and c_nation ride hidden code carriers
    assert [r[0] for r in rw.fd_restores] == ["c_name", "c_nation"]


@pytest.mark.parametrize("name,strategy", [("q1_1", "dense"), ("q3_2", "segment")])
def test_explain_prints_the_engines_strategy(ctxs, name, strategy):
    """`explain` prints the strategy the context's engine resolves at the
    planned G (on the CPU the kernel's twin "dense" at G <= 4096), and the
    engine then runs that strategy."""
    _, port = ctxs
    text = port.explain(tssb.QUERIES[name])
    assert "== Rewrite: GroupByQuery ==" in text
    assert "== Physical Plan ==" in text
    assert f"strategy={strategy} " in text
    port.sql(tssb.QUERIES[name])
    assert port.last_metrics.strategy == strategy


WORKLOAD_SQL = (
    [tssb.QUERIES[k] for k in tssb.QUERIES] + [ttpch.QUERIES[k] for k in ttpch.QUERIES]
)


def test_sql_strategy_equals_native_strategy(ctxs):
    _, port = ctxs
    for sql in WORKLOAD_SQL:
        port.sql(sql)
        via_sql = port.last_metrics
        rw = port.plan_sql(sql)
        port.engine.execute(rw.query, port.catalog.get(rw.datasource))
        native = port.last_metrics
        assert via_sql.strategy == native.strategy, sql
        assert via_sql.num_groups == native.num_groups, sql
        assert via_sql.strategy == tgroupby.resolve_strategy(
            "auto", native.num_groups, "cpu"
        )


def _card_spies(monkeypatch):
    """Make the engine resolve strategies as on a CUDA device, with the
    kernel's wrapper a counting spy that runs the plain version on the CPU
    tensors and `dense_partial_aggregate` a spy that fails."""
    resolve = tgroupby.resolve_strategy
    monkeypatch.setattr(
        tengine, "resolve_strategy", lambda s, g, device: resolve(s, g, "cuda")
    )
    calls = {"kernel": 0, "dense": 0}

    def kernel_spy(*a, **kw):
        calls["kernel"] += 1
        return tcuda.plain_partial_aggregate(*a, **kw)

    def dense_spy(*a, **kw):
        calls["dense"] += 1
        raise AssertionError("the plain twin was reached on a card")

    monkeypatch.setattr(tcuda, "cuda_partial_aggregate", kernel_spy)
    monkeypatch.setattr(tgroupby, "dense_partial_aggregate", dense_spy)
    return calls


def test_no_sql_query_reaches_the_plain_twin_on_a_card(ctxs, monkeypatch):
    """The engine resolves strategies as on a CUDA device: every query with
    G <= SCATTER_CUTOVER must go to the kernel's wrapper, none to
    `dense_partial_aggregate` directly."""
    _, port = ctxs
    calls = _card_spies(monkeypatch)
    for sql in WORKLOAD_SQL:
        before = calls["kernel"]
        port.sql(sql)
        m = port.last_metrics
        if m.num_groups <= tgroupby.SCATTER_CUTOVER:
            assert m.strategy == "cuda", sql
            assert calls["kernel"] - before == m.segments, sql
        else:
            assert m.strategy == "segment", sql
    assert calls["dense"] == 0


def test_sketch_sql_reaches_the_kernel_once_per_segment_and_set(ctxs, monkeypatch):
    """The sketch queries, CUBE included, as on a card: one kernel call per
    in-scope segment for every grouping set, none of the plain twin."""
    _, port = ctxs
    calls = _card_spies(monkeypatch)
    ds = port.catalog.get("lineorder")
    for sql in tssb.SKETCH_QUERIES.values():
        rw = port.plan_sql(sql)
        before = calls["kernel"]
        port.sql(sql)
        sets = max(len(rw.grouping_sets), 1)
        assert calls["kernel"] - before == sets * len(tengine.segments_in_scope(rw.query, ds))
        assert port.last_metrics.strategy == "cuda"
    assert calls["dense"] == 0
