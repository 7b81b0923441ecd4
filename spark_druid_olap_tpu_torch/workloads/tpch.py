"""TPC-H workload: a normalized TPC-H subset, its flat dictionary-encoded
`lineitem` datasource, Q1 as a native query spec, and its float64 pandas
oracle.

* `gen_tables(scale)` builds `lineitem` + `orders` / `customer` /
  `supplier` / `part` (customer hangs off orders: a snowflake edge resolved
  at flatten time).
* `NATIVE_QUERIES["q1"]` is the pricing summary report in the form the SQL
  planner lowers it to: the AVG rewrite into sum / count post-aggregations
  and the shipdate predicate as the query interval.
* `oracle(flat_frame(tables), "q1")` computes it in float64 pandas.

Constants are adapted to this generator's value domains; the query shape
follows the TPC-H spec.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..catalog.segment import DataSource, DimensionDict, build_datasource
from ..models import aggregations as A
from ..models import query as Q
from ..models.dimensions import DimensionSpec
from ..plan.expr import col
from .ssb import order_by

_MS_DAY = 86_400_000

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = {
    "AFRICA": ["ALGERIA", "ETHIOPIA", "KENYA", "MOROCCO", "MOZAMBIQUE"],
    "AMERICA": ["ARGENTINA", "BRAZIL", "CANADA", "PERU", "UNITED STATES"],
    "ASIA": ["CHINA", "INDIA", "INDONESIA", "JAPAN", "VIETNAM"],
    "EUROPE": ["FRANCE", "GERMANY", "ROMANIA", "RUSSIA", "UNITED KINGDOM"],
    "MIDDLE EAST": ["EGYPT", "IRAN", "IRAQ", "JORDAN", "SAUDI ARABIA"],
}
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]

# attribute -> (owning table, fact-side index resolver)
DIM_ATTRS = {
    "o_orderpriority": "orders",
    "o_orderdate": "orders",  # numeric-dict dimension: ~2.4k distinct days
    "o_orderdate_year": "orders",
    "c_custkey": "orders",
    "c_name": "orders",
    "c_mktsegment": "orders",  # customer attrs ride the orders row (snowflake)
    "c_nation": "orders",
    "c_region": "orders",
    "s_nation": "supplier",
    "s_region": "supplier",
    "p_brand": "part",
    "p_type": "part",
    "l_returnflag": "lineitem",
    "l_linestatus": "lineitem",
    "l_shipmode": "lineitem",
    "l_orderkey": "lineitem",
}

FLAT_METRICS = [
    "l_quantity", "l_extendedprice", "l_discount", "l_tax",
]

def _geo(n: int, rng):
    reg = rng.choice(np.array(REGIONS, dtype=object), size=n)
    nation = np.empty(n, dtype=object)
    for r in REGIONS:
        m = reg == r
        nation[m] = rng.choice(np.array(NATIONS[r], dtype=object), int(m.sum()))
    return reg, nation


def gen_tables(scale: float = 0.01, seed: int = 13) -> Dict[str, Dict[str, np.ndarray]]:
    """Normalized TPC-H subset at ~SF `scale` (SF1: 6M lineitem rows).
    Keys are dense 0..n-1 so the pre-join is a direct gather."""
    rng = np.random.default_rng(seed)

    n_c = max(100, int(150_000 * scale))
    c_region, c_nation = _geo(n_c, rng)
    customer = {
        "c_custkey": np.arange(n_c, dtype=np.int64),
        "c_name": np.array(
            [f"Customer#{k:09d}" for k in range(n_c)], dtype=object
        ),
        "c_mktsegment": rng.choice(np.array(SEGMENTS, dtype=object), n_c),
        "c_nation": c_nation,
        "c_region": c_region,
    }

    n_s = max(50, int(10_000 * scale))
    s_region, s_nation = _geo(n_s, rng)
    supplier = {
        "s_suppkey": np.arange(n_s, dtype=np.int64),
        "s_nation": s_nation,
        "s_region": s_region,
    }

    n_p = max(200, int(200_000 * scale))
    part = {
        "p_partkey": np.arange(n_p, dtype=np.int64),
        "p_brand": np.array(
            [f"Brand#{a}{b}" for a, b in zip(
                rng.integers(1, 6, n_p), rng.integers(1, 6, n_p)
            )], dtype=object,
        ),
        "p_type": rng.choice(
            np.array(
                ["ECONOMY ANODIZED STEEL", "LARGE BRUSHED BRASS",
                 "MEDIUM POLISHED COPPER", "SMALL PLATED TIN",
                 "STANDARD BURNISHED NICKEL"], dtype=object,
            ),
            n_p,
        ),
    }

    n_o = max(500, int(1_500_000 * scale))
    d0 = int(np.datetime64("1992-01-01", "ms").astype(np.int64))
    d1 = int(np.datetime64("1998-08-02", "ms").astype(np.int64))
    o_orderdate = (
        rng.integers(d0 // _MS_DAY, d1 // _MS_DAY, size=n_o) * _MS_DAY
    )
    orders = {
        "o_orderkey": np.arange(n_o, dtype=np.int64),
        "o_custkey": rng.integers(0, n_c, size=n_o).astype(np.int64),
        "o_orderdate": o_orderdate,
        "o_orderpriority": rng.choice(np.array(PRIORITIES, dtype=object), n_o),
    }

    n = int(6_001_215 * scale)
    okey = rng.integers(0, n_o, size=n).astype(np.int64)
    shipdate = orders["o_orderdate"][okey] + rng.integers(
        1, 122, size=n
    ) * _MS_DAY
    lineitem = {
        "l_orderkey": okey,
        "l_suppkey": rng.integers(0, n_s, size=n).astype(np.int64),
        "l_partkey": rng.integers(0, n_p, size=n).astype(np.int64),
        "l_shipdate": shipdate,
        "l_quantity": rng.integers(1, 51, size=n).astype(np.float32),
        "l_extendedprice": (rng.random(n).astype(np.float32) * 55_450 + 90),
        "l_discount": (rng.integers(0, 11, size=n) / 100).astype(np.float32),
        "l_tax": (rng.integers(0, 9, size=n) / 100).astype(np.float32),
        "l_returnflag": rng.choice(
            np.array(["A", "N", "R"], dtype=object), n, p=[0.25, 0.5, 0.25]
        ),
        "l_linestatus": np.where(
            shipdate < int(np.datetime64("1995-06-17", "ms").astype(np.int64)),
            "F", "O",
        ).astype(object),
        "l_shipmode": rng.choice(np.array(SHIPMODES, dtype=object), n),
    }
    return {
        "lineitem": lineitem, "orders": orders, "customer": customer,
        "supplier": supplier, "part": part,
    }


def flat_columns(tables):
    """Pre-join the snowflake into the dictionary-encoded flat datasource
    (dictionaries built on the SMALL tables, codes gathered through FKs)."""
    li = tables["lineitem"]
    o = tables["orders"]
    c = tables["customer"]
    okey = li["l_orderkey"]
    ckey = o["o_custkey"][okey]  # snowflake hop resolved at flatten time

    cols: Dict[str, np.ndarray] = {
        "l_shipdate": li["l_shipdate"],
        "o_orderdate": o["o_orderdate"][okey],
        **{m: li[m] for m in FLAT_METRICS},
    }
    dicts: Dict[str, DimensionDict] = {}

    def add(attr, values, fact_idx):
        if values.dtype.kind in ("U", "S", "O"):
            d = DimensionDict.build(list(values))
            codes = d.encode(list(values))
        else:
            uniq = np.unique(values.astype(np.int64))
            d = DimensionDict(values=tuple(int(v) for v in uniq))
            codes = d.encode_numeric(values)
        dicts[attr] = d
        cols[attr] = codes[fact_idx] if fact_idx is not None else codes

    add("o_orderpriority", o["o_orderpriority"], okey)
    year = (
        o["o_orderdate"].astype("datetime64[ms]").astype("datetime64[Y]")
        .astype(int) + 1970
    )
    add("o_orderdate_year", year.astype(np.int64), okey)
    add("c_custkey", c["c_custkey"], ckey)
    add("c_name", c["c_name"], ckey)
    add("c_mktsegment", c["c_mktsegment"], ckey)
    add("c_nation", c["c_nation"], ckey)
    add("c_region", c["c_region"], ckey)
    add("s_nation", tables["supplier"]["s_nation"], li["l_suppkey"])
    add("s_region", tables["supplier"]["s_region"], li["l_suppkey"])
    add("p_brand", tables["part"]["p_brand"], li["l_partkey"])
    add("p_type", tables["part"]["p_type"], li["l_partkey"])
    for a in ("l_returnflag", "l_linestatus", "l_shipmode"):
        add(a, li[a], None)
    add("l_orderkey", li["l_orderkey"], None)
    return cols, dicts


FLAT_DIMS = list(DIM_ATTRS)


def datasource(cols, dicts, rows_per_segment: int = 1 << 22) -> DataSource:
    """The flat lineitem datasource from `flat_columns` output."""
    return build_datasource(
        "lineitem", cols, FLAT_DIMS, FLAT_METRICS, time_col="l_shipdate",
        rows_per_segment=rows_per_segment, dicts=dicts,
    )


def _avg(name: str, field: str):
    """SQL AVG as the planner rewrites it: a sum, a count and their
    quotient as a post-aggregation."""
    aggs = (A.DoubleSum(f"{name}__sum", field), A.Count(f"{name}__cnt"))
    post = A.Arithmetic(name, "/", (
        A.FieldAccess(f"{name}__fa_s", f"{name}__sum"),
        A.FieldAccess(f"{name}__fa_c", f"{name}__cnt"),
    ))
    return aggs, post


def _q1() -> Q.GroupByQuery:
    disc_price = col("l_extendedprice") * (1 - col("l_discount"))
    avgs = [
        _avg("avg_qty", "l_quantity"),
        _avg("avg_price", "l_extendedprice"),
        _avg("avg_disc", "l_discount"),
    ]
    return Q.GroupByQuery(
        datasource="lineitem",
        dimensions=(DimensionSpec("l_returnflag"), DimensionSpec("l_linestatus")),
        aggregations=(
            A.DoubleSum("sum_qty", "l_quantity"),
            A.DoubleSum("sum_base_price", "l_extendedprice"),
            A.ExpressionAgg("sum_disc_price", disc_price),
            A.ExpressionAgg("sum_charge", disc_price * (1 + col("l_tax"))),
            *(a for aggs, _ in avgs for a in aggs),
            A.Count("count_order"),
        ),
        post_aggregations=tuple(p for _, p in avgs),
        # l_shipdate <= '1998-09-02' as the half-open query interval
        intervals=((-(1 << 62), _ms("1998-09-02") + 1),),
        limit_spec=order_by("l_returnflag", "l_linestatus"),
    )


# ---------------------------------------------------------------------------
# pandas float64 oracle — test scales only
# ---------------------------------------------------------------------------


def flat_frame(tables):
    import pandas as pd

    li = tables["lineitem"]
    o = tables["orders"]
    okey = li["l_orderkey"]
    ckey = o["o_custkey"][okey]
    c = tables["customer"]
    s = tables["supplier"]
    p = tables["part"]
    year = (
        o["o_orderdate"].astype("datetime64[ms]").astype("datetime64[Y]")
        .astype(int) + 1970
    )
    return pd.DataFrame(
        {
            "l_orderkey": okey,
            "l_shipdate": li["l_shipdate"],
            "o_orderdate": o["o_orderdate"][okey],
            "o_orderdate_year": year[okey],
            "o_orderpriority": o["o_orderpriority"][okey],
            "c_custkey": c["c_custkey"][ckey],
            "c_name": c["c_name"][ckey],
            "c_mktsegment": c["c_mktsegment"][ckey],
            "c_nation": c["c_nation"][ckey],
            "c_region": c["c_region"][ckey],
            "s_nation": s["s_nation"][li["l_suppkey"]],
            "s_region": s["s_region"][li["l_suppkey"]],
            "p_brand": p["p_brand"][li["l_partkey"]],
            "p_type": p["p_type"][li["l_partkey"]],
            "l_returnflag": li["l_returnflag"],
            "l_linestatus": li["l_linestatus"],
            "l_shipmode": li["l_shipmode"],
            **{
                m: np.asarray(li[m], dtype=np.float64)
                for m in FLAT_METRICS
            },
        }
    )


def _ms(s: str) -> int:
    return int(np.datetime64(s, "ms").astype(np.int64))


def oracle(f, name: str):
    """float64 reference result for NATIVE_QUERIES[name] over flat_frame
    output."""
    rev = f.l_extendedprice * (1 - f.l_discount)
    if name == "q1":
        m = f.l_shipdate <= _ms("1998-09-02")
        g = f[m].assign(
            disc_price=rev[m],
            charge=rev[m] * (1 + f.l_tax[m]),
        )
        out = g.groupby(["l_returnflag", "l_linestatus"], as_index=False).agg(
            sum_qty=("l_quantity", "sum"),
            sum_base_price=("l_extendedprice", "sum"),
            sum_disc_price=("disc_price", "sum"),
            sum_charge=("charge", "sum"),
            avg_qty=("l_quantity", "mean"),
            avg_price=("l_extendedprice", "mean"),
            avg_disc=("l_discount", "mean"),
            count_order=("l_quantity", "count"),
        )
        return out.sort_values(["l_returnflag", "l_linestatus"]).reset_index(
            drop=True
        )
    raise KeyError(name)


NATIVE_QUERIES: Dict[str, Q.GroupByQuery] = {"q1": _q1()}
