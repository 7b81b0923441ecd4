"""TPC-H workload: a normalized TPC-H subset, its flat dictionary-encoded
`lineitem` datasource with its snowflake star declaration, the query classes
as joined SQL, Q1 as a native query spec, and float64 pandas oracles.

* `gen_tables(scale)` builds `lineitem` + `orders` / `customer` /
  `supplier` / `part` (customer hangs off orders: a snowflake edge resolved
  at flatten time).
* `STAR_SCHEMA` declares that snowflake with its functional dependencies;
  `register(ctx, ...)` registers the flat fact with it plus the normalized
  tables into a `TPUOlapContext`.
* `QUERIES`: Q1 (AVG rewrite), Q3 (l_orderkey groups, ORDER BY revenue
  LIMIT 10: a TopN), Q10 (FD grouping pruning), Q5, Q6, Q12 (CASE counts),
  Q7 (EXTRACT year), Q14 (a ratio post-aggregation), Q19, and Q8 twice
  (a year column and EXTRACT(YEAR FROM o_orderdate)).
* `NATIVE_QUERIES["q1"]` is the pricing summary report in the form the SQL
  planner lowers it to: the AVG rewrite into sum / count post-aggregations
  and the shipdate predicate as the query interval.
* `oracle(flat_frame(tables), name)` computes each in float64 pandas.
* `EXTENDED_QUERIES`: twelve classes the planner cannot rewrite whole
  (correlated EXISTS and scalar subqueries, IN and NOT IN subqueries,
  HAVING against a scalar subquery, a LEFT JOIN in a derived table, a
  window rank, NOT EXISTS with SUBSTR), which run on the host fallback
  with their GROUP BY subtrees on the device, plus a q9-class star
  aggregate that stays on the device.  `register(..., extended=True)`
  adds the tables they read beyond the star: `rawline` (the normalized
  lineitem, which keeps l_partkey and l_suppkey) and `partsupp`
  (`partsupp_columns`).  `extended_oracle(tables, name)` computes each in
  float64 pandas.

Constants are adapted to this generator's value domains; the query shapes
follow the TPC-H spec.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..catalog.segment import DataSource, DimensionDict, build_datasource
from ..catalog.star import FunctionalDependency, StarRelationInfo, StarSchemaInfo
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

STAR_SCHEMA = StarSchemaInfo(
    fact_table="lineitem",
    relations=(
        StarRelationInfo("orders", (("l_orderkey", "o_orderkey"),)),
        StarRelationInfo(
            "customer", (("o_custkey", "c_custkey"),), parent="orders"
        ),
        StarRelationInfo("supplier", (("l_suppkey", "s_suppkey"),)),
        StarRelationInfo("part", (("l_partkey", "p_partkey"),)),
    ),
    functional_dependencies=(
        FunctionalDependency("customer", "c_custkey", "c_name"),
        FunctionalDependency("customer", "c_custkey", "c_nation"),
        FunctionalDependency("customer", "c_custkey", "c_mktsegment"),
        FunctionalDependency("customer", "c_nation", "c_region"),
        FunctionalDependency("supplier", "s_nation", "s_region"),
        FunctionalDependency("orders", "o_orderkey", "o_orderpriority"),
    ),
)


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


def register(ctx, scale: float = 0.01, seed: int = 13,
             rows_per_segment: int = 1 << 22, tables=None, extended: bool = False):
    """Register the flat fact (with snowflake star schema) + normalized
    dims — the reference's orderLineItemPartSupplier DDL analog.  With
    `extended`, also `rawline` and `partsupp`, which EXTENDED_QUERIES read."""
    tables = tables if tables is not None else gen_tables(scale, seed)
    cols, dicts = flat_columns(tables)
    ctx.register_table(
        "lineitem", cols,
        dimensions=FLAT_DIMS, metrics=FLAT_METRICS,
        time_column="l_shipdate", star_schema=STAR_SCHEMA,
        rows_per_segment=rows_per_segment, dicts=dicts,
    )
    ctx.register_table("orders", tables["orders"], time_column="o_orderdate")
    for t in ("customer", "supplier", "part"):
        ctx.register_table(t, tables[t])
    if extended:
        register_extended(ctx, tables)
    return tables


def register_extended(ctx, tables):
    """`rawline`, the normalized lineitem (the flat fact drops l_partkey
    and l_suppkey), and `partsupp`, both with schemas inferred."""
    ctx.register_table("rawline", tables["lineitem"], time_column="l_shipdate")
    ctx.register_table("partsupp", partsupp_columns(tables))


def partsupp_columns(tables, seed: int = 41):
    """partsupp synthesized over the part and supplier keys, four rows per
    part (the star omits it)."""
    rng = np.random.default_rng(seed)
    n_s = len(tables["supplier"]["s_suppkey"])
    n_p = len(tables["part"]["p_partkey"])
    n = 4 * n_p
    return {
        "ps_partkey": rng.integers(0, n_p, n).astype(np.int64),
        "ps_suppkey": rng.integers(0, n_s, n).astype(np.int64),
        "ps_availqty": rng.integers(1, 1000, n).astype(np.float32),
        "ps_supplycost": (rng.random(n) * 100).astype(np.float32),
    }


_J_ORD = "JOIN orders ON l_orderkey = o_orderkey"
_J_CUST = "JOIN customer ON o_custkey = c_custkey"
_J_SUPP = "JOIN supplier ON l_suppkey = s_suppkey"
_J_PART = "JOIN part ON l_partkey = p_partkey"

QUERIES: Dict[str, str] = {
    # Q1: pricing summary report — AVG rewrite + expression aggregates
    "q1": """
        SELECT l_returnflag, l_linestatus,
               sum(l_quantity) AS sum_qty,
               sum(l_extendedprice) AS sum_base_price,
               sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
               sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
               avg(l_quantity) AS avg_qty,
               avg(l_extendedprice) AS avg_price,
               avg(l_discount) AS avg_disc,
               count(*) AS count_order
        FROM lineitem
        WHERE l_shipdate <= '1998-09-02'
        GROUP BY l_returnflag, l_linestatus
        ORDER BY l_returnflag, l_linestatus
    """,
    # Q3-class: shipping priority — snowflake join + huge group domain
    # (l_orderkey: the sparse-groupby shape) + ORDER BY revenue LIMIT 10
    "q3": f"""
        SELECT l_orderkey,
               sum(l_extendedprice * (1 - l_discount)) AS revenue
        FROM lineitem {_J_ORD} {_J_CUST}
        WHERE c_mktsegment = 'BUILDING'
          AND o_orderdate < '1995-03-15'
          AND l_shipdate > '1995-03-15'
        GROUP BY l_orderkey
        ORDER BY revenue DESC
        LIMIT 10
    """,
    # Q10-class: returned-item reporting — GROUP BY customer attributes;
    # exercises FD grouping pruning (c_custkey determines c_name/c_nation:
    # the kernel groups by c_custkey alone, pruned columns ride hidden
    # code aggregations)
    "q10": f"""
        SELECT c_custkey, c_name, c_nation,
               sum(l_extendedprice * (1 - l_discount)) AS revenue
        FROM lineitem {_J_ORD} {_J_CUST}
        WHERE o_orderdate >= '1993-10-01' AND o_orderdate < '1994-01-01'
          AND l_returnflag = 'R'
        GROUP BY c_custkey, c_name, c_nation
        ORDER BY revenue DESC
        LIMIT 20
    """,
    # Q5-class: local supplier volume — both dim branches constrained to one
    # region, grouped by supplier nation
    "q5": f"""
        SELECT s_nation, sum(l_extendedprice * (1 - l_discount)) AS revenue
        FROM lineitem {_J_ORD} {_J_CUST} {_J_SUPP}
        WHERE c_region = 'ASIA' AND s_region = 'ASIA'
          AND o_orderdate >= '1994-01-01' AND o_orderdate < '1995-01-01'
        GROUP BY s_nation
        ORDER BY revenue DESC
    """,
    # Q6: forecasting revenue change — pure interval + bound filters into an
    # expression aggregate, no grouping
    "q6": """
        SELECT sum(l_extendedprice * l_discount) AS revenue
        FROM lineitem
        WHERE l_shipdate >= '1994-01-01' AND l_shipdate < '1995-01-01'
          AND l_discount >= 0.05 AND l_discount <= 0.07
          AND l_quantity < 24
    """,
    # Q12-class: shipmode line-priority counts — CASE inside SUM
    "q12": f"""
        SELECT l_shipmode,
               sum(CASE WHEN o_orderpriority = '1-URGENT'
                         OR o_orderpriority = '2-HIGH'
                        THEN 1 ELSE 0 END) AS high_line_count,
               sum(CASE WHEN o_orderpriority <> '1-URGENT'
                        AND o_orderpriority <> '2-HIGH'
                        THEN 1 ELSE 0 END) AS low_line_count
        FROM lineitem {_J_ORD}
        WHERE l_shipmode IN ('MAIL', 'SHIP')
          AND l_shipdate >= '1994-01-01' AND l_shipdate < '1995-01-01'
        GROUP BY l_shipmode
        ORDER BY l_shipmode
    """,
    # Q7-class: volume shipping between two nations — OR-of-ANDs across two
    # dimension branches + EXTRACT over the time column as a grouping dim
    "q7": f"""
        SELECT s_nation, c_nation,
               EXTRACT(YEAR FROM l_shipdate) AS l_year,
               sum(l_extendedprice * (1 - l_discount)) AS revenue
        FROM lineitem {_J_ORD} {_J_CUST} {_J_SUPP}
        WHERE ((s_nation = 'FRANCE' AND c_nation = 'GERMANY')
            OR (s_nation = 'GERMANY' AND c_nation = 'FRANCE'))
          AND l_shipdate >= '1995-01-01' AND l_shipdate <= '1996-12-31'
        GROUP BY s_nation, c_nation, EXTRACT(YEAR FROM l_shipdate)
        ORDER BY s_nation, c_nation, l_year
    """,
    # Q14-class: promo revenue — LIKE inside CASE, ratio of two aggregates
    # as a post-aggregation (constants adapted to this generator's p_type
    # domain: 'MEDIUM%' plays the role of 'PROMO%')
    "q14": f"""
        SELECT 100 * sum(CASE WHEN p_type LIKE 'MEDIUM%'
                              THEN l_extendedprice * (1 - l_discount)
                              ELSE 0 END)
                 / sum(l_extendedprice * (1 - l_discount)) AS promo_revenue
        FROM lineitem {_J_PART}
        WHERE l_shipdate >= '1995-09-01' AND l_shipdate < '1995-10-01'
    """,
    # Q19-class: discounted revenue — disjunction of conjunct blocks mixing
    # string dims and numeric metric bounds
    "q19": f"""
        SELECT sum(l_extendedprice * (1 - l_discount)) AS revenue
        FROM lineitem {_J_PART}
        WHERE (p_brand = 'Brand#12' AND l_quantity >= 1 AND l_quantity <= 11
               AND l_shipmode IN ('AIR', 'REG AIR'))
           OR (p_brand = 'Brand#23' AND l_quantity >= 10 AND l_quantity <= 20
               AND l_shipmode IN ('AIR', 'REG AIR'))
           OR (p_brand = 'Brand#34' AND l_quantity >= 20 AND l_quantity <= 30
               AND l_shipmode IN ('AIR', 'REG AIR'))
    """,
    # Q8 via EXTRACT(YEAR FROM o_orderdate) — no pre-materialized year
    # column needed (dictionary-backed EXTRACT dimension)
    "q8_extract": f"""
        SELECT EXTRACT(YEAR FROM o_orderdate) AS o_orderdate_year,
               sum(CASE WHEN s_nation = 'BRAZIL'
                        THEN l_extendedprice * (1 - l_discount)
                        ELSE 0 END) AS brazil_volume,
               sum(l_extendedprice * (1 - l_discount)) AS total_volume
        FROM lineitem {_J_ORD} {_J_CUST} {_J_SUPP} {_J_PART}
        WHERE c_region = 'AMERICA' AND p_type = 'ECONOMY ANODIZED STEEL'
          AND o_orderdate >= '1995-01-01' AND o_orderdate <= '1996-12-31'
        GROUP BY EXTRACT(YEAR FROM o_orderdate)
        ORDER BY o_orderdate_year
    """,
    # Q8-class: market share numerator/denominator via CASE over nation
    "q8": f"""
        SELECT o_orderdate_year,
               sum(CASE WHEN s_nation = 'BRAZIL'
                        THEN l_extendedprice * (1 - l_discount)
                        ELSE 0 END) AS brazil_volume,
               sum(l_extendedprice * (1 - l_discount)) AS total_volume
        FROM lineitem {_J_ORD} {_J_CUST} {_J_SUPP} {_J_PART}
        WHERE c_region = 'AMERICA' AND p_type = 'ECONOMY ANODIZED STEEL'
          AND o_orderdate >= '1995-01-01' AND o_orderdate <= '1996-12-31'
        GROUP BY o_orderdate_year
        ORDER BY o_orderdate_year
    """,
}


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
    """float64 reference result for QUERIES[name] over flat_frame output."""
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
    if name == "q3":
        m = (
            (f.c_mktsegment == "BUILDING")
            & (f.o_orderdate < _ms("1995-03-15"))
            & (f.l_shipdate > _ms("1995-03-15"))
        )
        g = (
            f[m].assign(revenue=rev[m])
            .groupby("l_orderkey", as_index=False)["revenue"].sum()
        )
        return g.sort_values("revenue", ascending=False).head(10).reset_index(
            drop=True
        )
    if name == "q10":
        m = (
            (f.o_orderdate >= _ms("1993-10-01"))
            & (f.o_orderdate < _ms("1994-01-01"))
            & (f.l_returnflag == "R")
        )
        g = (
            f[m].assign(revenue=rev[m])
            .groupby(["c_custkey", "c_name", "c_nation"], as_index=False)[
                "revenue"
            ].sum()
        )
        return g.sort_values("revenue", ascending=False).head(20).reset_index(
            drop=True
        )
    if name == "q5":
        m = (
            (f.c_region == "ASIA") & (f.s_region == "ASIA")
            & (f.o_orderdate >= _ms("1994-01-01"))
            & (f.o_orderdate < _ms("1995-01-01"))
        )
        g = (
            f[m].assign(revenue=rev[m])
            .groupby("s_nation", as_index=False)["revenue"].sum()
        )
        return g.sort_values("revenue", ascending=False).reset_index(drop=True)
    if name == "q6":
        m = (
            (f.l_shipdate >= _ms("1994-01-01"))
            & (f.l_shipdate < _ms("1995-01-01"))
            & (f.l_discount >= 0.05) & (f.l_discount <= 0.07)
            & (f.l_quantity < 24)
        )
        return float((f.l_extendedprice[m] * f.l_discount[m]).sum())
    if name == "q12":
        m = (
            f.l_shipmode.isin(["MAIL", "SHIP"])
            & (f.l_shipdate >= _ms("1994-01-01"))
            & (f.l_shipdate < _ms("1995-01-01"))
        )
        g = f[m]
        high = g.o_orderpriority.isin(["1-URGENT", "2-HIGH"])
        out = (
            g.assign(high=high.astype(np.int64), low=(~high).astype(np.int64))
            .groupby("l_shipmode", as_index=False)
            .agg(high_line_count=("high", "sum"), low_line_count=("low", "sum"))
        )
        return out.sort_values("l_shipmode").reset_index(drop=True)
    if name == "q7":
        m = (
            (
                ((f.s_nation == "FRANCE") & (f.c_nation == "GERMANY"))
                | ((f.s_nation == "GERMANY") & (f.c_nation == "FRANCE"))
            )
            & (f.l_shipdate >= _ms("1995-01-01"))
            & (f.l_shipdate <= _ms("1996-12-31"))
        )
        g = f[m]
        l_year = (
            np.asarray(g.l_shipdate, dtype="datetime64[ms]")
            .astype("datetime64[Y]")
            .astype(int)
            + 1970
        )
        out = (
            g.assign(l_year=l_year, revenue=rev[m])
            .groupby(["s_nation", "c_nation", "l_year"], as_index=False)[
                "revenue"
            ]
            .sum()
        )
        return out.sort_values(
            ["s_nation", "c_nation", "l_year"]
        ).reset_index(drop=True)
    if name == "q14":
        m = (f.l_shipdate >= _ms("1995-09-01")) & (
            f.l_shipdate < _ms("1995-10-01")
        )
        g = f[m]
        grev = rev[m]
        promo = np.where(
            g.p_type.str.startswith("MEDIUM"), grev, 0.0
        ).sum()
        return float(100.0 * promo / grev.sum())
    if name == "q19":
        block = lambda brand, lo, hi: (
            (f.p_brand == brand)
            & (f.l_quantity >= lo)
            & (f.l_quantity <= hi)
            & f.l_shipmode.isin(["AIR", "REG AIR"])
        )
        m = block("Brand#12", 1, 11) | block("Brand#23", 10, 20) | block(
            "Brand#34", 20, 30
        )
        return float(rev[m].sum())
    if name in ("q8", "q8_extract"):  # the same answer, two plans
        m = (
            (f.c_region == "AMERICA")
            & (f.p_type == "ECONOMY ANODIZED STEEL")
            & (f.o_orderdate >= _ms("1995-01-01"))
            & (f.o_orderdate <= _ms("1996-12-31"))
        )
        g = f[m]
        grev = rev[m]
        out = (
            g.assign(
                brazil_volume=np.where(g.s_nation == "BRAZIL", grev, 0.0),
                total_volume=grev,
            )
            .groupby("o_orderdate_year", as_index=False)
            .agg(
                brazil_volume=("brazil_volume", "sum"),
                total_volume=("total_volume", "sum"),
            )
        )
        return out.sort_values("o_orderdate_year").reset_index(drop=True)
    raise KeyError(name)


NATIVE_QUERIES: Dict[str, Q.GroupByQuery] = {"q1": _q1()}


EXTENDED_QUERIES: Dict[str, str] = {
    # Q2-class: the cheapest p_type per region, as RANK() over a GROUP BY
    "q2": """
        SELECT s_region, p_type, mn, rnk FROM
          (SELECT s_region, p_type, min(l_extendedprice) AS mn,
                  RANK() OVER (PARTITION BY s_region
                               ORDER BY min(l_extendedprice)) AS rnk
           FROM lineitem GROUP BY s_region, p_type) x
        WHERE rnk = 1 ORDER BY s_region
    """,
    # Q4: order priority checking, a correlated EXISTS against the fact
    "q4": """
        SELECT o_orderpriority, count(*) AS order_count
        FROM orders o
        WHERE o_orderdate >= '1995-01-01' AND o_orderdate < '1995-04-01'
          AND EXISTS (SELECT l_orderkey FROM lineitem
                      WHERE l_orderkey = o.o_orderkey AND l_discount > 0.05)
        GROUP BY o_orderpriority ORDER BY o_orderpriority
    """,
    # Q9-class: profit by supplier nation and order year, a star aggregate
    # that stays on the device
    "q9": """
        SELECT s_nation, o_orderdate_year AS yr,
               sum(l_extendedprice * (1 - l_discount) - 10 * l_quantity)
                   AS profit
        FROM lineitem
        JOIN supplier ON l_suppkey = s_suppkey
        JOIN orders ON l_orderkey = o_orderkey
        WHERE s_region = 'ASIA'
        GROUP BY s_nation, o_orderdate_year
        ORDER BY s_nation, yr DESC
    """,
    # Q11: important stock, HAVING against a scalar subquery of the same sum
    "q11": """
        SELECT ps_partkey, sum(ps_supplycost * ps_availqty) AS value
        FROM partsupp
        GROUP BY ps_partkey
        HAVING sum(ps_supplycost * ps_availqty) >
               (SELECT 0.002 * sum(ps_supplycost * ps_availqty)
                FROM partsupp)
        ORDER BY value DESC
    """,
    # Q13: the customer order-count distribution, a LEFT JOIN in a derived
    # table; COUNT(col) counts matched rows only
    "q13": """
        SELECT c_count, count(*) AS custdist
        FROM (SELECT c_custkey, count(o_orderkey) AS c_count
              FROM customer LEFT JOIN orders ON c_custkey = o_custkey
              GROUP BY c_custkey) co
        GROUP BY c_count
        ORDER BY custdist DESC, c_count DESC
    """,
    # Q15: the top supplier nation, a derived revenue view and a scalar max
    "q15": """
        SELECT s_nation, total FROM
          (SELECT s_nation, sum(l_extendedprice * (1 - l_discount)) AS total
           FROM lineitem
           WHERE l_shipdate >= '1996-01-01' AND l_shipdate < '1996-04-01'
           GROUP BY s_nation) r
        WHERE total =
          (SELECT max(total) FROM
             (SELECT s_nation, sum(l_extendedprice * (1 - l_discount)) AS total
              FROM lineitem
              WHERE l_shipdate >= '1996-01-01' AND l_shipdate < '1996-04-01'
              GROUP BY s_nation) r2)
    """,
    # Q16: supplier counting with exclusions, NOT IN over a subquery
    "q16": """
        SELECT p_brand, count(*) AS n
        FROM lineitem
        WHERE p_brand <> 'Brand#11'
          AND l_orderkey NOT IN
              (SELECT o_orderkey FROM orders
               WHERE o_orderpriority = '1-URGENT')
        GROUP BY p_brand ORDER BY p_brand
    """,
    # Q17: small-quantity-order revenue, a correlated scalar AVG per part
    "q17": """
        SELECT sum(l_extendedprice) / 7.0 AS avg_yearly
        FROM rawline o
        WHERE l_quantity <
              (SELECT 0.5 * avg(l_quantity) FROM rawline
               WHERE l_partkey = o.l_partkey)
    """,
    # Q18: large-volume customers, IN over a grouped HAVING subquery
    "q18": """
        SELECT c_name, l_orderkey, sum(l_quantity) AS total
        FROM lineitem
        WHERE l_orderkey IN
              (SELECT l_orderkey FROM lineitem
               GROUP BY l_orderkey HAVING sum(l_quantity) > 220.0)
        GROUP BY c_name, l_orderkey
        ORDER BY total DESC, l_orderkey LIMIT 10
    """,
    # Q20: potential part promotion, IN over a grouped HAVING subquery whose
    # WHERE holds another IN subquery
    "q20": """
        SELECT s_nation, count(*) AS n FROM supplier
        WHERE s_suppkey IN
          (SELECT l_suppkey FROM rawline
           WHERE l_partkey IN
             (SELECT p_partkey FROM part
              WHERE p_type = 'ECONOMY ANODIZED STEEL')
           GROUP BY l_suppkey HAVING sum(l_quantity) > 50)
        GROUP BY s_nation ORDER BY s_nation
    """,
    # Q21: suppliers who kept orders waiting, EXISTS and NOT EXISTS on the
    # same correlation key
    "q21": """
        SELECT s_nation, count(*) AS n FROM supplier s
        WHERE EXISTS (SELECT l_orderkey FROM rawline
                      WHERE l_suppkey = s.s_suppkey AND l_quantity > 25)
          AND NOT EXISTS (SELECT l_orderkey FROM rawline
                          WHERE l_suppkey = s.s_suppkey
                            AND l_extendedprice > 55400)
        GROUP BY s_nation ORDER BY s_nation
    """,
    # Q22: global sales opportunity, a NOT EXISTS anti-join and SUBSTR
    # grouping over the customer table
    "q22": """
        SELECT SUBSTR(c_name, 10, 1) AS cntry, count(*) AS numcust
        FROM customer c
        WHERE NOT EXISTS
              (SELECT o_orderkey FROM orders WHERE o_custkey = c.c_custkey)
        GROUP BY SUBSTR(c_name, 10, 1) ORDER BY cntry
    """,
}


def extended_oracle(tables, name: str, frame=None):
    """float64 pandas answer of EXTENDED_QUERIES[name] over the generated
    tables (`frame`: their `flat_frame`, computed when not given), in the
    query's column order.  Q2 keeps every p_type tied at a region's least
    minimum."""
    import pandas as pd

    if frame is None and name in ("q2", "q9", "q15", "q16", "q18"):
        frame = flat_frame(tables)
    f = frame
    o = pd.DataFrame(tables["orders"])
    li = tables["lineitem"]

    def counts(sel, key, out):
        return sel.groupby(key).size().sort_index().rename(out).reset_index()

    if name == "q2":
        mn = f.groupby(["s_region", "p_type"])["l_extendedprice"].min().reset_index(name="mn")
        best = mn[mn.mn == mn.groupby("s_region")["mn"].transform("min")]
        return best.assign(rnk=1).sort_values(["s_region", "p_type"]).reset_index(drop=True)
    if name == "q4":
        lo, hi = _ms("1995-01-01"), _ms("1995-04-01")
        disc = np.asarray(li["l_discount"], dtype=np.float64)
        hot = np.unique(li["l_orderkey"][disc > 0.05])
        sel = o[(o.o_orderdate >= lo) & (o.o_orderdate < hi) & o.o_orderkey.isin(hot)]
        return counts(sel, "o_orderpriority", "order_count")
    if name == "q9":
        sel = f[f.s_region == "ASIA"]
        sel = sel.assign(profit=sel.l_extendedprice * (1 - sel.l_discount) - 10 * sel.l_quantity)
        out = sel.groupby(["s_nation", "o_orderdate_year"])["profit"].sum().reset_index()
        out = out.sort_values(["s_nation", "o_orderdate_year"], ascending=[True, False])
        return out.rename(columns={"o_orderdate_year": "yr"}).reset_index(drop=True)
    if name == "q11":
        ps = pd.DataFrame(partsupp_columns(tables)).astype(
            {"ps_availqty": np.float64, "ps_supplycost": np.float64})
        v = ps.ps_supplycost * ps.ps_availqty
        per = v.groupby(ps.ps_partkey).sum()
        want = per[per > 0.002 * v.sum()].sort_values(ascending=False)
        return want.rename("value").rename_axis("ps_partkey").reset_index()
    if name == "q13":
        c = pd.DataFrame(tables["customer"])
        merged = c.merge(o, left_on="c_custkey", right_on="o_custkey", how="left")
        cc = merged.groupby("c_custkey")["o_orderkey"].count()
        return (cc.value_counts().rename_axis("c_count").reset_index(name="custdist")
                .sort_values(["custdist", "c_count"], ascending=False).reset_index(drop=True))
    if name == "q15":
        sel = f[(f.l_shipdate >= _ms("1996-01-01")) & (f.l_shipdate < _ms("1996-04-01"))]
        rev = (sel.l_extendedprice * (1 - sel.l_discount)).groupby(sel.s_nation).sum()
        return pd.DataFrame({"s_nation": [rev.idxmax()], "total": [rev.max()]})
    if name == "q16":
        urgent = o[o.o_orderpriority == "1-URGENT"].o_orderkey
        sel = f[(f.p_brand != "Brand#11") & ~f.l_orderkey.isin(urgent)]
        return counts(sel, "p_brand", "n")
    if name == "q17":
        rl = pd.DataFrame({k: li[k] for k in ("l_partkey", "l_quantity", "l_extendedprice")}
                          ).astype({"l_quantity": np.float64, "l_extendedprice": np.float64})
        thr = rl.groupby("l_partkey")["l_quantity"].transform("mean") * 0.5
        return pd.DataFrame({"avg_yearly": [rl[rl.l_quantity < thr].l_extendedprice.sum() / 7.0]})
    if name == "q18":
        qty = f.groupby("l_orderkey")["l_quantity"].sum()
        sel = f[f.l_orderkey.isin(qty[qty > 220.0].index)]
        return (sel.groupby(["c_name", "l_orderkey"])["l_quantity"].sum().reset_index(name="total")
                .sort_values(["total", "l_orderkey"], ascending=[False, True]).head(10)
                .reset_index(drop=True))
    sup = pd.DataFrame(tables["supplier"])
    if name == "q20":
        part = pd.DataFrame(tables["part"])
        rl = pd.DataFrame({k: li[k] for k in ("l_suppkey", "l_partkey", "l_quantity")})
        steel = part[part.p_type == "ECONOMY ANODIZED STEEL"].p_partkey
        vol = rl[rl.l_partkey.isin(steel)].groupby("l_suppkey")["l_quantity"].sum()
        return counts(sup[sup.s_suppkey.isin(vol[vol > 50].index)], "s_nation", "n")
    if name == "q21":
        big = np.unique(li["l_suppkey"][li["l_quantity"] > 25])
        small = np.unique(li["l_suppkey"][li["l_extendedprice"] > 55400])
        sel = sup[sup.s_suppkey.isin(big) & ~sup.s_suppkey.isin(small)]
        return counts(sel, "s_nation", "n")
    if name == "q22":
        c = pd.DataFrame(tables["customer"])
        sel = c[~c.c_custkey.isin(o.o_custkey)]
        return counts(sel.assign(cntry=sel.c_name.str[9]), "cntry", "numcust")
    raise KeyError(name)
