"""Star Schema Benchmark (SSB): the normalized tables, the flat
dictionary-encoded datasource, the 13 queries Q1.1-Q4.3 as native query
specs, and float64 pandas oracles.

* `gen_tables(scale)` builds the normalized star (lineorder fact + dwdate /
  customer / supplier / part dims; "dwdate" because DATE is a SQL keyword).
* `flat_columns(tables)` pre-joins it into the dictionary-encoded flat
  datasource (the "Druid index"): string attributes become codes via
  per-attribute dictionaries built on the SMALL dim tables, then gathered
  through the fact's foreign keys.
* `STAR_SCHEMA` declares the star (fact, four dimension tables, functional
  dependencies) that lets the SQL planner eliminate the joins;
  `register(ctx, ...)` registers the flat datasource with it plus the four
  normalized dimension tables into a `TPUOlapContext`.
* `QUERIES` are the 13 SSB queries as SQL over the normalized star (joins
  included).
* `NATIVE_QUERIES` are the same 13 queries as `GroupByQuery` specs, in the
  form the SQL planner lowers the joined SQL to (star joins eliminated,
  filters pushed into the flat datasource).  Filter constants are adapted
  to this generator's value domains; the query shapes (filter arity,
  group-bys, ordering) follow the SSB spec.  `TIMESERIES_QUERY` and
  `TOPN_QUERY` are one Timeseries and one TopN over the same datasource.
* `SKETCH_QUERIES` are the approximate queries of BASELINE configs #3
  (TopN + HLL, and the same over a filter) and #5 (CUBE + distinct count,
  as HLL and as theta) and an APPROX_QUANTILE query, over the flat fact.
* `register_streamed(ctx, scale)` registers the same star at a large scale
  factor through the sharded ingest pipeline, chunk by chunk;
  `fact_rows(tables, n, seed)` draws a batch of fact rows in domain values
  for `append_rows`.
* `oracle(frame, name)` computes each result in float64 pandas, over
  `flat_frame(tables)` (decoded strings, small scales) or
  `coded_frame(cols, dicts)` (categoricals over the codes, any scale);
  `sketch_oracle(frame, name)` the exact answers the sketch queries
  approximate (distinct counts, quantiles and the values they rank in).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..catalog.segment import (
    ColumnMeta,
    DataSource,
    DimensionDict,
    build_datasource,
    code_dtype,
)
from ..catalog.star import FunctionalDependency, StarRelationInfo, StarSchemaInfo
from ..models import aggregations as A
from ..models import filters as F
from ..models import query as Q
from ..models.dimensions import DimensionSpec
from ..plan.expr import col

_MS_DAY = 86_400_000

REGIONS = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"])
NATIONS_BY_REGION = {
    "AFRICA": ["ALGERIA", "ETHIOPIA", "KENYA", "MOROCCO", "MOZAMBIQUE"],
    "AMERICA": ["ARGENTINA", "BRAZIL", "CANADA", "PERU", "UNITED STATES"],
    "ASIA": ["CHINA", "INDIA", "INDONESIA", "JAPAN", "VIETNAM"],
    "EUROPE": ["FRANCE", "GERMANY", "ROMANIA", "RUSSIA", "UNITED KINGDOM"],
    "MIDDLE EAST": ["EGYPT", "IRAN", "IRAQ", "JORDAN", "SAUDI ARABIA"],
}

# attribute -> owning dim table, foreign-key column on the fact
DIM_ATTRS = {
    "d_year": ("dwdate", "lo_orderdate"),
    "d_yearmonthnum": ("dwdate", "lo_orderdate"),
    "d_yearmonth": ("dwdate", "lo_orderdate"),
    "d_weeknuminyear": ("dwdate", "lo_orderdate"),
    "c_region": ("customer", "lo_custkey"),
    "c_nation": ("customer", "lo_custkey"),
    "c_city": ("customer", "lo_custkey"),
    "s_region": ("supplier", "lo_suppkey"),
    "s_nation": ("supplier", "lo_suppkey"),
    "s_city": ("supplier", "lo_suppkey"),
    "p_mfgr": ("part", "lo_partkey"),
    "p_category": ("part", "lo_partkey"),
    "p_brand1": ("part", "lo_partkey"),
}

FLAT_DIMS = list(DIM_ATTRS)
FLAT_METRICS = [
    "lo_quantity", "lo_extendedprice", "lo_discount", "lo_revenue",
    "lo_supplycost",
    # FK retained on the flat fact for approx-distinct workloads
    # (HLL/theta over lo_custkey)
    "lo_custkey",
]

STAR_SCHEMA = StarSchemaInfo(
    fact_table="lineorder",
    relations=(
        StarRelationInfo("dwdate", (("lo_orderdate", "d_datekey"),)),
        StarRelationInfo("customer", (("lo_custkey", "c_custkey"),)),
        StarRelationInfo("supplier", (("lo_suppkey", "s_suppkey"),)),
        StarRelationInfo("part", (("lo_partkey", "p_partkey"),)),
    ),
    functional_dependencies=(
        FunctionalDependency("customer", "c_city", "c_nation"),
        FunctionalDependency("customer", "c_nation", "c_region"),
        FunctionalDependency("supplier", "s_city", "s_nation"),
        FunctionalDependency("supplier", "s_nation", "s_region"),
        FunctionalDependency("part", "p_brand1", "p_category"),
        FunctionalDependency("part", "p_category", "p_mfgr"),
        FunctionalDependency("dwdate", "d_datekey", "d_year"),
    ),
)


def _geo(n: int, rng) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    reg = rng.choice(REGIONS, size=n)
    nation = np.empty(n, dtype=object)
    for r in REGIONS:
        m = reg == r
        nation[m] = rng.choice(
            np.array(NATIONS_BY_REGION[r]), size=int(m.sum())
        )
    city = np.char.add(
        np.asarray(nation, dtype=str), rng.integers(0, 10, size=n).astype(str)
    )
    return reg.astype(object), nation, city.astype(object)


def gen_tables(scale: float = 0.01, seed: int = 7) -> Dict[str, Dict[str, np.ndarray]]:
    """Normalized SSB star at ~SF `scale` (SF1: 6M lineorder rows).  Keys are
    dense 0..n-1 so the pre-join is a direct gather.

    Materializes the whole fact host-side (SF10: 60M rows, about 2.4 GB)."""
    rng = np.random.default_rng(seed)
    out = gen_dim_tables(scale, rng)
    n_c = len(out["customer"]["c_custkey"])
    n_s = len(out["supplier"]["s_suppkey"])
    n_p = len(out["part"]["p_partkey"])
    out["lineorder"] = _gen_fact(
        int(6_000_000 * scale), rng, out["dwdate"]["d_datekey"], n_c, n_s, n_p
    )
    return out


def gen_dim_tables(scale: float, rng) -> Dict[str, Dict[str, np.ndarray]]:
    """The four SSB dimension tables (small at any scale factor)."""
    # dwdate: one row per calendar day 1992-01-01 .. 1998-12-31
    d0 = np.datetime64("1992-01-01")
    days = np.arange(d0, np.datetime64("1999-01-01"), dtype="datetime64[D]")
    years = days.astype("datetime64[Y]").astype(int) + 1970
    months = days.astype("datetime64[M]").astype(int) % 12 + 1
    day_of_year = (days - days.astype("datetime64[Y]")).astype(int) + 1
    dwdate = {
        "d_datekey": days.astype("datetime64[ms]").astype(np.int64),
        "d_year": years.astype(np.int32),
        "d_yearmonthnum": (years * 100 + months).astype(np.int32),
        "d_yearmonth": np.array(
            [f"{y}-{m:02d}" for y, m in zip(years, months)], dtype=object
        ),
        "d_weeknuminyear": ((day_of_year - 1) // 7 + 1).astype(np.int32),
    }

    n_c = max(100, int(30_000 * scale))
    c_region, c_nation, c_city = _geo(n_c, rng)
    customer = {
        "c_custkey": np.arange(n_c, dtype=np.int64),
        "c_region": c_region, "c_nation": c_nation, "c_city": c_city,
    }

    n_s = max(50, int(2_000 * scale))
    s_region, s_nation, s_city = _geo(n_s, rng)
    supplier = {
        "s_suppkey": np.arange(n_s, dtype=np.int64),
        "s_region": s_region, "s_nation": s_nation, "s_city": s_city,
    }

    n_p = max(200, int(200_000 * scale))
    mfgr = np.char.add("MFGR#", rng.integers(1, 6, size=n_p).astype(str))
    category = np.char.add(
        np.asarray(mfgr, dtype=str), rng.integers(1, 6, size=n_p).astype(str)
    )
    brand = np.char.add(
        np.asarray(category, dtype=str),
        np.char.add("-", rng.integers(1, 41, size=n_p).astype(str)),
    )
    part = {
        "p_partkey": np.arange(n_p, dtype=np.int64),
        "p_mfgr": np.asarray(mfgr, dtype=object),
        "p_category": np.asarray(category, dtype=object),
        "p_brand1": np.asarray(brand, dtype=object),
    }
    return {
        "dwdate": dwdate, "customer": customer,
        "supplier": supplier, "part": part,
    }


def _gen_fact(n: int, rng, datekeys, n_c: int, n_s: int, n_p: int,
              date_lo: int = 0, date_hi: Optional[int] = None):
    # dates are drawn pre-sorted (every other column is iid), so the fact
    # arrives time-sorted, the order Druid segments by; a chunk of the
    # stream draws from its slice [date_lo, date_hi) of the days
    date_idx = np.sort(rng.integers(
        date_lo, len(datekeys) if date_hi is None else date_hi, size=n, dtype=np.int16))
    quantity = rng.integers(1, 51, size=n).astype(np.float32)
    extendedprice = rng.random(n).astype(np.float32) * 55_450 + 90
    discount = rng.integers(0, 11, size=n).astype(np.float32)
    return {
        "lo_orderdate": np.asarray(datekeys)[date_idx],
        # int32 keys: segment encode casts integral metrics to int32
        "lo_custkey": rng.integers(0, n_c, size=n, dtype=np.int32),
        "lo_suppkey": rng.integers(0, n_s, size=n, dtype=np.int32),
        "lo_partkey": rng.integers(0, n_p, size=n, dtype=np.int32),
        "lo_quantity": quantity,
        "lo_extendedprice": extendedprice,
        "lo_discount": discount,
        "lo_revenue": extendedprice * (1 - discount / 100),
        "lo_supplycost": extendedprice * 0.6,
    }


def _fk_row_index(lo, fk_col: str, table: str, dwdate) -> np.ndarray:
    fk = lo[fk_col]
    if table == "dwdate":
        base = int(dwdate["d_datekey"][0])
        return ((fk - base) // _MS_DAY).astype(np.int64)
    return fk.astype(np.int64)  # dense 0..n-1 keys


def _dim_row_index(tables, fk_col: str, table: str) -> np.ndarray:
    """Row of `table` each fact row of `tables` joins through `fk_col`."""
    return _fk_row_index(tables["lineorder"], fk_col, table, tables["dwdate"])


def _attr_dicts(tables) -> Dict[str, Tuple[DimensionDict, np.ndarray]]:
    """Per flat attribute: (dictionary, encoded dim-table codes) — built on
    the SMALL dimension tables once; fact rows gather through the FK."""
    out: Dict[str, Tuple[DimensionDict, np.ndarray]] = {}
    for attr, (table, _) in DIM_ATTRS.items():
        vals = tables[table][attr]
        if vals.dtype.kind in ("U", "S", "O"):
            d = DimensionDict.build(list(vals))
            dim_codes = d.encode(list(vals))
        else:
            uniq = np.unique(vals.astype(np.int64))
            d = DimensionDict(values=tuple(int(v) for v in uniq))
            dim_codes = d.encode_numeric(vals)
        # narrow at the source: every fact-row gather downstream moves
        # 1-2 byte codes instead of int32
        out[attr] = (d, dim_codes.astype(code_dtype(d.cardinality)))
    return out


def _flat_chunk(lo, tables, attr_dicts) -> Dict[str, np.ndarray]:
    """One chunk of fact rows -> flat encoded columns (gathers only)."""
    cols: Dict[str, np.ndarray] = {
        "lo_orderdate": lo["lo_orderdate"],
        **{m: lo[m] for m in FLAT_METRICS},
    }
    idx_cache: Dict[str, np.ndarray] = {}
    for attr, (table, fk_col) in DIM_ATTRS.items():
        if table not in idx_cache:
            idx_cache[table] = _fk_row_index(
                lo, fk_col, table, tables["dwdate"]
            )
        cols[attr] = attr_dicts[attr][1][idx_cache[table]]
    return cols


def flat_columns(tables) -> Tuple[Dict[str, np.ndarray], Dict[str, DimensionDict]]:
    """Pre-join the star into the dictionary-encoded flat datasource.

    Per attribute: build the dictionary on the dim table (small), encode the
    dim rows, gather codes through the fact FK — the flat table never holds
    6M strings.  Returns (columns, dicts) for build_datasource; string-dict
    columns arrive pre-encoded (see the build_datasource caller contract).
    """
    ad = _attr_dicts(tables)
    cols = _flat_chunk(tables["lineorder"], tables, ad)
    return cols, {attr: d for attr, (d, _) in ad.items()}


def n_fact_chunks(scale: float, chunk_rows: int) -> int:
    return -(-int(6_000_000 * scale) // chunk_rows)


_FACT_STREAM = 90_001  # spawn-key tag separating fact chunks from dim draws


def gen_fact_chunk(ci: int, scale: float, seed: int, chunk_rows: int, tables):
    """Fact chunk `ci` of the streamed generator, from its own stream
    default_rng((seed, _FACT_STREAM, ci)): reproducible given the same
    (scale, seed, chunk_rows), so an oracle iterates with the chunk
    geometry the ingest used.  Chunk ci covers its slice of the date span,
    proportional to row position, so events arrive in time order and
    date predicates prune across the whole stream.  The JAX package's
    generator, value for value."""
    n = int(6_000_000 * scale)
    datekeys = tables["dwdate"]["d_datekey"]
    n_days = len(datekeys)
    start = ci * chunk_rows
    rows = min(chunk_rows, n - start)
    rng = np.random.default_rng((seed, _FACT_STREAM, ci))
    lo = (start * n_days) // n
    hi = max(lo + 1, ((start + rows) * n_days) // n)
    return _gen_fact(
        rows, rng, datekeys,
        len(tables["customer"]["c_custkey"]),
        len(tables["supplier"]["s_suppkey"]),
        len(tables["part"]["p_partkey"]),
        lo, hi,
    )


def fact_chunks(scale: float, seed: int, chunk_rows: int, tables):
    """Generator of lineorder chunks at SF `scale`, one `gen_fact_chunk`
    per step: the whole fact is never held."""
    for ci in range(n_fact_chunks(scale, chunk_rows)):
        yield gen_fact_chunk(ci, scale, seed, chunk_rows, tables)


def _sorted_flat_chunk(ci, scale, seed, chunk_rows, tables, ad):
    """Chunk ci generated, flat-encoded and time-sorted (the dates are
    drawn sorted, so the sort is a check unless another source feeds it)."""
    c = _flat_chunk(gen_fact_chunk(ci, scale, seed, chunk_rows, tables), tables, ad)
    dates = c["lo_orderdate"]
    if np.all(dates[1:] >= dates[:-1]):
        return c
    day = ((dates - dates.min()) // _MS_DAY).astype(np.int16)
    order = np.argsort(day, kind="stable")
    return {k: np.asarray(v)[order] for k, v in c.items()}


_APPEND_STREAM = 90_002  # spawn-key tag of `fact_rows`, apart from the fact's


def fact_rows(tables, n: int, seed: int, new_city: Optional[str] = None) -> Dict[str, np.ndarray]:
    """`n` lineorder rows drawn as the generator draws the fact, over the
    dimension tables of `tables`, as the flat datasource's columns in
    domain values (strings and numbers, epoch-ms dates): a batch for
    `append_rows`, whose values the dictionaries already hold, and, as a
    DataFrame, a frame `oracle` reads like `flat_frame`.  `new_city`
    replaces the c_city of every 1024th row with a value no dictionary
    holds, with the nation and region of the first row (so the star's
    functional dependencies hold)."""
    dw = tables["dwdate"]
    rng = np.random.default_rng((seed, _APPEND_STREAM))
    lo = _gen_fact(n, rng, dw["d_datekey"], len(tables["customer"]["c_custkey"]),
                   len(tables["supplier"]["s_suppkey"]), len(tables["part"]["p_partkey"]))
    out: Dict[str, np.ndarray] = {"lo_orderdate": lo["lo_orderdate"],
                                  **{m: lo[m] for m in FLAT_METRICS}}
    idx: Dict[str, np.ndarray] = {}
    for attr, (table, fk_col) in DIM_ATTRS.items():
        if table not in idx:
            idx[table] = _fk_row_index(lo, fk_col, table, dw)
        vals = np.asarray(tables[table][attr])[idx[table]]
        out[attr] = vals.astype(object) if vals.dtype.kind in "US" else vals
    if new_city is not None:
        for attr in ("c_city", "c_nation", "c_region"):
            out[attr] = out[attr].copy()
            # one nation and region for the new city, as for every city
            out[attr][::1024] = new_city if attr == "c_city" else out[attr][0]
    return out


def rows_frame(rows: Dict[str, np.ndarray]):
    """A batch of `fact_rows` as the frame `oracle` reads (`flat_frame`'s
    layout: metrics in float64)."""
    import pandas as pd

    return pd.DataFrame({k: np.asarray(v, dtype=np.float64) if k in FLAT_METRICS else v
                         for k, v in rows.items()})


def register_streamed(ctx, scale: float, seed: int = 7,
                      rows_per_segment: int = 1 << 19,
                      chunk_rows: int = 1 << 22,
                      workers: Optional[int] = None):
    """Register the SSB star at a large scale factor: the fact is
    generated, encoded and segmented chunk by chunk through the sharded
    ingest pipeline (`ingest.shard.build_datasource_sharded`), never held
    whole.  Chunks are date-sliced and time-sorted, so a segment spans a
    narrow date range and date predicates prune by zone map.  `workers`
    None resolves through `ingest.shard.sharded_ingest_workers`; 0 runs
    inline.  Returns the dimension tables (for an oracle)."""
    from ..ingest.shard import build_datasource_sharded

    tables = gen_dim_tables(scale, np.random.default_rng(seed))
    ad = _attr_dicts(tables)
    dicts = {attr: d for attr, (d, _) in ad.items()}
    chunks = (
        _sorted_flat_chunk(ci, scale, seed, chunk_rows, tables, ad)
        for ci in range(n_fact_chunks(scale, chunk_rows))
    )
    ds = build_datasource_sharded(
        "lineorder", chunks,
        dimension_cols=FLAT_DIMS, metric_cols=FLAT_METRICS,
        time_col="lo_orderdate",
        rows_per_segment=rows_per_segment, dicts=dicts,
        workers=1 if workers == 0 else workers,
    )
    ctx.register_datasource(ds, star_schema=STAR_SCHEMA)
    ctx.register_table("dwdate", tables["dwdate"], time_column="d_datekey")
    for t in ("customer", "supplier", "part"):
        ctx.register_table(t, tables[t])
    return tables


def datasource(cols, dicts, rows_per_segment: int = 1 << 19) -> DataSource:
    """The flat lineorder datasource from `flat_columns` output, time-sorted
    into 512K-row segments (segments are time partitions, so date
    predicates prune by zone map)."""
    return build_datasource(
        "lineorder", cols, FLAT_DIMS, FLAT_METRICS, time_col="lo_orderdate",
        rows_per_segment=rows_per_segment, dicts=dicts,
    )


# The star of `key_dimension_datasource`: the customer key determines the
# customer's city, so a grouping by (c_city, lo_custkey) groups by the key
# alone and carries the city (the planner's FD pruning), where the product
# of the two cardinalities (251 x 300001 at SF10) would pass the lowering's
# 2^26 bound on a combined domain.
KEYED_STAR_SCHEMA = dataclasses.replace(
    STAR_SCHEMA,
    functional_dependencies=STAR_SCHEMA.functional_dependencies
    + (FunctionalDependency("customer", "lo_custkey", "c_city"),),
)


def key_dimension_datasource(ds: DataSource, n_keys: int, key: str = "lo_custkey") -> DataSource:
    """The flat datasource with the fact's foreign key `key` (a metric) made a
    dimension, so that an exact COUNT(DISTINCT key) can group by it: the
    same segments and arrays, the key's dictionary its dense values
    0..n_keys-1, so its codes are its values and its resident device column
    is shared with the metric's.  Register it with KEYED_STAR_SCHEMA."""
    dic = DimensionDict(values=tuple(range(n_keys)))
    segs = tuple(
        dataclasses.replace(
            s,
            dims={**s.dims, key: s.metrics[key]},
            metrics={k: v for k, v in s.metrics.items() if k != key},
        )
        for s in ds.segments
    )
    cols = tuple(
        ColumnMeta(key, "dimension", "long", cardinality=n_keys) if c.name == key else c
        for c in ds.columns
    )
    return dataclasses.replace(ds, columns=cols, dicts={**ds.dicts, key: dic}, segments=segs)


def register(ctx, scale: float = 0.01, seed: int = 7,
             rows_per_segment: int = 1 << 19, tables=None,
             sort_by=("lo_orderdate",)):
    """Register the flat fact datasource (with the star schema) and the four
    normalized dimension tables into a TPUOlapContext.

    Rows are time-sorted into 512K-row segments by default, as Druid ingests
    (segments are time partitions): the date-derived SSB predicates
    (d_year, d_yearmonthnum, ...) then prune most segments by zone map
    before any kernel runs."""
    tables = tables if tables is not None else gen_tables(scale, seed)
    cols, dicts = flat_columns(tables)
    ctx.register_table(
        "lineorder", cols,
        dimensions=FLAT_DIMS, metrics=FLAT_METRICS,
        time_column="lo_orderdate", star_schema=STAR_SCHEMA,
        rows_per_segment=rows_per_segment, dicts=dicts,
        sort_by=list(sort_by),
    )
    ctx.register_table("dwdate", tables["dwdate"], time_column="d_datekey")
    for t in ("customer", "supplier", "part"):
        ctx.register_table(t, tables[t])
    return tables


# ---------------------------------------------------------------------------
# The 13 SSB queries, joined form (constants adapted to gen_tables domains)
# ---------------------------------------------------------------------------

_J_DATE = "JOIN dwdate ON lo_orderdate = d_datekey"
_J_CUST = "JOIN customer ON lo_custkey = c_custkey"
_J_SUPP = "JOIN supplier ON lo_suppkey = s_suppkey"
_J_PART = "JOIN part ON lo_partkey = p_partkey"

QUERIES: Dict[str, str] = {
    "q1_1": f"""
        SELECT sum(lo_extendedprice * lo_discount) AS revenue
        FROM lineorder {_J_DATE}
        WHERE d_year = 1993 AND lo_discount BETWEEN 1 AND 3
          AND lo_quantity < 25
    """,
    "q1_2": f"""
        SELECT sum(lo_extendedprice * lo_discount) AS revenue
        FROM lineorder {_J_DATE}
        WHERE d_yearmonthnum = 199401 AND lo_discount BETWEEN 4 AND 6
          AND lo_quantity BETWEEN 26 AND 35
    """,
    "q1_3": f"""
        SELECT sum(lo_extendedprice * lo_discount) AS revenue
        FROM lineorder {_J_DATE}
        WHERE d_weeknuminyear = 6 AND d_year = 1994
          AND lo_discount BETWEEN 5 AND 7 AND lo_quantity BETWEEN 26 AND 35
    """,
    "q2_1": f"""
        SELECT sum(lo_revenue) AS revenue, d_year, p_brand1
        FROM lineorder {_J_DATE} {_J_PART} {_J_SUPP}
        WHERE p_category = 'MFGR#12' AND s_region = 'AMERICA'
        GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1
    """,
    "q2_2": f"""
        SELECT sum(lo_revenue) AS revenue, d_year, p_brand1
        FROM lineorder {_J_DATE} {_J_PART} {_J_SUPP}
        WHERE p_brand1 BETWEEN 'MFGR#22-1' AND 'MFGR#22-8'
          AND s_region = 'ASIA'
        GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1
    """,
    "q2_3": f"""
        SELECT sum(lo_revenue) AS revenue, d_year, p_brand1
        FROM lineorder {_J_DATE} {_J_PART} {_J_SUPP}
        WHERE p_brand1 = 'MFGR#22-9' AND s_region = 'EUROPE'
        GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1
    """,
    "q3_1": f"""
        SELECT c_nation, s_nation, d_year, sum(lo_revenue) AS revenue
        FROM lineorder {_J_CUST} {_J_SUPP} {_J_DATE}
        WHERE c_region = 'ASIA' AND s_region = 'ASIA'
          AND d_year >= 1992 AND d_year <= 1997
        GROUP BY c_nation, s_nation, d_year
        ORDER BY d_year ASC, revenue DESC
    """,
    "q3_2": f"""
        SELECT c_city, s_city, d_year, sum(lo_revenue) AS revenue
        FROM lineorder {_J_CUST} {_J_SUPP} {_J_DATE}
        WHERE c_nation = 'UNITED STATES' AND s_nation = 'UNITED STATES'
          AND d_year >= 1992 AND d_year <= 1997
        GROUP BY c_city, s_city, d_year
        ORDER BY d_year ASC, revenue DESC
    """,
    "q3_3": f"""
        SELECT c_city, s_city, d_year, sum(lo_revenue) AS revenue
        FROM lineorder {_J_CUST} {_J_SUPP} {_J_DATE}
        WHERE c_city IN ('UNITED KINGDOM1', 'UNITED KINGDOM5')
          AND s_city IN ('UNITED KINGDOM1', 'UNITED KINGDOM5')
          AND d_year >= 1992 AND d_year <= 1997
        GROUP BY c_city, s_city, d_year
        ORDER BY d_year ASC, revenue DESC
    """,
    "q3_4": f"""
        SELECT c_city, s_city, d_year, sum(lo_revenue) AS revenue
        FROM lineorder {_J_CUST} {_J_SUPP} {_J_DATE}
        WHERE c_city IN ('UNITED KINGDOM1', 'UNITED KINGDOM5')
          AND s_city IN ('UNITED KINGDOM1', 'UNITED KINGDOM5')
          AND d_yearmonth = '1997-12'
        GROUP BY c_city, s_city, d_year
        ORDER BY d_year ASC, revenue DESC
    """,
    "q4_1": f"""
        SELECT d_year, c_nation, sum(lo_revenue - lo_supplycost) AS profit
        FROM lineorder {_J_CUST} {_J_SUPP} {_J_PART} {_J_DATE}
        WHERE c_region = 'AMERICA' AND s_region = 'AMERICA'
          AND (p_mfgr = 'MFGR#1' OR p_mfgr = 'MFGR#2')
        GROUP BY d_year, c_nation ORDER BY d_year, c_nation
    """,
    "q4_2": f"""
        SELECT d_year, s_nation, p_category,
               sum(lo_revenue - lo_supplycost) AS profit
        FROM lineorder {_J_CUST} {_J_SUPP} {_J_PART} {_J_DATE}
        WHERE c_region = 'AMERICA' AND s_region = 'AMERICA'
          AND (d_year = 1997 OR d_year = 1998)
          AND (p_mfgr = 'MFGR#1' OR p_mfgr = 'MFGR#2')
        GROUP BY d_year, s_nation, p_category
        ORDER BY d_year, s_nation, p_category
    """,
    "q4_3": f"""
        SELECT d_year, s_city, p_brand1,
               sum(lo_revenue - lo_supplycost) AS profit
        FROM lineorder {_J_CUST} {_J_SUPP} {_J_PART} {_J_DATE}
        WHERE c_region = 'AMERICA' AND s_nation = 'UNITED STATES'
          AND (d_year = 1997 OR d_year = 1998) AND p_category = 'MFGR#14'
        GROUP BY d_year, s_city, p_brand1
        ORDER BY d_year, s_city, p_brand1
    """,
}


# The approximate queries.  `topn_hll` is BASELINE config #3's text and
# `cube_hll` config #5's (bench.py); approx_count_distinct plans to HLL under
# the default `approx_count_distinct_sketch`, so `cube_theta` pins the theta
# sketch that config #5 names.  `filtered_hll` is config #3 over the rows of
# a filter on a non-time column, which masks about half of every segment's
# rows instead of pruning segments.
CUBE_DIMS = ("c_region", "s_region", "d_year")
_CUBE = (
    "SELECT c_region, s_region, d_year, sum(lo_revenue) AS revenue, "
    "{fn}(lo_custkey) AS uniq_custs "
    "FROM lineorder GROUP BY CUBE (c_region, s_region, d_year)"
)
_TOPN = (
    "SELECT c_city, sum(lo_revenue) AS revenue, "
    "approx_count_distinct(lo_custkey) AS uniq_custs "
    "FROM lineorder {where}GROUP BY c_city ORDER BY revenue DESC LIMIT 100"
)
FILTERED_QUANTITY = 25  # filtered_hll keeps lo_quantity < 25
SKETCH_QUERIES: Dict[str, str] = {
    "topn_hll": _TOPN.format(where=""),
    "filtered_hll": _TOPN.format(where=f"WHERE lo_quantity < {FILTERED_QUANTITY} "),
    "cube_hll": _CUBE.format(fn="approx_count_distinct"),
    "cube_theta": _CUBE.format(fn="approx_count_distinct_ds_theta"),
    "quantiles": (
        "SELECT d_year, APPROX_QUANTILE(lo_revenue, 0.5) AS p50, "
        "APPROX_QUANTILE(lo_revenue, 0.9) AS p90, sum(lo_revenue) AS revenue "
        "FROM lineorder GROUP BY d_year"
    ),
}
QUANTILE_FRACTIONS = {"p50": 0.5, "p90": 0.9}
# Exact COUNT(DISTINCT): config #3's TopN with the sketch replaced by an
# exact count, and a global count, planned under count_distinct_mode =
# 'exact' over `key_dimension_datasource` (the distinct column must be a
# dimension: its inner grouping is by c_city and lo_custkey).
EXACT_DISTINCT_QUERIES: Dict[str, str] = {
    "topn_exact": SKETCH_QUERIES["topn_hll"].replace(
        "approx_count_distinct(lo_custkey)", "COUNT(DISTINCT lo_custkey)"),
    "count_distinct": "SELECT count(DISTINCT lo_custkey) AS uniq_custs FROM lineorder",
}


def quantile_rank_bound(fraction: float, k: int = 1024) -> float:
    """Four standard errors in rank of a K-row uniform sample's quantile,
    4 * sqrt(f (1 - f) / K): 0.0625 at the median, 0.0375 at p90."""
    return 4 * float(np.sqrt(fraction * (1 - fraction) / k))


def quantile_rank_error(values: np.ndarray, estimate: float, fraction: float) -> float:
    """How far `estimate` sits in rank from `fraction` among a group's
    sorted exact `values`: its ranks run from the share of values below it
    to the share at or below it (ties span a range), and the error is the
    distance from `fraction` to that range, 0 inside it."""
    n = len(values)
    lo = np.searchsorted(values, estimate, "left") / n
    hi = np.searchsorted(values, estimate, "right") / n
    return float(max(lo - fraction, fraction - hi, 0.0))


# four standard errors of a distinct count: HLL at p = 11 (1.04 / sqrt(m))
# and theta at K = 4096 (1 / sqrt(K - 1))
DISTINCT_REL_BOUND = {
    "topn_hll": 4 * 1.04 / np.sqrt(2048),
    "filtered_hll": 4 * 1.04 / np.sqrt(2048),
    "cube_hll": 4 * 1.04 / np.sqrt(2048),
    "cube_theta": 4 / np.sqrt(4095),
    "topn_exact": 0.0,  # exact: equal to the oracle's count
}


# ---------------------------------------------------------------------------
# The 13 SSB queries as native specs (constants adapted to gen_tables domains)
# ---------------------------------------------------------------------------


def and_(*fs: F.Filter) -> F.Filter:
    """Left-nested pairwise conjunction, the shape the SQL planner builds
    (`a AND b AND c` -> And(And(a, b), c))."""
    out = fs[0]
    for f in fs[1:]:
        out = F.And((out, f))
    return out


def or_(*fs: F.Filter) -> F.Filter:
    out = fs[0]
    for f in fs[1:]:
        out = F.Or((out, f))
    return out


def num_eq(dim: str, v) -> F.Bound:
    return F.Bound(dim, lower=str(v), upper=str(v), ordering="numeric")


def num_ge(dim: str, v) -> F.Bound:
    return F.Bound(dim, lower=str(v), ordering="numeric")


def num_le(dim: str, v) -> F.Bound:
    return F.Bound(dim, upper=str(v), ordering="numeric")


def num_lt(dim: str, v) -> F.Bound:
    return F.Bound(dim, upper=str(v), upper_strict=True, ordering="numeric")


def order_by(*cols: str) -> Q.LimitSpec:
    """ORDER BY; a leading '-' orders that column descending."""
    return Q.LimitSpec(None, tuple(
        Q.OrderByColumnSpec(c[1:], "descending") if c.startswith("-")
        else Q.OrderByColumnSpec(c) for c in cols
    ))


def _dims(*names: str):
    return tuple(DimensionSpec(n) for n in names)


def _q1(*conds: F.Filter) -> Q.GroupByQuery:
    return Q.GroupByQuery(
        datasource="lineorder", dimensions=(),
        aggregations=(A.ExpressionAgg(
            "revenue", col("lo_extendedprice") * col("lo_discount")
        ),),
        filter=and_(*conds),
    )


def _q2(filt: F.Filter) -> Q.GroupByQuery:
    return Q.GroupByQuery(
        datasource="lineorder", dimensions=_dims("d_year", "p_brand1"),
        aggregations=(A.DoubleSum("revenue", "lo_revenue"),),
        filter=filt, limit_spec=order_by("d_year", "p_brand1"),
    )


def _q3(dims, filt: F.Filter) -> Q.GroupByQuery:
    return Q.GroupByQuery(
        datasource="lineorder", dimensions=_dims(*dims),
        aggregations=(A.DoubleSum("revenue", "lo_revenue"),),
        filter=filt, limit_spec=order_by("d_year", "-revenue"),
    )


def _q4(dims, filt: F.Filter) -> Q.GroupByQuery:
    return Q.GroupByQuery(
        datasource="lineorder", dimensions=_dims(*dims),
        aggregations=(A.ExpressionAgg(
            "profit", col("lo_revenue") - col("lo_supplycost")
        ),),
        filter=filt, limit_spec=order_by(*dims),
    )


_UK = ("UNITED KINGDOM1", "UNITED KINGDOM5")
_Y92_97 = (num_ge("d_year", 1992), num_le("d_year", 1997))
_MFGR12 = or_(F.Selector("p_mfgr", "MFGR#1"), F.Selector("p_mfgr", "MFGR#2"))
_Y97_98 = or_(num_eq("d_year", 1997), num_eq("d_year", 1998))

NATIVE_QUERIES: Dict[str, Q.GroupByQuery] = {
    "q1_1": _q1(
        num_eq("d_year", 1993), num_ge("lo_discount", 1),
        num_le("lo_discount", 3), num_lt("lo_quantity", 25),
    ),
    "q1_2": _q1(
        num_eq("d_yearmonthnum", 199401), num_ge("lo_discount", 4),
        num_le("lo_discount", 6), num_ge("lo_quantity", 26),
        num_le("lo_quantity", 35),
    ),
    "q1_3": _q1(
        num_eq("d_weeknuminyear", 6), num_eq("d_year", 1994),
        num_ge("lo_discount", 5), num_le("lo_discount", 7),
        num_ge("lo_quantity", 26), num_le("lo_quantity", 35),
    ),
    "q2_1": _q2(and_(
        F.Selector("p_category", "MFGR#12"), F.Selector("s_region", "AMERICA"),
    )),
    "q2_2": _q2(and_(
        and_(F.Bound("p_brand1", lower="MFGR#22-1"),
             F.Bound("p_brand1", upper="MFGR#22-8")),
        F.Selector("s_region", "ASIA"),
    )),
    "q2_3": _q2(and_(
        F.Selector("p_brand1", "MFGR#22-9"), F.Selector("s_region", "EUROPE"),
    )),
    "q3_1": _q3(("c_nation", "s_nation", "d_year"), and_(
        F.Selector("c_region", "ASIA"), F.Selector("s_region", "ASIA"),
        *_Y92_97,
    )),
    "q3_2": _q3(("c_city", "s_city", "d_year"), and_(
        F.Selector("c_nation", "UNITED STATES"),
        F.Selector("s_nation", "UNITED STATES"), *_Y92_97,
    )),
    "q3_3": _q3(("c_city", "s_city", "d_year"), and_(
        F.InFilter("c_city", _UK), F.InFilter("s_city", _UK), *_Y92_97,
    )),
    "q3_4": _q3(("c_city", "s_city", "d_year"), and_(
        F.InFilter("c_city", _UK), F.InFilter("s_city", _UK),
        F.Selector("d_yearmonth", "1997-12"),
    )),
    "q4_1": _q4(("d_year", "c_nation"), and_(
        F.Selector("c_region", "AMERICA"), F.Selector("s_region", "AMERICA"),
        _MFGR12,
    )),
    "q4_2": _q4(("d_year", "s_nation", "p_category"), and_(
        F.Selector("c_region", "AMERICA"), F.Selector("s_region", "AMERICA"),
        _Y97_98, _MFGR12,
    )),
    "q4_3": _q4(("d_year", "s_city", "p_brand1"), and_(
        F.Selector("c_region", "AMERICA"),
        F.Selector("s_nation", "UNITED STATES"), _Y97_98,
        F.Selector("p_category", "MFGR#14"),
    )),
}

# revenue per calendar month over the whole fact
TIMESERIES_QUERY = Q.TimeseriesQuery(
    datasource="lineorder", granularity="month",
    aggregations=(A.DoubleSum("revenue", "lo_revenue"),),
)

# the ten customer nations with the most revenue
TOPN_QUERY = Q.TopNQuery(
    datasource="lineorder", dimension=DimensionSpec("c_nation"),
    metric="revenue", threshold=10,
    aggregations=(A.DoubleSum("revenue", "lo_revenue"),),
)


# ---------------------------------------------------------------------------
# pandas oracle (float64)
# ---------------------------------------------------------------------------


def flat_frame_chunk(tables, lo):
    """The decoded flat pandas frame of ONE fact chunk `lo` (the unit of a
    chunked oracle: strings materialize a chunk at a time)."""
    import pandas as pd

    data = {
        "lo_orderdate": lo["lo_orderdate"],
        **{m: np.asarray(lo[m], dtype=np.float64) for m in FLAT_METRICS},
    }
    idx_cache: Dict[str, np.ndarray] = {}
    for attr, (table, fk_col) in DIM_ATTRS.items():
        if table not in idx_cache:
            idx_cache[table] = _fk_row_index(
                lo, fk_col, table, tables["dwdate"]
            )
        data[attr] = np.asarray(tables[table][attr])[idx_cache[table]]
    return pd.DataFrame(data)


def flat_frame(tables):
    """Decoded flat pandas DataFrame for oracle computation (string attrs
    materialized: small scales only)."""
    return flat_frame_chunk(tables, tables["lineorder"])


def merge_oracle_parts(parts):
    """Per-chunk `oracle` results merged into the whole table's: every SSB
    aggregate of `QUERIES` is a sum, so partials concatenate and re-sum by
    their group columns (the measure is the last column)."""
    import pandas as pd

    if isinstance(parts[0], float):
        return float(sum(parts))
    # empty partials are dropped first: a filtered query misses whole
    # date-sliced chunks, and a concat with empties makes int keys float
    nonempty = [p for p in parts if len(p)]
    if not nonempty:
        return parts[0]
    df = pd.concat(nonempty, ignore_index=True)
    vcol = df.columns[-1]
    g = [c for c in df.columns if c != vcol]
    return df.groupby(g, as_index=False, observed=True)[vcol].sum()


def coded_frame(cols, dicts):
    """The same frame as `flat_frame`, built from the flat encoded columns
    without materializing strings: string attributes become pandas
    Categoricals over their dictionary codes, numeric ones their values.
    Fit for SF10 (60M rows)."""
    import pandas as pd

    data = {
        "lo_orderdate": cols["lo_orderdate"],
        **{m: np.asarray(cols[m], dtype=np.float64) for m in FLAT_METRICS},
    }
    for attr in FLAT_DIMS:
        d = dicts[attr]
        codes = np.asarray(cols[attr])
        if d.numeric_values is not None:
            data[attr] = d.numeric_values[codes]
        else:
            data[attr] = pd.Categorical.from_codes(
                codes, categories=list(d.values)
            )
    return pd.DataFrame(data)


def _str_between(s, lo: str, hi: str):
    import pandas as pd

    if isinstance(s.dtype, pd.CategoricalDtype):
        cats = np.asarray(s.cat.categories, dtype=str)
        return s.isin(cats[(cats >= lo) & (cats <= hi)])
    b = s.astype(str)
    return (b >= lo) & (b <= hi)


def _month_start(ms):
    return np.asarray(ms, dtype="datetime64[ms]").astype(
        "datetime64[M]"
    ).astype("datetime64[ms]")


def oracle(f, name: str):
    """Reference result for NATIVE_QUERIES[name] ("timeseries" and "topn"
    for the other two specs) over a `flat_frame` or `coded_frame`.  Grouped
    results are sorted by their group columns (callers re-sort `got` the
    same way before comparing); "topn" returns every nation by revenue,
    descending, so a caller can check ties at the cut."""
    q = np.asarray(f.lo_quantity)
    dc = np.asarray(f.lo_discount)
    if name == "q1_1":
        m = (f.d_year == 1993) & (dc >= 1) & (dc <= 3) & (q < 25)
        return float((f.lo_extendedprice[m] * dc[m]).sum())
    if name == "q1_2":
        m = (f.d_yearmonthnum == 199401) & (dc >= 4) & (dc <= 6) & (q >= 26) & (q <= 35)
        return float((f.lo_extendedprice[m] * dc[m]).sum())
    if name == "q1_3":
        m = ((f.d_weeknuminyear == 6) & (f.d_year == 1994)
             & (dc >= 5) & (dc <= 7) & (q >= 26) & (q <= 35))
        return float((f.lo_extendedprice[m] * dc[m]).sum())
    if name in ("q2_1", "q2_2", "q2_3"):
        if name == "q2_1":
            m = (f.p_category == "MFGR#12") & (f.s_region == "AMERICA")
        elif name == "q2_2":
            m = _str_between(f.p_brand1, "MFGR#22-1", "MFGR#22-8") & (
                f.s_region == "ASIA"
            )
        else:
            m = (f.p_brand1 == "MFGR#22-9") & (f.s_region == "EUROPE")
        return (
            f[m].groupby(["d_year", "p_brand1"], observed=True).lo_revenue.sum()
            .reset_index().rename(columns={"lo_revenue": "revenue"})
        )
    if name in ("q3_1", "q3_2", "q3_3", "q3_4"):
        yr = (f.d_year >= 1992) & (f.d_year <= 1997)
        if name == "q3_1":
            m = (f.c_region == "ASIA") & (f.s_region == "ASIA") & yr
            g = ["c_nation", "s_nation", "d_year"]
        elif name == "q3_2":
            m = ((f.c_nation == "UNITED STATES")
                 & (f.s_nation == "UNITED STATES") & yr)
            g = ["c_city", "s_city", "d_year"]
        else:
            cities = ["UNITED KINGDOM1", "UNITED KINGDOM5"]
            m = f.c_city.isin(cities) & f.s_city.isin(cities)
            m &= yr if name == "q3_3" else (f.d_yearmonth == "1997-12")
            g = ["c_city", "s_city", "d_year"]
        return (
            f[m].groupby(g, observed=True).lo_revenue.sum()
            .reset_index().rename(columns={"lo_revenue": "revenue"})
        )
    if name in ("q4_1", "q4_2", "q4_3"):
        prof = f.lo_revenue - f.lo_supplycost
        if name == "q4_1":
            m = ((f.c_region == "AMERICA") & (f.s_region == "AMERICA")
                 & f.p_mfgr.isin(["MFGR#1", "MFGR#2"]))
            g = ["d_year", "c_nation"]
        elif name == "q4_2":
            m = ((f.c_region == "AMERICA") & (f.s_region == "AMERICA")
                 & f.d_year.isin([1997, 1998])
                 & f.p_mfgr.isin(["MFGR#1", "MFGR#2"]))
            g = ["d_year", "s_nation", "p_category"]
        else:
            m = ((f.c_region == "AMERICA") & (f.s_nation == "UNITED STATES")
                 & f.d_year.isin([1997, 1998]) & (f.p_category == "MFGR#14"))
            g = ["d_year", "s_city", "p_brand1"]
        return (
            f[m].assign(profit=prof).groupby(g, observed=True).profit.sum()
            .reset_index()
        )
    if name == "timeseries":
        return (
            f.assign(timestamp=_month_start(f.lo_orderdate))
            .groupby("timestamp").lo_revenue.sum()
            .reset_index().rename(columns={"lo_revenue": "revenue"})
        )
    if name == "topn":
        return (
            f.groupby("c_nation", observed=True).lo_revenue.sum()
            .reset_index().rename(columns={"lo_revenue": "revenue"})
            .sort_values("revenue", ascending=False, kind="stable")
            .reset_index(drop=True)
        )
    raise KeyError(name)


def _factorize(col):
    """(codes, decoded values) of a grouping column, values sorted."""
    import pandas as pd

    codes, uniq = pd.factorize(col, sort=True)
    return codes, np.asarray(uniq, dtype=object)


def _distinct(gid: np.ndarray, G: int, key: np.ndarray) -> np.ndarray:
    """Exact distinct keys per group: a presence map over (group, key)."""
    n = int(key.max()) + 1 if len(key) else 1
    seen = np.zeros((G, n), dtype=bool)
    seen[gid, key] = True
    return seen


def sketch_oracle(f, name: str):
    """Exact float64 answers to SKETCH_QUERIES[name] over a `flat_frame` or
    `coded_frame`, one row per group: revenue, the exact distinct
    `uniq_custs` (uncut: "topn_hll" and "filtered_hll" give every city by
    revenue, descending), and for "quantiles" the exact p50/p90 and each
    group's sorted `values`.  Cube rows carry None for the dimensions their
    set aggregates away and `__grouping_id`."""
    import itertools

    import pandas as pd

    rev = np.asarray(f.lo_revenue, dtype=np.float64)
    cust = np.asarray(f.lo_custkey).astype(np.int64)
    if name == "count_distinct":
        return pd.DataFrame({"uniq_custs": [len(np.unique(cust))]})
    if name in ("topn_hll", "filtered_hll", "topn_exact"):
        codes, vals = _factorize(f.c_city)
        G = len(vals)
        if name == "filtered_hll":
            keep = np.asarray(f.lo_quantity) < FILTERED_QUANTITY
            codes, rev, cust = codes[keep], rev[keep], cust[keep]
        out = pd.DataFrame({
            "c_city": vals,
            "revenue": np.bincount(codes, weights=rev, minlength=G),
            "uniq_custs": _distinct(codes, G, cust).sum(axis=1),
        })
        return out.sort_values("revenue", ascending=False, kind="stable").reset_index(drop=True)
    if name in ("cube_hll", "cube_theta"):
        fact = [_factorize(f[d]) for d in CUBE_DIMS]
        shape = tuple(len(v) for _, v in fact)
        gid = np.ravel_multi_index([c for c, _ in fact], shape)
        G = int(np.prod(shape))
        rows = np.bincount(gid, minlength=G).reshape(shape)
        revenue = np.bincount(gid, weights=rev, minlength=G).reshape(shape)
        seen = _distinct(gid, G, cust).reshape(shape + (-1,))
        frames = []
        k = len(CUBE_DIMS)
        for r in range(k, -1, -1):
            for keep in itertools.combinations(range(k), r):
                away = tuple(i for i in range(k) if i not in keep)
                n = rows.sum(axis=away)
                cells = np.argwhere(n > 0)
                out = {
                    d: (fact[i][1][cells[:, keep.index(i)]] if i in keep
                        else np.full(len(cells), None, dtype=object))
                    for i, d in enumerate(CUBE_DIMS)
                }
                at = tuple(cells.T)
                out["revenue"] = revenue.sum(axis=away)[at]
                out["uniq_custs"] = seen.any(axis=away).sum(axis=-1)[at]
                out["__grouping_id"] = sum(1 << (k - 1 - i) for i in away)
                frames.append(pd.DataFrame(out))
        return pd.concat(frames, ignore_index=True)
    if name == "quantiles":
        codes, years = _factorize(f.d_year)
        out = {"d_year": years, "revenue": np.bincount(codes, weights=rev)}
        out["values"] = [np.sort(rev[codes == g]) for g in range(len(years))]
        for p, frac in QUANTILE_FRACTIONS.items():
            out[p] = [np.quantile(v, frac) for v in out["values"]]
        return pd.DataFrame(out)
    raise KeyError(name)


def _row_keys(df, cols):
    return [tuple(map(str, r)) for r in df[list(cols)].astype(object).to_numpy()]


def check_sketch_answer(name: str, got, want, rtol: float = 2e-5) -> Dict[str, float]:
    """Hold a SKETCH_QUERIES frame against `sketch_oracle`: the same groups
    (for the TopNs the top 100 by revenue, ties at the cut allowed), sums
    within `rtol`, distinct counts within DISTINCT_REL_BOUND of the exact
    count, quantiles within `quantile_rank_bound` in rank
    (`quantile_rank_error`), and for the cubes every GROUPING_ID with nulls
    exactly where its bits say.  Raises AssertionError; returns the largest
    errors seen (for quantiles, per fraction: the rank error and the
    relative distance in value from the exact quantile)."""
    if name == "count_distinct":
        if list(got.uniq_custs) != list(want.uniq_custs):
            raise AssertionError(f"{name}: {list(got.uniq_custs)} vs {list(want.uniq_custs)}")
        return {"distinct_max_rel_err": 0.0}
    topn = name in ("topn_hll", "filtered_hll", "topn_exact")
    dims = ("c_city",) if topn else {"quantiles": ("d_year",)}.get(
        name, CUBE_DIMS + ("__grouping_id",)
    )
    wmap = dict(zip(_row_keys(want, dims), range(len(want))))
    idx = [wmap.get(k) for k in _row_keys(got, dims)]
    if None in idx:
        raise AssertionError(f"{name}: a group the oracle does not have")
    w = want.iloc[idx].reset_index(drop=True)
    rev, wrev = np.asarray(got.revenue, np.float64), np.asarray(w.revenue)
    err = {"revenue_max_rel_err": float((np.abs(rev - wrev) / np.abs(wrev)).max())}
    if err["revenue_max_rel_err"] > rtol:
        raise AssertionError(f"{name}: revenue off by {err['revenue_max_rel_err']}")
    if topn:
        k = min(100, len(want))
        if len(got) != k or (np.diff(rev) > 0).any():
            raise AssertionError(f"{name}: not the top {k} by revenue")
        left_out = np.setdiff1d(np.arange(len(want)), idx)
        if len(left_out) and want.revenue.iloc[left_out].max() > rev[-1] * (1 + rtol):
            raise AssertionError(f"{name}: a city above the cut was left out")
    elif len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} groups, oracle {len(want)}")
    if name == "quantiles":
        for p, frac in QUANTILE_FRACTIONS.items():
            est = np.asarray(got[p], np.float64)
            rank = max(quantile_rank_error(v, e, frac) for v, e in zip(w["values"], est))
            err[f"{p}_rank_err"] = rank
            exact = np.asarray(w[p], np.float64)
            err[f"{p}_value_rel_err"] = float((np.abs(est - exact) / np.abs(exact)).max())
            if rank > quantile_rank_bound(frac):
                raise AssertionError(f"{name}: {p} off by {rank} in rank")
        return err
    exact = np.asarray(w.uniq_custs, np.float64)
    rel = np.abs(np.asarray(got.uniq_custs, np.float64) - exact) / exact
    err["distinct_max_rel_err"] = float(rel.max())
    if err["distinct_max_rel_err"] > DISTINCT_REL_BOUND[name]:
        raise AssertionError(f"{name}: distinct count off by {rel.max()}")
    if not topn:
        gids = np.asarray(got["__grouping_id"])
        if sorted(set(gids.tolist())) != list(range(1 << len(CUBE_DIMS))):
            raise AssertionError(f"{name}: grouping ids {sorted(set(gids.tolist()))}")
        for i, d in enumerate(CUBE_DIMS):
            away = (gids >> (len(CUBE_DIMS) - 1 - i)) & 1 == 1
            if not np.array_equal(got[d].isna().to_numpy(), away):
                raise AssertionError(f"{name}: nulls of {d} do not follow the grouping id")
    return err
