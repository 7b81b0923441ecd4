"""Synthetic benchmark data generators (TPC-H lineitem, SSB flat star, the
event stream).

Statistically shaped synthetic tables with the real schemas, cardinalities
and value ranges; parity tests compare results against a float64 oracle
over the same generated columns, so correctness testing does not depend on
matching official dbgen output.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_MS_DAY = 86_400_000


def _days(date: str) -> int:
    return int(np.datetime64(date, "D").astype(int))


def gen_lineitem(scale: float = 0.01, seed: int = 0) -> Dict[str, np.ndarray]:
    """TPC-H lineitem columns used by Q1 (SF1 ≈ 6M rows)."""
    n = int(6_001_215 * scale)
    rng = np.random.default_rng(seed)
    shipdate_days = rng.integers(
        _days("1992-01-02"), _days("1998-12-01"), size=n
    )
    # l_returnflag correlates with shipdate in real data; synthetic keeps the
    # 3-value domain and rough mass distribution.
    returnflag = rng.choice(np.array(["A", "N", "R"]), size=n, p=[0.25, 0.5, 0.25])
    linestatus = np.where(
        shipdate_days < _days("1995-06-17"), "F", "O"
    ).astype(object)
    return {
        "l_returnflag": returnflag.astype(object),
        "l_linestatus": linestatus,
        "l_quantity": rng.integers(1, 51, size=n).astype(np.float32),
        "l_extendedprice": (rng.random(n).astype(np.float32) * 100_000 + 900),
        "l_discount": rng.integers(0, 11, size=n).astype(np.float32) / 100,
        "l_tax": rng.integers(0, 9, size=n).astype(np.float32) / 100,
        "l_shipdate": (shipdate_days.astype(np.int64) * _MS_DAY),
        "l_orderkey": rng.integers(1, int(1_500_000 * max(scale, 1e-3)) * 4,
                                   size=n).astype(np.int64),
    }


def gen_ssb_lineorder_flat(scale: float = 0.01, seed: int = 1) -> Dict[str, np.ndarray]:
    """SSB denormalized lineorder (the star pre-joined, Druid-style).

    SF1 lineorder ≈ 6M rows.  Columns cover Q1.x–Q4.x: date attributes,
    customer/supplier region+nation+city, part mfgr/category/brand, and the
    measures."""
    n = int(6_000_000 * scale)
    rng = np.random.default_rng(seed)

    d = rng.integers(_days("1992-01-01"), _days("1998-08-03"), size=n)
    dt = d.astype("datetime64[D]")
    years = dt.astype("datetime64[Y]").astype(int) + 1970
    months = dt.astype("datetime64[M]").astype(int) % 12 + 1
    yearmonthnum = years * 100 + months
    # SSB weeknuminyear
    day_of_year = (dt - dt.astype("datetime64[Y]")).astype(int) + 1
    weeknum = (day_of_year - 1) // 7 + 1

    regions = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"])
    nations_by_region = {
        "AFRICA": ["ALGERIA", "ETHIOPIA", "KENYA", "MOROCCO", "MOZAMBIQUE"],
        "AMERICA": ["ARGENTINA", "BRAZIL", "CANADA", "PERU", "UNITED STATES"],
        "ASIA": ["CHINA", "INDIA", "INDONESIA", "JAPAN", "VIETNAM"],
        "EUROPE": ["FRANCE", "GERMANY", "ROMANIA", "RUSSIA", "UNITED KINGDOM"],
        "MIDDLE EAST": ["EGYPT", "IRAN", "IRAQ", "JORDAN", "SAUDI ARABIA"],
    }

    def geo(prefix, rng):
        reg = rng.choice(regions, size=n)
        nation = np.empty(n, dtype=object)
        for r in regions:
            m = reg == r
            nation[m] = rng.choice(np.array(nations_by_region[r]), size=int(m.sum()))
        city = np.char.add(
            np.asarray(nation, dtype=str),
            rng.integers(0, 10, size=n).astype(str),
        )
        return reg.astype(object), nation, city.astype(object)

    c_region, c_nation, c_city = geo("c", rng)
    s_region, s_nation, s_city = geo("s", rng)

    mfgr = np.char.add("MFGR#", rng.integers(1, 6, size=n).astype(str))
    category = np.char.add(
        np.asarray(mfgr, dtype=str),
        rng.integers(1, 6, size=n).astype(str),
    )
    brand = np.char.add(
        np.asarray(category, dtype=str),
        rng.integers(1, 41, size=n).astype(str),
    )

    quantity = rng.integers(1, 51, size=n).astype(np.float32)
    extendedprice = rng.random(n).astype(np.float32) * 55_450 + 90
    discount = rng.integers(0, 11, size=n).astype(np.float32)
    revenue = extendedprice * (1 - discount / 100)
    supplycost = extendedprice * 0.6

    return {
        "lo_orderdate": d.astype(np.int64) * _MS_DAY,
        "d_year": years.astype(np.int32),
        "d_yearmonthnum": yearmonthnum.astype(np.int32),
        "d_yearmonth": np.array(
            [f"{y}-{m:02d}" for y, m in zip(years, months)], dtype=object
        ),
        "d_weeknuminyear": weeknum.astype(np.int32),
        "c_region": c_region,
        "c_nation": c_nation,
        "c_city": c_city,
        "s_region": s_region,
        "s_nation": s_nation,
        "s_city": s_city,
        "p_mfgr": np.asarray(mfgr, dtype=object),
        "p_category": np.asarray(category, dtype=object),
        "p_brand1": np.asarray(brand, dtype=object),
        "lo_quantity": quantity,
        "lo_extendedprice": extendedprice,
        "lo_discount": discount,
        "lo_revenue": revenue.astype(np.float32),
        "lo_supplycost": supplycost.astype(np.float32),
    }


LINEITEM_DIMS = ["l_returnflag", "l_linestatus"]
LINEITEM_METRICS = [
    "l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_orderkey",
]

SSB_DIMS = [
    "d_year", "d_yearmonthnum", "d_yearmonth", "d_weeknuminyear",
    "c_region", "c_nation", "c_city",
    "s_region", "s_nation", "s_city",
    "p_mfgr", "p_category", "p_brand1",
]
SSB_METRICS = [
    "lo_quantity", "lo_extendedprice", "lo_discount", "lo_revenue",
    "lo_supplycost",
]


# ---------------------------------------------------------------------------
# Event stream (BASELINE config #4: hourly rollup over a 1B-row stream)
# ---------------------------------------------------------------------------

EVENT_SITES = 32  # site dimension cardinality
EVENT_KINDS = 8  # event-kind dimension cardinality
EVENT_T0 = "2024-01-01"  # stream start
EVENT_SPAN_HOURS = 24 * 7  # one week of events


def event_stream_schema():
    """Schema-only datasource of the event stream (`exec/streaming.py`).

    The dimension dictionaries are the dense integer domains 0..K-1, so the
    generated values are their own rank codes: chunks need no encoding."""
    from ..catalog.segment import DimensionDict, schema_datasource

    return schema_datasource(
        "events",
        dims={
            "site": DimensionDict(values=tuple(range(EVENT_SITES))),
            "kind": DimensionDict(values=tuple(range(EVENT_KINDS))),
        },
        metric_cols={"value": "double", "latency": "double"},
        time_col="ts",
    )


def event_stream_interval():
    lo = int(np.datetime64(EVENT_T0, "ms").astype(np.int64))
    return (lo, lo + EVENT_SPAN_HOURS * 3_600_000)


def gen_event_chunk(chunk_idx: int, rows: int) -> Dict[str, np.ndarray]:
    """Chunk `chunk_idx` of the synthetic event stream, seeded by its index,
    so a 1B-row stream is `gen_event_chunk(i, rows)` for i below
    1B / rows, in O(rows) host memory."""
    rng = np.random.default_rng(1000 + chunk_idx)
    lo, hi = event_stream_interval()
    return {
        "ts": rng.integers(lo, hi, size=rows, dtype=np.int64),
        "site": rng.integers(0, EVENT_SITES, size=rows, dtype=np.int32),
        "kind": rng.integers(0, EVENT_KINDS, size=rows, dtype=np.int32),
        "value": (rng.random(rows) * 100.0).astype(np.float32),
        "latency": (rng.gamma(2.0, 15.0, size=rows)).astype(np.float32),
    }
