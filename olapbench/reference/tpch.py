"""Plain reference of the TPC-H queries the mixes send: Q1, Q5, Q6, Q7, Q8,
Q12, Q14 and Q19, from the normalized lineitem, orders, customer, supplier
and part tables.

Semantics follow the queries as spark_druid_olap_tpu_torch/workloads/
tpch.py words them (`QUERIES`): the same constants, computed here in float64
over the benchmark's own joins (customer through orders).  Imports nothing
of the program."""

from __future__ import annotations

import numpy as np
import torch

from .common import Expected, grouped

FACT = "lineitem"
METRICS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
MS_DAY = 86_400_000


def _ms(day: str) -> int:
    return int(np.datetime64(day, "ms").astype(np.int64))


def _o(b, col):
    return b.star.tables["orders"][col].to(b.device)[b["l_orderkey"].long()]


def _c(b, col):
    return b.star.tables["customer"][col].to(b.device)[b["o_custkey"]]


def _year_of(ms_col):
    """Calendar year of epoch-ms days (1992-1998 and the next year)."""
    starts = torch.as_tensor([_ms(f"{y}-01-01") for y in range(1992, 2001)], device=ms_col.device)
    return 1992 + torch.searchsorted(starts, ms_col, right=True) - 1


JOINS = {"s_nation": ("supplier", "l_suppkey"), "s_region": ("supplier", "l_suppkey"),
         "p_brand": ("part", "l_partkey"), "p_type": ("part", "l_partkey")}
DERIVED = {
    "o_orderdate": lambda b: _o(b, "o_orderdate"),
    "o_orderpriority": lambda b: _o(b, "o_orderpriority"),
    "o_custkey": lambda b: _o(b, "o_custkey"),
    "c_nation": lambda b: _c(b, "c_nation"),
    "c_region": lambda b: _c(b, "c_region"),
    "o_year_id": lambda b: _year_of(b["o_orderdate"]) - 1992,
    "l_year_id": lambda b: _year_of(b["l_shipdate"]) - 1992,
    "disc_price": lambda b: b["l_extendedprice"] * (1 - b["l_discount"]),
}
YEARS = 9  # 1992 .. 2000: shipdates run up to 121 days past 1998-08-01


class Ref:
    def __init__(self, star, device, metric_dtype=None):
        self.star, self.device, self.metric_dtype = star, device, metric_dtype
        self.names = star.names

    def group(self, mask_fn, keys, sums):
        return grouped(self.star, FACT, self.device, JOINS, DERIVED, METRICS,
                       self.metric_dtype, mask_fn, keys, sums)

    def code(self, attr, *values):
        return torch.as_tensor([self.names[attr].index(v) for v in values], device=self.device)

    def isin(self, b, attr, *values):
        return torch.isin(b[attr], self.code(attr, *values))


def _all(b):
    return torch.ones(len(b), dtype=torch.bool, device=b.device)


def _single(r, mask, name, fn):
    out = r.group(mask, [], {name: fn})
    return Expected([{name: out[()][name] if out else 0.0}], (), (name,))


def _decode(r, rows_out, keys, names):
    rows = []
    for key, v in rows_out.items():
        row = {}
        for (col, _), out, i in zip(keys, names, key):
            row[out] = 1992 + i if col.endswith("year_id") else r.names[col][i]
        row.update({k: val for k, val in v.items() if k != "__count"})
        rows.append((row, v["__count"]))
    return rows


def q1(r):
    keys = [("l_returnflag", 3), ("l_linestatus", 2)]
    out = r.group(lambda b: b["l_shipdate"] <= _ms("1998-09-02"), keys, {
        "sum_qty": lambda b: b["l_quantity"],
        "sum_base_price": lambda b: b["l_extendedprice"],
        "sum_disc_price": lambda b: b["disc_price"],
        "sum_charge": lambda b: b["disc_price"] * (1 + b["l_tax"]),
        "sum_disc": lambda b: b["l_discount"],
    })
    rows = []
    for row, n in _decode(r, out, keys, ("l_returnflag", "l_linestatus")):
        row["avg_qty"] = row["sum_qty"] / n
        row["avg_price"] = row["sum_base_price"] / n
        row["avg_disc"] = row.pop("sum_disc") / n
        row["count_order"] = n
        rows.append(row)
    return Expected(rows, ("l_returnflag", "l_linestatus"),
                    ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
                     "avg_qty", "avg_price", "avg_disc"), exact=("count_order",),
                    order=(("l_returnflag", False), ("l_linestatus", False)))


def q5(r):
    keys = [("s_nation", 25)]
    out = r.group(lambda b: r.isin(b, "c_region", "ASIA") & r.isin(b, "s_region", "ASIA")
                  & (b["o_orderdate"] >= _ms("1994-01-01")) & (b["o_orderdate"] < _ms("1995-01-01")),
                  keys, {"revenue": lambda b: b["disc_price"]})
    return Expected([row for row, _ in _decode(r, out, keys, ("s_nation",))], ("s_nation",),
                    ("revenue",), order=(("revenue", True),))


def q6(r):
    return _single(r, lambda b: (b["l_shipdate"] >= _ms("1994-01-01"))
                   & (b["l_shipdate"] < _ms("1995-01-01"))
                   & (b["l_discount"] >= 0.05) & (b["l_discount"] <= 0.07)
                   & (b["l_quantity"] < 24),
                   "revenue", lambda b: b["l_extendedprice"] * b["l_discount"])


def q7(r):
    fr, de = r.code("s_nation", "FRANCE"), r.code("s_nation", "GERMANY")
    keys = [("s_nation", 25), ("c_nation", 25), ("l_year_id", YEARS)]
    out = r.group(lambda b: (((b["s_nation"] == fr) & (b["c_nation"] == de))
                             | ((b["s_nation"] == de) & (b["c_nation"] == fr)))
                  & (b["l_shipdate"] >= _ms("1995-01-01")) & (b["l_shipdate"] <= _ms("1996-12-31")),
                  keys, {"revenue": lambda b: b["disc_price"]})
    names = ("s_nation", "c_nation", "l_year")
    return Expected([row for row, _ in _decode(r, out, keys, names)], names, ("revenue",),
                    order=tuple((c, False) for c in names))


def q8(r):
    brazil = r.code("s_nation", "BRAZIL")
    keys = [("o_year_id", YEARS)]
    out = r.group(lambda b: r.isin(b, "c_region", "AMERICA")
                  & r.isin(b, "p_type", "ECONOMY ANODIZED STEEL")
                  & (b["o_orderdate"] >= _ms("1995-01-01")) & (b["o_orderdate"] <= _ms("1996-12-31")),
                  keys, {"brazil_volume": lambda b: torch.where(b["s_nation"] == brazil,
                                                                b["disc_price"], 0.0),
                         "total_volume": lambda b: b["disc_price"]})
    return Expected([row for row, _ in _decode(r, out, keys, ("o_orderdate_year",))],
                    ("o_orderdate_year",), ("brazil_volume", "total_volume"),
                    order=(("o_orderdate_year", False),))


def q12(r):
    keys = [("l_shipmode", 7)]
    high = r.code("o_orderpriority", "1-URGENT", "2-HIGH")
    out = r.group(lambda b: r.isin(b, "l_shipmode", "MAIL", "SHIP")
                  & (b["l_shipdate"] >= _ms("1994-01-01")) & (b["l_shipdate"] < _ms("1995-01-01")),
                  keys, {"high": lambda b: torch.isin(b["o_orderpriority"], high).double()})
    rows = []
    for row, n in _decode(r, out, keys, ("l_shipmode",)):
        h = int(round(row.pop("high")))
        rows.append({**row, "high_line_count": h, "low_line_count": n - h})
    return Expected(rows, ("l_shipmode",), (), exact=("high_line_count", "low_line_count"),
                    order=(("l_shipmode", False),))


def q14(r):
    promo = torch.as_tensor([i for i, t in enumerate(r.names["p_type"]) if t.startswith("PROMO")],
                            device=r.device)
    out = r.group(lambda b: (b["l_shipdate"] >= _ms("1995-09-01"))
                  & (b["l_shipdate"] < _ms("1995-10-01")), [],
                  {"promo": lambda b: torch.where(torch.isin(b["p_type"], promo),
                                                  b["disc_price"], 0.0),
                   "total": lambda b: b["disc_price"]})
    v = out[()]
    return Expected([{"promo_revenue": 100.0 * v["promo"] / v["total"]}], (), ("promo_revenue",))


def q19(r):
    air = r.code("l_shipmode", "AIR", "REG AIR")

    def block(b, brand, lo, hi):
        return (r.isin(b, "p_brand", brand) & (b["l_quantity"] >= lo) & (b["l_quantity"] <= hi)
                & torch.isin(b["l_shipmode"], air))

    return _single(r, lambda b: block(b, "Brand#12", 1, 11) | block(b, "Brand#23", 10, 20)
                   | block(b, "Brand#34", 20, 30), "revenue", lambda b: b["disc_price"])


QUERIES = {f.__name__: f for f in (q1, q5, q6, q7, q8, q12, q14, q19)}


def expected(star, name: str, device, metric_dtype=None) -> Expected:
    return QUERIES[name](Ref(star, device, metric_dtype))


def fact_dates(star) -> torch.Tensor:
    return star.tables[FACT]["l_shipdate"]
