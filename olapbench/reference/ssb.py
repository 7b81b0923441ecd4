"""Plain reference of the SSB queries the mixes send: Q1.1-Q4.3, the
monthly Timeseries and the c_nation TopN, from the normalized star.

Semantics follow the SSB queries as spark_druid_olap_tpu_torch/workloads/
ssb.py words them (`QUERIES`, `TIMESERIES_QUERY`, `TOPN_QUERY`): the same
constants, computed here in float64 over the benchmark's own joins.
Imports nothing of the program."""

from __future__ import annotations

import torch

from .common import Expected, grouped

FACT = "lineorder"
METRICS = ("lo_quantity", "lo_extendedprice", "lo_discount", "lo_revenue", "lo_supplycost")
JOINS = {
    "d_datekey": ("dwdate", "lo_orderdate"), "d_year": ("dwdate", "lo_orderdate"),
    "d_yearmonthnum": ("dwdate", "lo_orderdate"), "d_yearmonth": ("dwdate", "lo_orderdate"),
    "d_weeknuminyear": ("dwdate", "lo_orderdate"),
    "c_region": ("customer", "lo_custkey"), "c_nation": ("customer", "lo_custkey"),
    "c_city": ("customer", "lo_custkey"),
    "s_region": ("supplier", "lo_suppkey"), "s_nation": ("supplier", "lo_suppkey"),
    "s_city": ("supplier", "lo_suppkey"),
    "p_mfgr": ("part", "lo_partkey"), "p_category": ("part", "lo_partkey"),
    "p_brand1": ("part", "lo_partkey"),
}
FIRST_YEAR, YEARS = 1992, 7
DERIVED = {"year_id": lambda b: b["d_year"] - FIRST_YEAR}


class Ref:
    def __init__(self, star, device, metric_dtype=None):
        self.star, self.device, self.metric_dtype = star, device, metric_dtype
        self.names = star.names

    def group(self, mask_fn, keys, sums):
        return grouped(self.star, FACT, self.device, JOINS, DERIVED, METRICS,
                       self.metric_dtype, mask_fn, keys, sums)

    def code(self, attr, *values):
        """Ids of the named values of a string attribute."""
        return [self.names[attr].index(v) for v in values]


def _isin(col, ids):
    return torch.isin(col, torch.as_tensor(ids, device=col.device))


def _q1(r, mask):
    out = r.group(mask, [], {"revenue": lambda b: b["lo_extendedprice"] * b["lo_discount"]})
    # a global aggregate over no row answers one row, as SQL does
    rev = out[()]["revenue"] if out else 0.0
    return Expected([{"revenue": rev}], (), ("revenue",))


def _decoders(r):
    d = {a: (lambda i, a=a: r.names[a][i]) for a in r.names}
    d["year_id"] = lambda i: FIRST_YEAR + i
    return d


def _grouped_query(r, mask, keys, value, out_names, order):
    """`keys` [(column, domain)], reported under `out_names`; one summed
    value column `value` = (name, fn)."""
    name, fn = value
    out = r.group(mask, keys, {name: fn})
    dec = _decoders(r)
    rows = []
    for key, v in out.items():
        row = {o: dec[k](i) for (k, _), o, i in zip(keys, out_names, key)}
        row[name] = v[name]
        rows.append(row)
    return Expected(rows, tuple(out_names), (name,), order=order)


def _dom(r, attr):
    return len(r.names[attr])


def q1_1(r):
    return _q1(r, lambda b: (b["d_year"] == 1993) & (b["lo_discount"] >= 1)
               & (b["lo_discount"] <= 3) & (b["lo_quantity"] < 25))


def q1_2(r):
    return _q1(r, lambda b: (b["d_yearmonthnum"] == 199401) & (b["lo_discount"] >= 4)
               & (b["lo_discount"] <= 6) & (b["lo_quantity"] >= 26) & (b["lo_quantity"] <= 35))


def q1_3(r):
    return _q1(r, lambda b: (b["d_weeknuminyear"] == 6) & (b["d_year"] == 1994)
               & (b["lo_discount"] >= 5) & (b["lo_discount"] <= 7)
               & (b["lo_quantity"] >= 26) & (b["lo_quantity"] <= 35))


_REV = ("revenue", lambda b: b["lo_revenue"])
_PROFIT = ("profit", lambda b: b["lo_revenue"] - b["lo_supplycost"])


def _q2(r, mask):
    return _grouped_query(r, mask, [("year_id", YEARS), ("p_brand1", _dom(r, "p_brand1"))], _REV,
                          ("d_year", "p_brand1"), (("d_year", False), ("p_brand1", False)))


def q2_1(r):
    return _q2(r, lambda b: _isin(b["p_category"], r.code("p_category", "MFGR#12"))
               & _isin(b["s_region"], r.code("s_region", "AMERICA")))


def q2_2(r):
    brands = [i for i, s in enumerate(r.names["p_brand1"]) if "MFGR#2221" <= s <= "MFGR#2228"]
    return _q2(r, lambda b: _isin(b["p_brand1"], brands)
               & _isin(b["s_region"], r.code("s_region", "ASIA")))


def q2_3(r):
    return _q2(r, lambda b: _isin(b["p_brand1"], r.code("p_brand1", "MFGR#2239"))
               & _isin(b["s_region"], r.code("s_region", "EUROPE")))


def _q3(r, c, s, mask):
    return _grouped_query(r, mask, [(c, _dom(r, c)), (s, _dom(r, s)), ("year_id", YEARS)], _REV,
                          (c, s, "d_year"), (("d_year", False), ("revenue", True)))


def _y92_97(b):
    return (b["d_year"] >= 1992) & (b["d_year"] <= 1997)


_UK = ("UNITED KINGDOM1", "UNITED KINGDOM5")


def q3_1(r):
    return _q3(r, "c_nation", "s_nation",
               lambda b: _isin(b["c_region"], r.code("c_region", "ASIA"))
               & _isin(b["s_region"], r.code("s_region", "ASIA")) & _y92_97(b))


def q3_2(r):
    return _q3(r, "c_city", "s_city",
               lambda b: _isin(b["c_nation"], r.code("c_nation", "UNITED STATES"))
               & _isin(b["s_nation"], r.code("s_nation", "UNITED STATES")) & _y92_97(b))


def q3_3(r):
    return _q3(r, "c_city", "s_city",
               lambda b: _isin(b["c_city"], r.code("c_city", *_UK))
               & _isin(b["s_city"], r.code("s_city", *_UK)) & _y92_97(b))


def q3_4(r):
    return _q3(r, "c_city", "s_city",
               lambda b: _isin(b["c_city"], r.code("c_city", *_UK))
               & _isin(b["s_city"], r.code("s_city", *_UK))
               & _isin(b["d_yearmonth"], r.code("d_yearmonth", "1997-12")))


def _q4(r, attrs, mask):
    keys = [("year_id", YEARS)] + [(a, _dom(r, a)) for a in attrs]
    out_names = ("d_year",) + tuple(attrs)
    return _grouped_query(r, mask, keys, _PROFIT, out_names,
                          tuple((c, False) for c in out_names))


def _america(b, r):
    return (_isin(b["c_region"], r.code("c_region", "AMERICA"))
            & _isin(b["s_region"], r.code("s_region", "AMERICA")))


def q4_1(r):
    return _q4(r, ("c_nation",), lambda b: _america(b, r)
               & _isin(b["p_mfgr"], r.code("p_mfgr", "MFGR#1", "MFGR#2")))


def q4_2(r):
    return _q4(r, ("s_nation", "p_category"), lambda b: _america(b, r)
               & ((b["d_year"] == 1997) | (b["d_year"] == 1998))
               & _isin(b["p_mfgr"], r.code("p_mfgr", "MFGR#1", "MFGR#2")))


def q4_3(r):
    return _q4(r, ("s_city", "p_brand1"),
               lambda b: _isin(b["c_region"], r.code("c_region", "AMERICA"))
               & _isin(b["s_nation"], r.code("s_nation", "UNITED STATES"))
               & ((b["d_year"] == 1997) | (b["d_year"] == 1998))
               & _isin(b["p_category"], r.code("p_category", "MFGR#14")))


def timeseries(r):
    """Revenue per calendar month, empty months left out."""
    out = r.group(lambda b: torch.ones(len(b), dtype=torch.bool, device=r.device),
                  [("d_yearmonth", _dom(r, "d_yearmonth"))], {"revenue": _REV[1]})
    rows = [{"timestamp": f"{r.names['d_yearmonth'][k[0]]}-01T00:00:00.000Z",
             "revenue": v["revenue"]} for k, v in out.items()]
    return Expected(rows, ("timestamp",), ("revenue",), order=(("timestamp", False),))


def topn(r):
    """The ten customer nations with the most revenue (every nation is a
    candidate: ties at the cut are the comparison's to settle)."""
    e = _grouped_query(r, lambda b: torch.ones(len(b), dtype=torch.bool, device=r.device),
                       [("c_nation", _dom(r, "c_nation"))], _REV, ("c_nation",),
                       (("revenue", True),))
    e.top = 10
    return e


QUERIES = {f.__name__: f for f in (q1_1, q1_2, q1_3, q2_1, q2_2, q2_3, q3_1, q3_2, q3_3,
                                   q3_4, q4_1, q4_2, q4_3, timeseries, topn)}


def expected(star, name: str, device, metric_dtype=None) -> Expected:
    return QUERIES[name](Ref(star, device, metric_dtype))


def fact_dates(star) -> torch.Tensor:
    """The fact's date (epoch ms) of every row, through its own join."""
    return star.tables["dwdate"]["d_datekey"][star.tables[FACT]["lo_orderdate"].long()]
