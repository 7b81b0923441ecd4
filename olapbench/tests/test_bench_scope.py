"""Each query file's `columns` and `in_scope`, which scan_roofline_pct
reads, agree with what the query's own text says.

Columns: every fact column the text names, outside the joins' ON clauses
(a star's joins are collapsed at ingest: the flat fact reads no key), and
the time column where a native query buckets by time.  In scope: the
half-open interval of fact dates that the query's predicates on the date
select: for SQL, its comparisons of the time column with a date; for a
native body, its filter evaluated over the calendar on the date's
attributes (`d_year`, `d_yearmonth`, ...), every other leaf left open."""

import datetime
import json
import os
import re

import numpy as np
import pytest

from olapbench.tests.conftest import CELLS
from olapbench.tests.conftest import cell as bench_cell

TIME_COLUMN = {"ssb": "lo_orderdate", "tpch": "l_shipdate"}
DAY = datetime.timedelta(days=1)


def _queries(root):
    for name in CELLS:
        cell = bench_cell(name, root)
        for q, doc in cell.queries.items():
            yield cell, q, doc


def _all_queries(root):
    return [pytest.param(c, q, d, id=f"{c.family}.{q}") for c, q, d in _queries(root)]


def sql_columns(sql, columns):
    text = re.sub(r"\bON\s+\w+\s*=\s*\w+", " ", sql, flags=re.I)
    text = re.sub(r"'[^']*'", " ", text)
    return {w for w in re.findall(r"[A-Za-z_][A-Za-z_0-9]*", text) if w in columns}


def native_columns(doc, columns, time_column):
    found = set()

    def walk(x):
        if isinstance(x, dict):
            for k, v in x.items():
                if k in ("dimension", "fieldName") and isinstance(v, str):
                    found.add(v)
                elif k == "expression" and isinstance(v, str):
                    found.update(re.findall(r"[A-Za-z_][A-Za-z_0-9]*", v))
                else:
                    walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)

    walk(doc)
    if doc.get("granularity", "all") != "all":
        found.add(time_column)
    return found & set(columns)


def sql_scope(sql, time_column):
    lo = hi = None
    for op, day in re.findall(rf"\b{time_column}\s*(>=|<=|<|>|=)\s*'(\d{{4}}-\d{{2}}-\d{{2}})'", sql):
        d = datetime.date.fromisoformat(day)
        if op in (">=", "=", ">"):
            lo = d + DAY if op == ">" else d
        if op in ("<=", "=", "<"):
            hi = d if op == "<" else d + DAY
    return [None if lo is None else lo.isoformat(), None if hi is None else hi.isoformat()]


def _calendar():
    from olapbench.data.ssb import _dwdate

    cols, ym_names = _dwdate()
    days = cols["d_datekey"].astype("datetime64[ms]").astype("datetime64[D]")
    attrs = {k: v for k, v in cols.items() if k != "d_datekey"}
    attrs["d_yearmonth"] = np.asarray(ym_names, dtype=object)[cols["d_yearmonth"]]
    return days, attrs


def _leaf(f, attrs):
    """The dates a leaf selects, or None where it is not on the date."""
    col = attrs.get(f.get("dimension"))
    if col is None:
        return None
    numeric = f.get("ordering") == "numeric" or col.dtype != object
    val = (lambda v: float(v)) if numeric else str
    if f["type"] == "selector":
        return col == val(f["value"])
    if f["type"] == "in":
        return np.isin(col, [val(v) for v in f["values"]])
    if f["type"] == "bound":
        m = np.ones(len(col), dtype=bool)
        if "lower" in f:
            m &= (col > val(f["lower"])) if f.get("lowerStrict") else (col >= val(f["lower"]))
        if "upper" in f:
            m &= (col < val(f["upper"])) if f.get("upperStrict") else (col <= val(f["upper"]))
        return m
    return None


def _select(f, attrs):
    if f is None:
        return None
    if f["type"] == "and":
        parts = [m for m in (_select(c, attrs) for c in f["fields"]) if m is not None]
        return np.logical_and.reduce(parts) if parts else None
    if f["type"] == "or":
        parts = [_select(c, attrs) for c in f["fields"]]
        return None if any(m is None for m in parts) else np.logical_or.reduce(parts)
    return _leaf(f, attrs)


def native_scope(doc):
    days, attrs = _calendar()
    m = _select(doc.get("filter"), attrs)
    if m is None or m.all():
        return [None, None]
    picked = days[m]
    first = picked.min().astype(datetime.date)
    last = picked.max().astype(datetime.date)
    return [first.isoformat(), (last + DAY).isoformat()]


@pytest.mark.parametrize("cell,query,doc", _all_queries(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))))
def test_columns_and_scope_follow_the_query_text(cell, query, doc):
    widths = cell.config["column_bytes"]
    time_column = TIME_COLUMN[cell.family]
    derived = []
    if "native" in doc:
        derived.append(("native", native_columns(doc["native"], widths, time_column),
                        native_scope(doc["native"])))
    if "sql" in doc:
        scope = sql_scope(doc["sql"], time_column) if "native" not in doc else None
        derived.append(("sql", sql_columns(doc["sql"], widths), scope))
    assert derived, query
    for form, cols, scope in derived:
        assert cols == set(doc["columns"]), (query, form, sorted(cols))
        if scope is not None:
            assert scope == doc["in_scope"], (query, form, scope)


def test_the_derivations_see_a_wrong_file(root):
    """A column left out, a join key counted, and a date bound moved are
    each told apart from the file."""
    cell = bench_cell("tpch_sf10.report", root)
    doc = cell.queries["q12"]
    widths = cell.config["column_bytes"]
    cols = sql_columns(doc["sql"], widths)
    assert "l_orderkey" not in cols and cols == set(doc["columns"])
    assert sql_scope(doc["sql"].replace("'1995-01-01'", "'1995-02-01'"), "l_shipdate") \
        != doc["in_scope"]
    ssb = bench_cell("ssb_sf10.flights", root).queries["q1_3"]
    moved = json.loads(json.dumps(ssb["native"]).replace('"lower": "6"', '"lower": "7"')
                       .replace('"upper": "6"', '"upper": "7"'))
    assert native_scope(moved) != ssb["in_scope"] == native_scope(ssb["native"])
