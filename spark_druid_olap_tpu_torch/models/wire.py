"""Druid wire JSON: decoding queries into specs, and the response envelope.

`query_from_druid` parses a Druid native query body (groupBy, topN,
timeseries, scan, search, timeBoundary, dataSourceMetadata,
segmentMetadata) into the spec objects `exec/engine.py` executes; every
spec's `to_druid()` prints the same JSON back, so
`query_from_druid(q.to_druid()) == q`.  Malformed client input raises
`WireError`.

JavaScript aggregators, filters and virtual columns are accepted only when
their `expression` string re-parses under the SQL expression grammar
(`sql/parser.py`), the form `to_druid()` prints; true JavaScript source
raises.

`druid_result_shape` turns an engine frame into the response Druid's broker
returns for the query type (the reference's `server.py:87-182`: `_jsonable`,
`_rows`, `_result_timestamp`, `druid_result_shape`); the HTTP server that
will serve it is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from . import aggregations as A
from . import query as Q
from .dimensions import (
    CaseExtraction,
    DimensionSpec,
    RegexExtraction,
    SubstringExtraction,
    TimeFieldExtraction,
    TimeFormatExtraction,
)
from .filters import _ms_to_iso, filter_from_druid


class WireError(ValueError):
    pass


def _expr(source: str):
    from ..sql.lexer import LexError
    from ..sql.parser import ParseError, Parser

    try:
        p = Parser(source)
        e = p.expr()
        if p.peek().kind != "EOF":
            # a half-parsed expression ("s * 2 bogus") must be rejected,
            # not silently truncated to the parseable prefix
            raise WireError(
                f"expression {source!r} has trailing input at "
                f"{p.peek().value!r}"
            )
        return e
    except WireError:
        raise
    except (ParseError, LexError) as e:  # malformed CLIENT input -> 400;
        # anything else is an internal parser bug and stays a 500
        raise WireError(
            f"expression {source!r} does not re-parse under the SQL "
            f"expression grammar: {e}"
        ) from None


def agg_from_druid(d: Dict[str, Any]) -> A.Aggregation:
    t = d["type"]
    if t == "count":
        return A.Count(d["name"])
    simple = {
        "longSum": A.LongSum,
        "doubleSum": A.DoubleSum,
        "floatSum": A.DoubleSum,
        "longMin": A.LongMin,
        "doubleMin": A.DoubleMin,
        "floatMin": A.DoubleMin,
        "longMax": A.LongMax,
        "doubleMax": A.DoubleMax,
        "floatMax": A.DoubleMax,
    }
    if t in simple:
        return simple[t](d["name"], d["fieldName"])
    if t == "hyperUnique":
        return A.HyperUnique(d["name"], d["fieldName"], d.get("precision", 11))
    if t == "cardinality":
        fields = tuple(d.get("fields") or d.get("fieldNames") or ())
        return A.CardinalityAgg(
            d["name"], fields, d.get("byRow", False), d.get("precision", 11)
        )
    if t == "thetaSketch":
        return A.ThetaSketch(d["name"], d["fieldName"], d.get("size", 4096))
    if t == "quantilesDoublesSketch":
        return A.QuantilesSketch(d["name"], d["fieldName"], d.get("k", 1024))
    if t == "dimCodeMax":  # internal FD-pruning carrier (not Druid dialect)
        return A.DimCodeMax(d["name"], d["fieldName"])
    if t == "filtered":
        return A.FilteredAgg(
            filter_from_druid(d["filter"]), agg_from_druid(d["aggregator"])
        )
    if t == "javascript":
        return A.ExpressionAgg(
            d["name"], _expr(d["expression"]), d.get("base", "doubleSum")
        )
    raise WireError(f"unsupported aggregation type {t!r}")


def post_agg_from_druid(d: Dict[str, Any]) -> A.PostAggregation:
    t = d["type"]
    if t == "fieldAccess":
        return A.FieldAccess(d.get("name", d["fieldName"]), d["fieldName"])
    if t == "constant":
        return A.ConstantPost(d.get("name", "const"), d["value"])
    if t == "arithmetic":
        return A.Arithmetic(
            d["name"], d["fn"], tuple(post_agg_from_druid(f) for f in d["fields"])
        )
    if t == "hyperUniqueCardinality":
        return A.HyperUniqueCardinality(d.get("name", d["fieldName"]), d["fieldName"])
    if t == "thetaSketchEstimate":
        f = d.get("field", {})
        if f.get("type") == "thetaSketchSetOp":
            fn = f.get("func", f.get("fn"))
            fields = tuple(x["fieldName"] for x in f.get("fields", ()))
            if fn not in ("UNION", "INTERSECT", "NOT"):
                raise WireError(f"thetaSketchSetOp func {fn!r}")
            if not fields:
                raise WireError("thetaSketchSetOp requires fields")
            return A.ThetaSketchSetOp(d["name"], fn, fields)
        return A.ThetaSketchEstimate(d["name"], f.get("fieldName", d.get("fieldName")))
    if t == "expression":
        return A.ExpressionPost(d["name"], _expr(d["expression"]))
    if t == "quantilesDoublesSketchToQuantile":
        f = d.get("field", {})
        return A.QuantileFromSketch(
            d["name"], f.get("fieldName", d.get("fieldName")), d["fraction"]
        )
    raise WireError(f"unsupported postAggregation type {t!r}")


def _extraction_from_druid(d: Dict[str, Any]):
    t = d["type"]
    if t == "substring":
        return SubstringExtraction(d["index"], d.get("length"))
    if t == "upper":
        return CaseExtraction(upper=True)
    if t == "lower":
        return CaseExtraction(upper=False)
    if t == "regex":
        return RegexExtraction(d["expr"], d.get("index", 1))
    if t == "lookup":
        from .dimensions import LookupExtraction

        lk = d.get("lookup", {})
        if lk.get("type") != "map":
            raise WireError(f"unsupported lookup type {lk.get('type')!r}")
        return LookupExtraction.from_mapping(
            d.get("name", "wire"),
            lk.get("map") or {},
            retain_missing=bool(d.get("retainMissingValue", False)),
            replace_missing=d.get("replaceMissingValueWith"),
        )
    if t == "stringFormat":
        from .dimensions import FormatExtraction

        fmt = d.get("format", "%s")
        # protect escaped %% before locating the single %s conversion
        guarded = fmt.replace("%%", "\x00")
        if guarded.count("%s") != 1:
            raise WireError(
                f"stringFormat must contain exactly one %s: {fmt!r}"
            )
        pre, suf = (
            p.replace("\x00", "%") for p in guarded.split("%s", 1)
        )
        return FormatExtraction(pre, suf)
    if t == "strlen":
        from .dimensions import StrlenExtraction

        return StrlenExtraction()
    if t == "cascade":
        from .dimensions import CascadeExtraction

        return CascadeExtraction(
            tuple(
                _extraction_from_druid(f) for f in d.get("extractionFns", ())
            )
        )
    if t == "timeFormat":
        fmt = d.get("format", "%Y")
        # field-shaped formats decode to the int-valued EXTRACT dimension
        for field, f in TimeFieldExtraction._FORMATS.items():
            if fmt == f:
                return TimeFieldExtraction(field)
        return TimeFormatExtraction(fmt, d.get("granularity"))
    raise WireError(f"unsupported extractionFn type {t!r}")


def dimension_from_druid(d) -> DimensionSpec:
    if isinstance(d, str):
        return DimensionSpec(d)
    t = d.get("type", "default")
    if t == "default":
        return DimensionSpec(d["dimension"], d.get("outputName"))
    if t == "extraction":
        return DimensionSpec(
            d["dimension"],
            d.get("outputName"),
            extraction=_extraction_from_druid(d["extractionFn"]),
        )
    raise WireError(f"unsupported dimension type {t!r}")


def _iso_ms(s: str) -> int:
    return int(np.datetime64(s.rstrip("Z"), "ms").astype(np.int64))


# Any start at-or-before year 0000 / end at-or-past year 3000 is treated as
# unbounded — covers our own _ETERNITY spelling, variants without millis,
# and anything a client means as "everything".
_ETERNITY_LO = int(np.datetime64("0000-01-01", "ms").astype(np.int64))
_ETERNITY_HI = int(np.datetime64("3000-01-01", "ms").astype(np.int64))
# Druid's canonical eternity instants (Long.MIN/MAX_VALUE as millis) have
# six-digit years np.datetime64 cannot parse; match them by prefix.
_DRUID_MIN_PREFIX = "-146136543-"
_DRUID_MAX_PREFIX = "146140482-"


def _bound_ms(s: str) -> int:
    s = s.strip()
    # Druid's canonical instants parse to values far outside the sentinel
    # range; genuine far-future/far-past bounds pass through UNCLAMPED so a
    # real [3500, 3600) interval stays a real interval
    if s.startswith(_DRUID_MIN_PREFIX):
        return -(1 << 62)
    if s.startswith(_DRUID_MAX_PREFIX):
        return 1 << 62
    return _iso_ms(s)


def intervals_from_druid(ivs: List[str]) -> Tuple[Tuple[int, int], ...]:
    # an eternity interval is the wire form of "no constraint" (Druid
    # requires an intervals field; our specs use () — a round-trip must not
    # turn it into a real time filter, which would demand a time column).
    # Detected by parsed bounds, not string equality: Druid's canonical
    # spelling, ours, and milliless variants must all decode to ().
    out = []
    for iv in ivs or ():
        a, b = iv.split("/")
        am = _bound_ms(a)
        bm = _bound_ms(b)
        if am <= _ETERNITY_LO and bm >= _ETERNITY_HI:
            # intervals union: eternity subsumes everything
            return ()
        out.append((am, bm))
    return tuple(out)


def granularity_from_druid(g) -> str:
    if isinstance(g, str):
        return g
    if isinstance(g, dict):
        if g.get("type") == "period":
            return g["period"]
        if g.get("type") == "all":
            return "all"
    raise WireError(f"unsupported granularity {g!r}")


def _common(d):
    filt = filter_from_druid(d["filter"]) if d.get("filter") else None
    ivs = intervals_from_druid(d.get("intervals", []))
    vcols = tuple(
        Q.VirtualColumn(
            v["name"],
            _expr(v["expression"]),
            "double" if v.get("outputType", "DOUBLE") == "DOUBLE" else "long",
        )
        for v in d.get("virtualColumns", ())
    )
    aggs = tuple(agg_from_druid(a) for a in d.get("aggregations", ()))
    posts = tuple(post_agg_from_druid(p) for p in d.get("postAggregations", ()))
    return filt, ivs, vcols, aggs, posts


def having_from_druid(d: Dict[str, Any]) -> Q.Having:
    """Druid havingSpec -> model.  A having the engine can't honor must be
    a WireError, never a silent drop (it filters result rows)."""
    t = d.get("type")
    ops = {"greaterThan": ">", "lessThan": "<", "equalTo": "=="}
    if t in ops:
        return Q.HavingCompare(d["aggregation"], ops[t], d["value"])
    if t == "and":
        return Q.HavingAnd(
            tuple(having_from_druid(s) for s in d["havingSpecs"])
        )
    if t == "or":
        return Q.HavingOr(
            tuple(having_from_druid(s) for s in d["havingSpecs"])
        )
    if t == "not":
        return Q.HavingNot(having_from_druid(d["havingSpec"]))
    raise WireError(f"unsupported havingSpec type {t!r}")


def query_from_druid(d: Dict[str, Any]) -> Q.QuerySpec:
    """A Druid native query body -> its spec.  Malformed client input (an
    unsupported type, an interval that does not parse, an expression with
    trailing input) raises WireError: decode-time ValueErrors are the
    client's, as the reference's server reports them."""
    try:
        return _query_from_druid(d)
    except WireError:
        raise
    except ValueError as e:
        raise WireError(str(e)) from e


def _query_from_druid(d: Dict[str, Any]) -> Q.QuerySpec:
    qt = d.get("queryType")
    ds = d.get("dataSource")
    if isinstance(ds, dict):
        ds = ds.get("name")
    if qt == "groupBy":
        filt, ivs, vcols, aggs, posts = _common(d)
        dims = tuple(dimension_from_druid(x) for x in d.get("dimensions", ()))
        ls = None
        if d.get("limitSpec"):
            spec = d["limitSpec"]
            ls = Q.LimitSpec(
                spec.get("limit"),
                tuple(
                    Q.OrderByColumnSpec(
                        c["dimension"] if isinstance(c, dict) else c,
                        c.get("direction", "ascending") if isinstance(c, dict) else "ascending",
                    )
                    for c in spec.get("columns", ())
                ),
                spec.get("offset", 0),
            )
        subtotals = ()
        if d.get("subtotalsSpec"):
            # name lists -> dimension-index tuples (the model's form)
            by_name = {spec.name: i for i, spec in enumerate(dims)}
            try:
                subtotals = tuple(
                    tuple(by_name[n] for n in names)
                    for names in d["subtotalsSpec"]
                )
            except KeyError as err:
                raise WireError(
                    f"subtotalsSpec names unknown dimension {err}"
                )
        return Q.GroupByQuery(
            datasource=ds,
            dimensions=dims,
            aggregations=aggs,
            post_aggregations=posts,
            filter=filt,
            having=(
                having_from_druid(d["having"]) if d.get("having") else None
            ),
            limit_spec=ls,
            intervals=ivs,
            granularity=granularity_from_druid(d.get("granularity", "all")),
            virtual_columns=vcols,
            subtotals=subtotals,
        )
    if qt == "topN":
        filt, ivs, vcols, aggs, posts = _common(d)
        dim = dimension_from_druid(d["dimension"])
        metric = d["metric"]
        descending = True
        if isinstance(metric, dict):
            t = metric.get("type")
            if t == "inverted":
                descending = False
                metric = metric.get("metric")
                if isinstance(metric, dict):
                    # Druid encodes descending dimension order as inverted-
                    # wrapped lexicographic
                    if metric.get("type") not in ("dimension", "lexicographic"):
                        raise WireError(
                            "unsupported inverted topN metric "
                            f"{metric.get('type')!r}"
                        )
                    ordering = metric.get("ordering", "lexicographic")
                    if ordering != "lexicographic":
                        raise WireError(
                            f"unsupported topN dimension ordering {ordering!r}"
                        )
                    descending = True
                    metric = dim.name
            elif t in ("dimension", "lexicographic"):
                # dimension-ordered topN: rank ASCENDING by the dimension's
                # own value (Druid expresses descending as inverted-wrapped
                # lexicographic, handled above).  alphaNumeric/numeric
                # orderings rank c2 before c10; a lexicographic sort would
                # silently return the wrong top-K, so they are rejected,
                # not coerced
                ordering = metric.get("ordering", "lexicographic")
                if ordering != "lexicographic":
                    raise WireError(
                        f"unsupported topN dimension ordering {ordering!r}"
                    )
                descending = False
                metric = dim.name
            else:
                raise WireError(f"unsupported topN metric spec {t!r}")
        return Q.TopNQuery(
            datasource=ds,
            dimension=dim,
            metric=metric,
            threshold=d["threshold"],
            aggregations=aggs,
            post_aggregations=posts,
            filter=filt,
            intervals=ivs,
            granularity=granularity_from_druid(d.get("granularity", "all")),
            virtual_columns=vcols,
            descending=descending,
        )
    if qt == "timeseries":
        filt, ivs, vcols, aggs, posts = _common(d)
        return Q.TimeseriesQuery(
            datasource=ds,
            granularity=granularity_from_druid(d.get("granularity", "all")),
            aggregations=aggs,
            post_aggregations=posts,
            filter=filt,
            intervals=ivs,
            virtual_columns=vcols,
            descending=d.get("descending", False),
            skip_empty_buckets=bool(
                (d.get("context") or {}).get("skipEmptyBuckets", False)
            ),
            output_name=(d.get("context") or {}).get(
                "outputName", "timestamp"
            ),
        )
    if qt == "scan":
        filt, ivs, vcols, _, _ = _common(d)
        for o in d.get("orderBy") or ():
            if "columnName" not in o:
                raise WireError("scan orderBy entry missing columnName")
        order_by = tuple(
            Q.OrderByColumnSpec(
                o["columnName"], o.get("order", "ascending")
            )
            for o in (d.get("orderBy") or ())
        )
        # legacy scan `order` field: time ordering
        if not order_by and d.get("order") in ("ascending", "descending"):
            order_by = (Q.OrderByColumnSpec("__time", d["order"]),)
        return Q.ScanQuery(
            datasource=ds,
            columns=tuple(d.get("columns", ())),
            filter=filt,
            intervals=ivs,
            limit=d.get("limit"),
            virtual_columns=vcols,
            order_by=order_by,
            offset=d.get("offset", 0),
            result_format=d.get("resultFormat", "list"),
        )
    if qt == "search":
        filt, ivs, _, _, _ = _common(d)
        qspec = d.get("query", {})
        return Q.SearchQuery(
            datasource=ds,
            dimensions=tuple(d.get("searchDimensions", ())),
            query=qspec.get("value", ""),
            filter=filt,
            intervals=ivs,
            limit=d.get("limit", 1000),
        )
    if qt == "timeBoundary":
        return Q.TimeBoundaryQuery(datasource=ds, bound=d.get("bound"))
    if qt == "dataSourceMetadata":
        return Q.DataSourceMetadataQuery(datasource=ds)
    if qt == "segmentMetadata":
        return Q.SegmentMetadataQuery(
            datasource=ds,
            intervals=intervals_from_druid(d.get("intervals", [])),
        )
    raise WireError(f"unsupported queryType {qt!r}")


# -- the response envelope ---------------------------------------------------


def _jsonable(v: Any):
    import datetime

    import pandas as pd

    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        f = float(v)
        return None if np.isnan(f) else f
    if isinstance(v, np.datetime64):
        return _ms_to_iso(int(v.astype("datetime64[ms]").astype(np.int64)))
    if isinstance(v, (pd.Timestamp, datetime.datetime)):
        # Druid wire format is ISO-8601 with the Z designator, not
        # str(Timestamp)'s "YYYY-MM-DD HH:MM:SS"
        return _ms_to_iso(
            int(np.datetime64(v.replace(tzinfo=None), "ms").astype(np.int64))
        )
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, float) and np.isnan(v):
        return None
    if v is None or isinstance(v, (str, int, float, bool)):
        return v
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)


def _rows(df) -> list:
    return [
        {k: _jsonable(v) for k, v in rec.items()}
        for rec in df.to_dict(orient="records")
    ]


def _result_timestamp(q) -> str:
    ivs = getattr(q, "intervals", ())
    return _ms_to_iso(ivs[0][0] if ivs else 0)


def druid_result_shape(q: Q.QuerySpec, df) -> Any:
    """Results in the shape Druid's broker returns for each query type."""
    if isinstance(q, Q.GroupByQuery):
        ts = _result_timestamp(q)
        out = []
        for rec in _rows(df):
            t = rec.pop("timestamp", ts)
            out.append({"version": "v1", "timestamp": t, "event": rec})
        return out
    if isinstance(q, Q.TimeseriesQuery):
        # wire shape always says "timestamp" whatever the SQL alias was
        return [
            {
                "timestamp": rec.pop(q.output_name, _result_timestamp(q)),
                "result": rec,
            }
            for rec in _rows(df)
        ]
    if isinstance(q, Q.TopNQuery):
        return [{"timestamp": _result_timestamp(q), "result": _rows(df)}]
    if isinstance(q, Q.ScanQuery):
        if q.result_format == "compactedList":
            # Druid compactedList: events are POSITIONAL value arrays
            # aligned with "columns", not keyed objects
            events = [
                [_jsonable(v) for v in row]
                for row in df.itertuples(index=False)
            ]
        else:
            events = _rows(df)
        return [
            {
                "segmentId": q.datasource,
                "columns": list(df.columns),
                "events": events,
            }
        ]
    if isinstance(q, Q.SearchQuery):
        return [{"timestamp": _result_timestamp(q), "result": _rows(df)}]
    if isinstance(q, Q.TimeBoundaryQuery):
        if df.empty:
            return []
        rec = _rows(df)[0]
        ts = rec.get("minTime", rec.get("maxTime"))
        return [{"timestamp": ts, "result": rec}]
    if isinstance(q, Q.DataSourceMetadataQuery):
        if df.empty:
            return []
        rec = _rows(df)[0]
        return [{"timestamp": rec["maxIngestedEventTime"], "result": rec}]
    if isinstance(q, Q.SegmentMetadataQuery):
        return _rows(df)
    return _rows(df)
