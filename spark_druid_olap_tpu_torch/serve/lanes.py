"""Priority lanes: admission classification for the serving core.

The admission pool alone is first come, first served, which is the
problem at dashboard scale: eight slots all held by large scans leave a
5 ms TopN waiting out the queue timeout behind them.  Lanes split
admission into separate slot pools (`ResilienceState.lanes`):

  * **interactive** — TopN / timeseries / metadata queries and small
    groupBys: the dashboard traffic whose p95 the serving core exists
    to protect.
  * **heavy** — scans, searches, and groupBys whose in-scope row count
    exceeds `SessionConfig.lane_heavy_rows`: work that holds a slot for
    seconds and must not occupy interactive capacity.

Classification reads only metadata (the query type and the row count of
the segments left after interval and zone-map pruning); it never touches
the card.  Each
lane carries its own queue depth, observed-load Retry-After, and
`sdol_lane_*` metrics; the server rejects per lane with 503 naming the
lane so clients can tell "the cluster is full" from "my scan class is
full".
"""

from __future__ import annotations

from ..models import query as Q

LANE_INTERACTIVE = "interactive"
LANE_HEAVY = "heavy"

LANES = (LANE_INTERACTIVE, LANE_HEAVY)

# query types answered from catalog metadata: never heavy
_METADATA_TYPES = (
    Q.TimeBoundaryQuery,
    Q.DataSourceMetadataQuery,
    Q.SegmentMetadataQuery,
)


def _rows_in_scope(q, ds) -> int:
    """Rows the query would scan after interval/zone-map pruning — the
    same metadata-only scoping the engine performs before dispatch."""
    from ..exec.engine import segments_in_scope

    try:
        return sum(s.num_rows for s in segments_in_scope(q, ds))
    except Exception:  # lane routing must never fail a query
        return ds.num_rows if ds is not None else 0


def classify_native(q, ds, config) -> str:
    """Lane of one decoded native QuerySpec.  TopN/timeseries/search and
    metadata queries are interactive by type (the dashboard shapes);
    scans and groupBys go heavy past the configured row threshold."""
    if isinstance(q, _METADATA_TYPES):
        return LANE_INTERACTIVE
    if isinstance(q, (Q.TopNQuery, Q.TimeseriesQuery)):
        return LANE_INTERACTIVE
    threshold = int(getattr(config, "lane_heavy_rows", 4 << 20))
    if threshold <= 0:
        return LANE_INTERACTIVE
    if isinstance(q, (Q.ScanQuery, Q.SearchQuery, Q.GroupByQuery)):
        if ds is not None and _rows_in_scope(q, ds) > threshold:
            return LANE_HEAVY
    return LANE_INTERACTIVE


def classify_rewrite(rw, catalog, config) -> str:
    """Lane of a planned SQL rewrite — the same policy as
    `classify_native`, applied to the rewrite's device query.  Exact-
    distinct shapes classify by their inner rewrite (that is what
    scans)."""
    if rw.exact_distinct is not None:
        return classify_rewrite(rw.exact_distinct.inner, catalog, config)
    ds = catalog.get(rw.datasource)
    return classify_native(rw.query, ds, config)
