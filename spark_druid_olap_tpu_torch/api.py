"""User-facing surface: register tables, run SQL, explain rewrites.

    from spark_druid_olap_tpu_torch.api import TPUOlapContext
    ctx = TPUOlapContext()                 # CUDA; device="cpu" runs on the host
    ctx.register_table("lineitem", cols, dimensions=[...], metrics=[...],
                       time_column="l_shipdate", star_schema=...)
    df  = ctx.sql("SELECT l_returnflag, sum(l_quantity) FROM lineitem "
                  "GROUP BY l_returnflag")
    print(ctx.explain("SELECT ..."))      # EXPLAIN DRUID REWRITE analog

A SQL string goes through the lexer and parser (`sql/`) to a logical plan,
through the planner (`plan/`: star-join elimination, interval extraction,
aggregate mapping, TopN/Timeseries routing) to a Druid query spec, through
`exec.engine.Engine` on the device, and through host post-processing here
(FD restores, host post-expressions, residual HAVING, output projection).

CUBE, ROLLUP and GROUPING SETS run one engine pass per set
(`execute_grouping_sets`); approximate distinct counts and APPROX_QUANTILE
run as sketch aggregators on the device.

What this package does not execute yet raises rather than being answered
another way: a statement the planner cannot rewrite (a subquery, an
unconforming join) raises `RewriteError`; exact COUNT(DISTINCT) and
non-aggregate scans raise NotImplementedError naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from .catalog.cache import MetadataCache
from .catalog.segment import DataSource, build_datasource
from .catalog.star import StarSchemaInfo
from .config import SessionConfig
from .exec.engine import Engine
from .exec.finalize import apply_limit_spec
from .models import query as Q
from .plan import expr as E
from .plan.planner import Planner, Rewrite, RewriteError
from .sql.parser import parse_sql
from .utils.lru import CountBudgetCache

__all__ = ["TPUOlapContext", "RewriteError"]


class TPUOlapContext:
    """A session: catalog, views, session flags, plan cache and one engine.

    Like `Engine`, it runs on CUDA unless the caller passes a device
    (`device="cpu"` runs on the host); with no device given and no GPU
    present the constructor raises."""

    def __init__(self, config: Optional[SessionConfig] = None, device=None):
        self.config = config or SessionConfig()
        self.catalog = MetadataCache()
        self.engine = Engine(device=device)
        # SQL text -> Rewrite: a repeated dashboard query pays
        # parse + plan once.  Keyed on the catalog version, views and config,
        # so any re-registration or session-flag change invalidates.
        self._plan_cache = CountBudgetCache(256)
        # CREATE VIEW registry: view name -> defining SELECT text; the parser
        # expands references as derived tables
        self.views: Dict[str, str] = {}

    # -- registration (CREATE TABLE ... USING ... OPTIONS analog) -----------

    def register_table(
        self,
        name: str,
        source,
        dimensions: Sequence[str] = (),
        metrics: Sequence[str] = (),
        time_column: Optional[str] = None,
        star_schema: Optional[StarSchemaInfo] = None,
        column_mapping: Optional[Mapping[str, str]] = None,
        rows_per_segment: int = 1 << 22,
        dicts: Optional[Mapping] = None,
        sort_by: Sequence[str] = (),
    ) -> DataSource:
        """Register a datasource from a pandas DataFrame, a dict of numpy
        columns, or a parquet/csv path (catalog/ingest.py).  `dicts` supplies
        pre-built dimension dictionaries for already-encoded columns.

        `sort_by` orders rows by the named columns before segmenting (the
        Druid secondary-partitioning analog): filters on those columns then
        prune whole segments via zone maps instead of masking rows."""
        from .catalog.ingest import to_columns

        cols = to_columns(source)
        if column_mapping:
            cols = {column_mapping.get(k, k): v for k, v in cols.items()}
        if time_column and np.asarray(cols[time_column]).dtype.kind in "OUS":
            # a string time column (CSV): parse each distinct value once
            vals, inv = np.unique(np.asarray(cols[time_column]), return_inverse=True)
            ms = np.asarray(vals, dtype="datetime64[ms]").astype(np.int64)
            cols[time_column] = ms[inv]
        if not dimensions and not metrics:
            dimensions, metrics = _infer_schema(cols, time_column)
        if sort_by:
            missing = [c for c in sort_by if c not in cols]
            if missing:
                raise ValueError(f"sort_by names unknown columns {missing}")

            def sort_keys(c):
                # null-safe keys: nulls order last (the flag is the more
                # significant key, so it follows the value in the lexsort)
                a = np.asarray(cols[c])
                if a.dtype.kind == "O":
                    nulls = np.array([v is None for v in a])
                    vals = np.array([("" if v is None else str(v)) for v in a])
                    return [vals, nulls]
                if c in (dicts or {}) and a.dtype.kind in "iu":
                    # pre-encoded codes: null codes are negative
                    return [a, a < 0]
                return [a]

            # stable lexsort (last key primary); encoded dims sort by code,
            # which is value order (dictionaries are sorted)
            keys: list = []
            for c in reversed(sort_by):
                keys.extend(sort_keys(c))
            order = np.lexsort(tuple(keys))
            cols = {k: np.asarray(v)[order] for k, v in cols.items()}
        ds = build_datasource(
            name,
            cols,
            dimension_cols=list(dimensions),
            metric_cols=list(metrics),
            time_col=time_column,
            rows_per_segment=rows_per_segment,
            dicts=dicts,
        )
        return self.register_datasource(ds, star_schema)

    def register_datasource(self, ds: DataSource, star_schema=None):
        """Register an already-built DataSource under its own name."""
        if star_schema is not None and not isinstance(star_schema, StarSchemaInfo):
            star_schema = StarSchemaInfo.from_json(star_schema)
        return self.catalog.put(ds, star_schema)

    def drop_table(self, name: str):
        self.catalog.drop(name)

    def clear_cache(self):
        """Clear-metadata-cache command: drops the catalog, the device
        residency and the plan cache."""
        self.catalog.clear()
        self.engine.clear_cache()
        self._plan_cache.clear()

    @property
    def last_metrics(self):
        """QueryMetrics of the most recent engine execution."""
        return self.engine.last_metrics

    # -- planning ------------------------------------------------------------

    def _planner(self) -> Planner:
        return Planner(self.catalog, self.config)

    def plan_sql(self, sql_text: str) -> Rewrite:
        lp, _, _ = parse_sql(sql_text, views=self.views)
        return self._planner().plan(lp)

    def explain(self, sql_text: str) -> str:
        """EXPLAIN DRUID REWRITE analog: logical plan -> chosen query spec
        JSON -> the group-by strategy this context's engine resolves."""
        lp, _, _ = parse_sql(sql_text, views=self.views)
        return self._planner().explain(lp, self.engine.device)

    # -- execution -----------------------------------------------------------

    def _plan_cache_key(self, sql_text: str):
        return (
            sql_text,
            self.catalog.version,
            tuple(sorted(self.views.items())),  # view redefinition invalidates
            repr(self.config),
            1,  # device count
        )

    def plan_cached(self, sql_text: str) -> Rewrite:
        """The Rewrite for a SELECT, from the plan cache when the same text
        was planned against the same catalog, views and config."""
        key = self._plan_cache_key(sql_text)
        cached = self._plan_cache.get(key)
        if cached is not None:
            return cached
        rw = self.plan_sql(sql_text)
        self._plan_cache[key] = rw
        return rw

    def sql(self, sql_text: str):
        """Run one SQL statement and return a pandas DataFrame.  Commands
        (CREATE/DROP/SHOW/DESCRIBE/SET/CLEAR CACHE) dispatch first."""
        from .sql.commands import parse_command, run_command

        cmd = parse_command(sql_text)
        if cmd is not None:
            return run_command(self, cmd)
        key = self._plan_cache_key(sql_text)
        rw = self._plan_cache.get(key)
        if rw is None:
            lp, explain, _ = parse_sql(sql_text, views=self.views)
            planner = self._planner()
            if explain:
                import pandas as pd

                text = planner.explain(lp, self.engine.device)
                return pd.DataFrame({"plan": text.split("\n")})
            rw = planner.plan(lp)
            self._plan_cache[key] = rw
        return self.execute_rewrite(rw)

    def execute_rewrite(self, rw: Rewrite):
        ds = self.catalog.get(rw.datasource)
        if ds is None:
            raise RewriteError(f"unknown table {rw.datasource!r}")
        # the engine resolves its own group-by strategy from G: the CUDA
        # kernel at G <= SCATTER_CUTOVER on a card, scatter above
        if rw.grouping_sets and isinstance(rw.query, Q.GroupByQuery):
            df = execute_grouping_sets(rw.query, rw.grouping_sets, ds, self.engine)
        else:
            df = self.engine.execute(rw.query, ds)
        return self._post_process(rw, ds, df)

    def _post_process(self, rw: Rewrite, ds, df):
        """Host-side result shaping every engine answer passes through."""
        # FD grouping pruning: decode the hidden max-over-codes carriers
        # back into the pruned columns before residuals and projection
        for out_name, hidden, dim_col in rw.fd_restores:
            raw = np.asarray(df[hidden], dtype=np.float64)
            codes = np.where(np.isnan(raw), -1, raw).astype(np.int64)
            # decode the result rows only: DimensionDict.decode converts the
            # whole dictionary first (150K customer names at TPC-H SF1)
            values = ds.dicts[dim_col].values
            df[out_name] = np.array(
                [values[c] if c >= 0 else None for c in codes], dtype=object
            )
            df = df.drop(columns=[hidden])
        for name, e in rw.host_post_exprs:
            df[name] = _eval_host(e, df)
        if rw.residual_having is not None:
            mask = np.asarray(_eval_host(rw.residual_having, df), dtype=bool)
            df = df[mask].reset_index(drop=True)
        cols = [c for c in rw.output_columns if c in df.columns]
        if cols and "__grouping_id" in df.columns and "__grouping_id" not in cols:
            cols.append("__grouping_id")  # the grouping sets' GROUPING_ID
        if cols and cols != list(df.columns):  # a pandas selection copies
            df = df[cols]
        return df


def grouping_set_queries(q: Q.GroupByQuery, grouping_sets) -> List[Q.GroupByQuery]:
    """The GroupBy spec each grouping set runs: the set's dimensions, no
    subtotals, and no limit (it applies to the combined result)."""
    return [
        dataclasses.replace(
            q,
            dimensions=tuple(q.dimensions[i] for i in s),
            subtotals=(),
            limit_spec=None,
        )
        for s in grouping_sets
    ]


def execute_grouping_sets(q: Q.GroupByQuery, grouping_sets, ds, engine):
    """CUBE/ROLLUP/GROUPING SETS: one engine pass per set, absent
    dimensions emitted as nulls, plus a __grouping_id bitmask (SQL
    GROUPING_ID semantics: bit i set => dim i aggregated away).  The
    limit/order spec applies to the combined result, not per set: a per-set
    sort would fail on sets that drop the orderBy dimension."""
    import pandas as pd

    all_dims = q.dimensions
    k = len(all_dims)
    frames = []
    for s, sub in zip(grouping_sets, grouping_set_queries(q, grouping_sets)):
        f = engine.execute(sub, ds)
        gid = 0
        present = set(s)
        for i in range(k):
            if i not in present:
                gid |= 1 << (k - 1 - i)
                f[all_dims[i].name] = None
        f["__grouping_id"] = gid
        frames.append(f)
    df = pd.concat(frames, ignore_index=True)
    order = [d.name for d in all_dims]
    df = df[order + [c for c in df.columns if c not in order]]
    if q.limit_spec is not None:
        df = apply_limit_spec(df, q.limit_spec).reset_index(drop=True)
    return df


def _eval_host(e: E.Expr, df) -> np.ndarray:
    """Evaluate a residual expression over the result table on the host:
    tiny data, numpy semantics, decoded strings."""
    cols = {c: np.asarray(df[c]) for c in df.columns}
    return np.asarray(E.compile_host_expr(e)(cols))


def _infer_schema(cols, time_column):
    dims, mets = [], []
    for k, v in cols.items():
        if k == time_column:
            continue
        if np.asarray(v).dtype.kind in ("U", "S", "O"):
            dims.append(k)
        else:
            mets.append(k)
    return dims, mets
