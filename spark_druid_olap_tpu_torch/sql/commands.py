"""Non-SELECT SQL commands: registration DDL, catalog listing, session flags.

    CREATE [TEMPORARY] TABLE t USING <fmt> OPTIONS (path '...', timeColumn
        'ts', dimensions 'a,b', metrics 'x', starSchema '<json>',
        columnMapping '<json>', rowsPerSegment '4194304')
    CREATE TABLE t USING tpu_olap OPTIONS (path '<saved directory>')
    CREATE TABLE t AS SELECT ...
    DROP TABLE [IF EXISTS] t
    SHOW TABLES
    DESCRIBE t | SHOW COLUMNS FROM t
    SET key = value        -- SessionConfig flags (SQLConf analog)
    SET                    -- show all flags
    CLEAR CACHE

Dispatched by `TPUOlapContext.sql` before the SELECT parser runs.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, Optional

_CLEAR = re.compile(r"^\s*clear\s+cache\s*;?\s*$", re.IGNORECASE)
_DROP = re.compile(
    r"^\s*drop\s+table\s+(?P<ife>if\s+exists\s+)?(?P<name>[A-Za-z_]\w*)\s*;?\s*$",
    re.IGNORECASE,
)
_SHOW = re.compile(r"^\s*show\s+tables\s*;?\s*$", re.IGNORECASE)
_DESC = re.compile(
    r"^\s*(describe|desc)\s+(?P<name>[A-Za-z_]\w*)\s*;?\s*$", re.IGNORECASE
)
_SHOWCOLS = re.compile(
    r"^\s*show\s+columns\s+from\s+(?P<name>[A-Za-z_]\w*)\s*;?\s*$",
    re.IGNORECASE,
)
_SET = re.compile(
    r"^\s*set\s+(?P<key>[A-Za-z_]\w*)\s*=\s*(?P<val>.+?)\s*;?\s*$",
    re.IGNORECASE,
)
_SET_SHOW = re.compile(r"^\s*set\s*;?\s*$", re.IGNORECASE)
_CREATE = re.compile(
    r"^\s*create\s+(temporary\s+)?table\s+(?P<name>[A-Za-z_]\w*)\s+"
    r"using\s+(?P<fmt>[\w.]+)\s+options\s*\((?P<opts>.*)\)\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)
# one OPTIONS entry: key 'value' or key "value"
_CTAS = re.compile(
    r"^\s*create\s+(temporary\s+)?table\s+(?P<name>[A-Za-z_]\w*)\s+as\s+"
    r"(?P<sel>select\b.*)$",
    re.IGNORECASE | re.DOTALL,
)
_CREATE_VIEW = re.compile(
    r"^\s*create\s+(?:or\s+replace\s+)?(?:temporary\s+)?view\s+"
    r"(?P<name>[A-Za-z_]\w*)\s+as\s+(?P<sel>select\b.*)$",
    re.IGNORECASE | re.DOTALL,
)
_DROP_VIEW = re.compile(
    r"^\s*drop\s+view\s+(?P<ife>if\s+exists\s+)?(?P<name>[A-Za-z_]\w*)"
    r"\s*;?\s*$",
    re.IGNORECASE,
)
_OPT_ENTRY = re.compile(
    r"^\s*([A-Za-z_]\w*)\s+(?:'((?:[^']|'')*)'|\"([^\"]*)\")\s*$"
)


def _split_options(text: str):
    """Split an OPTIONS(...) body on commas outside quotes; every chunk must
    match `key 'value'` — malformed entries are rejected, never dropped."""
    chunks, buf, q = [], [], None
    for ch in text:
        if q:
            buf.append(ch)
            if ch == q:
                q = None
        elif ch in ("'", '"'):
            q = ch
            buf.append(ch)
        elif ch == ",":
            chunks.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if buf and "".join(buf).strip():
        chunks.append("".join(buf))
    out = {}
    for c in chunks:
        m = _OPT_ENTRY.match(c)
        if not m:
            raise ValueError(
                f"malformed OPTIONS entry {c.strip()!r}: expected key 'value'"
            )
        k, a, b = m.group(1), m.group(2), m.group(3)
        out[k] = (a if a is not None else b).replace("''", "'")
    return out


@dataclasses.dataclass(frozen=True)
class Command:
    kind: str
    table: Optional[str] = None
    if_exists: bool = False
    key: Optional[str] = None
    value: Optional[str] = None
    options: Optional[Dict[str, str]] = None
    fmt: Optional[str] = None


def parse_command(sql: str) -> Optional[Command]:
    if _CLEAR.match(sql):
        return Command("clear_cache")
    m = _DROP.match(sql)
    if m:
        return Command(
            "drop_table", table=m.group("name"), if_exists=bool(m.group("ife"))
        )
    if _SHOW.match(sql):
        return Command("show_tables")
    m = _DESC.match(sql) or _SHOWCOLS.match(sql)
    if m:
        return Command("describe", table=m.group("name"))
    if _SET_SHOW.match(sql):
        return Command("set_show")
    m = _SET.match(sql)
    if m:
        return Command("set", key=m.group("key"), value=m.group("val"))
    m = _CREATE.match(sql)
    if m:
        opts = _split_options(m.group("opts"))
        return Command(
            "create_table",
            table=m.group("name"),
            options=opts,
            fmt=m.group("fmt").lower(),
        )
    m = _CTAS.match(sql)
    if m:
        return Command("ctas", table=m.group("name"), value=m.group("sel"))
    m = _CREATE_VIEW.match(sql)
    if m:
        return Command(
            "create_view", table=m.group("name"), value=m.group("sel")
        )
    m = _DROP_VIEW.match(sql)
    if m:
        return Command(
            "drop_view", table=m.group("name"), if_exists=bool(m.group("ife"))
        )
    return None


def _coerce_flag(cfg, key: str, raw: str):
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    if key not in fields:
        raise KeyError(
            f"unknown session flag {key!r}; flags: {sorted(fields)}"
        )
    raw = raw.strip().strip("'\"")
    # coerce by the declared field type, not the current value: Optional
    # fields default to None, and `isinstance(None, int)` would fall through
    # to storing a raw string
    ann = str(fields[key].type)
    if raw.lower() in ("none", "null"):
        if "Optional" not in ann and "None" not in ann:
            raise ValueError(
                f"session flag {key!r} ({ann}) does not accept none"
            )
        return None
    if "bool" in ann:
        return raw.lower() in ("1", "true", "yes", "on")
    if "int" in ann:
        return int(raw)
    if "float" in ann:
        return float(raw)
    return raw


def run_command(ctx, cmd: Command):
    import pandas as pd

    if cmd.kind == "clear_cache":
        ctx.clear_cache()
        return pd.DataFrame({"status": ["cache cleared"]})
    if cmd.kind == "drop_table":
        if ctx.catalog.get(cmd.table) is None and not cmd.if_exists:
            raise KeyError(f"table {cmd.table!r} does not exist")
        ctx.drop_table(cmd.table)
        return pd.DataFrame({"status": [f"dropped {cmd.table}"]})
    if cmd.kind == "show_tables":
        tables = sorted(ctx.catalog.tables())
        views = sorted(ctx.views)
        return pd.DataFrame(
            {
                "table": tables + views,
                "kind": ["table"] * len(tables) + ["view"] * len(views),
            }
        )
    if cmd.kind == "describe":
        ds = ctx.catalog.get(cmd.table)
        if ds is None and cmd.table in ctx.views:
            return pd.DataFrame(
                {"view": [cmd.table], "definition": [ctx.views[cmd.table]]}
            )
        if ds is None:
            raise KeyError(f"table {cmd.table!r} does not exist")
        return pd.DataFrame(
            {
                "column": [c.name for c in ds.columns],
                "kind": [c.kind for c in ds.columns],
                "dtype": [c.dtype for c in ds.columns],
                "cardinality": [c.cardinality for c in ds.columns],
            }
        )
    if cmd.kind == "set_show":
        items = sorted(dataclasses.asdict(ctx.config).items())
        return pd.DataFrame(
            {"key": [k for k, _ in items], "value": [str(v) for _, v in items]}
        )
    if cmd.kind == "set":
        val = _coerce_flag(ctx.config, cmd.key, cmd.value)
        setattr(ctx.config, cmd.key, val)
        ctx.apply_config()
        return pd.DataFrame({"status": [f"set {cmd.key}={val}"]})
    if cmd.kind == "create_table":
        if cmd.fmt not in ("csv", "parquet", "tpu_olap"):
            raise ValueError(
                f"CREATE TABLE USING {cmd.fmt!r}: supported providers are "
                "'csv', 'parquet', 'tpu_olap'"
            )
        opts = dict(cmd.options or {})
        path = opts.pop("path", None)
        if path is None:
            raise ValueError("CREATE TABLE ... OPTIONS requires path '...'")
        if cmd.fmt in ("csv", "parquet") and not path.lower().endswith(
            "." + cmd.fmt
        ):
            raise ValueError(
                f"USING {cmd.fmt} but path {path!r} has a different "
                "extension (use USING tpu_olap to ingest by extension)"
            )
        import os

        if cmd.fmt == "tpu_olap" and os.path.isdir(path):
            # a saved-datasource directory (catalog/persist.py, either
            # package's): the encoded segments load as they are, no ingest
            if opts:
                raise ValueError(
                    "saved-datasource load takes no options besides path; "
                    f"got {sorted(opts)}"
                )
            ds = ctx.load_table(path, name=cmd.table)
            return pd.DataFrame(
                {"status": [f"loaded {cmd.table} ({ds.num_rows} rows)"]}
            )
        kwargs = {}
        if "timeColumn" in opts:
            kwargs["time_column"] = opts.pop("timeColumn")
        if "dimensions" in opts:
            kwargs["dimensions"] = [
                s.strip() for s in opts.pop("dimensions").split(",") if s.strip()
            ]
        if "metrics" in opts:
            kwargs["metrics"] = [
                s.strip() for s in opts.pop("metrics").split(",") if s.strip()
            ]
        if "starSchema" in opts:
            kwargs["star_schema"] = json.loads(opts.pop("starSchema"))
        if "columnMapping" in opts:
            kwargs["column_mapping"] = json.loads(opts.pop("columnMapping"))
        if "rowsPerSegment" in opts:
            kwargs["rows_per_segment"] = int(opts.pop("rowsPerSegment"))
        if "sortBy" in opts:
            # secondary partitioning: rows sorted by these columns before
            # segmenting, so zone maps prune filtered segments
            kwargs["sort_by"] = [
                s.strip() for s in opts.pop("sortBy").split(",") if s.strip()
            ]
        if opts:
            raise ValueError(f"unknown CREATE TABLE options: {sorted(opts)}")
        ds = ctx.register_table(cmd.table, path, **kwargs)
        return pd.DataFrame(
            {"status": [f"created {cmd.table} ({ds.num_rows} rows)"]}
        )
    if cmd.kind == "ctas":
        # CREATE TABLE name AS SELECT ...: materialize the result as a new
        # datasource (the local analog of a Druid ingestion rollup);
        # dimensions/metrics are inferred from the result dtypes
        if ctx.catalog.get(cmd.table) is not None:
            raise ValueError(f"table {cmd.table!r} already exists")
        if cmd.table in ctx.views:
            raise ValueError(
                f"a view named {cmd.table!r} exists; it would shadow the "
                "new table (DROP VIEW first)"
            )
        df = ctx.sql(cmd.value)
        ds = ctx.register_table(cmd.table, df)
        return pd.DataFrame(
            {"status": [f"created {cmd.table} ({ds.num_rows} rows)"]}
        )
    if cmd.kind == "create_view":
        # the definition is PARSE-validated now (a syntactically broken
        # view fails at CREATE; name/type resolution happens per query,
        # so a view may legitimately precede its tables)
        if ctx.catalog.get(cmd.table) is not None:
            raise ValueError(
                f"a table named {cmd.table!r} exists; the view would "
                "shadow it (queries would silently read the view while "
                "DESCRIBE/DROP TABLE address the table)"
            )
        from .parser import parse_sql

        views = dict(ctx.views)
        views.pop(cmd.table, None)
        parse_sql(cmd.value, views=views)
        ctx.views[cmd.table] = cmd.value.strip()
        return pd.DataFrame({"status": [f"created view {cmd.table}"]})
    if cmd.kind == "drop_view":
        if cmd.table not in ctx.views:
            if cmd.if_exists:
                return pd.DataFrame(
                    {"status": [f"view {cmd.table} did not exist"]}
                )
            raise KeyError(f"view {cmd.table!r} does not exist")
        del ctx.views[cmd.table]
        return pd.DataFrame({"status": [f"dropped view {cmd.table}"]})
    raise ValueError(cmd.kind)
