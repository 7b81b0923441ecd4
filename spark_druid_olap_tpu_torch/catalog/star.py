"""Star-schema metadata + join-elimination (the soundness-critical part).

Reference parity: `StarSchema` / `StarSchemaInfo` / `FunctionalDependency`
(SURVEY.md §2 star-schema row `[U]`, expected
`org/sparklinedata/druid/metadata/StarSchema.scala`): the user *declares* the
fact/dimension join graph and functional dependencies in the table options;
`JoinTransform` eliminates dimension-table joins because the Druid index is
pre-joined (denormalized), mapping dim-table columns through to fact
dimensions.  Identically here: the TPU datasource is the denormalized flat
table; a query written against the normalized star (joins and all) collapses
to a Scan of the fact datasource when — and only when — every join edge
matches a declared relation (equality keys and n:1 cardinality), which is
what makes the elimination sound (SURVEY.md §7 hard part #6).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from ..plan import logical as L


@dataclasses.dataclass(frozen=True)
class FunctionalDependency:
    """determinant -> dependent within one table (e.g. c_city -> c_nation).
    Declares that grouping by `dependent` alongside `determinant` cannot
    change cardinality — used to validate collapses and (later) prune
    redundant grouping columns."""

    table: str
    determinant: str
    dependent: str

    def to_json(self):
        return {
            "table": self.table,
            "determinant": self.determinant,
            "dependent": self.dependent,
        }


@dataclasses.dataclass(frozen=True)
class StarRelationInfo:
    """One n:1 edge of the star: fact (or parent dim) joins to `table`.

    `non_null` declares the FK never null AND referentially intact (every
    parent row matches exactly one dim row) — the condition under which a
    LEFT join equals the INNER join and its elimination is sound."""

    table: str
    join_keys: Tuple[Tuple[str, str], ...]  # (parent-side col, dim-side col)
    parent: Optional[str] = None  # None => the fact table (snowflake support)
    cardinality: str = "n-1"  # n-1 | 1-1; n:1 keeps fact row multiplicity
    non_null: bool = False  # FK non-null + referential integrity declared

    def to_json(self):
        return {
            "table": self.table,
            "joinKeys": [list(k) for k in self.join_keys],
            "parent": self.parent,
            "cardinality": self.cardinality,
            "nonNull": self.non_null,
        }


@dataclasses.dataclass(frozen=True)
class StarSchemaInfo:
    """The declared star: fact table + relations + functional dependencies
    (the JSON `starSchema` option of the reference's DDL)."""

    fact_table: str
    relations: Tuple[StarRelationInfo, ...] = ()
    functional_dependencies: Tuple[FunctionalDependency, ...] = ()

    def relation_for(self, dim_table: str) -> Optional[StarRelationInfo]:
        for r in self.relations:
            if r.table == dim_table:
                return r
        return None

    def to_json(self) -> str:
        return json.dumps(
            {
                "factTable": self.fact_table,
                "relations": [r.to_json() for r in self.relations],
                "functionalDependencies": [
                    f.to_json() for f in self.functional_dependencies
                ],
            },
            indent=2,
        )

    @staticmethod
    def from_json(s) -> "StarSchemaInfo":
        d = json.loads(s) if isinstance(s, str) else s
        return StarSchemaInfo(
            fact_table=d["factTable"],
            relations=tuple(
                StarRelationInfo(
                    r["table"],
                    tuple((a, b) for a, b in r["joinKeys"]),
                    r.get("parent"),
                    r.get("cardinality", "n-1"),
                    r.get("nonNull", False),
                )
                for r in d.get("relations", ())
            ),
            functional_dependencies=tuple(
                FunctionalDependency(
                    f["table"], f["determinant"], f["dependent"]
                )
                for f in d.get("functionalDependencies", ())
            ),
        )


def _unqualify(name: str) -> Tuple[Optional[str], str]:
    if "." in name:
        t, c = name.split(".", 1)
        return t, c
    return None, name


def try_collapse_join(node: L.Join, catalog) -> Optional[L.LogicalPlan]:
    """Validate a Join subtree against registered star schemas; on success
    return the collapsed Scan(fact).

    Sound iff every join edge matches a declared n:1 relation on exactly the
    declared equality keys, hangs off its DECLARED parent (snowflake chains
    are validated against the actual tree shape, not just key names), and —
    for LEFT joins — the relation is declared `non_null` (or 1-1), since a
    left join only equals the inner join when no fact row dangles
    (SURVEY.md §7 hard part #6; VERDICT r1 weak #6)."""
    # flatten the left-deep join tree; each edge records the tables already
    # joined beneath it so parent chains can be checked against tree shape
    edges: List[Tuple[Tuple[str, ...], Tuple[Tuple[str, str], ...], str, str]] = []

    def walk(n) -> Optional[List[str]]:
        if isinstance(n, L.Scan):
            return [n.table]
        if isinstance(n, L.Join):
            if n.how not in ("inner", "left"):
                return None
            left_tables = walk(n.left)
            if left_tables is None or not isinstance(n.right, L.Scan):
                return None
            dim = n.right.table
            keys = []
            for lk, rk in zip(n.left_keys, n.right_keys):
                lt, lc = _unqualify(lk)
                rt, rc = _unqualify(rk)
                # orient: dim-side key is the one qualified by `dim`
                if rt == dim or (rt is None and lt is not None):
                    keys.append((lc, rc))
                elif lt == dim:
                    keys.append((rc, lc))
                else:
                    keys.append((lc, rc))
            edges.append((tuple(left_tables), tuple(keys), dim, n.how))
            return left_tables + [dim]
        return None

    all_tables = walk(node)
    if all_tables is None:
        return None

    # find the fact: the table with a registered star schema covering all dims
    for fact in all_tables:
        star = catalog.star_schema(fact) if hasattr(catalog, "star_schema") else None
        if star is None or star.fact_table != fact:
            continue
        ok = True
        for tables_before, keys, dim, how in edges:
            if dim == fact:
                ok = False  # the fact joined as a dim side: not a star shape
                break
            rel = star.relation_for(dim)
            if rel is None:
                ok = False
                break
            declared = {frozenset(k) for k in rel.join_keys}
            actual = {frozenset(k) for k in keys}
            if declared != actual:
                ok = False
                break
            if rel.cardinality not in ("n-1", "1-1"):
                ok = False
                break
            if how == "left" and not (
                rel.non_null or rel.cardinality == "1-1"
            ):
                ok = False  # dangling fact rows would differ from inner join
                break
            # snowflake parent validation: the declared parent must already
            # be in the joined subtree; for dim-parent edges the parent table
            # must also own the parent-side key columns.  (Fact-direct edges
            # skip the ownership check: the denormalized fact legitimately
            # drops FK columns after flattening — the declared relation is
            # the authority there.)
            expected_parent = rel.parent or fact
            if expected_parent not in tables_before:
                ok = False
                break
            if rel.parent is not None:
                pds = (
                    catalog.get(expected_parent)
                    if hasattr(catalog, "get")
                    else None
                )
                if pds is not None:
                    parent_cols = {c.name for c in pds.columns}
                    if not all(pk in parent_cols for pk, _ in keys):
                        ok = False
                        break
        if ok:
            return L.Scan(fact)
    return None
