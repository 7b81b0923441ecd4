"""Star-schema join collapse (JoinTransform analog) — see catalog/star.py.

Reference parity: `JoinTransform` (SURVEY.md §2 `[U]`): multi-way joins that
conform to the declared `StarSchema` are eliminated — the Druid index is
pre-joined/denormalized, so dimension-table columns map through to fact-table
dimensions, guarded by declared functional dependencies (SURVEY.md §7 hard
part #6: this is where silent wrong answers come from, so every elimination
is validated against the declared join graph before collapsing).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..config import SessionConfig
from . import logical as L
from .transforms import RewriteError


def collapse_star_join(node: L.Join, catalog, cfg: SessionConfig) -> L.LogicalPlan:
    """Collapse a Join subtree over a star schema into a single Scan of the
    fact datasource, remapping dimension-table columns.  Implemented in
    catalog/star.py's StarSchema.collapse — this wrapper resolves the schema
    from the catalog."""
    if not cfg.enable_join_collapse:
        raise RewriteError("join collapse disabled by config")
    from ..catalog.star import try_collapse_join

    result = try_collapse_join(node, catalog)
    if result is None:
        raise RewriteError(
            "join does not conform to any registered star schema "
            "(declare one in register_table(star_schema=...))"
        )
    return result
