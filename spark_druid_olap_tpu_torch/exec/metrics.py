"""Per-query execution metrics, filled by `exec/engine.py` on every execution
and kept on `Engine.last_metrics`.

Phase semantics (wall clock, single process):
  * `h2d_ms` / `h2d_bytes` — host->device column transfers this query caused
    (zero on residency-cache hits).
  * `device_ms` — the segment loop up to the synchronising fetch of the
    merged [G, M] state.
  * `finalize_ms` — host-side result materialization.
  * `total_ms` — the whole execution.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class QueryMetrics:
    query_type: str = ""
    strategy: str = ""
    datasource: str = ""
    device: str = ""
    rows_scanned: int = 0
    # bytes of segment data the query reads (needed columns x rows, incl.
    # validity): the numerator of a scan-bandwidth roofline
    bytes_scanned: int = 0
    segments: int = 0
    num_groups: int = 0
    h2d_bytes: int = 0
    h2d_ms: float = 0.0
    device_ms: float = 0.0
    finalize_ms: float = 0.0
    total_ms: float = 0.0
    bytes_resident: int = 0

    @property
    def rows_per_sec(self) -> float:
        if self.total_ms <= 0:
            return 0.0
        return self.rows_scanned / (self.total_ms / 1e3)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["rows_per_sec"] = self.rows_per_sec
        return d

    def describe(self) -> str:
        return (
            f"QueryMetrics[{self.query_type} strategy={self.strategy} "
            f"device={self.device} rows={self.rows_scanned} "
            f"segments={self.segments} groups={self.num_groups} "
            f"total={self.total_ms:.2f}ms (h2d={self.h2d_ms:.2f}ms/"
            f"{self.h2d_bytes}B device={self.device_ms:.2f}ms "
            f"finalize={self.finalize_ms:.2f}ms) "
            f"rows/s={self.rows_per_sec:,.0f} resident={self.bytes_resident}B]"
        )
