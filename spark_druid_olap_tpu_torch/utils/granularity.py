"""Time granularity — bucket boundary computation (host-side).

Druid granularities ("second".."year", ISO periods) used by Timeseries
queries and time-bucketed GROUP BY dimensions.  Boundaries are computed on
host (tiny: one entry per bucket in the query interval) and shipped to
device as a sorted int64 array; rows are bucketed with one vectorized
`searchsorted`.  This handles calendar
granularities (month/quarter/year, variable length) exactly, where a fixed
period division cannot.
"""

from __future__ import annotations

import datetime
import re
from typing import Optional

import numpy as np

_FIXED_MS = {
    "second": 1_000,
    "minute": 60_000,
    "fifteen_minute": 15 * 60_000,
    "thirty_minute": 30 * 60_000,
    "hour": 3_600_000,
    "six_hour": 6 * 3_600_000,
    "day": 86_400_000,
    "week": 7 * 86_400_000,
}

_ISO = re.compile(r"^P(?:(\d+)Y)?(?:(\d+)M)?(?:(\d+)W)?(?:(\d+)D)?"
                  r"(?:T(?:(\d+)H)?(?:(\d+)M)?(?:(\d+)S)?)?$")


def granularity_period_ms(gran: str) -> Optional[int]:
    """Fixed period in ms, or None for calendar granularities (month/…)."""
    g = gran.lower()
    if g in _FIXED_MS:
        return _FIXED_MS[g]
    if g in ("month", "quarter", "year", "all"):
        return None
    m = _ISO.match(gran)
    if m:
        y, mo, w, d, h, mi, s = (int(x) if x else 0 for x in m.groups())
        if y or mo:
            return None  # calendar
        return ((w * 7 + d) * 86_400 + h * 3_600 + mi * 60 + s) * 1_000
    raise ValueError(f"unknown granularity {gran!r}")


def _iso_calendar_months(gran: str) -> int:
    g = gran.lower()
    if g == "month":
        return 1
    if g == "quarter":
        return 3
    if g == "year":
        return 12
    m = _ISO.match(gran)
    if m:
        y, mo = (int(x) if x else 0 for x in m.groups()[:2])
        return y * 12 + mo
    raise ValueError(gran)


def bucket_starts(lo_ms: int, hi_ms: int, gran: str) -> np.ndarray:
    """Sorted int64 bucket start times covering [lo_ms, hi_ms]."""
    if gran.lower() == "all":
        return np.array([lo_ms], dtype=np.int64)
    period = granularity_period_ms(gran)
    if period is not None:
        # Druid aligns weeks to Monday; epoch (1970-01-01) is a Thursday, and
        # the nearest Monday boundary is 1969-12-29 = epoch - 3d ≡ +4d (mod 7d).
        offset = 4 * 86_400_000 if period == 7 * 86_400_000 else 0
        first = ((lo_ms - offset) // period) * period + offset
        n = (hi_ms - first) // period + 1
        if n > (1 << 24):
            raise ValueError(
                f"granularity {gran} over interval produces {n} buckets"
            )
        return (first + period * np.arange(n, dtype=np.int64)).astype(np.int64)
    months = _iso_calendar_months(gran)
    lo = datetime.datetime.fromtimestamp(lo_ms / 1000.0, tz=datetime.timezone.utc)
    start_month = (lo.year * 12 + (lo.month - 1)) // months * months
    out = []
    m = start_month
    while True:
        y, mm = divmod(m, 12)
        t = datetime.datetime(y, mm + 1, 1, tzinfo=datetime.timezone.utc)
        ms = int(t.timestamp() * 1000)
        out.append(ms)
        if ms > hi_ms:
            break
        m += months
    return np.array(out[:-1] if out[-1] > hi_ms and len(out) > 1 else out,
                    dtype=np.int64)
