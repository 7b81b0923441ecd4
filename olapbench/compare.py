"""The comparison that decides `correct`: a served answer against the
reference's expected answer.

Every response body is parsed into rows (a Druid groupBy's events, a
timeseries' results, a topN's result list, or SQL's row objects).  Against
`Expected` the rows must have exactly the expected keys, in the query's
order, with counts equal and every value within a relative gap; the gap is
reported, not judged here: `Judgement` gathers the numbers that `run`
holds against their limits."""

from __future__ import annotations

import dataclasses
import json
import math
from typing import List

# ties at a TopN's cut: a candidate whose expected value lies within this
# share of the cut's value may stand in for another (a rank question, not
# a numeric one: the values are still compared)
TOP_CUT_SLACK = 1e-3


def response_rows(body: bytes) -> List[dict]:
    doc = json.loads(body)
    rows = []
    for item in doc:
        if "event" in item:  # groupBy
            rows.append(item["event"])
        elif isinstance(item.get("result"), list):  # topN
            rows.extend(item["result"])
        elif isinstance(item.get("result"), dict):  # timeseries
            rows.append({"timestamp": item["timestamp"], **item["result"]})
        else:  # SQL
            rows.append(item)
    return rows


@dataclasses.dataclass
class Judgement:
    """The numbers one run compares: answers whose keys, order or counts
    differ from the reference (`mismatched`), and the widest relative gap
    of a value (`max_rel_err`)."""

    mismatched: int = 0
    max_rel_err: float = 0.0
    compared: int = 0
    first_fault: str = ""

    def fault(self, what: str) -> None:
        self.mismatched += 1
        if not self.first_fault:
            self.first_fault = what

    def gap(self, got, want) -> None:
        if not isinstance(got, (int, float)) or isinstance(got, bool):
            self.max_rel_err = math.inf
            return
        scale = abs(want)
        err = abs(got - want) / scale if scale > 0 else abs(got - want)
        if not err <= self.max_rel_err:  # also takes a NaN
            self.max_rel_err = err if err == err else math.inf


def _sorted_by(rows, order) -> bool:
    for a, b in zip(rows, rows[1:]):
        for col, desc in order:
            if a[col] == b[col]:
                continue
            if (a[col] > b[col]) != desc:
                return False
            break
    return True


def judge(label: str, body: bytes, exp, j: Judgement) -> None:
    """Compare one served body with `exp` (an `Expected`), into `j`."""
    j.compared += 1
    try:
        rows = response_rows(body)
    except (ValueError, TypeError, KeyError, AttributeError) as e:
        j.fault(f"{label}: unreadable body ({type(e).__name__})")
        return
    want = {tuple(r[k] for k in exp.keys): r for r in exp.rows}
    try:
        got = {tuple(r[k] for k in exp.keys): r for r in rows}
    except KeyError as e:
        j.fault(f"{label}: a row lacks key column {e}")
        return
    if len(got) != len(rows):
        j.fault(f"{label}: a key appears twice")
        return
    if exp.top is not None:
        ranked = sorted(exp.rows, key=lambda r: r[exp.order[0][0]], reverse=exp.order[0][1])
        n = min(exp.top, len(ranked))
        if n:
            cut = abs(ranked[n - 1][exp.order[0][0]])
            sure = {tuple(r[k] for k in exp.keys) for r in ranked[:n]
                    if abs(r[exp.order[0][0]] - ranked[n - 1][exp.order[0][0]]) > TOP_CUT_SLACK * cut}
            maybe = {tuple(r[k] for k in exp.keys) for r in ranked
                     if abs(r[exp.order[0][0]] - ranked[n - 1][exp.order[0][0]]) <= TOP_CUT_SLACK * cut}
            if len(rows) != n or not sure <= set(got) or not set(got) <= sure | maybe:
                j.fault(f"{label}: top {n} keys differ")
                return
        want = {k: want[k] for k in got}
    elif set(got) != set(want):
        missing, extra = set(want) - set(got), set(got) - set(want)
        j.fault(f"{label}: keys differ ({len(missing)} missing, {len(extra)} extra, "
                f"e.g. {sorted(missing or extra, key=str)[:2]})")
        return
    if exp.order and not _sorted_by(rows, exp.order):
        j.fault(f"{label}: rows out of order")
        return
    for key, w in want.items():
        g = got[key]
        for col in exp.exact:
            if g.get(col) != w[col]:
                j.fault(f"{label}: {col} of {key} is {g.get(col)}, expected {w[col]}")
                return
        for col in exp.values:
            if col not in g:
                j.fault(f"{label}: no column {col}")
                return
            j.gap(g[col], w[col])
