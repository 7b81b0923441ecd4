"""The plain reference's machinery: joined columns of a block of fact rows,
grouped sums in float64, and the expected answer of one query.

Plain PyTorch.  It reads the normalized tables the benchmark drew, does its
own joins through the foreign keys, and imports nothing of the program."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

BLOCK_ROWS = 1 << 23  # fact rows a block: bounds the reference's device memory


@dataclasses.dataclass
class Expected:
    """The answer a query must give.  `rows` hold every key and value
    column; `keys` identify a row, `exact` are counts compared exactly,
    `values` compared relatively.  `order` lists (column, descending) the
    answer is sorted by; `top` keeps that many rows of that order (a TopN),
    so rows beyond it are candidates only."""

    rows: List[dict]
    keys: Tuple[str, ...]
    values: Tuple[str, ...]
    exact: Tuple[str, ...] = ()
    order: Tuple[Tuple[str, bool], ...] = ()
    top: Optional[int] = None


class Block:
    """Fact rows [lo, hi) with any attribute of the star joined on demand.

    `joins[attr] = (table, foreign key)` gathers a dimension attribute
    through the fact's key (every key is its dimension's row); `derived`
    computes a column from others.  Metrics are float64, or rounded through
    `metric_dtype` first (the control's lower precision)."""

    def __init__(self, star, fact: str, lo: int, hi: int, device, joins: Dict[str, tuple],
                 derived: Dict[str, Callable], metrics: Sequence[str], metric_dtype=None):
        self.star, self.fact, self.lo, self.hi = star, fact, lo, hi
        self.device, self.joins, self.derived = device, joins, derived
        self.metrics, self.metric_dtype = set(metrics), metric_dtype
        self._cols: Dict[str, torch.Tensor] = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self._cols:
            self._cols[name] = self._load(name)
        return self._cols[name]

    def _load(self, name):
        t = self.star.tables
        if name in self.derived:
            return self.derived[name](self)
        if name in self.joins:
            table, fk = self.joins[name]
            return t[table][name].to(self.device)[self[fk].long()]
        col = t[self.fact][name][self.lo:self.hi].to(self.device)
        if name in self.metrics:
            if self.metric_dtype is not None:
                col = col.to(self.metric_dtype)
            return col.to(torch.float64)
        return col

    def __len__(self):
        return self.hi - self.lo


def blocks(star, fact: str, device, joins, derived, metrics, metric_dtype=None):
    n = star.rows(fact)
    for lo in range(0, n, BLOCK_ROWS):
        yield Block(star, fact, lo, min(n, lo + BLOCK_ROWS), device, joins, derived,
                    metrics, metric_dtype)


def grouped(star, fact, device, joins, derived, metrics, metric_dtype,
            mask_fn, keys: Sequence[Tuple[str, int]], sums: Dict[str, Callable]):
    """Sums of `sums[name](block)` over the rows `mask_fn(block)` keeps,
    grouped by `keys` [(column, domain size)] of integer ids; the count of
    rows under "__count".  Returns {key tuple: {name: float, "__count": int}}
    for the groups that hold a row."""
    dom = 1
    for _, size in keys:
        dom *= int(size)
    acc = {name: torch.zeros(dom, dtype=torch.float64, device=device) for name in sums}
    cnt = torch.zeros(dom, dtype=torch.int64, device=device)
    for b in blocks(star, fact, device, joins, derived, metrics, metric_dtype):
        m = mask_fn(b)
        gid = torch.zeros(len(b), dtype=torch.int64, device=device)
        for col, size in keys:
            gid = gid * int(size) + b[col].long()
        gid = gid[m]
        cnt.index_add_(0, gid, torch.ones_like(gid))
        for name, fn in sums.items():
            acc[name].index_add_(0, gid, fn(b)[m])
    present = torch.nonzero(cnt).flatten()
    sizes = [int(s) for _, s in keys]
    out = {}
    vals = {name: a[present].tolist() for name, a in acc.items()}
    counts = cnt[present].tolist()
    for i, g in enumerate(present.tolist()):
        key = []
        for s in reversed(sizes):
            key.append(g % s)
            g //= s
        out[tuple(reversed(key))] = {**{n: v[i] for n, v in vals.items()}, "__count": counts[i]}
    return out
