"""What a generator returns, and the encoding both generators share."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch


@dataclasses.dataclass
class Star:
    """A normalized schema: `tables[table][column]` are 1-D tensors, and a
    string attribute is held as ids into `names[column]`."""

    tables: Dict[str, Dict[str, torch.Tensor]]
    names: Dict[str, List[str]]

    def to(self, device) -> "Star":
        return Star({t: {c: v.to(device) for c, v in cols.items()}
                     for t, cols in self.tables.items()}, self.names)

    def rows(self, table: str) -> int:
        return int(next(iter(self.tables[table].values())).shape[0])


def narrow(codes: torch.Tensor, cardinality: int) -> torch.Tensor:
    """Codes in the smallest signed type holding [-1, cardinality)."""
    if cardinality <= 127:
        return codes.to(torch.int8)
    if cardinality <= 32767:
        return codes.to(torch.int16)
    return codes.to(torch.int32)


def attr_dict(ids: torch.Tensor, names: Optional[List[str]]):
    """The port's dictionary of one attribute and the code of each of its
    rows: the sorted distinct values present (strings through `names`, or
    the numbers themselves), and each row's rank among them."""
    from spark_druid_olap_tpu_torch.catalog.segment import DimensionDict

    present = torch.unique(ids)
    if names is None:
        codes = torch.searchsorted(present, ids)
        return DimensionDict(values=tuple(int(v) for v in present.tolist())), codes
    ids_present = present.tolist()
    order = sorted(range(len(ids_present)), key=lambda i: names[ids_present[i]])
    rank = torch.full((len(names),), -1, dtype=torch.int64)
    rank[present.cpu()[torch.tensor(order, dtype=torch.int64)]] = torch.arange(len(order))
    values = tuple(names[ids_present[i]] for i in order)
    return DimensionDict(values=values), rank.to(ids.device)[ids.long()]
