"""Sort-compaction group-by for high-cardinality group domains.

A group-by whose combined domain G is far above SCATTER_CUTOVER often has
few groups actually present (SSB q3.x: c_city x s_city x d_year is 504K
cells, a few hundred populated under the filter).  This tier compacts the
present group ids into `slots` state rows and aggregates over the slots:

    gid in [0, G)  --stable sort, run marks-->  slot in [0, slots)
                   --group-by over slots-->     [slots + 1, M] partials
                   + gids[slots + 1] mapping slot -> gid (-1 = empty)

Up to SPARSE_SLOTS the aggregation over slots is the hand-written CUDA
group-by kernel (`ops/cuda_groupby.py`; on the CPU its plain version);
above it the rows, already sorted by slot, are reduced per run
(`segmented_reduce_sorted`).  States keep the reference's layout and merge
segment by segment (`merge_sparse_states`), and every result has a fixed
size: no step asks the device how many rows or groups it found, so a
query's segment loop never waits on the card.  Flags ride the state:
`overflow` (more present groups than slots: the engine climbs
SLOTS_LADDER), `row_overflow` (more surviving rows than the row capacity of
`compact_rows`: it climbs ROW_CAPACITY_LADDER), and the exact counts
`n_rows` and `n_real` that pick the next rung.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .groupby import partial_aggregate

SPARSE_SLOTS = 4096

# Slot rungs: up to SPARSE_SLOTS the kernel aggregates over the slots; the
# higher rungs reduce sorted runs.  Past the top rung the engine runs the
# scatter path.
SLOTS_LADDER = (SPARSE_SLOTS, 1 << 15, 1 << 18, 1 << 21)

# Row capacity of the filter compaction when nothing better is known: a
# selective query packs its surviving rows into this many before the sort.
ROW_CAPACITY = 1 << 17

# Row-capacity rungs.  The engine picks the first from the filter's
# estimated selectivity (x2 headroom); on overflow, the smallest rung that
# holds the exact survivor count (`n_rows`), or a full-segment sort past the
# top.
ROW_CAPACITY_LADDER = (1 << 12, 1 << 14, 1 << 17, 1 << 18, 1 << 19, 1 << 20, 1 << 21)

_INF = float("inf")


def compact_rows(
    gid: torch.Tensor,
    mask: torch.Tensor,
    sum_values: torch.Tensor,
    minmax_values: torch.Tensor,
    minmax_masks: torch.Tensor,
    capacity: int,
):
    """Pack the rows the mask keeps into `capacity` rows, in row order: one
    cumsum, one searchsorted and gathers.  Row i of the result is the i-th
    kept row; rows past the kept count repeat a row with the mask cleared.
    Returns (*packed arrays, row_overflow, n): `row_overflow` is set when
    more than `capacity` rows survive (the packed state then lacks rows),
    and `n` is the exact survivor count."""
    R = gid.shape[0]
    dev = gid.device
    c = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    n = c[-1]
    row_overflow = n > capacity
    want = torch.arange(1, capacity + 1, dtype=torch.int32, device=dev)
    idx = torch.searchsorted(c, want, side="left").clamp_(max=R - 1)
    new_mask = torch.arange(capacity, dtype=torch.int32, device=dev) < n
    return (
        gid[idx],
        new_mask,
        sum_values[idx],
        minmax_values[idx],
        minmax_masks[idx],
        row_overflow,
        n,
    )


def segmented_reduce_sorted(
    slot: torch.Tensor,  # int32[R], nondecreasing run index per sorted row
    mask: torch.Tensor,  # bool[R]
    sum_values: torch.Tensor,  # f32[R, Ms]
    minmax_values: torch.Tensor,  # f32[R, Mn+Mx]
    minmax_masks: torch.Tensor,  # bool[R, Mn+Mx]
    capacity: int,
    num_min: int,
    num_max: int,
    n_rows: Optional[torch.Tensor] = None,
):
    """Per-run sums, mins and maxs over rows already sorted by run: the
    aggregation above SPARSE_SLOTS.  Run boundaries come from a searchsorted
    of the run index, and `torch.segment_reduce` reduces each run in row
    order, so the result is the same on every run.  Masked rows add nothing.
    With `n_rows`, rows from that position on are not read (the masked
    rows' run, which sorts last, would otherwise be walked row by row).

    Returns (sums[capacity, Ms], mins[capacity, Mn], maxs[capacity, Mx]),
    0 / +inf / -inf for an empty run.  The caller keeps slot < capacity."""
    dev = slot.device
    bounds = torch.searchsorted(
        slot, torch.arange(capacity + 1, dtype=slot.dtype, device=dev)
    )
    if n_rows is not None:
        bounds = torch.minimum(bounds, n_rows.to(bounds.dtype))
    lengths = bounds[1:] - bounds[:-1]
    m = mask[:, None]

    def reduce(values, how, initial):
        if values.shape[1] == 0:
            return torch.full((capacity, 0), initial, dtype=torch.float32, device=dev)
        return torch.segment_reduce(
            values, how, lengths=lengths, axis=0, unsafe=True, initial=initial
        )

    sums = reduce(torch.where(m, sum_values, 0.0), "sum", 0.0)
    v = minmax_values[:, :num_min]
    mins = reduce(torch.where(m & minmax_masks[:, :num_min], v, _INF), "min", _INF)
    v = minmax_values[:, num_min:num_min + num_max]
    maxs = reduce(
        torch.where(m & minmax_masks[:, num_min:num_min + num_max], v, -_INF), "max", -_INF
    )
    return sums, mins, maxs


def _runs(sorted_ids: torch.Tensor, n_out: int):
    """Run marks of sorted ids: (rank per row, first position of each of the
    first `n_out` runs; len(sorted_ids) where there are fewer runs).  The
    fixed-size counterpart of `nonzero(firsts, size=n_out)`."""
    n = sorted_ids.shape[0]
    firsts = torch.ones(n, dtype=torch.bool, device=sorted_ids.device)
    firsts[1:] = sorted_ids[1:] != sorted_ids[:-1]
    ranks = torch.cumsum(firsts, 0, dtype=torch.int32) - 1
    pos = torch.searchsorted(
        ranks, torch.arange(n_out, dtype=torch.int32, device=sorted_ids.device)
    )
    return ranks, pos


def sparse_partial_aggregate(
    gid: torch.Tensor,
    mask: torch.Tensor,
    sum_values: torch.Tensor,
    minmax_values: torch.Tensor,
    minmax_masks: torch.Tensor,
    *,
    num_groups: int,
    num_min: int,
    num_max: int,
    slots: int = SPARSE_SLOTS,
    inner_strategy: str = "cuda",
    row_capacity: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Compact the group ids to slots and aggregate over the slots.

    With `row_capacity`, the surviving rows are first packed by
    `compact_rows`, so the sort covers `row_capacity` rows, not the segment.
    Masked rows take the trash value G, which sorts last, so they never
    take a real group's slot; `slots` real groups fit exactly.  Up to
    SPARSE_SLOTS slots the kernel (`inner_strategy` "cuda", or its plain
    version "dense" on the CPU) aggregates over the sorted rows; a masked
    row's slot is clamped into range, where its cleared mask keeps it out
    of every aggregate, and the state's last row is the identity.  Above
    SPARSE_SLOTS, `segmented_reduce_sorted`.

    Returns {"gids": int32[slots + 1] (-1 = empty), "sums": f32[slots + 1, Ms],
    "mins", "maxs", "overflow": bool[], "row_overflow": bool[],
    "n_rows": int32[] exact survivor count, "n_real": int32[] present
    groups}, all on the input's device."""
    G = num_groups
    gid = gid.to(torch.int32)
    dev = gid.device
    row_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    if row_capacity is not None and row_capacity < gid.shape[0]:
        (gid, mask, sum_values, minmax_values, minmax_masks,
         row_overflow, n_rows) = compact_rows(
            gid, mask, sum_values, minmax_values, minmax_masks, row_capacity)
    else:
        n_rows = mask.sum(dtype=torch.int32)
    R = gid.shape[0]
    n_state = slots + 1
    g = torch.where(mask, gid, torch.full_like(gid, G))
    order = torch.argsort(g, stable=True)  # rows of a group keep row order
    sg = g[order]
    ranks, pos = _runs(sg, n_state)
    n_real = ranks[-1] + 1 - (sg[-1] == G).to(torch.int32)
    overflow = n_real > slots
    uniq = torch.where(pos < R, sg[pos.clamp(max=R - 1)], torch.full_like(pos, G, dtype=torch.int32))
    m_s, sv_s = mask[order], sum_values[order]
    mmv_s, mmm_s = minmax_values[order], minmax_masks[order]
    if slots > SPARSE_SLOTS:
        sums, mins, maxs = segmented_reduce_sorted(
            ranks.clamp(max=n_state - 1), m_s, sv_s, mmv_s, mmm_s,
            capacity=n_state, num_min=num_min, num_max=num_max, n_rows=n_rows,
        )
    else:
        sums, mins, maxs = partial_aggregate(
            ranks.clamp(max=slots - 1), m_s, sv_s, mmv_s, mmm_s,
            num_groups=slots, num_min=num_min, num_max=num_max,
            strategy=inner_strategy,
        )
        Ms = sums.shape[1]
        sums = torch.cat([sums, sums.new_zeros((1, Ms))])
        mins = torch.cat([mins, mins.new_full((1, num_min), _INF)])
        maxs = torch.cat([maxs, maxs.new_full((1, num_max), -_INF)])
    return {
        "gids": torch.where(uniq >= G, torch.full_like(uniq, -1), uniq),
        "sums": sums,
        "mins": mins,
        "maxs": maxs,
        "overflow": overflow,
        "row_overflow": row_overflow,
        "n_rows": n_rows,
        "n_real": n_real,
    }


def merge_sparse_states(
    a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor], num_groups: int
) -> Dict[str, torch.Tensor]:
    """Merge two sparse states of the same slot count into one.

    The gids of both sort together (stable, `a` first); each run of the
    first slots + 1 becomes a slot of the result.  A gid appears at most
    once in each state, so a real run holds one row of `a`, one of `b`, or
    one of each, and the merged sums are `a + b`: float32 addition of two
    values does not depend on their order, so the result is the same on
    every run without a deterministic mode.  Empty slots hold the
    identities (0, +inf, -inf).  `overflow` is set when the merged state has
    more distinct gids than slots; then `n_real` is max(a, b), a lower bound
    (the engine climbs one rung at a time), else the exact count.  `n_rows`
    is the max: the row capacity must hold the largest single segment."""
    n_state = a["gids"].shape[0]
    G = num_groups
    cg = torch.cat([a["gids"], b["gids"]])
    cg = torch.where(cg < 0, torch.full_like(cg, G), cg)
    N = cg.shape[0]
    order = torch.argsort(cg, stable=True)
    sg = cg[order]
    ranks, pos = _runs(sg, n_state)
    has = pos < N
    p0 = pos.clamp(max=N - 1)
    p1 = (p0 + 1).clamp(max=N - 1)
    dup = has & (p0 + 1 < N) & (sg[p1] == sg[p0])
    i0, i1 = order[p0], order[p1]
    uniq = torch.where(has, sg[p0], torch.full_like(sg[p0], G))
    overflow = a["overflow"] | b["overflow"] | (ranks[-1] + 1 > n_state)

    def fold(key, op, identity):
        v = torch.cat([a[key], b[key]])
        x0 = v[i0]
        x = torch.where(dup[:, None], op(x0, v[i1]), x0)
        return torch.where(has[:, None], x, torch.full_like(x, identity))

    exact = (uniq < G).sum(dtype=torch.int32)
    return {
        "gids": torch.where(uniq >= G, torch.full_like(uniq, -1), uniq),
        "sums": fold("sums", torch.add, 0.0),
        "mins": fold("mins", torch.minimum, _INF),
        "maxs": fold("maxs", torch.maximum, -_INF),
        "overflow": overflow,
        "row_overflow": a["row_overflow"] | b["row_overflow"],
        "n_rows": torch.maximum(a["n_rows"], b["n_rows"]),
        "n_real": torch.where(overflow, torch.maximum(a["n_real"], b["n_real"]), exact),
    }
