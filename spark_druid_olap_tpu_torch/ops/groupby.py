"""Partial GroupBy aggregation: per-segment partial aggregate states.

This module is the per-segment historical of the engine: it computes the
partial aggregate states ([G, M] sums, mins, maxs) for one shard of rows;
`exec/engine.py` folds the shards' states in canonical segment order.

Strategies:

* **Dense** (G <= SCATTER_CUTOVER).  On a CUDA device this is the
  hand-written kernel in `ops/cuda_groupby.py`.  `dense_partial_aggregate`
  is its plain PyTorch twin: a one-hot block ``onehot[B, G] =
  (gid[:, None] == arange(G))`` contracted with the value block
  ``values[B, M]`` gives exact per-group sums; min/max use the same match
  matrix with a masked where + reduce.  The engine takes it on the CPU.
* **Scatter** (G > SCATTER_CUTOVER): `index_add_` and `scatter_reduce_`
  of the kept rows into a [G, M] state — memory-linear in G.  On CUDA,
  float `index_add_` accumulates with atomics in a run-dependent order, so
  the sums run under PyTorch's deterministic mode, scoped to the call (a
  sort-based accumulation with a fixed order).

Determinism: every strategy sums in an order fixed by the shapes alone, so
a given (segment, query) produces bit-identical float sums from run to run.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch

# Above this combined cardinality the group-by takes the scatter path.
SCATTER_CUTOVER = 4096

_INF = float("inf")


def combine_group_ids(
    codes: Sequence[torch.Tensor], cards: Sequence[int]
) -> Tuple[Optional[torch.Tensor], int]:
    """Row-major combine N dictionary-code columns into one dense group id.

    gid = ((c0 * card1) + c1) * card2 + c2 ...   Null codes (-1) are clamped
    into slot 0 and must be masked by the caller.  Returns (None, 1) when
    there are no columns (the caller broadcasts group 0).
    """
    G = 1
    for c in cards:
        G *= int(c)
    gid = None
    for code, card in zip(codes, cards):
        # width choke point: codes may be STORED at int8/int16
        # (catalog.segment.code_dtype); widen BEFORE multiplying — torch
        # int8 arithmetic wraps silently
        c = torch.clamp(code.to(torch.int32), min=0)
        gid = c if gid is None else gid * int(card) + c
    return gid, G


def choose_block_rows(num_rows: int, num_groups: int,
                      budget_bytes: int = 32 << 20) -> int:
    """Pick the block size so the one-hot block fits the byte budget.

    B*G*4 bytes <= budget, B a multiple of 1024 (ROW_PAD), clamped to
    [1024, num_rows]."""
    b = budget_bytes // max(4 * num_groups, 1)
    b = max(1024, (b // 1024) * 1024)
    return int(min(b, max(num_rows, 1024)))


def dense_partial_aggregate(
    gid: torch.Tensor,  # int32[R]
    mask: torch.Tensor,  # bool[R] — filter ∧ validity
    sum_values: torch.Tensor,  # f32[R, Ms] — pre-masked (0 if excluded)
    minmax_values: torch.Tensor,  # f32[R, Mn+Mx] — raw values
    minmax_masks: torch.Tensor,  # bool[R, Mn+Mx] — per-agg masks
    num_groups: int,
    block_rows: int,
    num_min: int,
    num_max: int,
):
    """One-hot-matmul partial aggregation over row blocks, folded in block
    order.

    Returns (sums[G, Ms], mins[G, Mn], maxs[G, Mx]).  `sum_values` columns
    are pre-masked by the caller, so the product with the bool one-hot is
    exact.  Empty groups: sums 0, mins +inf, maxs -inf (the finalizer maps
    them to null).  The product runs in full float32: TF32 is off for
    matmuls (`torch.backends.cuda.matmul.allow_tf32`, False by default, is
    asserted on the card by `ops/cuda_groupby.plain_partial_aggregate`)."""
    R = gid.shape[0]
    if R % block_rows:
        raise ValueError(f"row count {R} is not a multiple of {block_rows}")
    dev = gid.device
    Ms = sum_values.shape[1]
    iota = torch.arange(num_groups, dtype=torch.int32, device=dev)
    # inf fills are explicit float32: a float64 fill would promote the
    # min/max and break parity with the kernel
    sums = torch.zeros((num_groups, Ms), dtype=torch.float32, device=dev)
    mins = torch.full((num_groups, num_min), _INF, dtype=torch.float32, device=dev)
    maxs = torch.full((num_groups, num_max), -_INF, dtype=torch.float32, device=dev)
    pos = torch.tensor(_INF, dtype=torch.float32, device=dev)
    gid = gid.to(torch.int32)
    for lo in range(0, R, block_rows):
        hi = lo + block_rows
        m = mask[lo:hi]
        match = (gid[lo:hi, None] == iota[None, :]) & m[:, None]  # [B, G]
        sums = sums + match.to(torch.float32).T @ sum_values[lo:hi]
        if num_min:
            v = minmax_values[lo:hi, :num_min]
            mm = m[:, None] & minmax_masks[lo:hi, :num_min]
            w = torch.where(
                match[:, :, None] & mm[:, None, :], v[:, None, :], pos
            )
            mins = torch.minimum(mins, w.amin(dim=0))
        if num_max:
            v = minmax_values[lo:hi, num_min:]
            mm = m[:, None] & minmax_masks[lo:hi, num_min:]
            w = torch.where(
                match[:, :, None] & mm[:, None, :], v[:, None, :], -pos
            )
            maxs = torch.maximum(maxs, w.amax(dim=0))
    return sums, mins, maxs


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic mode for the duration of one call."""
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def scatter_partial_aggregate(
    gid: torch.Tensor,
    mask: torch.Tensor,
    sum_values: torch.Tensor,
    minmax_values: torch.Tensor,
    minmax_masks: torch.Tensor,
    num_groups: int,
    num_min: int = 0,
    num_max: int = 0,
):
    """Scatter strategy: memory-linear in G, for G above the dense cutover.

    Only the rows the mask keeps are scattered.  (Sending masked rows to a
    trash slot, as the reference does, piles every filtered-out row onto
    one index, and the deterministic CUDA accumulation walks duplicates of
    an index one after another.)"""
    dev = gid.device
    keep = mask.nonzero().squeeze(1)
    seg = gid[keep].to(torch.int64)
    Ms = sum_values.shape[1]
    sums = torch.zeros((num_groups, Ms), dtype=torch.float32, device=dev)
    with _deterministic():
        sums.index_add_(0, seg, sum_values[keep])
    # min/max do not depend on the accumulation order
    mins = torch.full((num_groups, num_min), _INF, dtype=torch.float32, device=dev)
    maxs = torch.full((num_groups, num_max), -_INF, dtype=torch.float32, device=dev)
    pos = torch.tensor(_INF, dtype=torch.float32, device=dev)
    Mn = num_min
    mmv, mmm = minmax_values[keep], minmax_masks[keep]
    if Mn:
        v = torch.where(mmm[:, :Mn], mmv[:, :Mn], pos)
        mins.scatter_reduce_(0, seg[:, None].expand(-1, Mn), v, "amin")
    if num_max:
        v = torch.where(mmm[:, Mn:], mmv[:, Mn:], -pos)
        maxs.scatter_reduce_(0, seg[:, None].expand(-1, num_max), v, "amax")
    return sums, mins, maxs


def resolve_strategy(strategy: str, num_groups: int, device) -> str:
    """Single source of truth for 'auto' strategy resolution: scatter above
    the cutover; at or below it the CUDA kernel on a CUDA device and the
    plain dense twin on the CPU."""
    if strategy != "auto":
        return strategy
    if num_groups > SCATTER_CUTOVER:
        return "segment"
    return "cuda" if torch.device(device).type == "cuda" else "dense"


def partial_aggregate(
    gid,
    mask,
    sum_values,
    minmax_values,
    minmax_masks,
    num_groups: int,
    num_min: int,
    num_max: int,
    strategy: str = "auto",
):
    """Strategy dispatcher (see `resolve_strategy`)."""
    gid = gid.to(torch.int32)
    strategy = resolve_strategy(strategy, num_groups, gid.device)
    if strategy == "cuda":
        from .cuda_groupby import cuda_partial_aggregate

        return cuda_partial_aggregate(
            gid, mask, sum_values, minmax_values, minmax_masks,
            num_groups=num_groups, num_min=num_min, num_max=num_max,
        )
    if strategy == "dense":
        R = gid.shape[0]
        br = choose_block_rows(R, num_groups)
        # shrink to divide R (segments are ROW_PAD-padded so 1024 always divides)
        while R % br:
            br -= 1024
        br = max(br, 1024)
        return dense_partial_aggregate(
            gid, mask, sum_values, minmax_values, minmax_masks,
            num_groups=num_groups, block_rows=br,
            num_min=num_min, num_max=num_max,
        )
    if strategy == "segment":
        return scatter_partial_aggregate(
            gid, mask, sum_values, minmax_values, minmax_masks,
            num_groups=num_groups, num_min=num_min, num_max=num_max,
        )
    raise ValueError(f"unknown groupby strategy {strategy!r}")
