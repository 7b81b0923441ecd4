"""Theta (KMV) sketches: bottom-K hash sets per group, union-merge.

Druid's DataSketches `thetaSketch` aggregator, the other approx-distinct
the planner can push down.  Per-segment partial sketches union in the
engine's canonical segment order.

Shape: no per-row hash-table scatter.  A segment's rows are (group, hash)
pairs packed into one int64 key `g << 32 | h` (hashes are uint32 carried in
int64, see utils/hashing.py); one sort groups them and orders the hashes
within each group.  Duplicates and masked rows move to a trash group past
the last one and a second sort packs each group's distinct hashes
together, so group g's first K hashes are read with one gather from its
start.  Keys are unique or equal, so the sorted values, and the state, are
the same bits on every device.

State: uint32[G, K] in the reference package, int64[G, K] here, ascending,
padded with SENTINEL (0xFFFFFFFF).  Estimate: count < K ⇒ exact
distinct-hash count; else (K-1) / (kth / 2^32).  32-bit hash space ⇒
~n²/2³³ collision under-count (~1% at n=10⁸).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..utils.hashing import MASK32, hash_column

SENTINEL = 0xFFFFFFFF


def _bottom_k(h: torch.Tensor, gid: torch.Tensor, mask: torch.Tensor,
              num_groups: int, k: int) -> torch.Tensor:
    ok = mask & (gid >= 0) & (gid < num_groups)
    trash = (num_groups << 32) | SENTINEL
    key = torch.where(ok, (gid.to(torch.int64) << 32) | h, trash)
    s = torch.sort(key).values
    # collapse duplicate (group, hash) pairs and drop empty hashes
    drop = (s & MASK32) == SENTINEL
    drop[1:] |= s[1:] == s[:-1]
    s = torch.sort(torch.where(drop, trash, s)).values
    groups = torch.arange(num_groups + 1, dtype=torch.int64, device=s.device)
    starts = torch.searchsorted(s >> 32, groups)
    idx = starts[:-1, None] + torch.arange(k, device=s.device)
    keep = idx < starts[1:, None]
    hs = s[torch.clamp(idx, max=s.numel() - 1)] & MASK32
    return torch.where(keep, hs, SENTINEL)


def partial_theta(
    agg, cols: Mapping[str, torch.Tensor], gid, mask, num_groups: int
) -> torch.Tensor:
    h = hash_column(cols[agg.field_name], seed=7)
    return _bottom_k(h, gid, mask, num_groups, agg.size)


def empty_state(agg, G: int, device) -> torch.Tensor:
    return torch.full((G, agg.size), SENTINEL, dtype=torch.int64, device=device)


def merge_states(a: torch.Tensor, b: torch.Tensor, agg) -> torch.Tensor:
    """KMV union: concat, sort, dedupe, keep bottom-K. a, b: [G, K]."""
    s = torch.sort(torch.cat([a, b], dim=1), dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    s = torch.sort(torch.where(dup, SENTINEL, s), dim=1).values
    return s[:, : agg.size]


def merge_many(states, agg) -> torch.Tensor:
    """`merge_states` folded left over a non-empty sequence of states."""
    acc = states[0]
    for s in states[1:]:
        acc = merge_states(acc, s, agg)
    return acc


# the interface every sketch ops module gives `exec/lowering.sketch_ops`
partial = partial_theta


def finalize(agg, state: np.ndarray) -> np.ndarray:
    """The result column: each group's estimate, rounded."""
    return np.rint(estimate(state)).astype(np.int64)


def to_reference_state(state: torch.Tensor) -> np.ndarray:
    """The reference's layout of a state: uint32 hashes, on the host."""
    return state.cpu().numpy().astype(np.uint32)


def from_reference_state(state: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.asarray(state, dtype=np.uint32).astype(np.int64)).to(device)


def estimate(state: np.ndarray) -> np.ndarray:
    """Distinct estimate per group from uint32[..., K] KMV state."""
    s = np.asarray(state)
    k = s.shape[-1]
    valid = s != np.uint32(0xFFFFFFFF)
    count = valid.sum(axis=-1)
    kth = s[..., -1].astype(np.float64)  # largest kept hash
    frac = (kth + 1.0) / 2.0**32
    full = count >= k
    with np.errstate(divide="ignore", invalid="ignore"):
        est = np.where(full, (k - 1) / np.maximum(frac, 1e-12), count)
    return est


def set_op_estimate(fn: str, states) -> np.ndarray:
    """Estimate |A ∪ B|, |A ∩ B|, or |A \\ B...| per group from KMV states.

    Standard KMV set semantics: clip every sketch to the smallest common
    threshold theta (the inclusion probability both samples share), apply the
    set operation on the retained hash samples, scale by 1/theta.  Host-side
    numpy over result rows (G is result-sized here, not kernel-sized)."""
    states = [np.asarray(s) for s in states]
    if len(states) == 0:
        raise ValueError("set_op_estimate needs at least one state")
    sent = np.uint32(0xFFFFFFFF)

    def theta_of(s):
        k = s.shape[-1]
        count = (s != sent).sum(axis=-1)
        kth = s[..., -1].astype(np.float64)
        return np.where(count >= k, (kth + 1.0) / 2.0**32, 1.0)

    th = np.minimum.reduce([theta_of(s) for s in states])
    G = states[0].shape[0]
    out = np.zeros(G, dtype=np.float64)
    for g in range(G):
        limit = th[g] * 2.0**32
        sets = [
            {int(h) for h in s[g] if h != sent and h < limit} for s in states
        ]
        if fn == "UNION":
            acc = set.union(*sets)
        elif fn == "INTERSECT":
            acc = set.intersection(*sets)
        elif fn == "NOT":
            acc = sets[0].difference(*sets[1:])
        else:
            raise ValueError(f"theta set op {fn!r}")
        out[g] = len(acc) / max(th[g], 1e-12)
    return out
