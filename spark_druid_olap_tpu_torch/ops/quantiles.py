"""Approximate quantiles: per-group bottom-K random-priority value samples
(the `quantilesDoublesSketch` / APPROX_QUANTILE analog).

Each row draws a pseudo-random priority (a hash of its padded row position
in its segment, `SEGMENT_POSITION` where the caller's rows span several
segments, mixed with the value's bits, independent of the value's
magnitude), and
each group keeps the K rows with the smallest priorities: a uniform sample
without replacement.  The bottom-K of a union is the union of bottom-Ks
re-trimmed to K, so per-segment partials merge like theta sketches
(concat + sort by priority + take K).  Rank error ~ O(sqrt(p(1-p)/K)):
K=1024 gives ~±1.5% rank error at the median.

Shape: one stable sort of the int64 key `g << 31 | priority` (priorities
are in [0, 2^31)), group starts from a searchsorted, and one gather of each
group's first K rows.  Equal priorities are distinct rows with different
values, and the reference's sorts are stable: the port sorts stably too, so
ties keep row order and the samples are the reference's bits.

State: int32[G, K+1, 2] packing (priority, value bits); rows [0, K) are the
sample, row K carries the exact per-group row count N in its first
component (counts add on merge).  When a group holds <= K rows the sample
is the whole group and the quantile is exact.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..utils.hashing import hash_column

# int32 priority domain [0, 2^31); empty slots carry the max value so they
# sort last and never displace a real sample row
SENTINEL_P = 0x7FFFFFFF
# the column of each row's position in its segment, where one call's rows
# are not one segment (a mesh's row shard): a row then draws the priority
# it draws in its segment's call, so the merged sample is the same bits
# however the rows shard
SEGMENT_POSITION = "__segpos"


def _bottom_k_pairs(
    prio: torch.Tensor,
    val: torch.Tensor,
    gid: torch.Tensor,
    mask: torch.Tensor,
    num_groups: int,
    k: int,
) -> torch.Tensor:
    """Keep the K (priority, value) pairs with smallest priority per group.

    Unlike theta's _bottom_k there is NO dedup: equal priorities are
    distinct rows and both belong in the sample."""
    ok = mask & (gid >= 0) & (gid < num_groups)
    g = torch.where(ok, gid.to(torch.int64), num_groups)  # masked rows to trash group
    p = torch.where(ok, prio, SENTINEL_P)
    s, order = torch.sort((g << 31) | p, stable=True)
    vbits = val.view(torch.int32)[order]
    groups = torch.arange(num_groups + 1, dtype=torch.int64, device=s.device)
    starts = torch.searchsorted(s >> 31, groups)
    idx = starts[:-1, None] + torch.arange(k, device=s.device)
    idx_c = torch.clamp(idx, max=s.numel() - 1)
    ps = s[idx_c] & SENTINEL_P
    keep = (idx < starts[1:, None]) & (ps != SENTINEL_P)
    sample = torch.stack(
        [
            torch.where(keep, ps, SENTINEL_P).to(torch.int32),
            torch.where(keep, vbits[idx_c], 0),
        ],
        dim=-1,
    )
    # true per-group row count from the group boundaries (trash rows sort
    # past starts[G], so they never contribute)
    counts = (starts[1:] - starts[:-1]).to(torch.int32)
    extra = torch.stack([counts, torch.zeros_like(counts)], dim=-1)[:, None, :]
    return torch.cat([sample, extra], dim=1)  # [G, K+1, 2]


def partial_quantiles(
    agg, cols: Mapping[str, torch.Tensor], gid, mask, num_groups: int
) -> torch.Tensor:
    """Per-group sample state int32[G, K+1, 2] for one segment (rows [0, K)
    sample, row K the exact N counter)."""
    val = cols[agg.field_name].to(torch.float32)
    # priority must be independent of the value's magnitude but distinct
    # across (position, value) pairs: identical positions recur in every
    # segment, so mixing in the value bits keeps repeated layouts from
    # sampling the same positions everywhere
    pos = cols.get(SEGMENT_POSITION)
    if pos is None:
        pos = torch.arange(val.shape[0], dtype=torch.int32, device=val.device)
    h = hash_column(pos, seed=11) ^ hash_column(val, seed=13)
    return _bottom_k_pairs(h >> 1, val, gid, mask, num_groups, agg.size)


def empty_state(agg, G: int, device) -> torch.Tensor:
    # [G, K+1, 2]: K empty sample slots + the zero N-counter row
    st = torch.zeros((G, agg.size + 1, 2), dtype=torch.int32, device=device)
    st[:, : agg.size, 0] = SENTINEL_P
    return st


def merge_states(a: torch.Tensor, b: torch.Tensor, agg) -> torch.Tensor:
    """Union-merge two int32[G, K+1, 2] states: bottom-K by priority of the
    concatenated samples (exactly the global bottom-K, the KMV merge
    property), `a`'s rows first among equal priorities; the N counters in
    row K add."""
    k = agg.size
    cat = torch.cat([a[:, :k, :], b[:, :k, :]], dim=1)  # [G, 2K, 2]
    order = torch.sort(cat[..., 0], dim=1, stable=True).indices[:, :k]
    merged = torch.gather(cat, 1, order[..., None].expand(-1, -1, 2))
    return torch.cat([merged, a[:, k:, :] + b[:, k:, :]], dim=1)


def merge_many(states, agg) -> torch.Tensor:
    """`merge_states` folded left over a non-empty sequence of states."""
    acc = states[0]
    for s in states[1:]:
        acc = merge_states(acc, s, agg)
    return acc


# the interface every sketch ops module gives `exec/lowering.sketch_ops`
partial = partial_quantiles


def finalize(agg, state: np.ndarray) -> np.ndarray:
    """The result column: each group's N, as Druid finalizes a quantiles
    sketch (exact: the state's trailing counter row).  Quantile values come
    from the QuantileFromSketch post-aggregation over the raw state."""
    return count(state)


def to_reference_state(state: torch.Tensor) -> np.ndarray:
    """The reference's layout of a state: int32[G, K+1, 2], on the host."""
    return state.cpu().numpy().astype(np.int32, copy=False)


def from_reference_state(state: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.array(state, dtype=np.int32)).to(device)


def sample_values(state: np.ndarray) -> np.ndarray:
    """float64[..., K] sample values with empty slots as NaN (drops the
    trailing N-counter row)."""
    s = np.asarray(state)[..., :-1, :]
    valid = s[..., 0] != SENTINEL_P
    vals = s[..., 1].astype(np.int32).view(np.float32).astype(np.float64)
    return np.where(valid, vals, np.nan)


def estimate(state: np.ndarray, fraction: float) -> np.ndarray:
    """Per-group quantile estimate from the sample (NaN for empty groups).

    Linear interpolation over the sorted sample — matches numpy's default
    quantile definition, so parity tests compare directly at n <= K."""
    import warnings

    vals = sample_values(state)
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # all-NaN rows -> NaN quantile
        return np.nanquantile(vals, float(fraction), axis=-1)


def count(state: np.ndarray) -> np.ndarray:
    """TRUE rows aggregated per group (the sketch's N, exact — carried in
    the state's trailing counter row and summed across merges)."""
    s = np.asarray(state)
    return s[..., -1, 0].astype(np.int64)
