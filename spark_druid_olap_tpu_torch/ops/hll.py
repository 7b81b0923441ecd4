"""HyperLogLog: per-group register arrays, max-merge everywhere.

Druid's `hyperUnique` / `cardinality` aggregators, which the planner emits
for approx_count_distinct.  Each segment builds per-group HLL registers;
the engine merges them by register max.  Each row is hashed (uint32, in
int64), the low p bits pick the bucket, rho = leading zeros of the high
window + 1, and the registers take one `scatter_reduce_("amax")` over the
combined (group, bucket) index.  Max does not depend on the order of the
rows, so the registers are the same bits on every device and every run.
State: int32[G, 2^p], as in the reference package.

`_rho` must give the reference's value for every hash, and the reference
takes floor(log2 w) through XLA's float32 `log2`, which is off by one at
some w near powers of two (`_LOG2_EXCEPTIONS`).  `torch.log2` is off at
other w, and differently on each device, so the port computes the exact
floor(log2(float32(w))) from the float's exponent bits and then applies the
reference's exceptions.

Estimation (host-side, classic Flajolet HLL on 32-bit hashes): alpha_m * m²
/ sum(2^-M_j), with linear counting below 2.5m and the 32-bit large-range
correction.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..models import aggregations as A
from ..plan.expr import DeviceConst
from ..utils.hashing import combine_hashes, hash_column

# w (the hash's high window) where the reference's floor(log2(float32(w)))
# differs from the exact one: (first w, last w, the reference's value).
# Every such w below 2^28, found by running the reference's `_rho` over all
# of them (tests/test_torch_sketches.py regenerates the runs it can reach
# from the reference and compares).  Precision p >= 4 keeps w < 2^28.
_LOG2_EXCEPTIONS = (
    (8192, 8192, 12),
    (32768, 32768, 14),
    (2097151, 2097151, 21),
    (4194303, 4194303, 22),
    (8388601, 8388607, 23),
    (16777201, 16777215, 24),
    (33554418, 33554430, 25),
    (67108862, 67108868, 25),
    (134217724, 134217800, 26),
    (268435209, 268435447, 28),
)
MIN_PRECISION = 4


def _exception_table():
    w = np.concatenate([np.arange(a, b + 1) for a, b, _ in _LOG2_EXCEPTIONS])
    lg = np.concatenate([np.full(b - a + 1, v) for a, b, v in _LOG2_EXCEPTIONS])
    return DeviceConst(w.astype(np.int64)), DeviceConst(lg.astype(np.int32))


_EXC_W, _EXC_LG = _exception_table()


def _floor_log2(w: torch.Tensor) -> torch.Tensor:
    """The reference's floor(log2(float32(max(w, 1)))) for w in [0, 2^28)."""
    f = torch.clamp(w, min=1).to(torch.float32)
    lg = (f.view(torch.int32) >> 23) - 127  # the float's unbiased exponent
    keys, vals = _EXC_W.on(w.device), _EXC_LG.on(w.device)
    i = torch.clamp(torch.searchsorted(keys, w), max=keys.numel() - 1)
    return torch.where(keys[i] == w, vals[i], lg)


def _rho(h: torch.Tensor, p: int) -> torch.Tensor:
    """rho = #leading zeros of the (32-p)-bit window (h >> p) + 1, in
    [1, 33-p], as the reference computes it (0 at w = 2^(32-p) - 1 for
    p = 11, where its float32 log2 rounds up to 32 - p)."""
    if p < MIN_PRECISION:
        raise ValueError(f"HLL precision {p} < {MIN_PRECISION}: no rho table")
    w = h >> p
    nbits = 32 - p
    rho = nbits - _floor_log2(w)
    return torch.where(w == 0, torch.full_like(rho, nbits + 1), rho)


def partial_hll(
    agg,
    cols: Mapping[str, torch.Tensor],
    gid: torch.Tensor,
    mask: torch.Tensor,
    num_groups: int,
) -> torch.Tensor:
    """Partial HLL state int32[num_groups, 2^p] for one row shard."""
    p = agg.precision
    if isinstance(agg, A.CardinalityAgg):
        hs = [hash_column(cols[f], seed=0) for f in agg.field_names]
        if not agg.by_row and len(hs) > 1:
            # non-byRow multi-field: distinct over the union of values —
            # each field folds into the same registers
            out = _fold_registers(hs[0], gid, mask, num_groups, p)
            for hh in hs[1:]:
                out = torch.maximum(out, _fold_registers(hh, gid, mask, num_groups, p))
            return out
        h = combine_hashes(hs) if agg.by_row else hs[0]
    else:
        h = hash_column(cols[agg.field_name], seed=0)
    return _fold_registers(h, gid, mask, num_groups, p)


def _fold_registers(h, gid, mask, num_groups, p):
    m = 1 << p
    bucket = h & (m - 1)
    in_range = (gid >= 0) & (gid < num_groups)
    # a row the mask drops scatters rho 0 into its own group's register, a
    # no-op under max over zeros: no trash slot for every masked row to pile
    # onto, and no compaction, which would sync the host.  Only a group id
    # out of range falls back to group 0.
    rho = torch.where(mask & in_range, _rho(h, p), 0)
    idx = torch.where(in_range, gid.to(torch.int64), 0) * m + bucket
    regs = torch.zeros(num_groups * m, dtype=torch.int32, device=h.device)
    regs.scatter_reduce_(0, idx, rho, "amax")
    return regs.reshape(num_groups, m)


def empty_state(agg, G: int, device) -> torch.Tensor:
    return torch.zeros((G, 1 << agg.precision), dtype=torch.int32, device=device)


def merge_states(a: torch.Tensor, b: torch.Tensor, agg) -> torch.Tensor:
    """Union of two register arrays: the register max."""
    return torch.maximum(a, b)


# the interface every sketch ops module gives `exec/lowering.sketch_ops`
partial = partial_hll


def finalize(agg, state: np.ndarray) -> np.ndarray:
    """The result column: each group's estimate, rounded."""
    return np.rint(estimate(state)).astype(np.int64)


def to_reference_state(state: torch.Tensor) -> np.ndarray:
    """The reference's layout of a state: int32 registers, on the host."""
    return state.cpu().numpy().astype(np.int32, copy=False)


def from_reference_state(state: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.array(state, dtype=np.int32)).to(device)


def estimate(registers: np.ndarray) -> np.ndarray:
    """HLL cardinality estimate per group.  registers: int[..., m]."""
    regs = np.asarray(registers, dtype=np.float64)
    m = regs.shape[-1]
    if m >= 128:
        alpha = 0.7213 / (1 + 1.079 / m)
    elif m == 64:
        alpha = 0.709
    elif m == 32:
        alpha = 0.697
    else:
        alpha = 0.673
    est = alpha * m * m / np.sum(np.exp2(-regs), axis=-1)
    zeros = np.sum(regs == 0, axis=-1)
    # small-range: linear counting
    with np.errstate(divide="ignore"):
        lc = m * np.log(np.where(zeros > 0, m / np.maximum(zeros, 1), 1.0))
    est = np.where((est <= 2.5 * m) & (zeros > 0), lc, est)
    # large-range correction for 32-bit hash space
    two32 = 2.0**32
    est = np.where(
        est > two32 / 30.0, -two32 * np.log1p(-est / two32), est
    )
    return est
