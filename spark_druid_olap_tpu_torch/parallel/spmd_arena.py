"""The mesh's arena: one CUDA graph per device over a stacked block layout.

The reference stacks a datasource's segments into one `[B_pad, R]` array
per column, shards it over the row devices and folds each device's blocks
inside one traced program, the scope riding as data.  The port keeps the
layout and the fold, and captures each device's share as a CUDA graph
(`exec/arena.py`'s capture, on that device's stream):

* **The layout** (`plan_spmd_layout`, `stack_column`).  Canonical segment
  block ``b`` belongs to row device ``b % ndt`` at local step
  ``b // ndt``: device-major and cyclic, so a pruned scope spreads over
  every device.  Each device holds its blocks as one `[L, R]` stack per
  column; a runt tail block (an append's delta) is zero-padded with False
  validity.  The stacks are keyed by the full segment signature, never by
  a query's scope, so residency lasts across every query of a datasource
  version.  Over several processes a rank stacks only its own row
  devices' blocks (`DistributedEngine._owned_row_devices`): with one device
  a rank, block b lives on rank b % P, its `multihost.local_segments`.
* **Membership and window as data.**  A query's scope is the local-step
  window `[j_lo, j_lo + Lk)` covering its blocks and a membership flag per
  (block, member).  A device's program folds every block of the window
  whose flag is set (`fold_member`: a masked add, min and max, so a
  non-member block adds nothing).  The flags live in a device buffer that
  is filled before each run, so one program serves every scope with the
  same window; a graph binds addresses, so the window itself is part of
  the program's key (a window given as data would copy it).
* **Fold on the device, merge at the boundary.**  Each device folds its
  in-window blocks in canonical order with the segment loop's body
  (`exec.engine.shard_partials`), several members at once for a fused
  batch (`serve.fusion.shared_row_plan` shares their masks and group ids).
  A device with no member block keeps the identities (0, +inf, -inf), so
  the merge (`parallel/mesh.merge_tree`, flat or hierarchical) is exact for
  counts and extrema.
* **Deadline chunking.**  Under a finite deadline a scope runs one local
  step at a time (`step_body`): each step is one program per device, the
  fold of its partials and the coverage accounting run on the host side
  between steps, and the merge follows whatever was folded.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class SpmdArenaLayout:
    """The device-major cyclic stacking of one datasource's segments over
    `ndt` row devices.  Scope-independent: keyed on the full segment
    signature."""

    __slots__ = ("segs", "uids", "B", "R", "L", "B_pad", "ndt", "index")

    def __init__(self, segs, ndt: int):
        self.segs = list(segs)
        self.uids = tuple(s.uid for s in self.segs)
        self.B = len(self.segs)
        self.R = max((s.num_rows_padded for s in self.segs), default=0)
        self.ndt = ndt
        self.L = -(-max(self.B, 1) // ndt)
        self.B_pad = ndt * self.L
        # canonical segment index by uid (scope -> membership)
        self.index = {s.uid: i for i, s in enumerate(self.segs)}

    def pos(self, b: int) -> int:
        """Stacked position of canonical block `b`: device `b % ndt` holds
        it at local step `b // ndt`."""
        return (b % self.ndt) * self.L + b // self.ndt

    def block(self, r: int, j: int) -> Optional[int]:
        """The canonical block at row device `r`'s local step `j`, or None
        for a pad step."""
        b = j * self.ndt + r
        return b if b < self.B else None


def plan_spmd_layout(ds, ndt: int) -> Optional[SpmdArenaLayout]:
    """The layout of `ds` on `ndt` row devices, or None when the stacked
    layout does not apply: fewer than two segments, or padded row counts
    other than equal blocks plus at most one shorter last block (one large
    segment would inflate every block's pad)."""
    segs = list(ds.segments)
    if len(segs) < 2:
        return None
    shape0 = segs[0].num_rows_padded
    if any(s.num_rows_padded != shape0 for s in segs[:-1]):
        return None
    if segs[-1].num_rows_padded > shape0:
        return None
    return SpmdArenaLayout(segs, ndt)


def scope_window(layout: SpmdArenaLayout, canonical: Sequence[int]) -> Tuple[int, int]:
    """(j_lo, Lk): the local-step window covering the scope's canonical
    block range."""
    k0, k1 = min(canonical), max(canonical) + 1
    j_lo = k0 // layout.ndt
    j_hi = -(-k1 // layout.ndt)
    return j_lo, j_hi - j_lo


def membership_matrix(layout: SpmdArenaLayout, member_scopes) -> np.ndarray:
    """Permuted `[B_pad, n_members]` block-membership flags from each
    member's canonical in-scope indices; pad blocks stay False."""
    memb = np.zeros((layout.B_pad, len(member_scopes)), dtype=bool)
    for i, scope in enumerate(member_scopes):
        for b in scope:
            memb[layout.pos(b), i] = True
    return memb


def shard_membership(layout: SpmdArenaLayout, memb: np.ndarray, r: int, j_lo: int,
                     Lk: int) -> np.ndarray:
    """Row device `r`'s `[Lk, n]` slice of the membership over the window."""
    at = r * layout.L + j_lo
    return np.ascontiguousarray(memb[at:at + Lk])


def stack_column(layout: SpmdArenaLayout, name: Optional[str], r: int) -> np.ndarray:
    """Row device `r`'s `[L, R]` stack of one column (`name` None: the
    validity mask): its blocks at their local steps, zero (invalid) rows
    past a runt block and in pad steps."""
    seg0 = layout.segs[0]
    proto = np.asarray(seg0.valid if name is None else seg0.column(name))
    out = np.zeros((layout.L, layout.R), dtype=proto.dtype)
    for j in range(layout.L):
        b = layout.block(r, j)
        if b is None:
            continue
        s = layout.segs[b]
        arr = np.asarray(s.valid if name is None else s.column(name))
        out[j, : arr.shape[0]] = arr
    return out


def init_member(lowering, device) -> Tuple[torch.Tensor, ...]:
    """A member's fold carry: the identities, zero sums, +inf mins, -inf
    maxs (a device with no member block merges them unchanged)."""
    la, G = lowering.la, lowering.num_groups
    return (
        torch.zeros((G, len(la.sum_names)), dtype=torch.float32, device=device),
        torch.full((G, len(la.min_names)), float("inf"), dtype=torch.float32, device=device),
        torch.full((G, len(la.max_names)), -float("inf"), dtype=torch.float32, device=device),
    )


def fold_member(carry, part, flag: torch.Tensor):
    """`carry` folded with one block's partials where `flag` (a 0-d bool
    tensor on the device) is set: the segment loop's add, min and max, the
    carry first."""
    s, mn, mx = carry
    ps, pmn, pmx = part
    return (
        torch.where(flag, s + ps, s),
        torch.where(flag, torch.minimum(mn, pmn), mn),
        torch.where(flag, torch.maximum(mx, pmx), mx),
    )


def _block_cols(stacks: Dict[str, torch.Tensor], j: int, time_column: Optional[str]):
    cols = {n: t[j] for n, t in stacks.items() if n is not None}
    cols["__valid"] = stacks[None][j]
    if time_column and time_column in cols:
        cols["__time"] = cols[time_column]
    return cols


def _block_partials(lowerings, strategies, cols, share):
    from ..exec.engine import shard_partials

    memo: Dict = {}
    out = []
    for i, lw in enumerate(lowerings):
        s, mn, mx, _ = shard_partials(
            lw, cols, strategies[i],
            memo=memo if share is not None else None,
            share=share[i] if share is not None else None)
        out.append((s, mn, mx))
    return out


def shard_body(lowerings, strategies, stacks, steps: Sequence[Tuple[int, int]],
               memb_buf: torch.Tensor, time_column: Optional[str], share=None):
    """Row device's fold over its window: `steps` are (k, j) pairs, window
    offset and local step, of the steps that hold a block; `memb_buf` the
    `[Lk, n]` membership buffer.  Returns a callable giving, per member,
    (sums, mins, maxs), flattened."""
    device = memb_buf.device

    def body():
        carry = [init_member(lw, device) for lw in lowerings]
        for k, j in steps:  # canonical order within the device
            parts = _block_partials(lowerings, strategies,
                                    _block_cols(stacks, j, time_column), share)
            for i, part in enumerate(parts):
                carry[i] = fold_member(carry[i], part, memb_buf[k, i])
        return [t for c in carry for t in c]

    return body


def step_body(lowerings, strategies, stacks, j: int, time_column: Optional[str], share=None):
    """One local step's block partials per member, for deadline chunking:
    a callable giving (sums, mins, maxs) per member, flattened."""

    def body():
        parts = _block_partials(lowerings, strategies,
                                _block_cols(stacks, j, time_column), share)
        return [t for p in parts for t in p]

    return body
