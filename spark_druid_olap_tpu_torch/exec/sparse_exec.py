"""Sparse (sort-compaction) tier of the engine: the high-cardinality
group-by of `ops/sparse_groupby.py` over a query's segments, with its two
ladders.

* Row capacity: a selective query packs each segment's surviving rows into
  a rung of ROW_CAPACITY_LADDER before the sort.  The first rung comes from
  the filter's estimated selectivity; when a segment has more survivors,
  the exact count the state carries picks the smallest rung that holds
  them (a full-segment sort past the top), and the query runs again.
* Slots: SPARSE_SLOTS present groups fit the kernel's one pass over slots;
  when more are present, the count the state carries picks the next rung
  of SLOTS_LADDER (a segmented reduce over sorted runs), and the query runs
  again.  Past the top rung the tier declines, and the query is pinned to
  the scatter path.

The per-segment states merge on the device in canonical segment order, so
a query's sums are the same on every run, and the flags that decide the
ladders ride the merged state: one small fetch per pass decides it.  The
rungs a query needed are remembered (`lowering.memo_key`), so a repeat
starts on them.  Only these deterministic declines route a query to
another tier; an error raises.

Deadlines: a pass checkpoints between segments (`sparse.segment_loop`) and
every rung of the slots ladder before it runs (`sparse.slots_ladder`).  A
pass a deadline stopped under a partial collector answers with the state
merged so far, unless that state asks for a rung: a draining query climbs
no ladder, so the tier declines for this execution (nothing is pinned) and
the next path drains.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..catalog.segment import row_counts
from ..obs import SPAN_SPARSE_DISPATCH, prof, span
from ..ops import sparse_groupby as sg
from ..ops.groupby import SCATTER_CUTOVER
from ..plan.cost import estimate_selectivity
from ..resilience import checkpoint, checkpoint_partial, current_partial, fire
from .lowering import GroupByLowering, memo_key


def first_row_capacity(q, ds, rows: int) -> Optional[int]:
    """The first row-capacity rung of a pass whose largest unit (a segment,
    a shard's block) holds `rows` rows: None (a full sort) for an
    unfiltered query, whose every row survives; else from the filter's
    estimated selectivity with 2x headroom."""
    if q.filter is None and not q.intervals:
        return None
    sel = estimate_selectivity(q.filter, ds) if q.filter is not None else 1.0
    if sel >= 1.0:
        return sg.ROW_CAPACITY  # nothing to act on: the default rung
    need = 2.0 * sel * rows
    return next((c for c in sg.ROW_CAPACITY_LADDER if c >= need), None)


def next_row_capacity(n_rows: int, cap: int) -> Optional[int]:
    """After a row overflow: the smallest rung above `cap` that holds the
    largest unit's `n_rows` survivors, or None (a full sort) past the top."""
    return next((c for c in sg.ROW_CAPACITY_LADDER if c >= n_rows and c > cap), None)


def next_slots(n_real: int, slots: int) -> Optional[int]:
    """After a slots overflow: the smallest rung that holds the `n_real`
    present groups.  An overflowed merge reports a lower bound, so past the
    top of the ladder it climbs one rung and lets the rerun decide; None
    when `slots` is the top."""
    new = next((s for s in sg.SLOTS_LADDER if s >= n_real and s > slots), None)
    if new is None:
        new = next((s for s in sg.SLOTS_LADDER if s > slots), None)
    return new


class SparseExecMixin:
    """Engine mixin (`exec/engine.Engine`): the sparse tier.  It uses the
    engine's `_sparse_row_capacity` and `_sparse_slots` (memo key -> the
    rung learned) and `_sparse_disabled` (memo key -> reason)."""

    def _sparse_eligible(self, lowering: GroupByLowering, strategy: Optional[str] = None) -> bool:
        """Above the scatter cutover, for plain aggregates over real
        dimensions (sketch states are dense per group; those queries stay
        on the adaptive tier or scatter).  Under "sparse" or "adaptive"; and
        under "auto" or "dense" where the kernel serves the device, the
        counterpart of the reference's TPU-only upgrade: on the CPU the
        scatter path beats the sort.  `strategy` None is the engine's."""
        s = self.strategy if strategy is None else strategy
        if s in ("sparse", "adaptive"):
            chosen = True
        else:
            chosen = s in ("auto", "dense") and self._kernel_class() == "cuda"
        return (
            chosen
            and lowering.num_groups > SCATTER_CUTOVER
            and not lowering.la.sketch_aggs
            and bool(lowering.dims)
        )

    def _first_row_capacity(self, q, ds, segs):
        """The first row-capacity rung over the scope's largest segment."""
        return first_row_capacity(q, ds, max(s.num_rows for s in segs))

    def _sparse_pass(self, ds, lowering: GroupByLowering, segs, row_capacity, slots, m):
        """One pass over the segments at the given rungs: the merged state,
        on the device; None when a deadline stopped it before the first
        segment."""
        la = lowering.la
        G = lowering.num_groups
        pc = current_partial()
        if pc is not None:
            pc.begin_pass()
            pc.add_scope(len(segs), *row_counts(segs))
        state = None
        m.sparse_passes += 1
        for seg in segs:  # canonical segment order: the merge order
            if checkpoint_partial("sparse.segment_loop"):
                break
            cols = self._cols_for_segment(seg, ds, lowering.columns, m)
            fire("device_dispatch")
            with span(SPAN_SPARSE_DISPATCH, segment=seg.uid), prof.device_timer(self.device):
                gid, mask, sv, mmv, mmm = lowering.row_arrays(cols)
                st = sg.sparse_partial_aggregate(
                    gid, mask, sv, mmv, mmm,
                    num_groups=G, num_min=len(la.min_names), num_max=len(la.max_names),
                    slots=slots, inner_strategy=self._kernel_class(),
                    row_capacity=row_capacity,
                )
                state = st if state is None else sg.merge_sparse_states(state, st, G)
            m.dispatch_count += 1
            if pc is not None:
                pc.add_seen(1, *row_counts((seg,)))
        return state

    @staticmethod
    def _flags(state):
        """(overflow, row_overflow, n_rows, n_real) in one fetch."""
        keys = ("overflow", "row_overflow", "n_rows", "n_real")
        ov, rov, n_rows, n_real = torch.stack([state[k].to(torch.int64) for k in keys]).tolist()
        return bool(ov), bool(rov), n_rows, n_real

    def _groupby_sparse(self, q, ds, lowering: GroupByLowering, segs, m):
        """The sparse tier over the (non-empty) segment scope: the host state
        (lowering, sums, mins, maxs, sketch states, slot gids), or None when
        the present groups overflow the top of SLOTS_LADDER (the query is
        then pinned to the scatter path)."""
        qkey = memo_key(q, ds)
        if qkey in self._sparse_row_capacity:
            cap = self._sparse_row_capacity[qkey]
        else:
            cap = self._first_row_capacity(q, ds, segs)
        slots = self._sparse_slots.get(qkey, sg.SPARSE_SLOTS)
        m.inner_strategy = (
            self._kernel_class() if slots <= sg.SPARSE_SLOTS else "segmented_reduce"
        )
        while True:
            state = self._sparse_pass(ds, lowering, segs, cap, slots, m)
            pc = current_partial()
            draining = pc is not None and pc.triggered
            if state is None:
                m.declines.append("sparse: the deadline stopped the pass before its first segment")
                return None
            overflow, row_overflow, n_rows, n_real = self._flags(state)
            if draining and ((cap is not None and row_overflow) or overflow):
                m.declines.append("sparse: a draining query climbs no ladder")
                return None
            if cap is not None and row_overflow:
                cap = self._sparse_row_capacity[qkey] = next_row_capacity(n_rows, cap)
                continue
            if not overflow:
                break
            # every rung runs the whole scope again: a deadline cancels
            # between rungs
            checkpoint("sparse.slots_ladder")
            new = next_slots(n_real, slots)
            if new is None:
                reason = (f"sparse: more than {slots} groups present "
                          "(the top of SLOTS_LADDER)")
                self._sparse_disabled[qkey] = reason
                m.declines.append(reason)
                return None
            slots = self._sparse_slots[qkey] = new
            m.inner_strategy = "segmented_reduce"
        m.sparse_slots = slots
        m.sparse_row_capacity = 0 if cap is None else cap
        host = {k: state[k].cpu().numpy() for k in ("gids", "sums", "mins", "maxs")}
        return lowering, host["sums"], host["mins"], host["maxs"], {}, host["gids"]
