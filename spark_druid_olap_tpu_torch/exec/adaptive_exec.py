"""Adaptive dictionary-domain compaction for huge combined group domains.

SSB q3/q4-class queries group over a combined domain in the hundreds of
thousands (c_city x s_city x d_year = 504K cells) while the filter admits a
few codes of each dimension (c_nation = 'UNITED STATES' leaves 10 of 250
cities).  This tier finds the codes of each grouped dimension that are
present under the query's row mask, then runs the ordinary group-by over
the compacted domain:

  presence  one pass over the segments: per dimension, a count of rows per
            code under the row mask (the group-by kernel at the dimension's
            cardinality when it is at most SCATTER_CUTOVER, an `index_add_`
            of the mask above), summed over the segments on the card and
            read once;
  host      kept_d = codes with a count; G' = prod |kept_d|; a remap
            code -> compact code (-1 = absent);
  compacted the engine's segment loop over a lowering whose dimensions read
            their codes through the remap, so the kernel runs at G' instead
            of scatter at G.  Its kernel class is the cost model's at
            (the datasource's rows, G') (`plan/cost.choose_kernel_strategy`
            with the engine's `cost_config`).  Sketch aggregators ride
            along unchanged.

When the filter pins every grouped dimension (a Selector, In or Bound
conjunct on it), the kept sets come from the dictionaries with no pass at
all (`filter_derived_kept`).  Kept sets are remembered per query
(`lowering.memo_key`): a repeat runs the compacted pass alone.

Soundness: presence is measured under the very row mask the compacted pass
applies, so every kept row's codes are in kept_d; only masked rows can read
-1 from the remap, and `combine_group_ids` clamps them into slot 0, which
their mask keeps out of every aggregate.

Deadlines: the presence pass checkpoints between segments
(`adaptive.presence_loop`); an expiry there under a partial collector
triggers it and declines this execution only.  The compacted pass is the
engine's segment loop, with its checkpoints.

The remap is one gather through a device table, or nothing when a
dimension keeps every code.  The reference also has an unrolled
compare-and-select chain for small kept sets, picked by backend because a
table gather was slow on a TPU; both give identical codes, and on a GPU a
gather from a small table is one cached load per row, so the port keeps the
gather alone.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Set

import numpy as np
import torch

from ..catalog.segment import DataSource, row_counts
from ..models import filters as F
from ..ops.filters import numeric_dict_code_bounds
from ..ops.groupby import SCATTER_CUTOVER, partial_aggregate
from ..obs import SPAN_ADAPTIVE_PROBE, prof, span
from ..plan.cost import choose_kernel_strategy
from ..plan.expr import DeviceConst
from ..resilience import DeadlineExceeded, checkpoint, current_partial, fire
from .lowering import (
    GroupByLowering,
    ResolvedDim,
    _filter_columns,
    _query_key,
    empty_partials,
    memo_key,
)

# Decline compaction when the compacted domain is still bigger than this:
# the pass over G' would gain nothing on the scatter path.
ADAPTIVE_MAX_COMPACT_GROUPS = 1 << 17

# ... and when the domain barely shrinks.
ADAPTIVE_MIN_SHRINK = 0.5


def presence_columns(q, lowering: GroupByLowering, ds) -> List[str]:
    """Columns the presence pass reads: what the row mask and the dimension
    codes need, not the aggregates' inputs.  The physical time column stays
    whenever the lowering reads it (`row_mask` reads "__time", which the
    engine aliases from ds.time_column)."""
    keep = {"__valid", "__time"}
    if ds.time_column:
        keep.add(ds.time_column)
    for d in lowering.dims:
        keep.add(d.spec.dimension)
    if q.filter is not None:
        keep.update(_filter_columns(q.filter))
    for v in q.virtual_columns:
        keep.update(v.expression.columns())
    return [c for c in lowering.columns if c in keep]


def filter_derived_kept(q, lowering: GroupByLowering, ds) -> Optional[List[np.ndarray]]:
    """Kept code sets from the query's own filter, over the host-side
    dictionaries, with no pass over the data.

    When every grouped dimension is a plain dictionary dimension pinned by
    an AND-conjunct (Selector, In, or a Bound the device compile translates
    the same way), the accepted codes are computable in O(cardinality).
    Every kept row satisfies every conjunct, so the derived set is a
    superset of the measured one (it may cost a few empty groups).  Returns
    None when a dimension is unpinned: a presence pass is needed."""
    conjuncts: List[object] = []

    def collect(f):
        if isinstance(f, F.And):
            for c in f.fields:
                collect(c)
        elif f is not None:
            conjuncts.append(f)

    collect(getattr(q, "filter", None))
    kept: List[np.ndarray] = []
    for d in lowering.dims:
        spec = d.spec
        if (
            spec.dimension == "__time"
            or spec.granularity is not None
            or spec.extraction is not None
            or spec.dimension not in ds.dicts
        ):
            return None
        dic = ds.dicts[spec.dimension]
        # each branch mirrors the device filter compile (ops/filters.py):
        # the derived set must hold every code the device mask accepts
        acc: Optional[Set[int]] = None
        for f in conjuncts:
            if getattr(f, "dimension", None) != spec.dimension:
                continue
            cur: Optional[Set[int]] = None
            if isinstance(f, F.Selector):
                if f.value is None:
                    cur = {d.cardinality - 1}  # the null slot
                else:
                    c = dic.code_of(f.value)
                    cur = set() if c is None else {c}
            elif isinstance(f, F.InFilter):
                cur = {c for c in (dic.code_of(v) for v in f.values) if c is not None}
            elif isinstance(f, F.Bound):
                cur = _bound_accepted_codes(f, dic)
            if cur is not None:
                acc = cur if acc is None else (acc & cur)
        if acc is None:
            return None
        kept.append(np.array(sorted(acc), dtype=np.int32))
    return kept


def _bound_accepted_codes(f, dic) -> Optional[Set[int]]:
    """Dictionary codes a Bound conjunct accepts, branch for branch as the
    device compile translates it; None where that cannot be mirrored
    soundly (the dimension then needs the presence pass)."""
    nv = dic.numeric_values
    card = dic.cardinality
    if nv is not None:
        cb = numeric_dict_code_bounds(f, np.asarray(nv))
        if cb is not None:
            lo_c, hi_c = cb
            lo_c = 0 if lo_c is None else lo_c
            hi_c = card - 1 if hi_c is None else hi_c
            return set(range(max(0, lo_c), min(card - 1, hi_c) + 1))
        # a non-numeric literal: the device compares stringified values
        vals = [str(v) for v in dic.values]
        ok = set(range(card))
        if f.lower is not None:
            lo_s = str(f.lower)
            ok = {i for i in ok if (vals[i] > lo_s if f.lower_strict else vals[i] >= lo_s)}
        if f.upper is not None:
            hi_s = str(f.upper)
            ok = {i for i in ok if (vals[i] < hi_s if f.upper_strict else vals[i] <= hi_s)}
        return ok
    if f.ordering == "lexicographic":
        vals = np.asarray(dic.values, dtype=str)
        lo_c, hi_c = 0, card - 1
        if f.lower is not None:
            lo_c = int(np.searchsorted(vals, f.lower, side="right" if f.lower_strict else "left"))
        if f.upper is not None:
            hi_c = int(np.searchsorted(vals, f.upper, side="left" if f.upper_strict else "right")) - 1
        return set(range(max(0, lo_c), min(card - 1, hi_c) + 1))
    # a string dictionary under numeric ordering: the device compares raw
    # codes, so decline rather than risk a narrower set than the mask
    return None


def compacted_lowering(lowering: GroupByLowering, kept: List[np.ndarray]) -> GroupByLowering:
    """The same lowered query over the compacted code domain: each
    dimension reads its codes through a device table original -> compact
    code (-1 = absent), or unchanged when it keeps every code; `decode`
    maps compact codes back through kept_d, so finalization is unchanged."""
    new_dims: List[ResolvedDim] = []
    G = 1
    for d, kd in zip(lowering.dims, kept):
        if len(kd) == d.cardinality:
            codes_fn = d.codes_fn
        else:
            lut = np.full(d.cardinality, -1, np.int32)
            lut[kd] = np.arange(len(kd), dtype=np.int32)

            def codes_fn(cols, base=d.codes_fn, lut=DeviceConst(lut), card=d.cardinality):
                c = base(cols)
                # a masked row may carry an out-of-range code (a time
                # bucket before the first); clamp, its mask excludes it
                return lut.on(c.device)[c.clamp(0, card - 1).long()]

        def decode(codes, base=d.decode, kd=kd):
            return base(kd[np.asarray(codes, dtype=np.int64)])

        new_dims.append(ResolvedDim(d.spec, len(kd), codes_fn, decode))
        G *= len(kd)
    return dataclasses.replace(lowering, dims=new_dims, num_groups=G)


def presence_one(lowering: GroupByLowering, cols, counts, kernel: str):
    """Rows per code of each grouped dimension under the row mask over one
    unit of rows (a segment, a shard's block), added to `counts` (None
    before the first): the kernel (`kernel`: "cuda" on a card, its plain
    version "dense" on the CPU) up to SCATTER_CUTOVER codes, `index_add_`
    above.  Counts of ones in float32 are exact (a unit has far fewer than
    2^24 rows), so the unordered `index_add_` gives the same counts on
    every run."""
    mask = lowering.row_mask(cols)
    R = mask.shape[0]
    ones = mask.to(torch.float32)[:, None]
    none_f = torch.zeros((R, 0), dtype=torch.float32, device=mask.device)
    none_b = torch.zeros((R, 0), dtype=torch.bool, device=mask.device)
    per = []
    for d in lowering.dims:
        card = d.cardinality
        codes = d.codes_fn(cols).clamp(0, card - 1)
        if card <= SCATTER_CUTOVER:
            s, _, _ = partial_aggregate(
                codes, mask, ones, none_f, none_b, num_groups=card,
                num_min=0, num_max=0, strategy=kernel,
            )
            per.append(s[:, 0])
        else:
            per.append(
                torch.zeros(card, dtype=torch.float32, device=mask.device)
                .index_add_(0, codes.long(), ones[:, 0])
            )
    return per if counts is None else [a + b for a, b in zip(counts, per)]


def kept_codes(memo, qkey, q, lowering: GroupByLowering, ds, segs, measure, m):
    """The kept code sets of each grouped dimension and the tier's decline
    reason (None: it runs), with `memo` (memo key -> entry) the engine's.
    A measured set (`measure()`: the presence counts) is only valid for the
    segment set it scanned, so it carries that set and is measured again
    when it moved; a set derived from the filter is a superset on any
    segment set.  Sets `m.kept_source` and `m.compact_groups`; a decline
    drops the memo entry."""
    seg_sig = tuple(s.uid for s in segs)
    entry = memo.get(qkey)
    kept = None
    if entry is not None:
        if entry[0] == "derived":
            kept = entry[1]
        elif entry[1] == seg_sig:
            kept = entry[2]
        if kept is not None:
            m.kept_source = "memo"
    if kept is None:
        kept = filter_derived_kept(q, lowering, ds)
        if kept is not None:
            memo[qkey] = ("derived", kept)
            m.kept_source = "derived"
    if kept is None:
        if segs:
            kept = [np.nonzero(c > 0)[0].astype(np.int32) for c in measure()]
        else:
            kept = [np.zeros(0, np.int32) for _ in lowering.dims]
        memo[qkey] = ("measured", seg_sig, kept)
        m.kept_source = "measured"
    Gc = 1
    for kd in kept:
        Gc *= len(kd)
    m.compact_groups = Gc
    reason = None
    if Gc > ADAPTIVE_MAX_COMPACT_GROUPS:
        reason = f"adaptive: G'={Gc} > ADAPTIVE_MAX_COMPACT_GROUPS={ADAPTIVE_MAX_COMPACT_GROUPS}"
    elif Gc > ADAPTIVE_MIN_SHRINK * lowering.num_groups:
        reason = f"adaptive: G'={Gc} > ADAPTIVE_MIN_SHRINK * G={lowering.num_groups}"
    if reason is not None:
        memo.pop(qkey, None)
        m.declines.append(reason)
    return kept, reason


class AdaptiveDomainMixin:
    """Engine mixin (`exec/engine.Engine`): the adaptive tier.  It uses the
    engine's `_adaptive_kept` (memo key -> kept sets), `_adaptive_declined`
    (memo key -> reason), residency and segment loop."""

    def _adaptive_eligible(self, lowering: GroupByLowering, strategy: Optional[str] = None) -> bool:
        """Under "auto" or "adaptive" (`strategy`, None: the engine's), for
        a grouped query above the scatter cutover, sketches included.  An
        explicit kernel strategy ("cuda", "dense", "segment", "sparse") is
        honoured as such."""
        return (
            (self.strategy if strategy is None else strategy) in ("auto", "adaptive")
            and lowering.num_groups > SCATTER_CUTOVER
            and bool(lowering.dims)
        )

    def _presence_counts(self, q, ds, lowering: GroupByLowering, segs, m) -> List[np.ndarray]:
        """Rows per code of each grouped dimension under the row mask, summed
        over `segs` on the device and read with one fetch.  Counts of ones
        in float32 are exact (a segment has far fewer than 2^24 rows), so
        the unordered `index_add_` above the kernel's range gives the same
        counts on every run."""
        need = presence_columns(q, lowering, ds)
        counts = None
        for seg in segs:
            # the presence pass scans the whole scope too: a deadline
            # cancels between its segments (presence counts are no answer,
            # so expiry raises here; `_groupby_adaptive` declines on it)
            checkpoint("adaptive.presence_loop")
            cols = lowering.add_virtual(dict(self._cols_for_segment(seg, ds, need, m)))
            fire("device_dispatch")
            with span(SPAN_ADAPTIVE_PROBE, segment=seg.uid), prof.device_timer(self.device):
                counts = self._presence_one(lowering, cols, counts)
            m.dispatch_count += 1
        host = torch.cat(counts).cpu().numpy()  # the pass's one fetch
        out, at = [], 0
        for d in lowering.dims:
            out.append(host[at:at + d.cardinality])
            at += d.cardinality
        return out

    def _presence_one(self, lowering, cols, counts):
        """One segment's rows per code, added to `counts`."""
        return presence_one(lowering, cols, counts, self._kernel_class())

    def _adaptive_kept_codes(self, q, ds, lowering: GroupByLowering, segs, m):
        """The kept code sets of each grouped dimension (`kept_codes`), or
        None when the tier declines (the reason goes to `m.declines` and
        the decline memo)."""
        qkey = memo_key(q, ds)
        kept, reason = kept_codes(
            self._adaptive_kept, qkey, q, lowering, ds, segs,
            lambda: self._presence_counts(q, ds, lowering, segs, m), m)
        if reason is not None:
            self._adaptive_declined[qkey] = reason
            return None
        return kept

    def _adaptive_main_strategy(self, ds: DataSource, g_compact: int) -> str:
        """The compacted pass's kernel strategy: the cost model's class at
        (the datasource's rows, G'), by the engine's cost constants; dense
        is the kernel on a card (priced only up to SCATTER_CUTOVER there)
        and its plain version on the CPU."""
        cls = choose_kernel_strategy(ds.num_rows, g_compact, self.cost_config,
                                     device=self.device)
        return self._resolve_strategy(g_compact, cls)

    def _groupby_adaptive(self, q, ds: DataSource, lowering: GroupByLowering, segs, m):
        """The adaptive tier over the (non-empty) segment scope: the
        compacted lowering and the merged state of its pass on the device,
        or None when it declines.  The kept sets identify the compacted
        lowering, in the lowering cache and for the arena (`key_extra`),
        so no program replays the constants of another kept set."""
        try:
            kept = self._adaptive_kept_codes(q, ds, lowering, segs, m)
        except DeadlineExceeded as err:
            # the deadline expired in the presence pass, before any
            # aggregate partial exists.  With a collector armed, trigger it
            # and decline for this execution only (a deadline is a property
            # of the request, not of the query): the next path drains at
            # once to the zero-coverage answer.  Without one, expiry raises
            pc = current_partial()
            if pc is None:
                raise
            pc.trigger(err.site or "adaptive.presence_loop")
            m.declines.append("adaptive: the deadline expired in the presence pass")
            return None
        if kept is None:
            return None
        if any(len(kd) == 0 for kd in kept):
            # a grouped dimension has no code under the filter: the exact
            # answer is the empty grouped frame, and the presence pass saw
            # the whole scope to prove it
            pc = current_partial()
            if pc is not None:
                rows = row_counts(segs)
                pc.begin_pass()
                pc.add_scope(len(segs), *rows)
                pc.add_seen(len(segs), *rows)
            m.inner_strategy = "none"
            return lowering, empty_partials(lowering.la, 0, self.device)
        extra = ("adaptive",) + tuple(kd.tobytes() for kd in kept)
        key = _query_key(q, ds) + extra
        clow = self._lowering_cache.get(key)
        if clow is None:
            clow = compacted_lowering(lowering, kept)
            self._lowering_cache[key] = clow
        m.inner_strategy = self._adaptive_main_strategy(ds, clow.num_groups)
        state = self._partials_for_query(clow, segs, ds, m.inner_strategy, m, key_extra=extra)
        return clow, state
