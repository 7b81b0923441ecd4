#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`spark_druid_olap_tpu_torch`).

    python3 chip_smoke.py [--ssb-scale 10] [--tpch-scale 1]

Needs one CUDA card; without one it exits non-zero and prints no result.
Phases, one JSON line each:

1. card: name and power limit from nvidia-smi, torch and CUDA versions;
2. build: compiles the group-by kernel from `csrc/` (nvcc, sm_90a);
3. kernel: the kernel against its plain PyTorch version on the card, at
   the reference kernel's test shapes, the all-masked case and the shapes
   the main path launches in phases 4 to 7 (one 512K-row segment at each
   query's and grouping set's G and column counts, plus a time-sorted
   Timeseries segment; phase 7 fails on a shape left out): mins/maxs
   exactly equal, sums within rtol 1e-5 (another summation order over
   512K rows), two launches bit-equal.  At those shapes it times the
   kernel (`ms`) and one library call computing the same sums
   (`index_add_`, `library_ms`) by device time under torch.profiler,
   over launches that rotate through copies of the inputs larger than the
   L2 together, so reads come from HBM as the bound assumes; the call
   through the wrapper on the host clock (`call_ms`, CUDA events around
   one Python call); the plain version (`plain_ms`, CUDA events); and, to
   see what holds the kernel back, its device time per pass (`pass_ms`),
   on L2-resident inputs (`l2_ms`) and with every row masked (`floor_ms`);
4. main path: SSB (SF10: 60M lineorder rows in 512K-row time-sorted
   segments, resident on the card) and TPC-H lineitem (SF1), the 13 SSB
   queries, TPC-H Q1, a Timeseries and a TopN through
   `Engine(device="cuda").execute`, each checked against a float64 pandas
   oracle (group keys and counts exact, sums within rtol 2e-5) and run
   twice for bit-identical frames; p50 of the warm runs, rows scanned per
   second, strategy and the kernel launches each query made;
5. profile: one more warm run of each query under torch.profiler, its
   device time by kernel and the device's idle share of the p50;
6. sql: each workload's data registered into its own `TPUOlapContext`
   (whose engine ran that workload in phases 4 and 5, so the columns are
   already resident) with its star schema and its normalized dimension
   tables; the 13 SSB queries and every TPC-H query sent as joined SQL
   through `ctx.sql`.  Each query's planned Druid JSON must equal its
   native spec where one exists; its frame must be bit-identical to the
   native path's frame for the planned spec (same columns), hold against
   the float64 oracle, and be bit-identical over two runs; the kernel must
   launch for every query with G <= 4096.  Reported per query: plan ms
   cold (parse + plan of the text, no plan cache) and cached (the
   plan-cache hit); warm `ctx.sql` and native runs of the same spec
   interleaved in pairs, the side that goes first alternating, with the
   p50 of each side and the median of the per-pair differences; the
   launches of the `ctx.sql` runs;
7. sketches: first the sketch ops on the card against the same functions
   on the CPU, bit for bit: HLL (p = 11 and p = 4), theta (K = 4096) and
   quantile (K = 1024) partials and their merges over the first 4 in-scope
   SSB segments, at the group ids of the queries below, and `_rho` over
   ±8192 around every power of two below 2^28 against the reference's
   values (the exact floor(log2) with the committed exception table).
   Then `ssb.SKETCH_QUERIES` through `ctx.sql` (TopN + HLL, the same
   TopN over a filter that masks half of each segment's rows, CUBE + HLL,
   CUBE + theta, APPROX_QUANTILE), 2 cold and 5 warm runs each: frames
   bit-identical from run to run and held against the exact oracle
   (`ssb.check_sketch_answer`: sums within rtol 2e-5, distinct counts
   within 4 standard errors, quantiles within 4 standard errors in rank
   (±6.25% at the median, ±3.75% at p90, K = 1024; the largest rank error
   of each fraction is reported), every CUBE grouping id with its nulls),
   and the kernel launched once per in-scope segment per run for every
   grouping set.  Reported per query: p50, device busy ms and idle share
   (one more run under torch.profiler), and the sketch ops' own device ms
   (a replay of just the sketch partials and merges over the query's
   segments under torch.profiler).

Then the `kernels` line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.  Any failed check raises: the script
exits non-zero and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from spark_druid_olap_tpu_torch.api import TPUOlapContext, grouping_set_queries
from spark_druid_olap_tpu_torch.exec.engine import (
    merge_sketch_states,
    segments_in_scope,
    sketch_partials,
)
from spark_druid_olap_tpu_torch.exec.metrics import QueryMetrics
from spark_druid_olap_tpu_torch.exec.lowering import (
    groupby_with_time_granularity,
    lower_groupby,
    topn_to_groupby,
)
from spark_druid_olap_tpu_torch.models import aggregations as A
from spark_druid_olap_tpu_torch.models import query as Q
from spark_druid_olap_tpu_torch.ops import cuda_groupby, hll
from spark_druid_olap_tpu_torch.workloads import ssb, tpch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
F32_OPS_PER_S = 67e12  # H100 SXM published float32 rate outside tensor cores
KERNEL_RTOL = 1e-5
ORACLE_RTOL = 2e-5

# the reference kernel's test shapes (R, G, Ms, Mn, Mx)
TEST_SHAPES = [(4096, 12, 3, 0, 0), (8192, 300, 4, 2, 1), (8192, 700, 2, 1, 1), (1024, 1, 1, 0, 0)]
# one 512K-row segment at the shapes the main path launches
MAIN_SHAPES = [
    (524288, 1, 2, 0, 0),  # q1.1-q1.3: revenue and count, one group
    (524288, 12, 8, 0, 0),  # TPC-H Q1
    (524288, 26, 2, 0, 0),  # TopN by c_nation
    (524288, 84, 2, 0, 0),  # Timeseries by month
    (524288, 208, 2, 0, 0),  # q4.1
    (524288, 208, 4, 1, 1),  # the headline row of PR 1, min/max included
    (524288, 4096, 4, 1, 1),  # min/max at the scatter cutover
    # phase 7: revenue and count at each sketch query's and CUBE set's G
    (524288, 6, 2, 0, 0),  # CUBE sets (c_region), (s_region)
    (524288, 8, 2, 0, 0),  # CUBE set (d_year); the quantile query
    (524288, 36, 2, 0, 0),  # CUBE set (c_region, s_region)
    (524288, 48, 2, 0, 0),  # CUBE sets (c_region, d_year), (s_region, d_year)
    (524288, 251, 2, 0, 0),  # topn_hll, filtered_hll (c_city)
    (524288, 288, 2, 0, 0),  # CUBE set (c_region, s_region, d_year)
]
HEADLINE = (524288, 208, 4, 1, 1)
# Timeseries over a time-sorted segment: one or two months per segment
SKEWED = (524288, 84, 2, 0, 0)
ROTATE_BYTES = 200e6  # inputs cycled per timing: four times the 50 MB L2
WARM_RUNS = 5
SQL_PAIRS = 6  # interleaved SQL/native pairs per query in phase 6 (even)
SKETCH_COLD, SKETCH_WARM = 2, 5  # runs of each sketch query in phase 7
OP_CHECK_SEGMENTS = 4
# the sketch ops checked at each query's group ids
OP_CHECKS = {
    "topn_hll": (A.HyperUnique("hll11", "lo_custkey", precision=11),
                 A.HyperUnique("hll4", "lo_custkey", precision=4)),
    "cube_theta": (A.ThetaSketch("theta", "lo_custkey", size=4096),),
    "quantiles": (A.QuantilesSketch("quantiles", "lo_revenue", size=1024),),
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, default=str), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# -- phase 3: the kernel against its plain version ---------------------------


def make_inputs(R, G, Ms, Mn, Mx, device, seed=0, mask_p=0.8, skewed=False):
    rng = np.random.default_rng(seed)
    mask = rng.random(R) < mask_p
    gid = rng.integers(0, G, R).astype(np.int32)
    if skewed:  # two sorted runs: the segment spans two adjacent groups
        gid = np.where(np.arange(R) < R * 3 // 5, G // 2, G // 2 + 1).astype(np.int32)
    arrs = (
        gid,
        mask,
        (rng.random((R, Ms)) * 1000 * mask[:, None]).astype(np.float32),
        rng.random((R, Mn + Mx)).astype(np.float32),
        rng.random((R, Mn + Mx)) < 0.9,
    )
    return [torch.from_numpy(a).to(device) for a in arrs]


def cuda_ms(fn, reps: int = 20) -> float:
    """Median of `reps` CUDA-event timings of fn() after two warm-ups: the
    host's time to issue the call and the card's to run it."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, n: int):
    """Device time per call of fn(i), i < n: the device-side events (kernels,
    copies, fills) that torch.profiler records, summed and divided by n.
    Where the profiler records no device time, CUDA events around the n
    back-to-back calls.  Returns (ms, timer, ms by kernel name, events by
    kernel name): the counts show a window that caught more or fewer
    events than the n calls launch."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    fn(1 % n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {e.key: e.self_device_time_total / 1e3 / n for e in dev}
    if sum(by_name.values()) > 0:
        return sum(by_name.values()), "profiler", by_name, {e.key: e.count for e in dev}
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(n):
        fn(i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n, "events", {}, {}


def bound(R, G, Ms, Mn, Mx):
    """Least time the card could take: each input byte read once, each
    output written once, at the HBM rate; against one add or compare per
    row and column at the float32 rate.  Returns (ms, bound_by)."""
    nbytes = R * (4 + 1 + 4 * Ms + 5 * (Mn + Mx)) + 4 * G * (Ms + Mn + Mx)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = R * (Ms + Mn + Mx) / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel_shape(R, G, Ms, Mn, Mx, device, seed, mask_p=0.8, skewed=False):
    args = make_inputs(R, G, Ms, Mn, Mx, device, seed, mask_p, skewed)
    if mask_p == 0.0:
        args[2].zero_()
    got = cuda_groupby.cuda_partial_aggregate(*args, num_groups=G, num_min=Mn, num_max=Mx)
    again = cuda_groupby.cuda_partial_aggregate(*args, num_groups=G, num_min=Mn, num_max=Mx)
    want = cuda_groupby.plain_partial_aggregate(*args, G, Mn, Mx)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"kernel not bit-stable at {(R, G, Ms, Mn, Mx)}")
    for name, a, b in zip(("mins", "maxs"), got[1:], want[1:]):
        if not torch.equal(a, b):
            raise AssertionError(f"kernel {name} differ from plain at {(R, G, Ms, Mn, Mx)}")
    err = (got[0].double() - want[0].double()).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    rel = err / want[0].double().abs().clamp_min(1e-30)
    max_rel = float(rel.max()) if rel.numel() else 0.0
    if not bool((err <= KERNEL_RTOL * want[0].double().abs()).all()):
        raise AssertionError(f"kernel sums off by {max_rel} (rtol {KERNEL_RTOL}) at {(R, G, Ms, Mn, Mx)}")
    if mask_p == 0.0 and not (
        float(got[0].abs().sum()) == 0.0
        and bool(torch.isposinf(got[1]).all()) and bool(torch.isneginf(got[2]).all())
    ):
        raise AssertionError("all-masked input must give 0 / +inf / -inf")
    return args, max_abs, max_rel


def time_kernel(args, R, G, Ms, Mn, Mx, device):
    """Times of the kernel, its plain version and the library call at one
    shape, beside the bound."""
    set_bytes = sum(t.numel() * t.element_size() for t in args)
    n = max(20, -(-int(ROTATE_BYTES) // set_bytes))
    sets = [args] + [[t.clone() for t in args] for _ in range(n - 1)]
    kw = dict(num_groups=G, num_min=Mn, num_max=Mx)
    ms, timer, by_name, events = device_ms(
        lambda i: cuda_groupby.cuda_partial_aggregate(*sets[i], **kw), n)
    # the same launch on L2-resident inputs, and with every row masked
    # (staging, set-up and the combines only): what is left when HBM and the
    # per-row work are taken away
    l2_ms, _, _, l2_events = device_ms(
        lambda i: cuda_groupby.cuda_partial_aggregate(*args, **kw), n)
    masked = [[g, torch.zeros_like(m), sv, mmv, mmm] for g, m, sv, mmv, mmm in sets]
    floor_ms, _, _, floor_events = device_ms(
        lambda i: cuda_groupby.cuda_partial_aggregate(*masked[i], **kw), n)
    del masked
    lib_in = [
        (torch.where(m, g.long(), torch.full_like(g.long(), G)), sv)
        for g, m, sv, _, _ in sets
    ]
    del sets

    def library(i):
        seg, sv = lib_in[i]
        return torch.zeros(G + 1, Ms, device=device).index_add_(0, seg, sv)

    library_ms, _, _, _ = device_ms(library, n)
    del lib_in
    b_ms, b_by = bound(R, G, Ms, Mn, Mx)
    return {
        "ms": ms,
        "timer": timer,
        "pass_ms": {
            next((w for w in ("partial_pass", "fold_pass") if w in k), k[:40]): v
            for k, v in by_name.items()
        },
        "l2_ms": l2_ms,
        "floor_ms": floor_ms,
        # device events per window: 2n (partial_pass, fold_pass) when clean
        "events": [sum(e.values()) for e in (events, l2_events, floor_events)],
        "rotated_sets": n,
        "call_ms": cuda_ms(lambda: cuda_groupby.cuda_partial_aggregate(*args, **kw)),
        "plain_ms": cuda_ms(lambda: cuda_groupby.plain_partial_aggregate(*args, G, Mn, Mx), reps=3),
        "library_ms": library_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bound_share": b_ms / ms,
        "below_library": ms < library_ms,
    }


def kernel_phase(device):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's product in full f32
    rows = []
    for i, shape in enumerate(TEST_SHAPES):
        _, max_abs, max_rel = check_kernel_shape(*shape, device, seed=i)
        rows.append({"shape": shape, "max_abs_err": max_abs, "max_rel_err": max_rel})
    check_kernel_shape(2048, 10, 2, 1, 1, device, seed=9, mask_p=0.0)
    rows.append({"shape": (2048, 10, 2, 1, 1), "all_masked": True})
    timed = []
    cases = [(shape, False) for shape in MAIN_SHAPES] + [(SKEWED, True)]
    for i, ((R, G, Ms, Mn, Mx), skewed) in enumerate(cases):
        args, max_abs, max_rel = check_kernel_shape(
            R, G, Ms, Mn, Mx, device, seed=100 + i, skewed=skewed)
        timed.append({
            "shape": (R, G, Ms, Mn, Mx),
            "skewed": skewed,
            "geometry": cuda_groupby.geometry(R, G, Ms, Mn + Mx)._asdict(),
            "max_abs_err": max_abs,
            "max_rel_err": max_rel,
            **time_kernel(args, R, G, Ms, Mn, Mx, device),
        })
        emit("kernel_timing", **timed[-1])
    emit("kernel_check", cases=rows, rtol=KERNEL_RTOL, bit_stable=True)
    return rows, timed


# -- phase 4: the main path --------------------------------------------------


def _frame_check(name, got, want, keys, rtol=ORACLE_RTOL):
    """Group keys and integer columns exact, floats within rtol; returns the
    largest relative error seen."""
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} rows, oracle {len(want)}")
    got = got.sort_values(keys, kind="stable").reset_index(drop=True) if keys else got
    want = want.sort_values(keys, kind="stable").reset_index(drop=True) if keys else want
    worst = 0.0
    for c in want.columns:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if c in keys or w.dtype.kind in "iuM" or np.asarray(got[c]).dtype.kind in "iu":
            if w.dtype.kind == "M":
                g, w = g.astype("datetime64[ms]"), w.astype("datetime64[ms]")
            if not np.array_equal(g.astype(object), w.astype(object)):
                raise AssertionError(f"{name}: column {c} differs from the oracle")
            continue
        g, w = g.astype(np.float64), w.astype(np.float64)
        err = np.abs(g - w)
        if not (err <= rtol * np.abs(w)).all():
            raise AssertionError(f"{name}: column {c} off by {float((err / np.abs(w)).max())}")
        if len(w):
            worst = max(worst, float((err / np.maximum(np.abs(w), 1e-300)).max()))
    return worst


_ORACLES = {}


def oracle(workload, name, frame):
    """The float64 oracle of one query, computed once per run (phases 4 and
    6 check the same queries)."""
    key = (workload, name)
    if key not in _ORACLES:
        _ORACLES[key] = (tpch if workload == "tpch" else ssb).oracle(frame, name)
    return _ORACLES[key]


def _top_k_check(name, got, want, value):
    """ORDER BY value DESC LIMIT k against the oracle's top k, tie-aware:
    the values agree in order, every returned key that the oracle also
    returns carries its value, and a key the oracle left out sits at the
    cut (a float32 near-tie)."""
    g = np.asarray(got[value], dtype=np.float64)
    w = np.asarray(want[value], dtype=np.float64)
    if len(g) != len(w) or (np.diff(g) > 0).any():
        raise AssertionError(f"{name}: wrong length or order")
    if not (np.abs(g - w) <= ORACLE_RTOL * np.abs(w)).all():
        raise AssertionError(f"{name}: top-{len(w)} values differ from the oracle")
    keys = [c for c in want.columns if c != value]
    wmap = dict(zip(map(tuple, want[keys].astype(str).to_numpy()), w))
    for k, v in zip(map(tuple, got[keys].astype(str).to_numpy()), g):
        ref = wmap.get(k, w[-1])
        if abs(v - ref) > ORACLE_RTOL * abs(ref):
            raise AssertionError(f"{name}: {k} {v} vs oracle {ref}")
    return float((np.abs(g - w) / np.abs(w)).max()) if len(w) else 0.0


def check_against_oracle(name, got, frame, workload):
    if workload == "tpch":
        want = oracle(workload, name, frame)
        if isinstance(want, float):
            g = float(got.iloc[0, -1])
            if len(got) != 1 or abs(g - want) > ORACLE_RTOL * abs(want):
                raise AssertionError(f"{name}: {g} vs oracle {want}")
            return abs(g - want) / abs(want)
        if name in ("q3", "q10"):  # ORDER BY revenue DESC LIMIT k
            return _top_k_check(name, got[list(want.columns)], want, "revenue")
        keys = [c for c in want.columns if want[c].dtype.kind not in "f"]
        return _frame_check(name, got[list(want.columns)], want, keys)
    want = oracle(workload, name, frame)
    if isinstance(want, float):
        g = float(got["revenue"].iloc[0])
        if len(got) != 1 or abs(g - want) > ORACLE_RTOL * abs(want):
            raise AssertionError(f"{name}: {g} vs oracle {want}")
        return abs(g - want) / abs(want)
    if name == "topn":
        # tie-aware: each returned nation's revenue matches the oracle, the
        # order is non-increasing, and nothing left out beats the cut
        w = dict(zip(want.c_nation.astype(str), want.revenue))
        rev = np.asarray(got.revenue, dtype=np.float64)
        worst = 0.0
        for n, r in zip(got.c_nation.astype(str), rev):
            if abs(r - w[n]) > ORACLE_RTOL * abs(w[n]):
                raise AssertionError(f"topn: {n} {r} vs oracle {w[n]}")
            worst = max(worst, abs(r - w[n]) / abs(w[n]))
        k = ssb.TOPN_QUERY.threshold
        if len(got) != k or (np.diff(rev) > 0).any():
            raise AssertionError("topn: wrong length or order")
        left_out = [v for n, v in w.items() if n not in set(got.c_nation.astype(str))]
        if left_out and max(left_out) > rev[-1] * (1 + ORACLE_RTOL):
            raise AssertionError("topn: a nation above the cut was left out")
        return worst
    keys = [c for c in want.columns if c not in ("revenue", "profit")]
    want = want.assign(**{c: want[c].astype(object) for c in keys if c != "timestamp"})
    return _frame_check(name, got[list(want.columns)], want, keys)


def build_workloads(ssb_scale: float, tpch_scale: float, seed: int = 7):
    """The flat datasources and oracle frames of both workloads, and the
    normalized dimension tables the SQL phase registers.  The fact tables'
    raw columns are freed once flattened."""
    t0 = time.perf_counter()
    tables = ssb.gen_tables(ssb_scale, seed=seed)
    cols, dicts = ssb.flat_columns(tables)
    del tables["lineorder"]
    ssb_ds = ssb.datasource(cols, dicts)
    ssb_frame = ssb.coded_frame(cols, dicts)
    del cols
    tt = tpch.gen_tables(tpch_scale)
    tcols, tdicts = tpch.flat_columns(tt)
    tpch_ds = tpch.datasource(tcols, tdicts, rows_per_segment=1 << 19)
    tpch_frame = tpch.flat_frame(tt)
    del tcols, tt["lineitem"]
    emit(
        "data", ssb_scale=ssb_scale, ssb_rows=ssb_ds.num_rows,
        ssb_segments=len(ssb_ds.segments), tpch_scale=tpch_scale,
        tpch_rows=tpch_ds.num_rows, tpch_segments=len(tpch_ds.segments),
        seconds=time.perf_counter() - t0,
    )
    return {
        "ssb": (ssb_ds, ssb_frame),
        "tpch": (tpch_ds, tpch_frame),
        "dims": {"ssb": tables, "tpch": tt},
    }


def main_path_queries():
    return (
        [("ssb", n, q) for n, q in ssb.NATIVE_QUERIES.items()]
        + [("tpch", "q1", tpch.NATIVE_QUERIES["q1"])]
        + [("ssb", "timeseries", ssb.TIMESERIES_QUERY), ("ssb", "topn", ssb.TOPN_QUERY)]
    )


def run_main_path(engines, workloads, warm_runs: int = WARM_RUNS):
    """Drive every query of the main path through its workload's engine
    (`engines`: workload -> Engine); returns one summary per query."""
    import pandas as pd

    out = []
    for workload, name, q in main_path_queries():
        ds, frame = workloads[workload]
        engine = engines[workload]
        before = cuda_groupby.LAUNCHES
        first = engine.execute(q, ds)  # cold: moves the columns to the card
        m = engine.last_metrics
        second = engine.execute(q, ds)
        pd.testing.assert_frame_equal(first, second, check_exact=True)
        times = []
        for _ in range(warm_runs):
            t0 = time.perf_counter()
            engine.execute(q, ds)
            times.append((time.perf_counter() - t0) * 1e3)
        launches = cuda_groupby.LAUNCHES - before
        if engine.device.type == "cuda" and m.num_groups <= 4096 and launches == 0:
            raise AssertionError(f"{name}: G={m.num_groups} but the kernel never launched")
        p50 = statistics.median(times)
        out.append({
            "query": name,
            "strategy": m.strategy,
            "num_groups": m.num_groups,
            "segments": m.segments,
            "rows_scanned": m.rows_scanned,
            "result_rows": len(first),
            "p50_ms": p50,
            "rows_per_s": m.rows_scanned / (p50 / 1e3),
            "cold_ms": m.total_ms,
            "h2d_bytes": m.h2d_bytes,
            "kernel_launches": launches,
            "oracle_max_rel_err": check_against_oracle(name, first, frame, workload),
            "bit_identical": True,
        })
        emit("query", **out[-1])
    return out


def profile_queries(engines, workloads, summaries):
    """One more warm run of each query under torch.profiler: device time by
    kernel, the group-by kernel's share, and the device's idle share of the
    query's unprofiled p50 wall time."""
    from torch.profiler import ProfilerActivity, profile

    p50 = {s["query"]: s["p50_ms"] for s in summaries}
    for workload, name, q in main_path_queries():
        ds, _ = workloads[workload]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engines[workload].execute(q, ds)
        # device-side events only (kernels, copies): an aten op's average
        # repeats its kernels' device time
        dev = {
            e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
        }
        busy = sum(dev.values())
        groupby = sum(v for k, v in dev.items() if "partial_pass" in k or "fold_pass" in k)
        emit(
            "profile", query=name, wall_p50_ms=p50[name], device_busy_ms=busy,
            groupby_kernel_ms=groupby,
            device_idle_share=(1 - busy / p50[name]) if busy else None,
            top_device_ms=sorted(dev.items(), key=lambda kv: -kv[1])[:4],
        )


# -- phase 6: the SQL front end -----------------------------------------------


def register_sql(ctxs, workloads) -> float:
    """Register each workload's flat datasource with its star schema, and
    its normalized dimension tables, into its own context (`ctxs`:
    workload -> TPUOlapContext; SSB and TPC-H both name a customer,
    supplier and part table); returns seconds."""
    t0 = time.perf_counter()
    dims = workloads["dims"]
    s, t = ctxs["ssb"], ctxs["tpch"]
    s.register_datasource(workloads["ssb"][0], star_schema=ssb.STAR_SCHEMA)
    s.register_table("dwdate", dims["ssb"]["dwdate"], time_column="d_datekey")
    t.register_datasource(workloads["tpch"][0], star_schema=tpch.STAR_SCHEMA)
    t.register_table("orders", dims["tpch"]["orders"], time_column="o_orderdate")
    for name in ("customer", "supplier", "part"):
        s.register_table(name, dims["ssb"][name])
        t.register_table(name, dims["tpch"][name])
    return time.perf_counter() - t0


def sql_queries():
    return [("ssb", n, q) for n, q in ssb.QUERIES.items()] + [
        ("tpch", n, q) for n, q in tpch.QUERIES.items()
    ]


def _median_ms(fn, n: int) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _interleaved_ms(sql_fn, native_fn, pairs: int):
    """`pairs` runs of each function, interleaved: SQL then native in even
    pairs, native then SQL in odd ones, so neither side always runs first.
    Returns (SQL ms, native ms, kernel launches of the SQL runs)."""
    sql_ms, native_ms, launches = [], [], 0
    for i in range(pairs):
        for side in (("sql", "native") if i % 2 == 0 else ("native", "sql")):
            before = cuda_groupby.LAUNCHES
            t0 = time.perf_counter()
            (sql_fn if side == "sql" else native_fn)()
            ms = (time.perf_counter() - t0) * 1e3
            if side == "sql":
                sql_ms.append(ms)
                launches += cuda_groupby.LAUNCHES - before
            else:
                native_ms.append(ms)
    return sql_ms, native_ms, launches


def run_sql_path(ctxs, workloads, pairs: int = SQL_PAIRS):
    """Drive every SQL query through its workload's `ctx.sql` (`ctxs`:
    workload -> TPUOlapContext); returns one summary per query.  Only the
    launches of the `ctx.sql` calls are counted."""
    import pandas as pd

    natives = {"ssb": ssb.NATIVE_QUERIES, "tpch": tpch.NATIVE_QUERIES}
    out = []
    for workload, name, sql in sql_queries():
        ctx = ctxs[workload]
        _, frame = workloads[workload]
        plan_cold = _median_ms(lambda: ctx.plan_sql(sql), 3)
        rw = ctx.plan_sql(sql)
        spec = natives[workload].get(name)
        planned = json.dumps(rw.query.to_druid(), sort_keys=True, default=str)
        if spec is not None and planned != json.dumps(
            spec.to_druid(), sort_keys=True, default=str
        ):
            raise AssertionError(f"{name}: planned JSON differs from the native spec")
        launches = cuda_groupby.LAUNCHES
        first = ctx.sql(sql)
        m = ctx.last_metrics
        second = ctx.sql(sql)
        launches = cuda_groupby.LAUNCHES - launches
        pd.testing.assert_frame_equal(first, second, check_exact=True)
        plan_cached = _median_ms(lambda: ctx.plan_cached(sql), 20)
        ds = ctx.catalog.get(rw.datasource)
        native_q = spec if spec is not None else rw.query
        native = ctx.engine.execute(native_q, ds)
        native_strategy = ctx.last_metrics.strategy
        sql_ms, native_ms, warm_launches = _interleaved_ms(
            lambda: ctx.sql(sql), lambda: ctx.engine.execute(native_q, ds), pairs)
        launches += warm_launches
        if ctx.engine.device.type == "cuda" and m.num_groups <= 4096 and launches == 0:
            raise AssertionError(f"{name}: G={m.num_groups} but the kernel never launched")
        diffs = [a - b for a, b in zip(sql_ms, native_ms)]
        cols = [c for c in first.columns if c in native.columns]
        pd.testing.assert_frame_equal(
            first[cols].reset_index(drop=True), native[cols].reset_index(drop=True),
            check_exact=True,
        )
        if native_strategy != m.strategy:
            raise AssertionError(f"{name}: SQL ran {m.strategy}, native {native_strategy}")
        out.append({
            "query": f"{name} (TPC-H)" if workload == "tpch" else name,
            "json_equals_native": None if spec is None else True,
            "strategy": m.strategy,
            "num_groups": m.num_groups,
            "segments": m.segments,
            "result_rows": len(first),
            "plan_cold_ms": plan_cold,
            "plan_cached_ms": plan_cached,
            "sql_p50_ms": statistics.median(sql_ms),
            "native_p50_ms": statistics.median(native_ms),
            # per pair, SQL ms minus native ms: median, and the pairs where
            # SQL went first / native went first
            "sql_minus_native_ms": statistics.median(diffs),
            "diff_sql_first_ms": diffs[0::2],
            "diff_native_first_ms": diffs[1::2],
            "kernel_launches": launches,
            "oracle_max_rel_err": check_against_oracle(name, first, frame, workload),
            "bit_identical": True,
            "bit_identical_to_native": True,
        })
        emit("sql_query", **out[-1])
    return out


# -- phase 7: sketches --------------------------------------------------------


def _sketch_sets(ctx, name, full=False):
    """The group-by specs one sketch query runs, one per grouping set, as
    `api.execute_grouping_sets` splits them; with `full`, only its grouping
    by every dimension."""
    import dataclasses

    rw = ctx.plan_sql(ssb.SKETCH_QUERIES[name])
    q = rw.query
    if isinstance(q, Q.TopNQuery):
        q = topn_to_groupby(q)
    if full or not rw.grouping_sets:
        qs = [dataclasses.replace(q, subtotals=())]
    else:
        qs = grouping_set_queries(q, rw.grouping_sets)
    return [groupby_with_time_granularity(x) for x in qs]


def sketch_op_checks(ctx):
    """The engine's sketch partials and merges (`sketch_partials`,
    `merge_sketch_states`) on the context's device against the same
    functions on the CPU over the same inputs, bit for bit: over the first
    OP_CHECK_SEGMENTS in-scope SSB segments (their resident columns), at the
    group ids of each query's grouping by every dimension; one summary per
    op."""
    import dataclasses

    ds = ctx.catalog.get("lineorder")
    out = []
    for name, aggs in OP_CHECKS.items():
        (q,) = _sketch_sets(ctx, name, full=True)
        q = dataclasses.replace(q, aggregations=aggs, post_aggregations=(), limit_spec=None)
        lowering = lower_groupby(q, ds)
        acc = {"card": {}, "cpu": {}}
        segs = segments_in_scope(q, ds)[:OP_CHECK_SEGMENTS]
        for seg in segs:
            cols = ctx.engine._cols_for_segment(seg, ds, lowering.columns, QueryMetrics())
            gid, mask = lowering.row_arrays(cols)[:2]
            new = {
                "card": sketch_partials(lowering, cols, gid, mask),
                "cpu": sketch_partials(
                    lowering, {k: v.cpu() for k, v in cols.items()}, gid.cpu(), mask.cpu()),
            }
            for k in acc:
                merge_sketch_states(lowering.la, acc[k], new[k])
            for agg in aggs:
                for what, states in (("partial", new), ("merge", acc)):
                    if not torch.equal(states["card"][agg.name].cpu(), states["cpu"][agg.name]):
                        raise AssertionError(f"{agg.name}: {what} on the card differs from the CPU")
        for agg in aggs:
            out.append({"op": agg.name, "query": name, "num_groups": lowering.num_groups,
                        "segments": len(segs), "state_shape": list(acc["card"][agg.name].shape),
                        "bit_equal_to_cpu": True})
            emit("sketch_op_check", **out[-1])
    return out


def rho_check(device):
    """`hll._rho` on `device` over ±8192 around every power of two below
    2^28 (p = 4) against the reference's values computed on the host: the
    float32 exponent of w with the committed exception table applied."""
    half, top = 8192, 28
    w = np.unique(np.concatenate([
        np.arange(max((1 << k) - half, 0), min((1 << k) + half, 1 << top)) for k in range(top)
    ]))
    lg = np.frexp(np.maximum(w, 1).astype(np.float32))[1].astype(np.int64) - 1
    for a, b, v in hll._LOG2_EXCEPTIONS:
        lg[(w >= a) & (w <= b)] = v
    want = np.where(w == 0, top + 1, top - lg)
    got = hll._rho(torch.from_numpy(w << 4).to(device), 4).cpu().numpy()
    bad = int((got != want).sum())
    emit("rho_check", values=len(w), mismatches=bad, exceptions_applied=int(
        sum(b - a + 1 for a, b, _ in hll._LOG2_EXCEPTIONS)))
    if bad:
        raise AssertionError(f"_rho on {device} differs from the reference at {bad} values")
    return {"values": len(w), "mismatches": bad}


def run_sketch_queries(ctx, frame, cold=SKETCH_COLD, warm=SKETCH_WARM):
    """Each SKETCH_QUERIES entry through `ctx.sql`, `cold` + `warm` runs:
    bit-identical frames, the exact oracle, and one kernel launch per
    in-scope segment per run for every grouping set; one summary each."""
    import pandas as pd

    ds = ctx.catalog.get("lineorder")
    out, oracles = [], {}
    for name, sql in ssb.SKETCH_QUERIES.items():
        sets = _sketch_sets(ctx, name)
        t_query = time.perf_counter()
        before = cuda_groupby.LAUNCHES
        frames, times = [], []
        for _ in range(cold + warm):
            t0 = time.perf_counter()
            frames.append(ctx.sql(sql))
            times.append((time.perf_counter() - t0) * 1e3)
        launches = cuda_groupby.LAUNCHES - before
        for f in frames[1:]:
            pd.testing.assert_frame_equal(frames[0], f, check_exact=True)
        per_run = sum(len(segments_in_scope(q, ds)) for q in sets)
        lowered = [lower_groupby(q, ds) for q in sets]
        for lw in lowered:
            la = lw.la
            shape = (lw.num_groups, len(la.sum_names), len(la.min_names), len(la.max_names))
            if shape not in {s[1:] for s in MAIN_SHAPES}:
                raise AssertionError(f"{name}: kernel shape {shape} not checked in phase 3")
        on_card = ctx.engine.device.type == "cuda"
        if on_card and launches != per_run * (cold + warm):
            raise AssertionError(
                f"{name}: {launches} kernel launches, want {per_run} per run")
        runs_s = time.perf_counter() - t_query
        t0 = time.perf_counter()
        key = "cube" if name.startswith("cube") else name  # one answer for both cubes
        if key not in oracles:
            oracles[key] = ssb.sketch_oracle(frame, name)
        want = oracles[key]
        oracle_s = time.perf_counter() - t0
        out.append({
            "query": name,
            "grouping_sets": len(sets),
            "num_groups": [lw.num_groups for lw in lowered],
            "segments_per_run": per_run,
            "result_rows": len(frames[0]),
            "cold_ms": times[:cold],
            "p50_ms": statistics.median(times[cold:]),
            "kernel_launches": launches,
            **ssb.check_sketch_answer(name, frames[0], want),
            "runs_seconds": runs_s,
            "oracle_seconds": oracle_s,
            "bit_identical": True,
        })
        emit("sketch_query", **out[-1])
    return out


def _device_events_ms(prof):
    """Device time by kernel name (kernels, copies, memsets), summed from the
    profiler's raw device events: parsing a trace of a whole CUBE into
    `key_averages()` costs tens of seconds.  Raises when the window holds
    no device event."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            out[e.name()] = out.get(e.name(), 0.0) + e.duration_ns() / 1e6
    if not out:
        raise AssertionError("the profiler recorded no device time")
    return out


def profile_sketch_queries(ctx, summaries):
    """One more run of each sketch query under torch.profiler (device busy
    ms, idle share of the p50), and a replay of only its sketch partials
    and merges over its segments, in the engine's order, under the
    profiler: the sketch ops' device ms, by kernel."""
    from torch.profiler import ProfilerActivity, profile

    ds = ctx.catalog.get("lineorder")
    engine = ctx.engine
    for s in summaries:
        name = s["query"]
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ctx.sql(ssb.SKETCH_QUERIES[name])
        busy = sum(_device_events_ms(prof).values())
        by_kernel = {}
        for q in _sketch_sets(ctx, name):
            lowering = engine._lowering_for(q, ds)
            inputs = []
            for seg in segments_in_scope(q, ds):
                cols = lowering.add_virtual(dict(engine._cols_for_segment(
                    seg, ds, lowering.columns, QueryMetrics())))  # resident
                inputs.append((cols, *lowering.row_arrays(cols)[:2]))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                acc = {}
                for cols, gid, mask in inputs:
                    merge_sketch_states(lowering.la, acc, sketch_partials(lowering, cols, gid, mask))
                torch.cuda.synchronize()
            del inputs
            for k, v in _device_events_ms(prof).items():
                by_kernel[k] = by_kernel.get(k, 0.0) + v
        sketch_ms = sum(by_kernel.values())
        s.update(
            device_busy_ms=busy,
            device_idle_share=(1 - busy / s["p50_ms"]) if busy else None,
            sketch_ops_device_ms=sketch_ms,
            sketch_ops_top_kernels=sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5],
        )
        emit("sketch_profile", query=name, wall_p50_ms=s["p50_ms"], device_busy_ms=busy,
             device_idle_share=s["device_idle_share"], sketch_ops_device_ms=sketch_ms,
             sketch_ops_top_kernels=[(k[:60], v) for k, v in s["sketch_ops_top_kernels"]],
             seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ssb-scale", type=float, default=10.0)
    ap.add_argument("--tpch-scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    emit("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    lib = cuda_groupby.build()
    emit("build", seconds=time.perf_counter() - t0, library=lib.name,
         ptxas=[l for l in cuda_groupby.BUILD_LOG.splitlines() if "registers" in l])

    _, timed = kernel_phase(device)

    workloads = build_workloads(args.ssb_scale, args.tpch_scale)
    # one context per workload: its engine drives that workload through
    # phases 4 to 6, which share its residency
    ctxs = {w: TPUOlapContext(device=device) for w in ("ssb", "tpch")}
    engines = {w: c.engine for w, c in ctxs.items()}

    def resident():
        return sum(e.bytes_resident() for e in engines.values())

    torch.cuda.reset_peak_memory_stats(device)
    cuda_groupby.LAUNCHES = 0  # count only the main path's launches
    t0 = time.perf_counter()
    queries = run_main_path(engines, workloads)
    launches = cuda_groupby.LAUNCHES
    emit("main_path", queries=len(queries), seconds=time.perf_counter() - t0,
         kernel_launches=launches, bytes_resident=resident(),
         peak_device_bytes=torch.cuda.max_memory_allocated(device),
         ssb_scale=args.ssb_scale, tpch_scale=args.tpch_scale)
    if launches == 0:
        raise AssertionError("the main path never launched the kernel")
    profile_queries(engines, workloads, queries)

    reg_s = register_sql(ctxs, workloads)
    cuda_groupby.LAUNCHES = 0  # count only the SQL path's launches
    t0 = time.perf_counter()
    sql = run_sql_path(ctxs, workloads)
    sql_launches = sum(q["kernel_launches"] for q in sql)
    emit("sql", queries=len(sql), seconds=time.perf_counter() - t0,
         register_seconds=reg_s, kernel_launches=sql_launches,
         bytes_resident=resident(),
         peak_device_bytes=torch.cuda.max_memory_allocated(device))
    if sql_launches == 0:
        raise AssertionError("the SQL path never launched the kernel")

    t0 = time.perf_counter()
    ops = sketch_op_checks(ctxs["ssb"])
    rho = rho_check(device)
    checks_s = time.perf_counter() - t0
    cuda_groupby.LAUNCHES = 0  # count only the sketch path's launches
    sketches = run_sketch_queries(ctxs["ssb"], workloads["ssb"][1])
    sketch_launches = cuda_groupby.LAUNCHES
    profile_sketch_queries(ctxs["ssb"], sketches)
    emit("sketches", queries=len(sketches), seconds=time.perf_counter() - t0,
         checks_seconds=checks_s, op_checks=len(ops), rho_values=rho["values"], kernel_launches=sketch_launches,
         bytes_resident=resident(),
         peak_device_bytes=torch.cuda.max_memory_allocated(device))
    if sketch_launches == 0:
        raise AssertionError("the sketch path never launched the kernel")

    head = next(t for t in timed if t["shape"] == HEADLINE and not t["skewed"])
    print(json.dumps({"kernels": [{
        "name": "groupby_partial",
        "route": "cuda",
        "source": "spark_druid_olap_tpu_torch/csrc/groupby_partial.cu",
        "replaces": "spark_druid_olap_tpu/ops/pallas_groupby.py:65",
        "launches": launches + sql_launches + sketch_launches,
        "launches_native": launches,
        "launches_sql": sql_launches,
        "launches_sketch": sketch_launches,
        "max_abs_err": max(t["max_abs_err"] for t in timed),
        "max_rel_err": max(t["max_rel_err"] for t in timed),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "call_ms": head["call_ms"],
        "bound_share": head["bound_share"],
        "shape": head["shape"],
        "shapes": timed,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
