#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`spark_druid_olap_tpu_torch`).

    python3 chip_smoke.py [--ssb-scale 10] [--tpch-scale 1]

Needs one CUDA card; without one it exits non-zero and prints no result.
Phases, one JSON line each:

1. card: name and power limit from nvidia-smi, torch and CUDA versions;
2. build: compiles the group-by kernel from `csrc/` (nvcc, sm_90a);
3. kernel: the kernel against its plain PyTorch version on the card, at
   the reference kernel's test shapes, the all-masked case and main-path
   shapes (one 512K-row segment, G in {1, 12, 208, 4096}): mins/maxs
   exactly equal, sums within rtol 1e-5 (another summation order over
   512K rows), two launches bit-equal; at the main-path shapes, CUDA-event
   medians of the kernel, the plain version and one library call
   (`index_add_`) computing the same sums, beside the bound;
4. main path: SSB (SF10: 60M lineorder rows in 512K-row time-sorted
   segments, resident on the card) and TPC-H lineitem (SF1), the 13 SSB
   queries, TPC-H Q1, a Timeseries and a TopN through
   `Engine(device="cuda").execute`, each checked against a float64 pandas
   oracle (group keys and counts exact, sums within rtol 2e-5) and run
   twice for bit-identical frames; p50 of the warm runs, rows scanned per
   second, strategy and the kernel launches each query made;
5. profile: one more warm run of each query under torch.profiler, its
   device time by kernel and the device's idle share of the p50.

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

from spark_druid_olap_tpu_torch.exec.engine import Engine
from spark_druid_olap_tpu_torch.ops import cuda_groupby
from spark_druid_olap_tpu_torch.workloads import ssb, tpch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
F32_OPS_PER_S = 67e12  # H100 SXM published float32 rate outside tensor cores
KERNEL_RTOL = 1e-5
ORACLE_RTOL = 2e-5

# the reference kernel's test shapes (R, G, Ms, Mn, Mx)
TEST_SHAPES = [(4096, 12, 3, 0, 0), (8192, 300, 4, 2, 1), (8192, 700, 2, 1, 1), (1024, 1, 1, 0, 0)]
# one 512K-row SSB segment at the group counts of the main path
MAIN_SHAPES = [(524288, g, 4, 1, 1) for g in (1, 12, 208, 4096)]
HEADLINE_G = 208
WARM_RUNS = 5


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, default=str), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# -- phase 3: the kernel against its plain version ---------------------------


def make_inputs(R, G, Ms, Mn, Mx, device, seed=0, mask_p=0.8):
    rng = np.random.default_rng(seed)
    mask = rng.random(R) < mask_p
    arrs = (
        rng.integers(0, G, R).astype(np.int32),
        mask,
        (rng.random((R, Ms)) * 1000 * mask[:, None]).astype(np.float32),
        rng.random((R, Mn + Mx)).astype(np.float32),
        rng.random((R, Mn + Mx)) < 0.9,
    )
    return [torch.from_numpy(a).to(device) for a in arrs]


def cuda_ms(fn, reps: int = 20) -> float:
    """Median of `reps` CUDA-event timings of fn() after two warm-ups."""
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


def bound(R, G, Ms, Mn, Mx):
    """Least time the card could take: each input byte read once, each
    output written once, at the HBM rate; against one add or compare per
    row and column at the float32 rate.  Returns (ms, bound_by)."""
    nbytes = R * (4 + 1 + 4 * Ms + 5 * (Mn + Mx)) + 4 * G * (Ms + Mn + Mx)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = R * (Ms + Mn + Mx) / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel_shape(R, G, Ms, Mn, Mx, device, seed, mask_p=0.8):
    args = make_inputs(R, G, Ms, Mn, Mx, device, seed, mask_p)
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


def kernel_phase(device):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's product in full f32
    rows = []
    for i, shape in enumerate(TEST_SHAPES):
        _, max_abs, max_rel = check_kernel_shape(*shape, device, seed=i)
        rows.append({"shape": shape, "max_abs_err": max_abs, "max_rel_err": max_rel})
    check_kernel_shape(2048, 10, 2, 1, 1, device, seed=9, mask_p=0.0)
    rows.append({"shape": (2048, 10, 2, 1, 1), "all_masked": True})
    timed = []
    for i, (R, G, Ms, Mn, Mx) in enumerate(MAIN_SHAPES):
        args, max_abs, max_rel = check_kernel_shape(R, G, Ms, Mn, Mx, device, seed=100 + i)
        gid, mask, sv = args[:3]
        seg = torch.where(mask, gid.long(), torch.full_like(gid.long(), G))

        def library(seg=seg, sv=sv, G=G, Ms=Ms):
            return torch.zeros(G + 1, Ms, device=device).index_add_(0, seg, sv)

        b_ms, b_by = bound(R, G, Ms, Mn, Mx)
        timed.append({
            "shape": (R, G, Ms, Mn, Mx),
            "max_abs_err": max_abs,
            "max_rel_err": max_rel,
            "ms": cuda_ms(lambda: cuda_groupby.cuda_partial_aggregate(
                *args, num_groups=G, num_min=Mn, num_max=Mx)),
            "plain_ms": cuda_ms(lambda: cuda_groupby.plain_partial_aggregate(*args, G, Mn, Mx)),
            "library_ms": cuda_ms(library),
            "bound_ms": b_ms,
            "bound_by": b_by,
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


def check_against_oracle(name, got, frame, workload):
    if workload == "tpch":
        want = tpch.oracle(frame, name)
        return _frame_check(name, got[list(want.columns)], want, ["l_returnflag", "l_linestatus"])
    want = ssb.oracle(frame, name)
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
    emit(
        "data", ssb_scale=ssb_scale, ssb_rows=ssb_ds.num_rows,
        ssb_segments=len(ssb_ds.segments), tpch_scale=tpch_scale,
        tpch_rows=tpch_ds.num_rows, tpch_segments=len(tpch_ds.segments),
        seconds=time.perf_counter() - t0,
    )
    return {"ssb": (ssb_ds, ssb_frame), "tpch": (tpch_ds, tpch_frame)}


def main_path_queries():
    return (
        [("ssb", n, q) for n, q in ssb.NATIVE_QUERIES.items()]
        + [("tpch", "q1", tpch.NATIVE_QUERIES["q1"])]
        + [("ssb", "timeseries", ssb.TIMESERIES_QUERY), ("ssb", "topn", ssb.TOPN_QUERY)]
    )


def run_main_path(engine: Engine, workloads, warm_runs: int = WARM_RUNS):
    """Drive every query of the main path; returns one summary per query."""
    import pandas as pd

    out = []
    for workload, name, q in main_path_queries():
        ds, frame = workloads[workload]
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


def profile_queries(engine: Engine, workloads, summaries):
    """One more warm run of each query under torch.profiler: device time by
    kernel, the group-by kernel's share, and the device's idle share of the
    query's unprofiled p50 wall time."""
    from torch.profiler import ProfilerActivity, profile

    p50 = {s["query"]: s["p50_ms"] for s in summaries}
    for workload, name, q in main_path_queries():
        ds, _ = workloads[workload]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.execute(q, ds)
        # device-side events only (kernels, copies): an aten op's average
        # repeats its kernels' device time
        dev = {
            e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
        }
        busy = sum(dev.values())
        groupby = sum(v for k, v in dev.items() if "partial_pass" in k or "finish_pass" in k)
        emit(
            "profile", query=name, wall_p50_ms=p50[name], device_busy_ms=busy,
            groupby_kernel_ms=groupby,
            device_idle_share=(1 - busy / p50[name]) if busy else None,
            top_device_ms=sorted(dev.items(), key=lambda kv: -kv[1])[:4],
        )


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
    engine = Engine(device=device)
    torch.cuda.reset_peak_memory_stats(device)
    cuda_groupby.LAUNCHES = 0  # count only the main path's launches
    t0 = time.perf_counter()
    queries = run_main_path(engine, workloads)
    launches = cuda_groupby.LAUNCHES
    emit("main_path", queries=len(queries), seconds=time.perf_counter() - t0,
         kernel_launches=launches, bytes_resident=engine.bytes_resident(),
         peak_device_bytes=torch.cuda.max_memory_allocated(device),
         ssb_scale=args.ssb_scale, tpch_scale=args.tpch_scale)
    if launches == 0:
        raise AssertionError("the main path never launched the kernel")
    profile_queries(engine, workloads, queries)

    head = next(t for t in timed if t["shape"][1] == HEADLINE_G)
    print(json.dumps({"kernels": [{
        "name": "groupby_partial",
        "route": "cuda",
        "source": "spark_druid_olap_tpu_torch/csrc/groupby_partial.cu",
        "replaces": "spark_druid_olap_tpu/ops/pallas_groupby.py:65",
        "launches": launches,
        "max_abs_err": max(t["max_abs_err"] for t in timed),
        "max_rel_err": max(t["max_rel_err"] for t in timed),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
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
