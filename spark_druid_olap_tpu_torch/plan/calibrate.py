"""Measure the cost model's constants on the device the port runs on.

It times what the engine dispatches (the dense class at the row counts it
dispatches, a 512K-row segment and a quarter of one; the eager classes on a
card at 16 times those, see below):

* the dense class: on a card the hand-written kernel through
  `ops/cuda_groupby.cuda_partial_aggregate` (never its plain version), on
  the CPU that plain version, at two row counts and two domains of at most
  4096 groups -> `cost_per_row_dense` (us per row per tile) and
  `dense_tile_groups` (the tile width that fits the G-dependence);
* the `index_add_` scatter (`ops/groupby.scatter_partial_aggregate`) at
  `scatter_lo_groups` and `scatter_hi_groups` -> `cost_per_row_scatter`,
  `cost_per_row_scatter_hi`; a zeroed state of G groups and the fold's
  pass over it at both domains -> `cost_per_group_state`;
* the sparse tier's sort-reduce over 4096 slots
  (`ops/sparse_groupby.sparse_partial_aggregate`, the kernel inside on a
  card) and its compaction pass (`compact_rows`) -> `cost_per_row_sparse`,
  `cost_per_row_compact`;
* one near-empty launch and its sync -> `cost_dispatch_us`;
* a host-to-device copy from page-locked memory, the copy
  `exec/pipeline.TransferPipeline.put` makes -> `h2d_bytes_per_s`;
* on two or more distinct cards, the mesh's merge (`parallel/mesh.py`
  `reduce_states`) of a [4096, 64] float32 state (1 MiB) a card, against
  the same call with a one-float state (the collective's fixed latency),
  each salted so no repeat is a cached answer ->
  `collective_bytes_per_us` (the ring's 2(n - 1)/n of the state over the
  difference).  On one card it stays unmeasured (None, and the file's
  `collective` says why): the config keeps its data-sheet default;
* on the host, the two constants of the device assist's decision: the host
  fallback's vectorized grouped pass (`exec/fallback._vectorized_set`: a
  pandas groupby of one key with a sum and its count) per input row, over
  a quarter as many groups as rows (the shape whose decision is close) ->
  `cost_per_row_interp`; and the engine's fetch, decode and frame build
  (`exec/finalize.finalize_groupby`) per result group ->
  `cost_per_group_decode`.

Each per-row constant is the slope between two sizes, so the fixed cost of
a launch and its sync cancels; each time is the least of timed repeats
after a warm-up (the host's jitter only adds time; the dispatch's and the
link's time is the median), each repeat ending in a 4-byte fetch that
proves the work finished, over several launches rotated across input
copies larger than the card's L2 together (a segment's columns come from
HBM).  The paths run
as the engine runs them warm: on a card the dense class's launches are
captured once into a CUDA graph and each repeat is one replay (the arena's
warm path; eager launches from Python would time the host, not the card),
while the scatter, the sparse tier and the compaction, which sync with the
host or size their work from the data, run eagerly as the engine's loop
runs them, on a card at 16x the rows (2^23 and 2^21), where their device
work and not the host's launch and sync sets the time (at a segment's rows
the host hides it, and the slope sat under the host's jitter).  The file
records each constant's spread: the least and the most slope that any two
repeats, one at each size, give, unguarded (`spread`).  On a card the
result is written to the committed
`calibration.torch_cuda.json` at the repository root, with the card's name
and power limit; `SessionConfig.load_calibrated` applies a file only on a
device of the same name.  On the CPU it is printed, and written only to
`--out` (the CPU's profile is built into
`SessionConfig.apply_platform_profile`).

    python -m spark_druid_olap_tpu_torch.plan.calibrate [--device cpu]
        [--out PATH] [--rows N] [--launches K] [--budget-s S]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import _REPO_ROOT, SessionConfig, calibration_device, device_name
from ..ops.groupby import SCATTER_CUTOVER, partial_aggregate, scatter_partial_aggregate
from ..ops.sparse_groupby import SPARSE_SLOTS, compact_rows, sparse_partial_aggregate


def sidecar_path(platform: str, root: Optional[str] = None) -> str:
    """`calibration.<platform>.json` in `root` (default: the repository
    root), the one place the per-platform file name is made: a card's run
    writes `sidecar_path("torch_cuda")`, which is `config.CUDA_CALIBRATION`,
    the file `SessionConfig.load_calibrated` reads on a card."""
    return os.path.join(root if root is not None else _REPO_ROOT,
                        "calibration.%s.json" % platform)


# input copies a timed repeat rotates through: 8 segment-sized copies hold
# about 55 MB at 2^19 rows, past the H100's 50 MB L2
COPIES = 8
# on a card the eager classes run at this many times the rows, where their
# device work, not the host's launch and sync, sets the time
EAGER_ROWS_FACTOR = 16


def _repeat_times(fn, reps: int = 3) -> List[float]:
    """Wall seconds of `reps` runs of `fn(salt)`, in order, after one
    warm-up run (a kernel's first call builds it).  `fn` returns a scalar
    tensor that each repeat fetches to the host (4 bytes): the fetch waits
    for the work, so the time is the work's and not its enqueue."""
    fn(0).item()
    ts = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn(i + 1).item()
        ts.append(time.perf_counter() - t0)
    return ts


def _timeit_synced(fn, reps: int = 3) -> float:
    """Median wall seconds of `reps` runs of `fn(salt)` (`_repeat_times`)."""
    return float(np.median(_repeat_times(fn, reps)))


def _slope_or_fallback(t_hi: float, t_lo: float, n_hi: int, n_lo: int, t_rtt: float,
                       floor: float = 1e-6) -> float:
    """Per-unit cost in us from the slope between two sizes.  An inverted or
    implausible slope (below `floor`: the size step sat under the timer's
    jitter) never persists as "this is free": the single point at the
    larger size less the measured round trip stands in."""
    slope = (t_hi - t_lo) * 1e6 / max(n_hi - n_lo, 1)
    if slope < floor:
        slope = max((t_hi - t_rtt) * 1e6 / n_hi, floor)
    return slope


def _slope_us_per_row(fn, n_hi: int, n_lo: int, reps: int, t_rtt: float,
                      floor: float = 1e-6, launches: int = 1) -> Tuple[float, List[float]]:
    """Per-unit cost in us of `fn(n, salt)`, which runs `launches` passes over
    `n` units, from the slope between the least times at `n_hi` and `n_lo`
    (the host's jitter only adds time, so the least repeat is the one it
    disturbed least); and the constant's spread, the least and the most
    slope that any repeat at `n_hi` and any at `n_lo` give together, as
    measured (no guard: a spread reaching 0 or below says the size step
    sat under the jitter)."""
    hi = _repeat_times(lambda s: fn(n_hi, s), reps)
    lo = _repeat_times(lambda s: fn(n_lo, s), reps)
    N_hi, N_lo = launches * n_hi, launches * n_lo
    slope = _slope_or_fallback(min(hi), min(lo), N_hi, N_lo, t_rtt, floor)
    per_unit = 1e6 / max(N_hi - N_lo, 1)
    return slope, [(min(hi) - max(lo)) * per_unit, (max(hi) - min(lo)) * per_unit]


def _clamp_bandwidth(bytes_per_s: float) -> float:
    """A measured bandwidth kept inside physical reality: nothing here moves
    more than 2 TB/s, and under 1 MB/s the measurement, not the link,
    failed."""
    return min(max(bytes_per_s, 1e6), 2e12)


def _replayed(fn, dev):
    """`fn(n, salt)` as the arena runs a warm scope on a card: the work at
    each `n` captured once into a CUDA graph (after a warm-up run on the
    capturing stream), every call one replay whose launches are counted as
    a replay's (`cuda_groupby.count_replay`)."""
    from ..ops import cuda_groupby

    graphs = {}

    def run(n, salt):
        if n not in graphs:
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                fn(n, 0)
            graph = torch.cuda.CUDAGraph()
            with cuda_groupby.capture_launches() as launched, torch.cuda.stream(stream):
                graph.capture_begin()
                out = fn(n, 0)
                graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(stream)
            graphs[n] = (graph, out, list(launched))
        graph, out, launched = graphs[n]
        graph.replay()
        cuda_groupby.count_replay(launched)
        return out + salt

    return run


def power_limit(device) -> Optional[str]:
    """The card's power limit as `nvidia-smi` reports it ("700.00 W"), or
    None on the CPU or where `nvidia-smi` cannot say."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(index)], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None if out.returncode == 0 else None


def host_constants(rows: int, reps: int, rng, dev) -> Tuple[Dict, Dict]:
    """The device assist's two host constants (us), and their spreads:
    `cost_per_row_interp`, the host fallback interpreting an Aggregate
    subtree (`exec/fallback.execute_fallback` of `SELECT k, SUM(v), COUNT(*)
    ... GROUP BY k`, warm: the decoded frame cached) over `4 * rows` and
    `rows` input rows, each keyed over a quarter as many groups as rows;
    and `cost_per_group_decode`, the engine's fetch of a [G, 2] state from
    `dev`, its decode and frame build (`finalize_groupby` of a
    one-dimension GroupBy with a count and a sum) at G = `rows` and
    `rows // 4`, every group present."""
    from ..catalog.cache import MetadataCache
    from ..catalog.segment import DimensionDict, build_datasource
    from ..exec.fallback import evict_decoded_segments, execute_fallback
    from ..exec.finalize import finalize_groupby
    from ..exec.lowering import lower_groupby
    from ..models import aggregations as A
    from ..models.dimensions import DimensionSpec
    from ..models.query import GroupByQuery
    from ..sql.parser import parse_sql

    def table(name, n, g):
        """A table of `n` rows keyed over `g` codes of a dimension `k`, and a
        metric `v`."""
        return build_datasource(
            name, {"k": rng.integers(0, g, size=n).astype(np.int32),
                   "v": rng.random(n).astype(np.float32)}, ["k"], ["v"],
            dicts={"k": DimensionDict(values=tuple(range(g)))})

    catalog = MetadataCache()
    plans = {}
    for n in (4 * rows, rows):
        catalog.put(table(f"interp{n}", n, max(1, n // 4)))
        plans[n] = parse_sql(f"SELECT k, SUM(v) AS s, COUNT(*) AS c FROM interp{n} GROUP BY k")[0]

    def interp(n, salt):
        return torch.tensor(float(len(execute_fallback(plans[n], catalog))) + salt)

    try:
        interp_us, interp_spread = _slope_us_per_row(interp, 4 * rows, rows, reps, 0.0)
    finally:
        evict_decoded_segments(s.uid for n in plans
                               for s in catalog.get(f"interp{n}").segments)

    def lowered(g):
        codes = np.arange(g, dtype=np.int32)
        ds = build_datasource(
            f"decode{g}", {"k": codes, "v": np.ones(g, np.float32)}, ["k"], ["v"],
            dicts={"k": DimensionDict(values=tuple(range(g)))})
        q = GroupByQuery(datasource=ds.name, dimensions=(DimensionSpec("k"),),
                         aggregations=(A.Count("n"), A.DoubleSum("s", "v")))
        return q, lower_groupby(q, ds)

    cases = {g: lowered(g) for g in (rows, max(1, rows // 4))}
    states = {g: torch.ones((g, len(low.la.sum_names)), dtype=torch.float32, device=dev)
              for g, (_, low) in cases.items()}

    def decode(g, salt):
        q, low = cases[g]
        la = low.la
        state = states[g]
        sums = state.cpu().numpy()
        mins = np.zeros((g, len(la.min_names)), np.float32)
        maxs = np.zeros((g, len(la.max_names)), np.float32)
        df = finalize_groupby(q, low.dims, la, sums, mins, maxs, {})
        return torch.tensor(float(len(df)) + salt)

    decode_us, decode_spread = _slope_us_per_row(decode, rows, max(1, rows // 4), reps, 0.0)
    return ({"cost_per_row_interp": interp_us, "cost_per_group_decode": decode_us},
            {"cost_per_row_interp": interp_spread, "cost_per_group_decode": decode_spread})


def collective_rate(cards: int, rng, reps: int = 5) -> float:
    """Bytes per us of the mesh's merge across `cards` distinct cards: the
    sum-merge (`parallel/mesh.reduce_states`) of a [4096, 64] float32
    state per card, less the same merge of one float (its fixed latency),
    the ring's 2(n - 1)/n of a state over the difference.  The salt rides
    into every state, so no repeat merges the same bytes."""
    from ..parallel.mesh import reduce_states

    devs = [torch.device("cuda", i) for i in range(cards)]
    g, m = 4096, 64
    states = [torch.from_numpy(rng.random((g, m)).astype(np.float32)).to(d) for d in devs]
    tiny = [torch.zeros(1, device=d) for d in devs]

    def merge(parts, salt):
        return reduce_states([p + salt for p in parts], "sum").reshape(-1)[-1:]

    t_full = _timeit_synced(lambda s: merge(states, s), reps=max(reps, 5))
    t_base = _timeit_synced(lambda s: merge(tiny, s), reps=max(reps, 5))
    moved = 2.0 * (cards - 1) / cards * g * m * 4
    return moved / (max(t_full - t_base, 1e-7) * 1e6)


def calibrate(
    rows: int = 1 << 19,
    groups: int = 1024,
    wide: int = 1 << 20,
    save_path: Optional[str] = None,
    budget_s: Optional[float] = None,
    device=None,
    dense_groups=(256, SCATTER_CUTOVER),
    launches: int = COPIES,
    reps: int = 5,
) -> Dict:
    """Measure the constants on `device` (default: the card, else the CPU)
    and write them to `save_path` (default: on a card the committed
    `calibration.torch_cuda.json`, on the CPU nothing; "" writes nothing).
    `rows` is the larger row count of each slope (the smaller is a quarter
    of it); `groups` and `wide` the scatter's two domains; `dense_groups`
    the dense class's two domains (at most 4096).  A repeat makes
    `launches` launches.  The eager classes run at EAGER_ROWS_FACTOR x
    `rows` and a quarter of it on a card (`rows` and a quarter on the CPU),
    over half as many input copies.  `budget_s` caps
    the wall time: once it passes, the remaining steps are skipped, their
    constants written as None (`load_calibrated` keeps the device's
    defaults for them) and the file marked `"partial": true`."""
    dev = calibration_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if max(dense_groups) > SCATTER_CUTOVER:
        raise ValueError(f"the dense class takes at most {SCATTER_CUTOVER} groups")
    deadline = time.perf_counter() + budget_s if budget_s is not None else None

    def over() -> bool:
        return deadline is not None and time.perf_counter() > deadline

    # the one-hot class on this device: the kernel on a card, its plain
    # version on the CPU (the engine's own resolution)
    kernel_class = "cuda" if dev.type == "cuda" else "dense"
    rows_lo = max(1024, rows // 4)
    copies = max(1, launches)
    eager_rows = EAGER_ROWS_FACTOR * rows if dev.type == "cuda" else rows
    eager_lo = max(1024, eager_rows // 4)
    rng = np.random.default_rng(0)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    def inputs(domain: int, present: Optional[np.ndarray] = None, sel: float = 1.0,
               n: int = rows, k: int = copies):
        """`k` input sets of `n` rows: gid over `domain` (or drawn from the
        `present` codes), a mask keeping `sel` of the rows, two sum
        columns, no min or max."""
        out = []
        for _ in range(k):
            g = (rng.integers(0, domain, size=n) if present is None
                 else present[rng.integers(0, len(present), size=n)])
            mask = np.ones(n, bool) if sel >= 1.0 else rng.random(n) < sel
            out.append((put(g.astype(np.int32)), put(mask),
                        put(rng.random((n, 2)).astype(np.float32)),
                        torch.zeros((n, 0), dtype=torch.float32, device=dev),
                        torch.zeros((n, 0), dtype=torch.bool, device=dev)))
        return out

    def eager_inputs(domain: int, present: Optional[np.ndarray] = None, sel: float = 1.0):
        return inputs(domain, present, sel, n=eager_rows, k=max(1, copies // 2))

    def rotated(sets, body, k):
        """fn(n, salt): `k` passes of `body` over the first `n` rows of each
        input set in turn, reduced to one scalar on the device."""
        def fn(n, salt):
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(k):
                a = sets[i % len(sets)]
                acc = acc + body(*(t[:n] for t in a))
            return acc + salt
        return fn

    def first_sum(out):
        return out[0].sum() if isinstance(out, tuple) else out["sums"].sum()

    spread = {}

    def slope(name, fn, n_hi, n_lo, k, floor=1e-6):
        value, spread[name] = _slope_us_per_row(fn, n_hi, n_lo, reps, t_rtt, floor, k)
        return value

    # one near-empty launch and its sync: the fixed cost of a dispatch
    tiny = torch.ones(64, dtype=torch.float32, device=dev)
    rtt = _repeat_times(lambda s: tiny.sum() + s, max(4 * reps, 21))
    t_rtt = float(np.median(rtt))
    measured = {"cost_dispatch_us": t_rtt * 1e6}
    spread["cost_dispatch_us"] = [min(rtt) * 1e6, max(rtt) * 1e6]

    # the dense class at two domains; the tile width is the one whose
    # ceil(G / W) ratio matches the two domains' per-row ratio
    g_lo, g_hi = sorted(dense_groups)
    per_row = {}
    for g in (g_lo, g_hi):
        sets = inputs(g)
        fn = rotated(sets, lambda *a, g=g: first_sum(partial_aggregate(
            *a, num_groups=g, num_min=0, num_max=0, strategy=kernel_class)), launches)
        if dev.type == "cuda":
            fn = _replayed(fn, dev)
        per_row[g] = slope(f"per_row_dense_at_{g}", fn, rows, rows_lo, launches)
        del sets, fn
    ratio = max(1.0, per_row[g_hi] / per_row[g_lo])
    tile = int(min(g_hi, max(1, round(g_hi / ratio))))
    measured["dense_tile_groups"] = tile
    tiles_lo = max(1, -(-g_lo // tile))
    measured["cost_per_row_dense"] = per_row[g_lo] / tiles_lo
    spread["cost_per_row_dense"] = [v / tiles_lo for v in spread[f"per_row_dense_at_{g_lo}"]]

    # the scatter at its two domains, per row from the slopes; it syncs
    # (it sizes its work from the mask), so it runs eagerly
    def scatter_fn(domain):
        return rotated(eager_inputs(domain), lambda *a: first_sum(scatter_partial_aggregate(
            *a, num_groups=domain, num_min=0, num_max=0)), launches)

    scatter = slope("cost_per_row_scatter", scatter_fn(groups), eager_rows, eager_lo, launches)
    measured["cost_per_row_scatter"] = scatter
    measured["cost_per_row_scatter_hi"] = None
    measured["cost_per_group_state"] = None
    if not over():
        measured["cost_per_row_scatter_hi"] = slope(
            "cost_per_row_scatter_hi", scatter_fn(wide), eager_rows, eager_lo, launches,
            floor=scatter)
        # per group of state: a zeroed [G, 2] state and the fold's pass over
        # it, the slope between the two domains (the reference takes the
        # difference of the scatter's intercepts, which sat below the timer's
        # jitter on a card)
        def state(g, salt):
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for _ in range(launches):
                acc = acc + torch.zeros((g, 2), dtype=torch.float32, device=dev).sum()
            return acc + salt

        fn = _replayed(state, dev) if dev.type == "cuda" else state
        measured["cost_per_group_state"] = slope(
            "cost_per_group_state", fn, wide, groups, launches, floor=1e-9)

    # the sparse tier's sort-reduce over its 4096 slots: every row sorted,
    # the kernel (or its plain version) over the slots; SPARSE_SLOTS codes
    # of the wide domain are present, so the slots hold them all
    measured["cost_per_row_sparse"] = None
    if not over():
        present = np.sort(rng.choice(wide, size=SPARSE_SLOTS, replace=False))
        fn = rotated(eager_inputs(wide, present=present), lambda *a: first_sum(
            sparse_partial_aggregate(*a, num_groups=wide, num_min=0, num_max=0,
                                     slots=SPARSE_SLOTS, inner_strategy=kernel_class)),
            launches)
        # a sort cannot beat a quarter of a scatter pass over the same rows
        measured["cost_per_row_sparse"] = slope(
            "cost_per_row_sparse", fn, eager_rows, eager_lo, launches, floor=scatter / 4)
        del fn

    # the compaction pass ahead of the sort (1% of the rows kept), floored
    # at the scatter's per-row cost: it reads at least as much
    measured["cost_per_row_compact"] = None
    if not over():
        sel = 0.01
        cap = max(4096, int(eager_rows * sel * 2))
        fn = rotated(eager_inputs(wide, sel=sel),
                     lambda *a: compact_rows(*a, capacity=cap)[2].sum(), launches)
        measured["cost_per_row_compact"] = max(
            slope("cost_per_row_compact", fn, eager_rows, eager_lo, launches), scatter)
        del fn
    elif measured["cost_per_row_compact"] is None:
        measured["cost_per_row_compact"] = scatter

    # the link: 64 MiB and 16 MiB copies from page-locked memory (on the
    # CPU a copy between host buffers), the slope in bytes
    measured["h2d_bytes_per_s"] = None
    if not over():
        big, small = 1 << 24, 1 << 22
        host = torch.from_numpy(rng.random(big).astype(np.float32))
        if dev.type == "cuda":
            host = host.pin_memory()

        def h2d(n, salt):
            return host[:n].to(dev, non_blocking=True, copy=True)[-1] + salt

        t_b = _timeit_synced(lambda s: h2d(big, s), reps=max(reps, 5))
        t_s = _timeit_synced(lambda s: h2d(small, s), reps=max(reps, 5))
        bw = _clamp_bandwidth((big - small) * 4 / max(t_b - t_s, 1e-9))
        if bw >= 2e12:  # an inverted slope: the single point less the round trip
            bw = _clamp_bandwidth(big * 4 / max(t_b - t_rtt, 1e-9))
        measured["h2d_bytes_per_s"] = bw

    # the mesh's merge across distinct cards
    measured["collective_bytes_per_us"] = None
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    collective = f"unmeasured: {cards if dev.type == 'cuda' else 'no'} card(s), it needs two"
    if cards > 1 and not over():
        measured["collective_bytes_per_us"] = collective_rate(cards, rng, reps)
        collective = f"measured across {cards} cards"

    # the host's two constants of the device assist
    measured["cost_per_row_interp"] = measured["cost_per_group_decode"] = None
    if not over():
        host_measured, host_spread = host_constants(rows, reps, rng, dev)
        measured.update(host_measured)
        spread.update(host_spread)

    out = dict(measured)
    out.update({
        "rows": rows,
        "rows_lo": rows_lo,
        "launches": launches,
        "eager_rows": eager_rows,
        "eager_rows_lo": eager_lo,
        "groups": groups,
        "scatter_lo_groups": groups,
        "scatter_hi_groups": wide,
        "dense_groups": [g_lo, g_hi],
        "per_row_dense_at": {str(g): v for g, v in per_row.items()},
        "device": device_name(dev),
        "power_limit": power_limit(dev),
        "platform": dev.type,
        "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "collective": collective,
        "torch": torch.__version__,
        "kernel_class": kernel_class,
        # per-row constants are slopes between the least of `reps` timed
        # repeats at `rows` and at `rows_lo`, after a warm-up, each repeat
        # proven finished by a 4-byte fetch (the dispatch and the link: the
        # median of the repeats); on a card the dense
        # class is timed by graph replays; `spread` holds each measured
        # slope's least and most over any two repeats, one at each size (us)
        "samples_per_constant": reps,
        "dense_timing": "graph replay" if dev.type == "cuda" else "eager",
        "spread": spread,
        "budget_s": budget_s,
        "partial": bool(over()),
    })
    if save_path is None and dev.type == "cuda":
        save_path = sidecar_path("torch_cuda")
    if save_path:
        with open(save_path, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default when present) or cpu")
    ap.add_argument("--out", default=None, help="the file to write (default: on a card "
                    "calibration.torch_cuda.json at the repository root; on the CPU none)")
    ap.add_argument("--rows", type=int, default=1 << 19)
    ap.add_argument("--launches", type=int, default=COPIES)
    ap.add_argument("--budget-s", type=float, default=None)
    args = ap.parse_args(argv)
    out = calibrate(rows=args.rows, save_path=args.out, budget_s=args.budget_s,
                    device=args.device, launches=args.launches)
    print(json.dumps(out, indent=1))
    cfg = SessionConfig.load_calibrated(path=args.out, device=args.device)
    print(json.dumps({"calibration_meta": cfg.calibration_meta}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
