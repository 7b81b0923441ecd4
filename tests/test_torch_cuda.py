"""The hand-written CUDA kernel, and the sketch ops, on the card.

Every test here needs a CUDA card (the kernel has no CPU mode; the sketch
ops are held against their own CPU runs), carries the `cuda` marker and
skips without one.  The file imports only the PyTorch
port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: mins and maxs exactly equal to the plain version; sums within
rtol 1e-5 (the kernel sums in another order over up to 512K rows); two
launches bit-equal; engine frames on the card against the CPU within the
parity bound rtol 2e-5.  Sketch states (HLL registers, theta hash sets,
quantile samples) and `_rho` on the card are bit-equal to the CPU's, and
so are the sketch columns of the sketch queries' frames.  A stream on the
card against the same stream on the CPU: keys and counts equal, sums within
rtol 1e-6; bit-identical with double buffering on and off.  A query
scope's CUDA graph (the arena) gives the eager loop's bits, and each replay
counts the launches it captured; a capture succeeds over a lowering the
lowering cache rebuilt after the scope's first run; a column that leaves
the residency cache drops the graphs that read it.  Cold columns come from
pinned host copies kept per column, with the pageable copies' bits.
Resilience: under an injected deadline the chunked replays (one graph per
segment) give the loop's bits at every truncation point and the whole
graph's past the last; a retry after a transient failure evicts the graphs
and columns and replays none of them; a refused launch or a failed capture
raises KernelError without a retry.  The cost model: the calibration at
small rows measures every constant on the card (the dense class through
the kernel, by graph replays) and names the card; the dense class is never
priced, planned or run above 4096 groups on a card.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.exec.arena import arena_disabled
from spark_druid_olap_tpu_torch.exec.engine import Engine
from spark_druid_olap_tpu_torch.exec.lowering import sketch_ops
from spark_druid_olap_tpu_torch.exec.streaming import StreamExecutor
from spark_druid_olap_tpu_torch.models import aggregations as A
from spark_druid_olap_tpu_torch.models import filters as F
from spark_druid_olap_tpu_torch.models import query as Q
from spark_druid_olap_tpu_torch.models.dimensions import DimensionSpec
from spark_druid_olap_tpu_torch.ops import cuda_groupby as cg
from spark_druid_olap_tpu_torch.ops import hll
from spark_druid_olap_tpu_torch.utils import datagen
from spark_druid_olap_tpu_torch.workloads import ssb, tpch

pytestmark = pytest.mark.cuda

SHAPES = [
    (4096, 12, 3, 0, 0),
    (8192, 300, 4, 2, 1),
    (8192, 700, 2, 1, 1),
    (1024, 1, 1, 0, 0),
    (524288, 4096, 4, 1, 1),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mk(R, G, Ms, Mn, Mx, device, seed=0, mask_p=0.8):
    rng = np.random.default_rng(seed)
    mask = rng.random(R) < mask_p
    arrs = (
        rng.integers(0, G, R).astype(np.int32),
        mask,
        (rng.random((R, Ms)) * mask[:, None]).astype(np.float32),
        rng.random((R, Mn + Mx)).astype(np.float32),
        rng.random((R, Mn + Mx)) < 0.9,
    )
    return [torch.from_numpy(a).to(device) for a in arrs]


def _held_to_plain(arrs, G, Mn, Mx):
    before = cg.LAUNCHES
    got = cg.cuda_partial_aggregate(*arrs, num_groups=G, num_min=Mn, num_max=Mx)
    again = cg.cuda_partial_aggregate(*arrs, num_groups=G, num_min=Mn, num_max=Mx)
    want = cg.plain_partial_aggregate(*arrs, G, Mn, Mx)
    torch.cuda.synchronize()
    assert cg.LAUNCHES == before + 2
    for a, b in zip(got, again):
        # bit-identical run to run (NaN compares equal to NaN here)
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
    np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].cpu().numpy())
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=1e-5)


@pytest.mark.parametrize("R,G,Ms,Mn,Mx", SHAPES)
def test_kernel_matches_plain(card, R, G, Ms, Mn, Mx):
    _held_to_plain(_mk(R, G, Ms, Mn, Mx, card, seed=6), G, Mn, Mx)


def _sorted_runs(gid, G, runs):
    """gid in `runs` sorted runs: a time-sorted segment spans a few groups."""
    R = gid.shape[0]
    return np.minimum(np.arange(R) * runs // R + G // 2, G - 1).astype(np.int32)


# (R, G, Ms, Mn, Mx, gid layout): each is a regime or an edge of the design
LAYOUTS = {
    "one_group": (65536, 12, 2, 1, 1, lambda g, G: np.full_like(g, 5)),
    "sorted_runs": (65536, 84, 2, 0, 0, lambda g, G: _sorted_runs(g, G, 2)),
    "sorted_many_runs": (65536, 208, 2, 1, 1, lambda g, G: np.sort(g)),
    "lane_edge": (65536, 48, 2, 0, 0, None),
    "warp_edge_low": (65536, 49, 2, 0, 0, None),
    "warp_edge": (65536, 1024, 2, 0, 0, None),
    "shared_edge": (65536, 1025, 2, 0, 0, None),
    "two_column_blocks": (65536, 12, 8, 1, 1, None),
    "short_last_chunk": (3072, 10, 2, 1, 1, None),
    "shared_short_last_chunk": (5120, 3000, 2, 1, 1, None),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_layouts_match_plain(card, layout):
    R, G, Ms, Mn, Mx, gid_fn = LAYOUTS[layout]
    arrs = _mk(R, G, Ms, Mn, Mx, card, seed=11)
    if gid_fn is not None:
        arrs[0] = torch.from_numpy(gid_fn(arrs[0].cpu().numpy(), G)).to(card)
    geo = cg.geometry(R, G, Ms, Mn + Mx)
    regime = {"lane_edge": "lane", "warp_edge_low": "warp", "warp_edge": "warp",
              "shared_edge": "block", "shared_short_last_chunk": "block"}.get(layout)
    assert regime in (None, geo.regime)
    if layout == "two_column_blocks":
        assert Ms + Mn + Mx > geo.cols
    if "short_last_chunk" in layout:
        assert R % geo.chunk_rows
    _held_to_plain(arrs, G, Mn, Mx)


def test_kernel_nan_in_minmax(card):
    gid, mask, sv, mmv, mmm = _mk(8192, 30, 2, 2, 2, card, seed=12)
    mmv[::97, 1] = float("nan")
    mmv[5::131, 2] = float("nan")
    _held_to_plain([gid, mask, sv, mmv, mmm], 30, 2, 2)
    mins = cg.cuda_partial_aggregate(gid, mask, sv, mmv, mmm, num_groups=30,
                                     num_min=2, num_max=2)[1]
    assert bool(torch.isnan(mins[:, 1]).any())


def test_kernel_all_masked(card):
    gid, mask, sv, mmv, mmm = _mk(2048, 10, 2, 1, 1, card, mask_p=0.0)
    sums, mins, maxs = cg.cuda_partial_aggregate(
        gid, mask, sv, mmv, mmm, num_groups=10, num_min=1, num_max=1
    )
    assert float(sums.abs().sum()) == 0.0
    assert bool(torch.isposinf(mins).all()) and bool(torch.isneginf(maxs).all())


def test_kernel_rejects_bad_inputs(card):
    gid, mask, sv, mmv, mmm = _mk(2048, 8, 2, 1, 1, card)
    kw = dict(num_groups=8, num_min=1, num_max=1)
    with pytest.raises(TypeError):
        cg.cuda_partial_aggregate(gid.long(), mask, sv, mmv, mmm, **kw)
    with pytest.raises(ValueError):
        cg.cuda_partial_aggregate(gid, mask, sv.t().contiguous().t(), mmv, mmm, **kw)
    with pytest.raises(ValueError):
        cg.cuda_partial_aggregate(gid, mask.cpu(), sv, mmv, mmm, **kw)
    with pytest.raises(ValueError):
        cg.cuda_partial_aggregate(gid, mask, sv, mmv, mmm, num_groups=5000,
                                  num_min=1, num_max=1)


def test_engine_on_card_matches_cpu(card):
    cols, dicts = ssb.flat_columns(ssb.gen_tables(0.01, seed=7))
    ssb_ds = ssb.datasource(cols, dicts, rows_per_segment=16384)
    tpch_ds = tpch.datasource(*tpch.flat_columns(tpch.gen_tables(0.01)),
                              rows_per_segment=16384)
    cases = (
        [(ssb_ds, n, q) for n, q in ssb.NATIVE_QUERIES.items()]
        + [(tpch_ds, "q1", tpch.NATIVE_QUERIES["q1"])]
        + [(ssb_ds, "timeseries", ssb.TIMESERIES_QUERY), (ssb_ds, "topn", ssb.TOPN_QUERY)]
    )
    cpu, gpu = Engine(device="cpu"), Engine(device=card)
    for ds, name, q in cases:
        before = cg.LAUNCHES
        got = gpu.execute(q, ds)
        m = gpu.last_metrics
        if m.num_groups <= 4096 and m.segments:
            assert cg.LAUNCHES > before, name
            assert m.strategy == "cuda"
        pd.testing.assert_frame_equal(gpu.execute(q, ds), got, check_exact=True)
        want = cpu.execute(q, ds)
        assert list(got.columns) == list(want.columns) and len(got) == len(want), name
        for c in want.columns:
            if want[c].dtype.kind == "f":
                np.testing.assert_allclose(
                    got[c].to_numpy(np.float64), want[c].to_numpy(np.float64),
                    rtol=2e-5, err_msg=name,
                )
            elif name != "topn" and not name.startswith("q3"):
                # ordered by float aggregates: rows may swap on near-ties
                np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy(), name)


SKETCHES = {
    "hll11": A.HyperUnique("s", "a", precision=11),
    "hll4": A.HyperUnique("s", "a", precision=4),
    "theta": A.ThetaSketch("s", "a", size=4096),
    "quantiles": A.QuantilesSketch("s", "v", size=1024),
}


@pytest.mark.parametrize("kind", sorted(SKETCHES))
def test_sketch_ops_on_card_equal_cpu(card, kind):
    agg = SKETCHES[kind]
    ops = sketch_ops(agg)
    states = {"cpu": [], "card": []}
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        R, G = 65536, 250
        arrs = {
            "a": rng.integers(-3, 300_000, R).astype(np.int32),
            "v": (rng.random(R) * 1000).astype(np.float32),
            "gid": rng.integers(0, G, R).astype(np.int32),
            "mask": rng.random(R) < 0.8,
        }
        for where, dev in (("cpu", "cpu"), ("card", card)):
            t = {k: torch.from_numpy(v).to(dev) for k, v in arrs.items()}
            states[where].append(ops.partial(agg, t, t["gid"], t["mask"], G))
    for a, b in zip(states["card"], states["cpu"]):
        assert torch.equal(a.cpu(), b)
    merged = {k: ops.merge_states(*v, agg) for k, v in states.items()}
    assert torch.equal(merged["card"].cpu(), merged["cpu"])


def test_rho_on_card_matches_cpu(card):
    w = np.concatenate([np.arange(max((1 << k) - 8192, 0), (1 << k) + 8192) for k in range(28)])
    h = torch.from_numpy(np.unique(w) << 4)
    assert torch.equal(hll._rho(h.to(card), 4).cpu(), hll._rho(h, 4))


def test_sketch_queries_on_card_match_cpu(card):
    tables = ssb.gen_tables(0.01, seed=11)
    ctxs = {d: TPUOlapContext(SessionConfig(result_cache_entries=0), device=d)
            for d in ("cpu", card)}
    for ctx in ctxs.values():
        ssb.register(ctx, tables=tables, rows_per_segment=16384)
    frame = ssb.flat_frame(tables)
    for name, sql in ssb.SKETCH_QUERIES.items():
        before = cg.LAUNCHES
        got, want = ctxs[card].sql(sql), ctxs["cpu"].sql(sql)
        assert cg.LAUNCHES > before, name
        pd.testing.assert_frame_equal(ctxs[card].sql(sql), got, check_exact=True)
        ssb.check_sketch_answer(name, got, ssb.sketch_oracle(frame, name))
        keys = [c for c in want.columns if c != "revenue"]
        got = got.sort_values(keys, na_position="last").reset_index(drop=True)
        want = want.sort_values(keys, na_position="last").reset_index(drop=True)
        pd.testing.assert_frame_equal(got[keys], want[keys], check_exact=True)
        np.testing.assert_allclose(got.revenue, want.revenue, rtol=2e-5, err_msg=name)


def _sparse_inputs(seed, R, G, distinct, p):
    """Rows over the same `distinct` group ids (seed 0) whatever the seed."""
    pool = np.random.default_rng(0).choice(G, size=distinct, replace=False).astype(np.int32)
    rng = np.random.default_rng(seed)
    mask = rng.random(R) < p
    return (pool[rng.integers(0, distinct, R)], mask,
            (rng.random((R, 2)) * 100 * mask[:, None]).astype(np.float32),
            rng.random((R, 2)).astype(np.float32), rng.random((R, 2)) < 0.9)


@pytest.mark.parametrize("slots,cap", [(4096, None), (4096, 8192), (1 << 18, None)])
def test_sparse_tier_ops_on_card_match_cpu(card, slots, cap):
    """sparse_partial_aggregate (the kernel over 4096 slots, the segmented
    reduce above) and merge_sparse_states on the card against the CPU:
    gids, mins, maxs, flags and counts equal, sums within rtol 1e-5, and
    two launches bit-equal."""
    from spark_druid_olap_tpu_torch.ops import sparse_groupby as sg

    G = 1 << 22
    states = {"cpu": None, "card": None}
    for seed in (1, 2):
        arrs = _sparse_inputs(seed, 65536, G, 3000 if slots <= 4096 else 40000, 0.7)
        for where, dev, inner in (("cpu", "cpu", "dense"), ("card", card, "cuda")):
            t = [torch.from_numpy(a).to(dev) for a in arrs]
            kw = dict(num_groups=G, num_min=1, num_max=1, slots=slots,
                      inner_strategy=inner, row_capacity=cap)
            st = sg.sparse_partial_aggregate(*t, **kw)
            if where == "card":
                again = sg.sparse_partial_aggregate(*t, **kw)
                assert all(torch.equal(st[k], again[k]) for k in st)
            prev = states[where]
            states[where] = st if prev is None else sg.merge_sparse_states(prev, st, G)
    got, want = states["card"], states["cpu"]
    assert not bool(want["overflow"])
    for k in want:
        if k == "sums":
            np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(), rtol=1e-5)
        else:
            assert torch.equal(got[k].cpu(), want[k]), k


def test_high_cardinality_tiers_on_card_match_cpu(card):
    """The high-cardinality SSB queries and the exact-distinct queries on
    the card under "auto", "sparse" and "segment" against the CPU: the same
    path, keys and counts equal, sums within 2e-5, a second run bit-equal,
    and the kernel launched by every tier pass at most 4096 wide."""
    tables = ssb.gen_tables(0.01, seed=11)
    cols, dicts = ssb.flat_columns(tables)
    ds = ssb.datasource(cols, dicts, rows_per_segment=16384)
    keyed = ssb.key_dimension_datasource(ds, len(tables["customer"]["c_custkey"]))
    names = ["q2_1", "q2_2", "q2_3", "q3_1", "q3_2", "q3_3", "q3_4", "q4_2", "q4_3"]
    exact = {}
    for where in ("cpu", card):
        ctx = TPUOlapContext(SessionConfig(result_cache_entries=0), device=where)
        ctx.register_datasource(keyed, star_schema=ssb.KEYED_STAR_SCHEMA)
        ctx.sql("SET count_distinct_mode = 'exact'")
        exact[where] = ctx
    for strategy in ("auto", "sparse", "segment"):
        cpu = Engine(device="cpu", strategy=strategy)
        gpu = Engine(device=card, strategy=strategy)
        for name in names:
            q = ssb.NATIVE_QUERIES[name]
            before = cg.LAUNCHES
            got = gpu.execute(q, ds)
            m = gpu.last_metrics
            pd.testing.assert_frame_equal(gpu.execute(q, ds), got, check_exact=True)
            want = cpu.execute(q, ds)
            if strategy == "auto":
                assert m.strategy in ("adaptive", "sparse") or m.tier_declines, m.describe()
            if (m.strategy == "adaptive" and 0 < m.compact_groups <= 4096) or (
                    m.strategy == "sparse" and m.sparse_slots <= 4096):
                assert m.inner_strategy == "cuda" and cg.LAUNCHES > before, m.describe()
            keys = [c for c in want.columns if want[c].dtype.kind != "f"]
            got = got.sort_values(keys).reset_index(drop=True)
            want = want.sort_values(keys).reset_index(drop=True)
            pd.testing.assert_frame_equal(got[keys], want[keys], check_exact=True)
            for c in want.columns.difference(keys):
                np.testing.assert_allclose(got[c], want[c], rtol=2e-5, err_msg=name)
    frame = ssb.flat_frame(tables)
    for name, sql in ssb.EXACT_DISTINCT_QUERIES.items():
        got = exact[card].sql(sql)
        pd.testing.assert_frame_equal(exact[card].sql(sql), got, check_exact=True)
        ssb.check_sketch_answer(name, got, ssb.sketch_oracle(frame, name))
        want = exact["cpu"].sql(sql)
        np.testing.assert_array_equal(got.uniq_custs, want.uniq_custs)


# -- the streaming executor ----------------------------------------------------

STREAM_QUERIES = {
    "timeseries": Q.TimeseriesQuery(
        datasource="events", granularity="hour",
        aggregations=(A.Count("n"), A.DoubleSum("v", "value"), A.DoubleMax("mx", "latency")),
        intervals=(datagen.event_stream_interval(),),
    ),
    "groupby": Q.GroupByQuery(
        datasource="events",
        dimensions=(DimensionSpec("site", "site"), DimensionSpec("kind", "kind")),
        aggregations=(A.Count("n"), A.DoubleSum("v", "value"),
                      A.DoubleMin("lo", "latency"), A.DoubleMax("hi", "latency")),
        filter=F.Bound("kind", lower=2, upper=None, ordering="numeric"),
    ),
}


def _event_chunks(n, rows, short=777):
    chunks = [datagen.gen_event_chunk(i, rows) for i in range(n)]
    chunks[-1] = {k: v[: rows - short] for k, v in chunks[-1].items()}
    return chunks


@pytest.mark.parametrize("name", sorted(STREAM_QUERIES))
def test_stream_on_card_matches_cpu(card, name):
    q, ds, rows = STREAM_QUERIES[name], datagen.event_stream_schema(), 16384
    chunks = _event_chunks(6, rows)
    # the CPU side pinned to the kernel's class (its plain version): the CPU
    # profile would price the scatter cheaper there
    want = StreamExecutor(engine=Engine(device="cpu", strategy="dense")).execute(
        q, ds, iter(chunks), rows)
    engine = Engine(device=card)
    ex = StreamExecutor(engine=engine)
    before = cg.LAUNCHES
    got = ex.execute(q, ds, iter(chunks), rows)
    assert cg.LAUNCHES - before == len(chunks) and ex.stats.strategy == "cuda"
    assert ex.stats.h2d_bytes == len(chunks) * rows * (12 if name == "timeseries" else 16)
    pd.testing.assert_frame_equal(ex.execute(q, ds, iter(chunks), rows), got, check_exact=True)
    off = StreamExecutor(engine=engine, double_buffer=False)
    pd.testing.assert_frame_equal(off.execute(q, ds, iter(chunks), rows), got, check_exact=True)
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for c in want.columns:
        if c in ("v",):
            np.testing.assert_allclose(got[c].to_numpy(np.float64),
                                       want[c].to_numpy(np.float64), rtol=1e-6)
        else:  # keys, counts, min, max
            np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy(), c)


def test_stream_longer_than_ring_matches_oracle(card):
    """A ring of 4 staging slots (prefetch 1) under 40 chunks: a slot
    refilled while its copy was in flight would put one chunk's rows in
    another's place, which the float64 oracle would see."""
    rows, n = 8192, 40
    chunks = [datagen.gen_event_chunk(i, rows) for i in range(n)]
    for double_buffer in (True, False):
        ex = StreamExecutor(engine=Engine(device=card), prefetch=1, double_buffer=double_buffer)
        got = ex.execute(STREAM_QUERIES["timeseries"], datagen.event_stream_schema(),
                         iter(chunks), rows)
        lo, _ = datagen.event_stream_interval()
        h = np.concatenate([(c["ts"] - lo) // 3_600_000 for c in chunks])
        value = np.concatenate([c["value"] for c in chunks]).astype(np.float64)
        latency = np.concatenate([c["latency"] for c in chunks]).astype(np.float64)
        mx = np.full(datagen.EVENT_SPAN_HOURS, -np.inf)
        np.maximum.at(mx, h, latency)
        np.testing.assert_array_equal(got["n"].to_numpy(), np.bincount(h))
        np.testing.assert_allclose(got["v"].to_numpy(np.float64),
                                   np.bincount(h, weights=value), rtol=2e-5)
        np.testing.assert_array_equal(got["mx"].to_numpy(np.float64), mx)


def test_assisted_q18_class_on_card_equals_assist_off(card):
    """A q18-class query (IN over a grouped HAVING subquery, the outer
    GROUP BY over l_orderkey) on the host fallback of a context on the
    card: the assist runs the outer grouping on the engine (the adaptive
    tier, the kernel at its compacted G') and its frame equals the same
    query with the assist off (keys and counts exact, sums within rtol
    2e-5), and a second run is bit-identical."""
    tables = tpch.gen_tables(0.05)
    # the assist's cost gate priced to assist (an interpreted row costs more
    # than any engine run): it would decline a q18-class subtree
    ctx = TPUOlapContext(SessionConfig(result_cache_entries=0, cost_per_row_interp=1e9),
                         device=card)
    tpch.register(ctx, tables=tables, rows_per_segment=1 << 16)
    sql = """
        SELECT l_orderkey, sum(l_quantity) AS total FROM lineitem
        WHERE l_orderkey IN (SELECT l_orderkey FROM lineitem
                             GROUP BY l_orderkey HAVING sum(l_quantity) > 220.0)
        GROUP BY l_orderkey ORDER BY total DESC, l_orderkey LIMIT 20
    """
    before = cg.LAUNCHES
    got = ctx.sql(sql)
    m = ctx.last_metrics
    assert m.executor == "device+fallback" and m.assist_subplans == 1, m.describe()
    assert cg.LAUNCHES > before
    pd.testing.assert_frame_equal(ctx.sql(sql), got, check_exact=True)
    ctx.sql(f"SET device_assist_min_rows = {ctx.catalog.get('lineitem').num_rows + 1}")
    off = ctx.sql(sql)
    assert ctx.last_metrics.executor == "fallback"
    assert len(got) == 20
    assert list(got.l_orderkey) == list(off.l_orderkey)
    np.testing.assert_allclose(got.total, off.total, rtol=2e-5)


GRAPH_CASES = [("ssb", "q1_1"), ("ssb", "q3_2"), ("ssb", "q4_1"), ("tpch", "q1"),
               ("ssb", "timeseries")]


def _graph_datasources():
    cols, dicts = ssb.flat_columns(ssb.gen_tables(0.01, seed=7))
    return {
        "ssb": ssb.datasource(cols, dicts, rows_per_segment=4096),
        "tpch": tpch.datasource(*tpch.flat_columns(tpch.gen_tables(0.01)),
                                rows_per_segment=4096),
    }


def _graph_query(workload, name):
    if name == "timeseries":
        return ssb.TIMESERIES_QUERY
    return (ssb if workload == "ssb" else tpch).NATIVE_QUERIES[name]


@pytest.mark.parametrize("workload,name", GRAPH_CASES)
def test_captured_graph_equals_the_eager_loop(card, workload, name):
    """First run eager, second captured (after one eager warm-up of the
    body) and replayed, third replayed: every frame bit-identical to the
    loop's with the arena off; a replay is one dispatch and adds one launch
    per in-scope segment to the counters."""
    ds = _graph_datasources()[workload]
    q = _graph_query(workload, name)
    eng = Engine(device=card)
    with arena_disabled():
        want = eng.execute(q, ds)
    m = eng.last_metrics
    # the eager loop: a pass per segment (q3_2's presence pass adds one more)
    assert m.segments > 1 and m.dispatch_count >= m.segments and m.graph_replays == 0
    pd.testing.assert_frame_equal(eng.execute(q, ds), want, check_exact=True)
    assert eng.last_metrics.graph_captures == 0
    for run in ("capture", "replay"):
        before, shapes = cg.LAUNCHES, dict(cg.LAUNCH_SHAPES)
        got = eng.execute(q, ds)
        torch.cuda.synchronize()
        m = eng.last_metrics
        pd.testing.assert_frame_equal(got, want, check_exact=True)
        assert (m.graph_captures, m.graph_replays, m.dispatch_count) == (
            int(run == "capture"), 1, 1), m.describe()
        assert m.arena_segments == m.segments
        launched = m.segments * (2 if run == "capture" else 1)  # the warm-up's too
        assert cg.LAUNCHES - before == launched
        added = {k: v - shapes.get(k, 0) for k, v in cg.LAUNCH_SHAPES.items()
                 if v != shapes.get(k, 0)}
        assert sum(added.values()) == launched and len(added) == 1


@pytest.mark.parametrize("workload,name", GRAPH_CASES)
def test_capture_over_a_rebuilt_lowering(card, workload, name):
    """The lowering cache drops the scope's lowering after its first run:
    the second run captures over the rebuilt lowering, whose constants
    have no device copy yet.  The capture's warm-up makes those copies, so
    the capture succeeds and replays the loop's bits."""
    ds = _graph_datasources()[workload]
    q = _graph_query(workload, name)
    eng = Engine(device=card)
    want = eng.execute(q, ds)
    eng._lowering_cache.clear()
    for captures in (1, 0):
        pd.testing.assert_frame_equal(eng.execute(q, ds), want, check_exact=True)
        m = eng.last_metrics
        assert (m.graph_captures, m.graph_replays, m.dispatch_count) == (captures, 1, 1), \
            m.describe()


def test_evicted_column_drops_its_graph(card):
    ds = _graph_datasources()["ssb"]
    q = ssb.NATIVE_QUERIES["q4_1"]
    eng = Engine(device=card)
    want = eng.execute(q, ds)
    eng.execute(q, ds)
    assert len(eng._arena.keys()) == 1 and eng.last_metrics.graph_captures == 1
    seg = next(s for s in ds.segments)
    eng._device_cache.pop((seg.uid, "valid"))
    assert eng._arena.keys() == []
    pd.testing.assert_frame_equal(eng.execute(q, ds), want, check_exact=True)
    m = eng.last_metrics
    assert m.graph_replays == 0 and m.dispatch_count == m.segments  # eager again
    pd.testing.assert_frame_equal(eng.execute(q, ds), want, check_exact=True)
    assert eng.last_metrics.graph_captures == 1
    eng.clear_cache()
    assert eng._arena.keys() == [] and eng.bytes_resident() == 0


def test_cold_columns_come_from_kept_pinned_copies(card):
    """With the transfer pipeline on, a cold column is copied from a pinned
    host copy made at its first copy and kept: the scope's columns come
    back after `drop_residency` from the same copies, and every frame
    equals the pageable copies' bit for bit."""
    ds = _graph_datasources()["ssb"]
    q = ssb.NATIVE_QUERIES["q4_1"]
    eng = Engine(device=card)
    want = eng.execute(q, ds)
    m = eng.last_metrics
    stats = eng._pipeline.to_dict()
    per_seg = len(eng._lowering_for(q, ds).columns) + 1
    assert stats == {"enabled": True, "pinned_columns": m.segments * per_seg,
                     "pinned_bytes": m.h2d_bytes}
    assert all(t.is_pinned() for t in eng._pipeline._pinned.values())
    eng.drop_residency()
    pd.testing.assert_frame_equal(eng.execute(q, ds), want, check_exact=True)
    assert eng.last_metrics.h2d_bytes == m.h2d_bytes and eng._pipeline.to_dict() == stats
    eng.configure_pipeline(SessionConfig(transfer_pipeline=False))
    eng.drop_residency()
    pd.testing.assert_frame_equal(eng.execute(q, ds), want, check_exact=True)
    eng.clear_cache()
    assert eng._pipeline.to_dict()["pinned_columns"] == 0


def _scan_datasource():
    cols, dicts = ssb.flat_columns(ssb.gen_tables(0.01, seed=7))
    return ssb.datasource(cols, dicts, rows_per_segment=16384)


_FACT_FILTER = {"type": "and", "fields": [
    {"type": "bound", "dimension": "lo_discount", "lower": "1", "upper": "3",
     "ordering": "numeric"},
    {"type": "bound", "dimension": "lo_quantity", "upper": "25", "upperStrict": True,
     "ordering": "numeric"}]}
_SCANS = {
    "unordered_limit": {"columns": ["lo_orderdate", "lo_extendedprice", "c_city"],
                        "filter": _FACT_FILTER, "limit": 1000},
    "ordered_top": {"columns": ["lo_orderdate", "lo_extendedprice", "lo_discount"],
                    "filter": _FACT_FILTER, "limit": 100, "offset": 3,
                    "orderBy": [{"columnName": "lo_extendedprice", "order": "descending"}]},
    "ordered_ties": {"columns": ["lo_quantity", "s_city", "lo_revenue"], "limit": 50,
                     "orderBy": [{"columnName": "lo_quantity", "order": "descending"},
                                 {"columnName": "s_city"}]},
    "virtual_month": {"columns": ["__time", "rev"], "resultFormat": "compactedList",
                      "virtualColumns": [{"type": "expression", "name": "rev",
                                          "expression": "lo_extendedprice * lo_discount"}],
                      "intervals": ["1994-03-01T00:00:00.000Z/1994-04-01T00:00:00.000Z"],
                      "filter": _FACT_FILTER},
}


@pytest.mark.parametrize("name", sorted(_SCANS))
def test_scan_on_card_matches_cpu(card, name):
    """The Scan's mask and compaction on the card give the CPU's rows, in
    its order, and copy the same bytes to the host."""
    from spark_druid_olap_tpu_torch.models.wire import query_from_druid

    ds = _scan_datasource()
    q = query_from_druid({"queryType": "scan", "dataSource": "lineorder", **_SCANS[name]})
    cpu, gpu = Engine(device="cpu"), Engine(device=card)
    want = cpu.execute(q, ds)
    got = gpu.execute(q, ds)
    assert len(want) > 0
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert gpu.last_metrics.d2h_bytes == cpu.last_metrics.d2h_bytes
    assert gpu.last_metrics.segments == cpu.last_metrics.segments


def test_search_counts_on_card_equal_bincount(card):
    """The Search's counts on the card equal `np.bincount` over the same
    codes under the same mask."""
    from spark_druid_olap_tpu_torch.models.wire import query_from_druid

    ds = _scan_datasource()
    gpu = Engine(device=card)
    for filt in (None, _FACT_FILTER):
        body = {"queryType": "search", "dataSource": "lineorder",
                "searchDimensions": ["c_city", "s_city"],
                "query": {"type": "insensitive_contains", "value": "united"}}
        if filt is not None:
            body["filter"] = filt
        got = gpu.execute(query_from_druid(body), ds)
        want = {}
        for dim in ("c_city", "s_city"):
            values = ds.dicts[dim].values
            counts = np.zeros(len(values), np.int64)
            for seg in ds.segments:
                keep = np.asarray(seg.valid).copy()
                if filt is not None:
                    d, qn = seg.column("lo_discount"), seg.column("lo_quantity")
                    keep &= (d >= 1) & (d <= 3) & (qn < 25)
                codes = np.asarray(seg.dims[dim])[keep]
                counts += np.bincount(codes[codes >= 0], minlength=len(values))
            want.update({(dim, v): int(c) for v, c in zip(values, counts)
                         if c and "united" in str(v).lower()})
        assert len(want) > 0
        assert dict(zip(zip(got["dimension"], got["value"]), got["count"])) == want


# -- resilience on the card ------------------------------------------------------


def _injected_deadline_run(eng, q, ds, skip):
    """One execution under a partial collector with an injected deadline at
    the segment loop's `skip`-th checkpoint: (frame, collector)."""
    from spark_druid_olap_tpu_torch import resilience as R

    R.injector().arm("engine.segment_loop", error_type=R.InjectedDeadline, skip=skip, times=1)
    try:
        with R.partial_scope(True) as pc:
            df = eng.execute(q, ds)
    finally:
        R.injector().disarm()
    return df, pc


@pytest.mark.parametrize("workload,name", GRAPH_CASES)
def test_chunked_replays_equal_the_graph_and_the_loop_at_every_k(card, workload, name):
    """Under an armed checkpoint site a scope replays one graph per segment,
    the checkpoint on the host between replays.  At every truncation point
    K the frame is the loop's bit for bit with the same coverage; past the
    last segment it is the whole-scope graph's; the chunk graphs are
    captured once, when first reached."""
    ds = _graph_datasources()[workload]
    q = _graph_query(workload, name)
    eng = Engine(device=card)
    eng.execute(q, ds)
    whole = eng.execute(q, ds)  # captured: the whole-scope graph's bits
    segs = eng.last_metrics.segments
    assert eng.last_metrics.graph_replays == 1
    captured = 0
    for k in range(segs + 1):
        got, pc = _injected_deadline_run(eng, q, ds, k)
        m = eng.last_metrics
        assert m.arena_segments == m.graph_replays == min(k, segs), m.describe()
        captured += m.graph_captures
        with arena_disabled():
            loop, lpc = _injected_deadline_run(eng, q, ds, k)
        pd.testing.assert_frame_equal(got, loop, check_exact=True)
        assert pc.coverage() == lpc.coverage()
        assert pc.is_partial == (k < segs) == lpc.is_partial
        if k >= segs:
            pd.testing.assert_frame_equal(got, whole, check_exact=True)
    assert captured == segs  # each chunk captured once, then replayed


@pytest.mark.parametrize("site", ["device_dispatch", "engine.resolve"])
def test_retry_after_an_evict_never_replays_a_dropped_graph(card, monkeypatch, site):
    """A transient failure before or after the scope's replay evicts the
    query's graphs and columns; the retry runs the loop over fresh copies
    and replays none of the dropped graphs; the next runs capture anew."""
    from spark_druid_olap_tpu_torch import resilience as R

    ds = _graph_datasources()["ssb"]
    q = ssb.NATIVE_QUERIES["q4_1"]
    eng = Engine(device=card)
    want = eng.execute(q, ds)
    eng.execute(q, ds)
    kept = [p.graph for p in eng._arena._programs.values()]  # ids stay unique
    old = {id(g) for g in kept}
    assert old
    replayed = []
    orig = torch.cuda.CUDAGraph.replay
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay",
                        lambda self: (replayed.append(id(self)), orig(self))[1])
    R.injector().arm(site, times=1)
    try:
        got = eng.execute(q, ds)
    finally:
        R.injector().disarm()
    m = eng.last_metrics
    assert m.retries == 1 and m.graph_replays == 0 and m.h2d_bytes > 0, m.describe()
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    # the old graph ran only in the failed attempt, where the failure came
    # after its replay
    assert sum(r in old for r in replayed) == int(site == "engine.resolve")
    assert eng._arena.keys() == []
    n = len(replayed)
    for captures in (1, 0):  # captured again from the fresh columns
        pd.testing.assert_frame_equal(eng.execute(q, ds), want, check_exact=True)
        assert eng.last_metrics.graph_captures == captures
    assert len(replayed) == n + 2 and not set(replayed[n:]) & old


def test_kernel_errors_are_never_retried(card, monkeypatch):
    """A refused launch and a failed capture raise KernelError at once: no
    retry, nothing counted on the breaker, no degraded answer."""
    from spark_druid_olap_tpu_torch import resilience as R

    ds = _graph_datasources()["ssb"]
    q = ssb.NATIVE_QUERIES["q1_1"]
    eng = Engine(device=card)
    eng.execute(q, ds)  # the scope's warm-up: its next run captures

    def refuse(*a, **k):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", refuse)
    with pytest.raises(R.KernelError, match="capture failed"):
        eng.execute(q, ds)
    assert eng.last_metrics.retries == 0 and eng.breaker.to_dict()["failures_total"] == 0
    monkeypatch.undo()

    class Refused:
        def sdol_groupby_partial(self, *a):
            return 9  # cudaErrorInvalidConfiguration

        def sdol_error_string(self, rc):
            return b"invalid configuration argument"

    monkeypatch.setattr(cg, "_library", lambda: Refused())
    with arena_disabled(), pytest.raises(R.KernelError, match="launch failed"):
        eng.execute(q, ds)
    assert eng.last_metrics.retries == 0 and eng.breaker.state == "closed"
    assert eng.breaker.to_dict()["failures_total"] == 0


def _sync_count(fn):
    """(fn's result, the synchronizing CUDA calls it made: torch's sync
    debug mode)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message) for w in caught)


def test_warm_fused_batch_is_one_replay_and_one_fetch(card):
    """A fused micro-batch over resident segments: its first batch runs the
    fused eager loop, its second captures one CUDA graph, the third is one
    replay and one host fetch.  Its launches equal the sum of its members'
    in-scope segments, and every member's frame is bit-identical to its
    serial run on the card."""
    from spark_druid_olap_tpu_torch.exec.engine import segments_in_scope

    tables = ssb.gen_tables(0.01, seed=11)
    ctx = TPUOlapContext(SessionConfig(result_cache_entries=0), device=card)
    ssb.register(ctx, tables=tables, rows_per_segment=16384)
    ds = ctx.catalog.get("lineorder")
    qs = [ssb.NATIVE_QUERIES[n] for n in ("q1_1", "q1_2", "q4_1")] + [
        ssb.TIMESERIES_QUERY, ssb.TOPN_QUERY]
    serial = [ctx.engine.execute(q, ds) for q in qs]
    for _ in range(2):
        ctx.engine.execute_fused(qs, ds)
    segs = 0
    for q in qs:
        inner, _ = ctx.engine._groupby_family(q, ds)
        segs += len(segments_in_scope(inner, ds))
    before = cg.LAUNCHES
    out, syncs = _sync_count(lambda: ctx.engine.execute_fused(qs, ds))
    m = out[0][2]
    assert m.dispatch_count == 1 and m.graph_replays == 1, m.describe()
    assert syncs == 1 and cg.LAUNCHES - before == segs
    for (df, _, _), want in zip(out, serial):
        pd.testing.assert_frame_equal(df, want, check_exact=True)


def test_sampled_receipts_carry_cuda_event_time(card):
    """At the default sample rate a query adds no sync; a sampled query's
    receipt holds the CUDA-event time of its dispatches."""
    from spark_druid_olap_tpu_torch.obs import prof

    tables = ssb.gen_tables(0.01, seed=11)
    ctx = TPUOlapContext(SessionConfig(result_cache_entries=0), device=card)
    ssb.register(ctx, tables=tables, rows_per_segment=16384)
    for _ in range(3):
        ctx.sql(ssb.QUERIES["q4_1"])
    before = prof.SYNCS
    rc = ctx.sql(ssb.QUERIES["q4_1"]).attrs["receipt"]
    assert prof.SYNCS == before and rc["device_timing"] == "span" and rc["syncs"] == 0
    ctx.sql("SET prof_sample_rate = 1")
    rc = ctx.sql(ssb.QUERIES["q4_1"]).attrs["receipt"]
    assert rc["sampled"] and rc["device_timing"] == "cuda_events"
    assert rc["device_ms"] > 0 and rc["syncs"] >= 1 and prof.SYNCS > before



# -- ingest and storage on the card -------------------------------------------------

INGEST_QUERIES = ("q1_1", "q2_1", "q4_1")


def _ingest_contexts(card, tables, **kw):
    """(card context, CPU context) over the same SSB tables, the result
    cache off."""
    out = []
    for dev in (card, "cpu"):
        ctx = TPUOlapContext(SessionConfig(result_cache_entries=0, **kw), device=dev)
        ssb.register(ctx, tables=tables, rows_per_segment=16384)
        out.append(ctx)
    return out


def _replays_match_cpu(gpu, cpu, runs=3):
    """Each query `runs` times on the card (eager, capture, replay) against
    the CPU: frames within the parity bound, the last run a graph replay
    over live uids only."""
    ds = gpu.catalog.get("lineorder")
    live = {s.uid for s in ds.segments}
    for name in INGEST_QUERIES:
        q = ssb.NATIVE_QUERIES[name]
        want = cpu.engine.execute(q, cpu.catalog.get("lineorder"))
        for _ in range(runs):
            got = gpu.engine.execute(q, ds)
        m = gpu.engine.last_metrics
        if m.strategy == "cuda":
            assert m.graph_replays == 1, (name, m.describe())
        _assert_frames_close(got, want)
        assert gpu.engine.resident_uids() <= live | _other_uids(gpu)


def _other_uids(ctx):
    return {s.uid for t in ctx.catalog.tables() if t != "lineorder"
            for s in ctx.catalog.get(t).segments}


def _assert_frames_close(got, want, rtol=2e-5):
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for c in want.columns:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


def test_append_then_replay(card):
    tables = ssb.gen_tables(0.01, seed=11)
    gpu, cpu = _ingest_contexts(card, tables)
    _replays_match_cpu(gpu, cpu)
    for i in range(3):
        batch = ssb.fact_rows(tables, 3000 + i, seed=i)
        for c in (gpu, cpu):
            c.append_rows("lineorder", batch)
        _replays_match_cpu(gpu, cpu)
    assert gpu.catalog.get("lineorder").delta_rows == 9003


def test_remap_then_replay(card):
    tables = ssb.gen_tables(0.01, seed=11)
    gpu, cpu = _ingest_contexts(card, tables)
    _replays_match_cpu(gpu, cpu)
    old = {s.uid for s in gpu.catalog.get("lineorder").segments}
    graphs = len(gpu.engine._arena.keys())
    assert graphs >= 1
    batch = ssb.fact_rows(tables, 2048, seed=5, new_city="CANADA  NEW")
    for c in (gpu, cpu):
        c.append_rows("lineorder", batch)
    # every segment remapped: no column, pinned copy or graph of the old
    # uids is left, so nothing replays over a freed column
    assert not old & gpu.engine.resident_uids()
    assert not any(k[0] in old for k in gpu.engine._pipeline._pinned)
    assert not any(ck[0] in old for ck in gpu.engine._arena._by_col)
    _replays_match_cpu(gpu, cpu)


def test_compaction_then_replay(card):
    tables = ssb.gen_tables(0.01, seed=11)
    gpu, cpu = _ingest_contexts(card, tables, compaction_rows_per_segment=16384)
    for i in range(4):
        batch = ssb.fact_rows(tables, 2500, seed=10 + i)
        for c in (gpu, cpu):
            c.append_rows("lineorder", batch)
    _replays_match_cpu(gpu, cpu)
    deltas = {s.uid for s in gpu.catalog.get("lineorder").delta_segments()}
    for c in (gpu, cpu):
        c.compact("lineorder")
    assert not deltas & gpu.engine.resident_uids()
    assert not any(ck[0] in deltas for ck in gpu.engine._arena._by_col)
    _replays_match_cpu(gpu, cpu)


def test_restart_from_disk(card, tmp_path):
    tables = ssb.gen_tables(0.01, seed=11)
    gpu = TPUOlapContext(SessionConfig(result_cache_entries=0, storage_dir=str(tmp_path)),
                         device=card)
    ssb.register(gpu, tables=tables, rows_per_segment=16384)
    gpu.append_rows("lineorder", ssb.fact_rows(tables, 4000, seed=3))
    before = {n: gpu.sql(ssb.QUERIES[n]) for n in INGEST_QUERIES}
    gpu.close()
    again = TPUOlapContext(SessionConfig(result_cache_entries=0, storage_dir=str(tmp_path)),
                           device=card)
    assert again.storage.last_recovery["replayed_rows"] == 4000
    for _ in range(3):  # cold from the memory-mapped columns, capture, replay
        after = {n: again.sql(ssb.QUERIES[n]) for n in INGEST_QUERIES}
        for n in INGEST_QUERIES:
            pd.testing.assert_frame_equal(after[n], before[n], check_exact=True)


def test_delta_refresh_of_sketches_beside_concurrent_captures(card):
    """A delta refresh of a sketch query (HLL, theta, quantiles) merges its
    cached states with the deltas' on the host, so it runs beside another
    thread capturing graphs on the same engine: no capture fails, and every
    refreshed answer equals the CPU's full run."""
    import threading

    tables = ssb.gen_tables(0.01, seed=11)
    gpu = TPUOlapContext(device=card)  # the result cache and delta reuse on
    cpu = TPUOlapContext(SessionConfig(result_cache_entries=0), device="cpu")
    for c in (gpu, cpu):
        ssb.register(c, tables=tables, rows_per_segment=16384)
    sketches = [ssb.SKETCH_QUERIES["topn_hll"], ssb.SKETCH_QUERIES["quantiles"],
                "SELECT c_region, approx_count_distinct_ds_theta(lo_custkey) AS u, "
                "sum(lo_revenue) AS r FROM lineorder GROUP BY c_region"]
    for sql in sketches:
        gpu.sql(sql)
    stop, errors, scopes = threading.Event(), [], [0]

    def capture_loop():
        k = 2
        try:
            while not stop.is_set():
                q = gpu.plan_sql("SELECT d_year, sum(lo_revenue) AS r FROM lineorder "
                                 f"WHERE lo_quantity < {k} GROUP BY d_year").query
                for _ in range(2):  # a new scope: the eager loop, then its capture
                    gpu.engine.execute(q, gpu.catalog.get("lineorder"))
                scopes[0] += 1
                k = k % 49 + 2
        except BaseException as err:  # reported by the main thread
            errors.append(err)

    t = threading.Thread(target=capture_loop)
    t.start()
    try:
        for i in range(4):
            batch = ssb.fact_rows(tables, 4096, seed=40 + i)
            for c in (gpu, cpu):
                c.append_rows("lineorder", batch)
            for sql in sketches:
                _assert_frames_close(gpu.sql(sql), cpu.sql(sql))
    finally:
        stop.set()
        t.join()
    assert not errors, errors
    assert gpu.serve.result_cache.to_dict()["delta_hits"] == 4 * len(sketches)
    assert scopes[0] > 0 and len(gpu.engine._arena.keys()) > 0


# -- the cost model ------------------------------------------------------------


def test_calibrate_on_card(card, tmp_path):
    """`plan/calibrate.calibrate` at small rows on the card: every constant
    measured, finite and positive, the dense class through the kernel by
    graph replays (their launches counted), the file naming the card, and
    `load_calibrated` applying it."""
    from spark_druid_olap_tpu_torch.config import CALIBRATED_FLOATS, CALIBRATED_INTS
    from spark_druid_olap_tpu_torch.plan import calibrate

    path = tmp_path / "calibration.torch_cuda.json"
    before = cg.LAUNCHES
    out = calibrate.calibrate(rows=1 << 15, launches=2, reps=3, save_path=str(path), device=card)
    assert cg.LAUNCHES > before
    assert (out["device"], out["platform"], out["kernel_class"], out["dense_timing"]) == (
        torch.cuda.get_device_name(card), "cuda", "cuda", "graph replay")
    assert out["partial"] is False and out["power_limit"]
    for k in CALIBRATED_FLOATS + CALIBRATED_INTS:
        assert np.isfinite(out[k]) and out[k] > 0, k
    cfg = SessionConfig.load_calibrated(path=str(path), device=card)
    assert cfg.calibration_meta["applied"] and cfg.calibration_meta["source"] == "file"
    assert cfg.cost_per_row_dense == out["cost_per_row_dense"]


def test_dense_class_is_never_planned_above_4096_on_card(card, monkeypatch):
    """On a card the dense class is priced inf above 4096 groups, whatever
    `dense_max_groups` says and with the model on or off; a context on the
    card plans the kernel's class at G <= 4096 (and runs the kernel) and
    another class above, and no query reaches the plain twin."""
    from spark_druid_olap_tpu_torch.ops import groupby as tgroupby
    from spark_druid_olap_tpu_torch.plan.cost import _kernel_costs

    def plain_spy(*a, **kw):
        raise AssertionError("the plain twin was reached on a card")

    monkeypatch.setattr(tgroupby, "dense_partial_aggregate", plain_spy)
    cfg = SessionConfig(dense_max_groups=1 << 20)
    for g in (4097, 1 << 16):
        assert dict(_kernel_costs(1 << 20, g, cfg, True, device=card))["dense"] == float("inf")
    assert np.isfinite(dict(_kernel_costs(1 << 20, 4096, cfg, False, device=card))["dense"])
    tables = ssb.gen_tables(0.01, seed=11)
    for enabled in (True, False):
        ctx = TPUOlapContext(SessionConfig(result_cache_entries=0, dense_max_groups=1 << 20,
                                           cost_model_enabled=enabled), device=card)
        ssb.register(ctx, tables=tables, rows_per_segment=16384)
        for name in ("q1_1", "q4_1", "q3_2", "q4_3"):
            rw = ctx.plan_sql(ssb.QUERIES[name])
            ctx.sql(ssb.QUERIES[name])
            m = ctx.last_metrics
            if rw.num_groups > 4096:
                assert rw.physical.strategy != "dense" and m.strategy != "cuda", m.describe()
            else:
                assert rw.physical.strategy == "dense" and m.strategy == "cuda", m.describe()


# -- multi-device execution -----------------------------------------------------


def _mesh_frames_close(got, want, rtol=1e-5):
    floats = [c for c in want.columns if want[c].dtype.kind == "f"]
    keys = [c for c in want.columns if c not in floats]
    got = got.sort_values(keys, kind="stable").reset_index(drop=True)
    want = want.sort_values(keys, kind="stable").reset_index(drop=True)
    for c in keys:
        np.testing.assert_array_equal(np.asarray(got[c]), np.asarray(want[c]), err_msg=c)
    for c in floats:
        np.testing.assert_allclose(np.asarray(got[c], np.float64), np.asarray(want[c], np.float64),
                                   rtol=rtol, err_msg=c)


@pytest.mark.parametrize("strategy", ["dense", "segment", "sparse", "adaptive"])
def test_logical_mesh_on_the_card_equals_the_cpu_mesh(card, strategy):
    """A (4, 1) mesh of 4 x the card against the same mesh of CPU shards and
    the card's single-device engine, per class (sums within rtol 1e-5: the
    kernel and the plain version add in other orders); the kernel's
    launches reach the card, the arena's graphs replay from the third run."""
    from spark_druid_olap_tpu_torch.parallel.distributed import DistributedEngine
    from spark_druid_olap_tpu_torch.parallel.mesh import make_mesh

    tables = ssb.gen_tables(0.01, seed=7)
    cols, dicts = ssb.flat_columns(tables)
    ds = ssb.datasource(cols, dicts, rows_per_segment=8192)
    names = ("q4_1", "q3_2", "q1_1") if strategy in ("dense", "segment") else ("q3_2", "q2_1")
    gpu = DistributedEngine(make_mesh(4, 1, [card] * 4), strategy=strategy)
    cpu = DistributedEngine(make_mesh(4, 1, ["cpu"] * 4), strategy=strategy)
    one = Engine(device=card)
    for name in names:
        q = ssb.NATIVE_QUERIES[name]
        before = cg.LAUNCHES
        for _ in range(3):
            got = gpu.execute(q, ds)
        m = gpu.last_metrics
        assert m.distributed and m.mesh_shape == (4, 1) and m.device.startswith("cuda")
        if m.strategy == "cuda" or (m.strategy == "adaptive" and m.compact_groups <= 4096):
            assert cg.LAUNCHES > before, m.describe()
        if m.strategy == "cuda":
            assert m.graph_replays == 4  # one graph per shard
        _mesh_frames_close(got, cpu.execute(q, ds))
        _mesh_frames_close(got, one.execute(q, ds, strategy))


def test_mesh_over_real_cards_merges_with_nccl(card):
    """(n, 1) over every card: the merge reduces across cards with NCCL and
    the answers equal the single card's."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more cards for an NCCL merge; this machine has {n}")
    from spark_druid_olap_tpu_torch.parallel import mesh as tmesh
    from spark_druid_olap_tpu_torch.parallel.distributed import DistributedEngine

    parts = [torch.full((4, 3), float(i + 1), device=torch.device("cuda", i)) for i in range(n)]
    assert torch.equal(tmesh.reduce_states(parts, "sum").cpu(),
                       torch.full((4, 3), float(n * (n + 1) // 2)))
    assert torch.equal(tmesh.reduce_states(parts, "max").cpu(), torch.full((4, 3), float(n)))
    got = tmesh.gather_states(parts)
    assert [float(t[0, 0]) for t in got] == [float(i + 1) for i in range(n)]
    tables = ssb.gen_tables(0.01, seed=7)
    cols, dicts = ssb.flat_columns(tables)
    ds = ssb.datasource(cols, dicts, rows_per_segment=8192)
    eng = DistributedEngine(tmesh.make_mesh())
    one = Engine(device=card)
    for name in ("q4_1", "q3_2"):
        q = ssb.NATIVE_QUERIES[name]
        for _ in range(3):
            got = eng.execute(q, ds)
        assert eng.last_metrics.mesh_shape == (n, 1)
        _mesh_frames_close(got, one.execute(q, ds))


# -- processes and the cluster on the card -------------------------------------


def test_two_ranks_on_one_card_over_gloo_equal_the_slice_mesh(card, tmp_path):
    """Two processes on the card, merged over gloo through the host (NCCL
    will not put two ranks on one card): every case of
    `test_torch_multihost` bit-equal on both ranks and to this process's
    2 x 1 slice mesh of the card under the hierarchical tree, each rank
    holding half its residency."""
    from spark_druid_olap_tpu_torch.parallel import mesh as tmesh
    from test_torch_multihost import CASES, run_cases, spawn

    ranks = spawn(tmp_path, 2, 1, device="cuda:0")
    single = run_cases(tmesh.make_slice_mesh(2, 1, [card] * 2))
    for res in ranks:
        assert res["info"]["process_count"] == 2
        for case, *_ in CASES:
            pd.testing.assert_frame_equal(res[case]["frame"], single[case]["frame"],
                                          check_exact=True)
            assert res[case]["strategy"] == single[case]["strategy"]
            assert res[case]["resident"] * 2 == single[case]["resident"] > 0, case


def test_historical_on_the_card_answers_as_a_cpu_historical(card, tmp_path):
    """A broker over one historical on the card and one over a CPU
    historical, both booted from one store: the same frames (sums within
    rtol 1e-5: the kernel and its plain version add in other orders), the
    card's partials launched by the kernel."""
    from spark_druid_olap_tpu_torch.cluster import ClusterClient, HistoricalNode

    broker = TPUOlapContext(SessionConfig(storage_dir=str(tmp_path)), device="cpu")
    ssb.register(broker, scale=0.01, rows_per_segment=8192)
    ds = broker.catalog.get("lineorder")
    frames = {}
    for dev in (card, "cpu"):
        node = HistoricalNode(f"h-{torch.device(dev).type}", str(tmp_path), device=dev).start()
        client = ClusterClient(broker, nodes={node.node_id: node.url}, replication=1)
        try:
            before = cg.LAUNCHES
            cases = {"q1_1": ssb.NATIVE_QUERIES["q1_1"], "q4_1": ssb.NATIVE_QUERIES["q4_1"],
                     "timeseries": ssb.TIMESERIES_QUERY, "topn": ssb.TOPN_QUERY}
            for name, q in cases.items():
                assert client.covers(q, ds), name
                frames.setdefault(name, {})[str(dev)] = client.execute(q, ds)
                assert client.last_metrics.executor == "cluster" and not client.last_metrics.partial
            if torch.device(dev).type == "cuda":
                assert cg.LAUNCHES > before
        finally:
            client.close()
            node.shutdown()
    for name, got in frames.items():
        _mesh_frames_close(got[str(card)], got["cpu"])
    broker.close()
