"""Multi-device execution: the port's `DistributedEngine` on 8 logical CPU
shards against the JAX package's on the conftest's 8 CPU devices.

The meshes are (8, 1), (4, 2) and a 2 x 4 slice mesh under the flat and the
hierarchical merge tree (the reference's tree pinned by its cost constants,
the port's by the same constants).  Parity contract: group keys, counts,
minima, maxima and HLL estimates exact; float sums within rtol 1e-6 (the
merge adds the shards' states in another order than `psum`); quantile
estimates equal where the shards hold the reference's rows (the
dense-state path concatenates and splits a scope as the reference does).
Behaviour held on the port alone, against its single-device engine or a
float64 oracle: the sparse slots ladder, durable shard residency and
scope pruning, a retry after a fault at `mesh.dispatch`, deadline partials
and their coverage, the arena's programs, a fused batch, state capture and
merge for delta reuse, the fault 0(a) repair (scatter sums at few groups
against the oracle), and a context that plans onto the mesh.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from spark_druid_olap_tpu import resilience as jres
from spark_druid_olap_tpu.catalog import segment as jseg
from spark_druid_olap_tpu.config import SessionConfig as JConfig
from spark_druid_olap_tpu.parallel.distributed import DistributedEngine as JDist
from spark_druid_olap_tpu.parallel.mesh import make_mesh as jmake_mesh
from spark_druid_olap_tpu.parallel.mesh import make_slice_mesh as jmake_slice_mesh
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu.workloads import tpch as jtpch
from spark_druid_olap_tpu_torch import resilience
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.catalog.segment import (
    DimensionDict,
    build_datasource,
    datasource_from_numpy,
    datasource_to_numpy,
)
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.exec.engine import Engine, segments_in_scope
from spark_druid_olap_tpu_torch.exec.lowering import groupby_with_time_granularity, memo_key
from spark_druid_olap_tpu_torch.models import aggregations as A
from spark_druid_olap_tpu_torch.models.dimensions import DimensionSpec
from spark_druid_olap_tpu_torch.models.filters import Bound, InFilter
from spark_druid_olap_tpu_torch.models.query import GroupByQuery
from spark_druid_olap_tpu_torch.parallel import mesh as tmesh
from spark_druid_olap_tpu_torch.parallel import spmd_arena
from spark_druid_olap_tpu_torch.parallel.distributed import DistributedEngine
from spark_druid_olap_tpu_torch.workloads import ssb as tssb
from spark_druid_olap_tpu_torch.workloads import tpch as ttpch
from test_torch_engine import to_reference

RTOL = 1e-6
CPU8 = ["cpu"] * 8
MESHES = ("8x1", "4x2", "slice-flat", "slice-hier")


def _tree_constants(kind):
    """Rates that make the cost model pick the tree `kind` names on a slice
    mesh (equal in both packages)."""
    if kind == "slice-flat":
        return {"collective_bytes_per_us": 1e3, "dcn_bytes_per_us": 1e9}
    return {"collective_bytes_per_us": 1e9, "dcn_bytes_per_us": 1e3}


def port_engine(kind, strategy="auto"):
    if kind == "8x1":
        m = tmesh.make_mesh(8, 1, CPU8)
    elif kind == "4x2":
        m = tmesh.make_mesh(4, 2, CPU8)
    else:
        m = tmesh.make_slice_mesh(2, 4, CPU8)
    eng = DistributedEngine(m, strategy=strategy)
    cfg = SessionConfig.load_calibrated(device="cpu")
    if kind.startswith("slice"):
        cfg = dataclasses.replace(cfg, **_tree_constants(kind))
    eng.cost_config = cfg
    return eng


def ref_engine(kind, strategy="auto"):
    if kind == "8x1":
        m = jmake_mesh(n_data=8)
    elif kind == "4x2":
        m = jmake_mesh(n_data=4, n_groups=2)
    else:
        m = jmake_slice_mesh(2, 4)
    eng = JDist(mesh=m, strategy=strategy)
    cfg = JConfig.load_calibrated()
    if kind.startswith("slice"):
        cfg = dataclasses.replace(cfg, **_tree_constants(kind))
    eng._calibrated_cfg = cfg
    return eng


@pytest.fixture(scope="module")
def data():
    """Reference datasources over several segments (SSB ~12K rows in 4096-row
    segments, TPC-H ~6K rows in 2048-row segments), and the port's copies
    of the same segments."""
    cols, dicts = jssb.flat_columns(jssb.gen_tables(0.002, seed=7))
    ssb_ds = jseg.build_datasource(
        "lineorder", cols, jssb.FLAT_DIMS, jssb.FLAT_METRICS,
        time_col="lo_orderdate", rows_per_segment=4096, dicts=dicts)
    cols, dicts = jtpch.flat_columns(jtpch.gen_tables(0.001))
    tpch_ds = jseg.build_datasource(
        "lineitem", cols, jtpch.FLAT_DIMS, jtpch.FLAT_METRICS,
        time_col="l_shipdate", rows_per_segment=2048, dicts=dicts)
    ref = {"ssb": ssb_ds, "tpch": tpch_ds}
    return ref, {k: datasource_from_numpy(datasource_to_numpy(v)) for k, v in ref.items()}


def q1_minmax():
    """TPC-H Q1 with a filter and the extrema (the reference test's shape)."""
    q = ttpch.NATIVE_QUERIES["q1"]
    return dataclasses.replace(q, aggregations=q.aggregations + (
        A.DoubleMin("min_p", "l_extendedprice"), A.DoubleMax("max_p", "l_extendedprice")))


def quantity_query(datasource, dim, qty, price):
    """Counts, extrema and integer-valued sums (a quantity, exact in float32
    at these sizes, so the scatter's float64 accumulation and the
    reference's float32 one agree), one of them under a FILTER."""
    return GroupByQuery(
        datasource=datasource,
        dimensions=(DimensionSpec(dim, dim),),
        aggregations=(A.Count("n"), A.DoubleSum("qty", qty), A.DoubleMin("lo", price),
                      A.DoubleMax("hi", price),
                      A.FilteredAgg(Bound(qty, upper="25", ordering="numeric"),
                                    A.DoubleSum("qty_small", qty))),
    )


QUERIES = {
    "q1": ("tpch", q1_minmax),
    "qty_tpch": ("tpch", lambda: quantity_query("lineitem", "l_returnflag", "l_quantity",
                                                "l_extendedprice")),
    "qty_ssb": ("ssb", lambda: quantity_query("lineorder", "c_nation", "lo_quantity",
                                              "lo_revenue")),
    "q4_1": ("ssb", lambda: tssb.NATIVE_QUERIES["q4_1"]),
    "timeseries": ("ssb", lambda: tssb.TIMESERIES_QUERY),
    "topn": ("ssb", lambda: tssb.TOPN_QUERY),
}


def assert_same(got, want, rtol=RTOL):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    floats = [c for c in want.columns if want[c].dtype.kind == "f"]
    keys = [c for c in want.columns if c not in floats]
    if keys:
        got = got.sort_values(keys, kind="stable").reset_index(drop=True)
        want = want.sort_values(keys, kind="stable").reset_index(drop=True)
    for c in keys:
        np.testing.assert_array_equal(np.asarray(got[c]), np.asarray(want[c]), err_msg=c)
    for c in floats:
        np.testing.assert_allclose(np.asarray(got[c], np.float64), np.asarray(want[c], np.float64),
                                   rtol=rtol, err_msg=c)


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("name,strategy", [("q1", "dense"), ("qty_tpch", "segment"),
                                           ("q4_1", "dense"), ("timeseries", "dense"),
                                           ("topn", "dense"), ("qty_ssb", "segment")])
def test_mesh_matches_reference(data, kind, name, strategy):
    ref, port = data
    workload, make = QUERIES[name]
    q = make()
    teng = port_engine(kind, strategy)
    want = ref_engine(kind, strategy).execute(to_reference(q), ref[workload])
    got = teng.execute(q, port[workload])
    assert_same(got, want)
    m = teng.last_metrics
    assert m.distributed and m.segments == len(segments_in_scope(
        groupby_with_time_granularity(teng._groupby_family(q, port[workload])[0]),
        port[workload]))
    assert m.strategy == ("dense" if strategy == "dense" else "segment")
    if kind.startswith("slice"):
        assert m.merge_tree == ("flat" if kind == "slice-flat" else "hierarchical")
        assert m.mesh_shape == (8, 1)  # the slice mesh flattened, as the reference reports
    # a repeat folds in the same order: bit-identical
    pd.testing.assert_frame_equal(teng.execute(q, port[workload]), got)


@pytest.mark.parametrize("kind", ("8x1", "4x2"))
def test_sketches_match_reference(data, kind):
    """HLL and theta estimates exact against the reference's mesh; the
    quantile sample equal to the single device's (a row hashes its segment
    position, so the sample does not depend on the shards; the reference's
    mesh hashes shard positions, a sample as good but another one), its
    estimates within the rank bound of the oracle."""
    ref, port = data
    q = GroupByQuery(
        datasource="lineitem",
        dimensions=(DimensionSpec("l_returnflag", "l_returnflag"),),
        aggregations=(A.HyperUnique("hll", "l_orderkey"),
                      A.ThetaSketch("theta", "l_orderkey", size=1024),
                      A.QuantilesSketch("qs", "l_extendedprice", size=256),
                      A.Count("n")),
        post_aggregations=(A.QuantileFromSketch("p50", "qs", 0.5),),
    )
    want = ref_engine(kind).execute(to_reference(q), ref["tpch"])
    got = port_engine(kind).execute(q, port["tpch"])
    single = Engine(device="cpu").execute(q, port["tpch"])
    got, want, single = (f.sort_values("l_returnflag").reset_index(drop=True)
                         for f in (got, want, single))
    for c in ("l_returnflag", "hll", "theta", "qs", "n"):
        np.testing.assert_array_equal(np.asarray(got[c]), np.asarray(want[c]), err_msg=c)
    np.testing.assert_array_equal(np.asarray(got["p50"]), np.asarray(single["p50"]))
    frame = ttpch.flat_frame(jtpch.gen_tables(0.001))
    for flag, est in zip(got["l_returnflag"], got["p50"]):
        values = np.sort(frame.loc[frame["l_returnflag"] == flag, "l_extendedprice"]
                         .to_numpy(np.float64))
        assert tssb.quantile_rank_error(values, float(est), 0.5) <= tssb.quantile_rank_bound(
            0.5, 256)


def _high_g(name, n=30_000, da=900, db=900, populated=2_000, seed=3, segs=4):
    """The reference test's high-cardinality datasource: G = 810K, few pairs
    present.  Returns (port datasource, the reference's over the same
    columns, the columns)."""
    rng = np.random.default_rng(seed)
    pairs = rng.choice(da * db, size=populated, replace=False)
    pick = rng.integers(0, populated, size=n)
    cols = {
        "a": (pairs[pick] // db).astype(np.int64),
        "b": (pairs[pick] % db).astype(np.int64),
        "v": (rng.random(n) * 100).astype(np.float32),
    }
    ds = build_datasource(
        name, cols, dimension_cols=["a", "b"], metric_cols=["v"],
        rows_per_segment=n // segs,
        dicts={"a": DimensionDict(values=tuple(range(da))),
               "b": DimensionDict(values=tuple(range(db)))})
    ref = jseg.build_datasource(
        name, cols, dimension_cols=["a", "b"], metric_cols=["v"],
        rows_per_segment=n // segs,
        dicts={"a": jseg.DimensionDict(values=tuple(range(da))),
               "b": jseg.DimensionDict(values=tuple(range(db)))})
    return ds, ref, cols


def _high_g_query(name, filt=None):
    return GroupByQuery(
        datasource=name,
        dimensions=(DimensionSpec("a", "a"), DimensionSpec("b", "b")),
        aggregations=(A.Count("n"), A.DoubleSum("s", "v"), A.DoubleMin("lo", "v"),
                      A.DoubleMax("hi", "v")),
        filter=filt,
    )


def _oracle(cols, mask=None):
    df = pd.DataFrame({k: np.asarray(v) for k, v in cols.items()})
    if mask is not None:
        df = df[mask]
    return (df.groupby(["a", "b"], as_index=False)
            .agg(n=("v", "count"), s=("v", "sum"), lo=("v", "min"), hi=("v", "max"))
            .sort_values(["a", "b"]).reset_index(drop=True))


def _check_high_g(got, want):
    got = got.sort_values(["a", "b"]).reset_index(drop=True)
    assert len(got) == len(want)
    for c in ("a", "b", "n"):
        np.testing.assert_array_equal(np.asarray(got[c], np.int64), np.asarray(want[c], np.int64))
    for c in ("lo", "hi"):
        np.testing.assert_array_equal(np.asarray(got[c], np.float32), np.asarray(want[c], np.float32))
    np.testing.assert_allclose(got["s"], want["s"], rtol=2e-5)


@pytest.mark.parametrize("kind", ("8x1", "4x2"))
def test_sparse_matches_reference(kind):
    """The sparse rung: per-shard slot compaction, an all-gather and the
    `merge_sparse_states` fold; the groups axis splits the gid domain."""
    ds, ref_ds, cols = _high_g("hcm_" + kind)
    q = _high_g_query(ds.name)
    want = ref_engine(kind, "sparse").execute(to_reference(q), ref_ds)
    eng = port_engine(kind, "sparse")
    got = eng.execute(q, ds)
    assert eng.last_metrics.strategy == "sparse"
    assert_same(got, want)
    _check_high_g(got, _oracle(cols))


def test_sparse_slots_ladder_climbs_and_remembers():
    """More present groups than the first slots rung: the engine reruns one
    rung up, remembers it, and the answer holds."""
    ds, _, cols = _high_g("hcm_ladder", n=20_000, populated=5_000)
    q = _high_g_query(ds.name)
    eng = port_engine("8x1", "sparse")
    _check_high_g(eng.execute(q, ds), _oracle(cols))
    qkey = memo_key(groupby_with_time_granularity(q), ds)
    assert eng._sparse_slots[qkey] > 4096
    assert eng.last_metrics.sparse_passes == 2
    _check_high_g(eng.execute(q, ds), _oracle(cols))
    assert eng.last_metrics.sparse_passes == 1


def test_adaptive_matches_reference():
    """Presence counts summed across shards, then the compacted pass."""
    ds, ref_ds, cols = _high_g("hcm_adaptive")
    keep = tuple(range(30))
    q = _high_g_query(ds.name, InFilter("a", keep))
    want = ref_engine("8x1", "adaptive").execute(to_reference(q), ref_ds)
    eng = port_engine("8x1", "adaptive")
    got = eng.execute(q, ds)
    m = eng.last_metrics
    assert m.strategy == "adaptive" and m.compact_groups < 100_000
    assert_same(got, want)
    _check_high_g(got, _oracle(cols, np.isin(cols["a"], keep)))
    eng.execute(q, ds)
    assert eng.last_metrics.kept_source in ("memo", "derived")


@pytest.mark.parametrize("rung", ("dense", "sparse", "adaptive"))
def test_long_shards_run_in_blocks(data, monkeypatch, rung):
    """A shard longer than SHARD_BLOCK_ROWS runs a launch per block, the
    blocks' states folded in row order (the sparse tier's merged, the
    presence counts summed): the answers hold the reference's, and no
    launch takes more than a block."""
    from spark_druid_olap_tpu_torch.parallel import distributed as tdist

    monkeypatch.setattr(tdist, "SHARD_BLOCK_ROWS", 1024)
    seen = []

    def recording(fn):
        def run(gid, *a, **kw):
            seen.append(gid.shape[0])
            return fn(gid, *a, **kw)
        return run

    monkeypatch.setattr(tdist, "partial_aggregate", recording(tdist.partial_aggregate))
    monkeypatch.setattr(tdist.sg, "sparse_partial_aggregate",
                        recording(tdist.sg.sparse_partial_aggregate))
    if rung == "dense":
        ref, port = data
        q = q1_minmax()
        want = ref_engine("4x2", "dense").execute(to_reference(q), ref["tpch"])
        got = port_engine("4x2", "dense").execute(q, port["tpch"])
        assert_same(got, want)
    else:
        ds, ref_ds, cols = _high_g("hcm_blocks_" + rung)
        keep = tuple(range(30))
        q = _high_g_query(ds.name, InFilter("a", keep) if rung == "adaptive" else None)
        want = ref_engine("8x1", rung).execute(to_reference(q), ref_ds)
        eng = port_engine("8x1", rung)
        got = eng.execute(q, ds)
        assert eng.last_metrics.strategy == rung
        assert_same(got, want)
        mask = np.isin(cols["a"], keep) if rung == "adaptive" else None
        _check_high_g(got, _oracle(cols, mask))
    assert seen and max(seen) <= 1024 and len(seen) > 8


def test_progressive_declines_the_mesh_and_ignores_its_breaker():
    """`sql_progressive` streams no query planned onto the mesh (the mesh
    has no per-segment refinement; `sql` answers it), and an open mesh
    breaker does not stop a single-device query from streaming."""
    tables = tssb.gen_tables(0.002, seed=7)
    ctx = TPUOlapContext(SessionConfig(result_cache_entries=0), device="cpu", devices=CPU8)
    tssb.register(ctx, tables=tables, rows_per_segment=4096)
    ctx.sql("SET cost_model_enabled = false")
    sql = tssb.QUERIES["q4_1"]
    assert ctx._backend_for(ctx.plan_sql(sql)) == "mesh"
    assert ctx.sql_progressive(sql) is None
    br = ctx.resilience.breaker_for("mesh")
    for _ in range(ctx.config.breaker_failure_threshold):
        br.record_failure()
    assert br.state == "open"
    ctx.sql("SET prefer_distributed = false")
    assert ctx._backend_for(ctx.plan_sql(sql)) == "device"
    frames = [df for df, _ in ctx.sql_progressive(sql)]
    assert len(frames) >= 2
    assert_same(frames[-1], ctx.sql(sql))
    assert br.state == "open" and ctx.resilience.breaker_for("device").state == "closed"


def test_shard_residency_is_durable_and_scoped(data):
    """A scope's shards are placed once and serve every query over it; a
    query pruned to fewer segments places only its scope, and its metrics
    count the pruned scope."""
    _, port = data
    ds = port["ssb"]
    eng = port_engine("4x2", "dense")  # the groups axis: the row-shard path
    q = tssb.NATIVE_QUERIES["q4_1"]
    eng.execute(q, ds)
    assert eng.last_metrics.h2d_bytes > 0
    eng.execute(q, ds)
    assert eng.last_metrics.h2d_bytes == 0
    segs = list(ds.segments)
    lo, hi = segs[1].interval[0], segs[1].interval[1]
    pruned = dataclasses.replace(q, intervals=((lo, hi),))
    scope = segments_in_scope(groupby_with_time_granularity(pruned), ds)
    assert 0 < len(scope) < len(segs)
    before = set(eng._shard_cache)
    want = Engine(device="cpu", strategy="dense").execute(pruned, ds)
    assert_same(eng.execute(pruned, ds), want)
    m = eng.last_metrics
    assert m.segments == len(scope)
    assert m.rows_scanned == sum(s.num_rows for s in scope)
    placed = set(eng._shard_cache) - before
    assert placed and {k[4] for k in placed} == {tuple(s.uid for s in scope)}


def test_retry_after_a_fault_at_mesh_dispatch(data):
    ref, port = data
    q = q1_minmax()
    want = ref_engine("8x1", "dense").execute(to_reference(q), ref["tpch"])
    eng = port_engine("8x1", "dense")
    resilience.injector().arm("mesh.dispatch", mode="error", times=1)
    try:
        got = eng.execute(q, port["tpch"])
    finally:
        resilience.injector().disarm()
    assert eng.last_metrics.retries == 1
    assert eng.breaker.state == "closed"
    assert_same(got, want)


@pytest.fixture(scope="module")
def fine_segments():
    """The SSB rows in 512-row segments: 24 blocks, 3 local steps a shard."""
    cols, dicts = jssb.flat_columns(jssb.gen_tables(0.002, seed=7))
    ref = jseg.build_datasource(
        "lineorder", cols, jssb.FLAT_DIMS, jssb.FLAT_METRICS,
        time_col="lo_orderdate", rows_per_segment=512, dicts=dicts)
    return ref, datasource_from_numpy(datasource_to_numpy(ref))


@pytest.mark.parametrize("k", (0, 1, 2))
def test_deadline_partials_match_reference(fine_segments, k):
    """An expiry before local step k of the arena's step loop: the partial
    answer folds the blocks of steps 0..k-1 on every shard, as the
    reference's chunk loop does, and its coverage counts their rows."""
    ref_ds, ds = fine_segments
    q = tssb.NATIVE_QUERIES["q4_1"]
    frames, pcs = [], []
    for pkg, eng, qq, d in ((resilience, port_engine("8x1", "dense"), q, ds),
                            (jres, ref_engine("8x1", "dense"), to_reference(q), ref_ds)):
        pkg.injector().arm("mesh.segment_loop", error_type=pkg.InjectedDeadline, skip=k,
                           times=1)
        try:
            with pkg.deadline_scope(60_000), pkg.partial_scope(True) as pc:
                frames.append(eng.execute(qq, d))
        finally:
            pkg.injector().disarm()
        pcs.append(pc)
    assert_same(frames[0], frames[1])
    scope = segments_in_scope(groupby_with_time_granularity(q), ds)
    layout = spmd_arena.plan_spmd_layout(ds, 8)
    blocks = sorted(layout.index[s.uid] for s in scope)
    j_lo, _ = spmd_arena.scope_window(layout, blocks)
    seen = sum(layout.segs[b].num_rows for b in blocks if b // 8 < j_lo + k)
    assert pcs[0].is_partial and pcs[0].rows_seen == seen
    assert pcs[0].coverage() == pcs[1].coverage()


def test_arena_programs_and_fused_batch(data):
    """The arena's per-device programs are built once per scope window and
    reused; a fused batch gives every member its serial frame and the
    reference's."""
    ref, port = data
    ds, ref_ds = port["ssb"], ref["ssb"]
    names = ("q1_1", "q1_2", "q1_3", "q4_1")
    qs = [tssb.NATIVE_QUERIES[n] for n in names]
    eng = port_engine("8x1", "dense")
    for _ in range(2):
        eng.execute(qs[3], ds)
        assert eng.last_metrics.dispatch_count == 1 and eng.last_metrics.arena_segments > 0
    n_programs = len(list(eng._programs))
    eng.execute(qs[3], ds)
    assert len(list(eng._programs)) == n_programs
    assert all(eng.fusable(q, ds) for q in qs)
    want = JDist(mesh=jmake_mesh(n_data=8), strategy="dense").execute_fused(
        [to_reference(q) for q in qs], ref_ds)
    for _ in range(2):
        got = eng.execute_fused(qs, ds)
        for (df, state, m), (wdf, _, _), q in zip(got, want, qs):
            assert m.fused_batch == 4 and m.distributed
            assert_same(df, wdf)
            assert_same(df, eng.execute(q, ds))
            assert state["sums"].flags.owndata or state["sums"].base is not None


def test_state_capture_and_delta_merge(data):
    """The merged host state of an execution, and the partials of a subset
    of segments merged with the rest's, finalize to the full answer."""
    _, port = data
    ds = port["ssb"]
    q = tssb.NATIVE_QUERIES["q4_1"]
    eng = port_engine("8x1", "dense")
    with eng.state_capture() as cap:
        full = eng.execute(q, ds)
    assert cap["state"] is not None
    uids = [s.uid for s in ds.segments]
    a, _ = eng.groupby_partials_host(q, ds, within_uids=uids[:-1])
    b, m = eng.groupby_partials_host(q, ds, within_uids=uids[-1:])
    assert m.distributed
    merged = eng.merge_groupby_states(q, ds, a, b)
    assert_same(eng.finalize_groupby_state(q, ds, merged), full)
    assert_same(eng.finalize_groupby_state(q, ds, cap["state"]), full)


@pytest.mark.parametrize("name", ("timeseries", "q1"))
def test_scatter_sums_hold_the_oracle_at_few_groups(name):
    """Fault 0(a): pinned to the scatter at few groups (the Timeseries' 84
    months, TPC-H Q1's 12 groups) over 2^19-row segments, the sums hold
    the float64 oracle's rtol 2e-5: a segment's sums accumulate in
    float64."""
    if name == "timeseries":
        tables = tssb.gen_tables(0.1, seed=7)
        cols, dicts = tssb.flat_columns(tables)
        ds = tssb.datasource(cols, dicts)
        q, frame = tssb.TIMESERIES_QUERY, tssb.flat_frame(tables)
        want = tssb.oracle(frame, "timeseries")
        got = Engine(device="cpu", strategy="segment").execute(q, ds)
        g = np.asarray(got["revenue"], np.float64)
        w = np.asarray(want["revenue"], np.float64)
    else:
        tables = ttpch.gen_tables(0.1)
        cols, dicts = ttpch.flat_columns(tables)
        ds = ttpch.datasource(cols, dicts, rows_per_segment=1 << 19)
        q = ttpch.NATIVE_QUERIES["q1"]
        want = ttpch.oracle(ttpch.flat_frame(tables), "q1")
        got = Engine(device="cpu", strategy="segment").execute(q, ds)
        keys = ["l_returnflag", "l_linestatus"]
        got = got.sort_values(keys).reset_index(drop=True)
        want = want.sort_values(keys).reset_index(drop=True)
        sums = [c for c in want.columns if c.startswith("sum_")]
        g = got[sums].to_numpy(np.float64)
        w = want[sums].to_numpy(np.float64)
    assert max(s.num_rows for s in ds.segments) >= 1 << 18
    np.testing.assert_allclose(g, w, rtol=2e-5)


@pytest.mark.parametrize("groups,sort", [(84, True), (84, False), (150_001, False)])
def test_scatter_row_blocks_sum_as_one_pass(monkeypatch, groups, sort):
    """The card's row-block accumulation of the scatter's float64 sums (a
    table row per block and group, the blocks summed after) gives the
    float32 rounding of the exact sums, as the one pass does, whether a
    segment's rows fall in few groups (time-sorted) or spread."""
    from spark_druid_olap_tpu_torch.ops import groupby as tg

    rng = np.random.default_rng(groups)
    R = 1 << 16
    gid = rng.integers(0, groups, R)
    gid = np.sort(gid) if sort else gid
    gid = torch.tensor(gid.astype(np.int32))
    mask = torch.tensor(rng.random(R) < 0.9)
    vals = torch.tensor(rng.random((R, 2)).astype(np.float32) * 1000)
    none_f, none_b = torch.zeros((R, 0)), torch.zeros((R, 0), dtype=torch.bool)
    one = tg.scatter_partial_aggregate(gid, mask, vals, none_f, none_b, groups)[0]
    monkeypatch.setattr(tg, "_blocked_accumulation", lambda dev: True)
    monkeypatch.setattr(tg, "SCATTER_BLOCK_ROWS", 256)
    blocked = tg.scatter_partial_aggregate(gid, mask, vals, none_f, none_b, groups)[0]
    exact = torch.zeros((groups, 2), dtype=torch.float64).index_add_(
        0, gid[mask].long(), vals[mask].double()).to(torch.float32)
    np.testing.assert_array_equal(blocked.numpy(), exact.numpy())
    np.testing.assert_array_equal(one.numpy(), exact.numpy())


def test_context_plans_onto_the_mesh_and_set_replans():
    """A context over 8 CPU devices routes a GroupBy to the mesh engine
    under its own "mesh" breaker; SET on the three flags replans."""
    tables = tssb.gen_tables(0.002, seed=7)
    one = TPUOlapContext(SessionConfig(result_cache_entries=0), device="cpu")
    ctx = TPUOlapContext(SessionConfig(result_cache_entries=0), device="cpu", devices=CPU8)
    for c in (one, ctx):
        tssb.register(c, tables=tables, rows_per_segment=4096)
    ctx.sql("SET cost_model_enabled = false")
    sql = tssb.QUERIES["q4_1"]
    assert_same(ctx.sql(sql), one.sql(sql))
    m = ctx.last_metrics
    assert m.distributed and m.mesh_shape == (8, 1)
    assert ctx._backend_for(ctx.plan_sql(sql)) == "mesh"
    assert ctx._dist_engine.breaker is ctx.resilience.breaker_for("mesh")
    assert ctx.engine.breaker is ctx.resilience.breaker_for("device")
    ctx.sql("SET mesh_groups_axis = 2")
    assert ctx.plan_sql(sql).physical.mesh_shape == (4, 2)
    assert_same(ctx.sql(sql), one.sql(sql))
    assert ctx.last_metrics.mesh_shape == (4, 2)
    ctx.sql("SET mesh_data_axis = 2")
    assert ctx.plan_sql(sql).physical.mesh_shape == (2, 2)
    ctx.sql("SET prefer_distributed = false")
    assert not ctx.plan_sql(sql).physical.distributed
    assert_same(ctx.sql(sql), one.sql(sql))
    assert not ctx.last_metrics.distributed
    assert not one.plan_sql(sql).physical.distributed  # one device: never the mesh


def test_sampled_mesh_query_receipts_per_shard_device_time():
    """A sampled query on the mesh: its receipt carries each shard's device
    time (on the CPU each shard's host time), its metrics the same list;
    an unsampled one carries none."""
    tables = tssb.gen_tables(0.002, seed=7)
    ctx = TPUOlapContext(SessionConfig(result_cache_entries=0), device="cpu", devices=CPU8)
    tssb.register(ctx, tables=tables, rows_per_segment=4096)
    ctx.sql("SET cost_model_enabled = false")
    sql = tssb.QUERIES["q4_1"]
    assert "shard_device_ms" not in ctx.sql(sql).attrs["receipt"]
    ctx.tracer.force_sample_next()
    rc = ctx.sql(sql).attrs["receipt"]
    shards = rc["shard_device_ms"]
    assert len(shards) >= 1 and all(len(d) == 8 and min(d) >= 0 for d in shards)
    assert ctx.last_metrics.shard_device_ms == shards[-1]
    assert rc["dispatch_count"] >= 1


def test_mesh_requires_devices_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedEngine()
