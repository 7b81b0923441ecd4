"""The cost model of the PyTorch port against the JAX reference's, on the CPU.

* **The single-device model.**  `scatter_row_cost`, `_kernel_costs`,
  `choose_kernel_strategy`, `query_kernel_costs`, `choose_query_kernel` and
  `choose_physical` with one device give the reference's costs (within
  rel 1e-12: the same float arithmetic) and decisions (exactly) under
  equal constants, over seeded grids of (rows, G, selectivity, segments)
  and over the SSB and TPC-H specs and plans, for two constant sets (the
  reference's defaults and its CPU profile), and on the single-device
  cases of `tests/test_cost_model.py`.  Equal constants: the reference's
  cost fields passed to both packages, `dense_max_groups` 4096 (on a card
  the port's dense class is the kernel, which stops there), and the
  port's `dense_tile_groups` at the reference's 128-group tile.
* **Deliberate differences, held as such.**  The port's dense tile width is
  its own, measured on its card (`dense_tile_groups`); a TopN prices its
  dimension (held against the reference's prices of the TopN's GroupBy
  form, which the engine runs; the reference reads `dimensions`, which a
  TopN lacks); on a card the dense class is priced inf above 4096 groups
  whatever `dense_max_groups` says, with the model on or off.
* **Routing.**  Each class the model picks (dense, segment, sparse,
  adaptive) routes the engine to it, as the reference's plan routes its
  engine, and the frames match the reference's (keys and counts exact,
  sums within rtol 1e-6).  `SET` of a constant replans at once; two
  threads with different plans each run their own strategy (the engine's
  attribute never changes).  A grouping set narrow enough for the kernel
  under a plan of the scatter class takes its own G's class.  The adaptive
  tier's compacted pass and the stream take the model's class at their own
  (rows, G), as the reference's do.
* **The mesh half.**  `choose_physical` at `n_devices` 8 plans the mesh as
  the reference does (the class, the target, the mesh shape, the modelled
  mesh cost within rel 1e-12) under equal constants, the collective rate,
  `prefer_distributed` and the two axis flags included, over the SSB and
  TPC-H specs; `choose_merge_tree` and `groupby_state_bytes` give the
  reference's values over a seeded grid; `SET` on `prefer_distributed`,
  `mesh_data_axis` and `mesh_groups_axis` replans a context over 8 devices.
* **The calibrated assist.**  Under equal constants it assists a
  q2-class subtree (a few groups over the base) and declines a q18-class
  one (a group per order), as the reference decides, with the modelled
  figures in the decline; `missing_resident_bytes` counts what is not
  resident on the device (a pinned host copy still has to cross).
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu.config import SessionConfig as JaxConfig
from spark_druid_olap_tpu.exec import lowering as jlowering
from spark_druid_olap_tpu.exec import streaming as jstreaming
from spark_druid_olap_tpu.exec.engine import Engine as JaxEngine
from spark_druid_olap_tpu.plan import cost as jcost
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu.workloads import tpch as jtpch
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.exec import lowering as tlowering
from spark_druid_olap_tpu_torch.exec import streaming as tstreaming
from spark_druid_olap_tpu_torch.exec.engine import Engine
from spark_druid_olap_tpu_torch.models import aggregations as A
from spark_druid_olap_tpu_torch.models.dimensions import DimensionSpec
from spark_druid_olap_tpu_torch.models.query import GroupByQuery, ScanQuery
from spark_druid_olap_tpu_torch.plan import cost as tcost
from spark_druid_olap_tpu_torch.utils import datagen
from spark_druid_olap_tpu_torch.workloads import ssb as tssb
from spark_druid_olap_tpu_torch.workloads import tpch as ttpch
from test_torch_engine import CASES, assert_frames_match, datasources, to_reference  # noqa: F401

INF = float("inf")
COST_FIELDS = (
    "cost_model_enabled", "dense_max_groups", "cost_per_row_dense", "cost_per_row_scatter",
    "cost_per_row_scatter_hi", "scatter_lo_groups", "scatter_hi_groups",
    "cost_per_row_sparse", "cost_per_row_compact", "cost_per_group_state",
    "cost_dispatch_us", "h2d_bytes_per_s", "cost_per_row_interp", "cost_per_group_decode",
)
# the reference's CPU profile (its config.apply_platform_profile), as its
# own tests/test_cost_model.py sets it
CPU_PROFILE = dict(
    cost_per_row_dense=0.58, cost_per_row_scatter=0.0012, cost_per_row_scatter_hi=0.0071,
    scatter_lo_groups=1024, scatter_hi_groups=1 << 21, cost_per_row_sparse=0.49,
    cost_per_row_compact=0.0012, cost_per_group_state=0.0023,
)
CONSTANTS = {"reference_defaults": {}, "cpu_profile": CPU_PROFILE}


def configs(**kw):
    """(reference config, port config) with equal constants: `kw` on the
    reference's defaults, dense_max_groups 4096, one device, and the port's
    dense tile at the reference's 128 groups."""
    ref = JaxConfig(**{"dense_max_groups": 4096, "prefer_distributed": False, **kw})
    fields = {f.name for f in dataclasses.fields(SessionConfig)}
    port = SessionConfig(dense_tile_groups=128, **{
        **{k: v for k, v in kw.items() if k in fields},
        **{k: getattr(ref, k) for k in COST_FIELDS}})
    return ref, port


def _close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-12), k


def _grid(seed, n=60):
    """Seeded (rows, G, selectivity, segments, sparse_ok, adaptive_ok, ndims)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (int(10 ** rng.uniform(3, 9)), int(10 ** rng.uniform(0, 6.5)),
               1.0 if rng.random() < 0.3 else float(10 ** rng.uniform(-5, 0)),
               int(rng.integers(1, 1200)), bool(rng.random() < 0.7),
               bool(rng.random() < 0.7), int(rng.integers(1, 5)))


# -- the single-device model, function by function ------------------------------


@pytest.mark.parametrize("consts", sorted(CONSTANTS))
def test_scatter_row_cost_matches_reference(consts):
    ref, port = configs(**CONSTANTS[consts])
    for g in [1, 1023, 1024, 1025, 4096, 65536, 1 << 20, 1 << 21, 1 << 23] + [
            int(10 ** x) for x in np.random.default_rng(1).uniform(0, 7, 40)]:
        assert tcost.scatter_row_cost(g, port) == pytest.approx(
            jcost.scatter_row_cost(g, ref), rel=1e-12), g


@pytest.mark.parametrize("consts", sorted(CONSTANTS))
def test_kernel_costs_match_reference(consts):
    ref, port = configs(**CONSTANTS[consts])
    for rows, g, sel, segs, sparse_ok, adaptive_ok, ndims in _grid(2):
        kw = dict(selectivity=sel, n_segments=segs, adaptive_ok=adaptive_ok, ndims=ndims)
        _close(dict(tcost._kernel_costs(rows, g, port, sparse_ok, **kw)),
               dict(jcost._kernel_costs(rows, g, ref, sparse_ok, **kw)))


@pytest.mark.parametrize("consts", sorted(CONSTANTS))
def test_choose_kernel_strategy_matches_reference(consts):
    ref, port = configs(**CONSTANTS[consts])
    for rows, g, _, _, sparse_ok, _, _ in _grid(3):
        assert tcost.choose_kernel_strategy(rows, g, port, sparse_ok) == \
            jcost.choose_kernel_strategy(rows, g, ref, sparse_ok), (rows, g)


def test_dense_tile_width_is_the_ports_own():
    """The port's deliberate difference: dense prices ceil(G / dense_tile_groups)
    tiles; at 128 the reference's form, at the card's measured width its own."""
    ref, port = configs()
    wide = dataclasses.replace(port, dense_tile_groups=4096)
    for g in (1, 128, 129, 2048, 4096):
        want = dict(jcost._kernel_costs(10 ** 6, g, ref, False))["dense"]
        assert dict(tcost._kernel_costs(10 ** 6, g, port, False))["dense"] == pytest.approx(want)
        assert dict(tcost._kernel_costs(10 ** 6, g, wide, False))["dense"] == pytest.approx(
            10 ** 6 * port.cost_per_row_dense)


@pytest.mark.parametrize("enabled", [True, False])
def test_dense_is_inf_above_4096_on_a_card(enabled):
    """On a card the dense class is the kernel: inf above SCATTER_CUTOVER
    whatever dense_max_groups says, so neither the model nor its "off"
    rule picks it there; on the CPU dense_max_groups decides, as in the
    reference."""
    _, port = configs(dense_max_groups=1 << 20, cost_model_enabled=enabled,
                      cost_per_row_dense=1e-12)
    gb = GroupByQuery(datasource="t", dimensions=(DimensionSpec("d"),),
                      aggregations=(A.DoubleSum("s", "v"),))
    ds = _FakeDS(10 ** 7)
    for g, on_card_inf in ((4096, False), (4097, True), (1 << 19, True)):
        card = dict(tcost._kernel_costs(10 ** 7, g, port, True, adaptive_ok=True, device="cuda"))
        cpu = dict(tcost._kernel_costs(10 ** 7, g, port, True, adaptive_ok=True))
        assert (card["dense"] == INF) == on_card_inf and cpu["dense"] < INF
        pick = tcost.choose_physical(gb, ds, g, port, device="cuda").strategy
        assert (pick == "dense") == (not on_card_inf), (g, pick)
        assert tcost.choose_physical(gb, ds, g, port).strategy == "dense"
        if on_card_inf:
            assert tcost.choose_kernel_strategy(10 ** 7, g, port, device="cuda") == "segment"


class _FakeDS:
    """choose_physical reads num_rows (and dicts for the selectivity walk)."""

    def __init__(self, rows):
        self.num_rows = rows
        self.dicts = {}


def _gb(*aggs, jax=False):
    from spark_druid_olap_tpu.models import aggregations as JA
    from spark_druid_olap_tpu.models.dimensions import DimensionSpec as JDim
    from spark_druid_olap_tpu.models.query import GroupByQuery as JGroupBy

    if jax:
        return JGroupBy(datasource="t", dimensions=(JDim("d"),), aggregations=aggs or (
            JA.DoubleSum("s", "v"), JA.Count("n")))
    return GroupByQuery(datasource="t", dimensions=(DimensionSpec("d"),),
                        aggregations=aggs or (A.DoubleSum("s", "v"), A.Count("n")))


# the single-device cases of tests/test_cost_model.py: (rows, G, constants,
# the decision the reference's test asserts)
REFERENCE_CASES = {
    "small_domain_prefers_dense": (1_000_000, 64, {}, ("dense",)),
    "huge_domain_prefers_sparse": (1_000_000, 8192, {}, ("sparse",)),
    "crossover_follows_constants": (1_000_000, 100_000, dict(
        cost_per_row_scatter=1e-9, cost_per_row_dense=1.0), ("segment", "sparse")),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_single_device_cases(case):
    rows, g, consts, want = REFERENCE_CASES[case]
    ref, port = configs(**consts)
    got = tcost.choose_physical(_gb(), _FakeDS(rows), g, port, 1)
    exp = jcost.choose_physical(_gb(jax=True), _FakeDS(rows), g, ref, 1)
    assert got.strategy == exp.strategy and got.strategy in want
    assert (got.distributed, got.mesh_shape, got.num_groups, got.rows) == (False, None, g, rows)
    assert got.est_cost_local == pytest.approx(exp.est_cost_local, rel=1e-12)


# the CPU-profile shapes of tests/test_cost_model.py: (rows, G, selectivity,
# the class that must beat the other)
PROFILE_CASES = {
    "q3_2_shape_routes_to_sparse": (600_000_000, 504_008, 1.0 / 730, "sparse", "segment"),
    "populated_unfiltered_stays_on_scatter": (100_000_000, 2_000_000, 1.0, "segment", "sparse"),
}


@pytest.mark.parametrize("case", sorted(PROFILE_CASES))
def test_reference_cpu_profile_cases(case):
    rows, g, sel, wins, loses = PROFILE_CASES[case]
    ref, port = configs(**CPU_PROFILE)
    got = dict(tcost._kernel_costs(rows, g, port, True, selectivity=sel))
    _close(got, dict(jcost._kernel_costs(rows, g, ref, True, selectivity=sel)))
    assert got[wins] < got[loses] and got["dense"] == INF


def test_scan_plans_one_group_single_device():
    _, port = configs()
    q = ScanQuery(datasource="t", columns=("d",))
    p = tcost.choose_physical(q, _FakeDS(500_000_000), 1, port, 1)
    assert (p.distributed, p.mesh_shape, p.num_groups) == (False, None, 1)
    # a Scan stays on one device with several in the list, as the
    # reference's (the mesh runs GroupBy-family queries)
    p = tcost.choose_physical(q, _FakeDS(10), 1, port, 8)
    assert (p.distributed, p.mesh_shape) == (False, None)


# -- the model over the SSB and TPC-H specs ------------------------------------------


def _reference_form(tq, jq):
    """The spec the reference prices for a port spec: a TopN's GroupBy form
    (the deliberate difference: the port counts a TopN's dimension)."""
    if type(tq).__name__ == "TopNQuery":
        return jlowering.topn_to_groupby(jq)
    return jq


def _groups(tq, ds):
    if type(tq).__name__ == "TimeseriesQuery":
        inner = tlowering.timeseries_to_groupby(tq)
    elif type(tq).__name__ == "TopNQuery":
        inner = tlowering.topn_to_groupby(tq)
    else:
        inner = tq
    return tlowering.lower_groupby(tlowering.groupby_with_time_granularity(inner), ds).num_groups


@pytest.mark.parametrize("consts", sorted(CONSTANTS))
@pytest.mark.parametrize("workload,name,spec", CASES, ids=[c[1] for c in CASES])
def test_query_costs_and_plan_match_reference(datasources, consts, workload, name, spec):
    ref_ds, port_ds = (d[workload] for d in datasources)
    ref, port = configs(**CONSTANTS[consts])
    jq = _reference_form(spec, to_reference(spec))
    g = _groups(spec, port_ds)
    for G in (g, 4 * g + 4097):  # its own domain, and one above the cutover
        costs = tcost.query_kernel_costs(spec, port_ds, G, port)
        _close(costs, jcost.query_kernel_costs(jq, ref_ds, G, ref))
        assert tcost.choose_query_kernel(spec, port_ds, G, port) == \
            jcost.choose_query_kernel(jq, ref_ds, G, ref)
        got = tcost.choose_physical(spec, port_ds, G, port, 1)
        exp = jcost.choose_physical(jq, ref_ds, G, ref, 1)
        assert (got.strategy, got.distributed, got.mesh_shape, got.num_groups, got.rows) == (
            exp.strategy, exp.distributed, exp.mesh_shape, exp.num_groups, exp.rows)
        assert got.est_cost_local == pytest.approx(exp.est_cost_local, rel=1e-12)
        if type(spec).__name__ != "TopNQuery":
            assert got.describe() == exp.describe()


MESH_FLAGS = {
    "data8": {},
    "groups2": {"mesh_groups_axis": 2},
    "data2_groups2": {"mesh_data_axis": 2, "mesh_groups_axis": 2},
    "slow_link": {"collective_bytes_per_us": 1.0},
    "model_off": {"cost_model_enabled": False},
}


@pytest.mark.parametrize("flags", sorted(MESH_FLAGS))
@pytest.mark.parametrize("workload,name,spec", CASES, ids=[c[1] for c in CASES])
def test_mesh_half_matches_reference(datasources, flags, workload, name, spec):
    """`choose_physical` over 8 devices: the reference's class, target, mesh
    shape and modelled costs under equal constants (the collective rate,
    the dispatch cost and the mesh flags included)."""
    ref_ds, port_ds = (d[workload] for d in datasources)
    kw = {"collective_bytes_per_us": 40_000.0, **MESH_FLAGS[flags]}
    ref, port = configs(**kw)
    ref = dataclasses.replace(ref, prefer_distributed=True)
    port = dataclasses.replace(port, prefer_distributed=True,
                               **{k: getattr(ref, k) for k in ("collective_bytes_per_us",
                                                               "mesh_data_axis",
                                                               "mesh_groups_axis")})
    jq = _reference_form(spec, to_reference(spec))
    g = _groups(spec, port_ds)
    for G in (g, 4 * g + 4097):
        got = tcost.choose_physical(spec, port_ds, G, port, 8)
        exp = jcost.choose_physical(jq, ref_ds, G, ref, 8)
        assert (got.strategy, got.distributed, got.mesh_shape) == (
            exp.strategy, exp.distributed, exp.mesh_shape)
        assert got.est_cost_local == pytest.approx(exp.est_cost_local, rel=1e-12)
        assert got.est_cost_dist == pytest.approx(exp.est_cost_dist, rel=1e-12)
        off = tcost.choose_physical(spec, port_ds, G, dataclasses.replace(
            port, prefer_distributed=False), 8)
        assert not off.distributed and off.mesh_shape is None


def test_merge_tree_and_state_bytes_match_reference():
    """`choose_merge_tree` over a seeded grid of state sizes, slice counts and
    rates, and `groupby_state_bytes` over plain and sketch aggregations."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        kw = {"collective_bytes_per_us": float(10 ** rng.uniform(2, 6)),
              "dcn_bytes_per_us": float(10 ** rng.uniform(2, 6))}
        ref, port = configs(**kw)
        port = dataclasses.replace(port, **kw)
        args = (int(10 ** rng.uniform(2, 9)), int(rng.integers(1, 5)), int(rng.integers(1, 9)))
        got, exp = tcost.choose_merge_tree(*args, port), jcost.choose_merge_tree(*args, ref)
        assert got[0] == exp[0]
        assert got[1:] == pytest.approx(exp[1:], rel=1e-12)
    for aggs in ((A.Count("n"),), (A.DoubleSum("s", "v"), A.HyperUnique("h", "u")),
                 (A.ThetaSketch("t", "u", size=512), A.Count("n"))):
        q = GroupByQuery(datasource="t", dimensions=(DimensionSpec("d", "d"),), aggregations=aggs)
        for G in (1, 208, 5000):
            assert tcost.groupby_state_bytes(q, G, None) == jcost.groupby_state_bytes(
                to_reference(q), G, None)


def test_set_on_the_mesh_flags_replans():
    """A context over 8 devices: SET of `prefer_distributed`,
    `mesh_data_axis` and `mesh_groups_axis` plans again at once; with the
    defaults' H100 rates the model prices the logical CPU mesh as it is
    told, and with the model off a GroupBy takes the mesh."""
    ctx = TPUOlapContext(SessionConfig(result_cache_entries=0), device="cpu",
                         devices=["cpu"] * 8)
    tssb.register(ctx, scale=0.002)
    q41 = tssb.QUERIES["q4_1"]
    ctx.sql("SET cost_model_enabled = false")
    assert ctx.plan_cached(q41).physical.mesh_shape == (8, 1)
    ctx.sql("SET mesh_groups_axis = 2")
    assert ctx.plan_cached(q41).physical.mesh_shape == (4, 2)
    ctx.sql("SET mesh_data_axis = 2")
    assert ctx.plan_cached(q41).physical.mesh_shape == (2, 2)
    ctx.sql("SET prefer_distributed = false")
    p = ctx.plan_cached(q41).physical
    assert not p.distributed and p.mesh_shape is None
    assert ctx.config.prefer_distributed is False and ctx.config.mesh_data_axis == 2
    ctx.sql("SET mesh_data_axis = none")
    assert ctx.config.mesh_data_axis is None


@pytest.fixture(scope="module")
def tables():
    return {"ssb": jssb.gen_tables(scale=0.01, seed=11), "tpch": jtpch.gen_tables(scale=0.01)}


def _contexts(tables, **kw):
    """A reference and a port context over the same tables, with equal
    constants (`kw` on the reference's defaults)."""
    ref_cfg, port_cfg = configs(result_cache_entries=0, **kw)
    ref, port = sd.TPUOlapContext(ref_cfg), TPUOlapContext(port_cfg, device="cpu")
    jssb.register(ref, tables=tables["ssb"], rows_per_segment=16384)
    jtpch.register(ref, tables=tables["tpch"])
    tssb.register(port, tables=tables["ssb"], rows_per_segment=16384)
    ttpch.register(port, tables=tables["tpch"])
    return ref, port


@pytest.fixture(scope="module")
def ctxs(tables):
    return _contexts(tables)


SQL = [("ssb", n) for n in jssb.QUERIES] + [("tpch", n) for n in jtpch.QUERIES]


@pytest.mark.parametrize("workload,name", SQL, ids=[f"{w}-{n}" for w, n in SQL])
def test_planned_physical_matches_reference(ctxs, workload, name):
    """`Rewrite.physical` of each SSB and TPC-H query: the reference's plan,
    from the planner's own group estimate (a TopN's against the reference's
    prices of its GroupBy form)."""
    ref, port = ctxs
    sql = (jssb if workload == "ssb" else jtpch).QUERIES[name]
    jrw, trw = ref.plan_sql(sql), port.plan_sql(sql)
    assert trw.num_groups == jrw.physical.num_groups
    want = jrw.physical
    if type(trw.query).__name__ == "TopNQuery":
        want = jcost.choose_physical(jlowering.topn_to_groupby(jrw.query),
                                     ref.catalog.get(jrw.datasource), jrw.physical.num_groups,
                                     ref.config, 1)
    got = trw.physical
    assert (got.strategy, got.distributed, got.mesh_shape, got.rows) == (
        want.strategy, want.distributed, want.mesh_shape, want.rows)
    assert got.est_cost_local == pytest.approx(want.est_cost_local, rel=1e-12)
    assert got.describe() in port.explain(sql)


# -- routing ----------------------------------------------------------------------

# constants under which each class is the cheapest for its query
ROUTES = {
    "dense": ("q4_1", dict(cost_per_row_scatter=1.0)),
    "segment": ("q4_1", dict(cost_per_row_dense=1.0, cost_per_row_scatter=1e-9,
                             cost_per_row_scatter_hi=1e-9)),
    "sparse": ("q3_2", dict(cost_per_row_dense=1.0, cost_per_row_scatter=1.0,
                            cost_per_row_scatter_hi=1.0, cost_per_row_sparse=1e-9)),
    "adaptive": ("q3_2", dict(cost_per_row_dense=1e-9, cost_per_row_scatter=1.0,
                              cost_per_row_scatter_hi=1.0, cost_per_row_sparse=1.0,
                              cost_dispatch_us=0.0)),
}


@pytest.mark.parametrize("cls", sorted(ROUTES))
def test_each_planned_class_routes_the_engine(tables, cls):
    name, consts = ROUTES[cls]
    ref, port = _contexts(tables, **consts)
    sql = jssb.QUERIES[name]
    assert port.plan_sql(sql).physical.strategy == ref.plan_sql(sql).physical.strategy == cls
    got, want = port.sql(sql), ref.sql(sql)
    m = port.last_metrics
    assert m.strategy == ("dense" if cls == "dense" else cls), m.describe()
    assert ref.last_metrics.strategy in (cls, "pallas" if cls == "dense" else cls)
    assert port.engine.strategy == "auto"
    assert_frames_match(got, want)


def test_set_of_a_constant_replans():
    """The plan cache keys on the config: SET of a constant or of
    cost_model_enabled plans again at once, and the next run takes the
    new class."""
    port = TPUOlapContext(SessionConfig(result_cache_entries=0), device="cpu")
    tssb.register(port, scale=0.01)
    q41, q32 = tssb.QUERIES["q4_1"], tssb.QUERIES["q3_2"]
    port.sql(q41)
    assert port.plan_cached(q41).physical.strategy == "dense"
    assert port.last_metrics.strategy == "dense"
    port.sql("SET cost_per_row_dense = 1000")
    assert port.plan_cached(q41).physical.strategy == "segment"
    port.sql(q41)
    assert port.last_metrics.strategy == "segment"
    port.sql("SET cost_model_enabled = false")
    assert port.plan_cached(q41).physical.strategy == "dense"
    assert port.plan_cached(q32).physical.strategy == "sparse"
    port.sql(q32)
    assert port.last_metrics.strategy == "sparse"
    with pytest.raises(KeyError):
        port.sql("SET vmem_budget_mb = 16")  # no counterpart on a card


def test_narrow_grouping_sets_under_a_planned_scatter_take_their_own_class():
    """A CUBE planned to the scatter at its whole G (62500) prices each set
    again at its own G: the two 250-group sets and the grand total take the
    cheaper class there (the kernel's, under the card's constants), the
    full set keeps the plan's; a pinned engine runs every set under its
    pin.  Both answers hold the float64 answer (keys and counts exact, the
    planned sums within 1e-6; the pinned scatter's float32 sums, added one
    after another, within 1e-5).  The sparse tier is priced out, so that
    the scatter is the plan whatever the card's calibration says."""
    port = TPUOlapContext(SessionConfig(result_cache_entries=0, cost_per_row_sparse=1.0),
                          device="cpu")
    tables = tssb.register(port, scale=0.01)
    sql = ("SELECT c_city, s_city, SUM(lo_revenue) AS revenue, COUNT(*) AS n "
           "FROM lineorder GROUP BY CUBE (c_city, s_city)")
    assert port.plan_sql(sql).physical.strategy == "segment"
    eng, seen = port.engine, []
    orig = eng.execute_groupby_batch

    def spy(queries, ds, set_labels=None, strategies=None):
        seen.append([(len(q.dimensions), s) for q, s in zip(queries, strategies)])
        return orig(queries, ds, set_labels=set_labels, strategies=strategies)

    eng.execute_groupby_batch = spy
    planned = port.sql(sql)
    eng.strategy = "segment"
    try:
        pinned = port.sql(sql)
    finally:
        eng.strategy = "auto"
    assert sorted(seen[0]) == [(0, "dense"), (1, "dense"), (1, "dense"), (2, "segment")]
    assert sorted(seen[1]) == [(0, "segment"), (1, "segment"), (1, "segment"), (2, "segment")]
    flat = tssb.flat_frame(tables)
    keys = ["c_city", "s_city"]
    parts = []
    for dims in ([], ["c_city"], ["s_city"], keys):
        g = (flat.groupby(dims).agg(revenue=("lo_revenue", "sum"), n=("lo_revenue", "size"))
             .reset_index() if dims else
             flat.agg(revenue=("lo_revenue", "sum"), n=("lo_revenue", "size")).T)
        parts.append(g.assign(**{k: "<all>" for k in keys if k not in dims}))
    import pandas as pd

    want = pd.concat(parts, ignore_index=True)
    want = want.assign(revenue=want.revenue.astype(np.float64), n=want.n.astype(np.int64))
    for got, rtol in ((planned, 1e-6), (pinned, 1e-5)):
        got = got.fillna({k: "<all>" for k in keys})[keys + ["revenue", "n"]]
        assert_frames_match(got.astype({k: str for k in keys}),
                            want[keys + ["revenue", "n"]].astype({k: str for k in keys}), rtol)


def test_concurrent_queries_each_run_their_own_plan():
    """Four threads, two plans, a short switch interval: every execution
    runs its own query's strategy, passed as an argument; the engine's
    attribute stays "auto"."""
    port = TPUOlapContext(SessionConfig(result_cache_entries=0), device="cpu")
    tssb.register(port, scale=0.01)
    sqls = [tssb.QUERIES["q4_1"], tssb.QUERIES["q3_2"]] * 2
    plans = {port.plan_sql(s).num_groups: port.plan_sql(s).physical.strategy for s in sqls}
    assert len(set(plans.values())) == 2
    eng, seen, lock = port.engine, [], threading.Lock()
    orig = eng._dispatch_groupby_once

    def spy(q, ds, scope, strategy=None):
        with lock:
            seen.append((scope[2].num_groups, strategy, eng.strategy))
        return orig(q, ds, scope, strategy)

    eng._dispatch_groupby_once = spy
    start, errors = threading.Barrier(len(sqls)), []

    def client(sql):
        try:
            start.wait()
            for _ in range(3):
                port.sql(sql)
        except BaseException as err:  # reported by the main thread
            errors.append(err)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(s,)) for s in sqls]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(seen) == 3 * len(sqls)
    assert all(s == plans[g] and attr == "auto" for g, s, attr in seen), seen


def test_adaptive_compacted_pass_takes_the_models_class(datasources):
    """The compacted pass's class is `choose_kernel_strategy(ds.num_rows,
    G')`, the reference's under equal constants; "dense" is the kernel's
    plain version on the CPU."""
    ref_ds, port_ds = (d["ssb"] for d in datasources)
    for consts in ({}, CPU_PROFILE, dict(cost_per_row_dense=1.0, cost_per_row_scatter=1e-9)):
        ref, port = configs(**consts)
        je, te = JaxEngine(strategy="adaptive"), Engine(device="cpu", strategy="adaptive")
        je._calibrated_cfg, te.cost_config = ref, port
        for g in (1, 100, 4096, 5000, 1 << 16):
            want = je._adaptive_main_strategy(ref_ds, g)
            assert te._adaptive_main_strategy(port_ds, g) == want, (consts, g)
        q = tssb.NATIVE_QUERIES["q3_2"]
        te.execute(q, port_ds)
        m = te.last_metrics
        if m.strategy == "adaptive":
            assert m.inner_strategy == te._adaptive_main_strategy(port_ds, m.compact_groups)


STREAM_Q = GroupByQuery(
    datasource="events", dimensions=(DimensionSpec("site", "site"),),
    aggregations=(A.Count("n"), A.DoubleSum("v", "value")),
)


@pytest.mark.parametrize("consts", ["reference_defaults", "cpu_profile", "scatter_free"])
def test_stream_class_follows_the_cost_model(consts):
    """Under "auto" the stream's class is the model's at (rows per chunk,
    G) among dense and segment, the reference's decision under equal
    constants; an explicit strategy is the engine's own."""
    kw = CONSTANTS.get(consts, dict(cost_per_row_dense=1.0, cost_per_row_scatter=1e-9))
    ref, port = configs(**kw)
    chunks = [datagen.gen_event_chunk(i, 4096) for i in range(2)]
    te = Engine(device="cpu")
    te.cost_config = port
    ex = tstreaming.StreamExecutor(engine=te)
    jex = jstreaming.StreamExecutor()
    jex.engine._calibrated_cfg = ref
    for g, rows in ((169, 1 << 21), (10, 4096), (5000, 1 << 16), (1 << 18, 1 << 20)):
        assert ex._stream_strategy(g, rows) == jex._stream_strategy(g, rows), (g, rows)
    ex.execute(STREAM_Q, datagen.event_stream_schema(), iter(chunks), 4096)
    G = te._lowering_for(STREAM_Q, datagen.event_stream_schema()).num_groups
    assert ex.stats.strategy == ex._stream_strategy(G, 4096)
    pinned = tstreaming.StreamExecutor(engine=Engine(device="cpu", strategy="segment"))
    assert pinned._stream_strategy(G, 4096) == "segment"


# -- the calibrated assist ----------------------------------------------------------

ASSIST_SQL = {
    # q2-class: a few groups over the whole base, interpreted above it
    "q2_class": ("SELECT l_returnflag, total FROM (SELECT l_returnflag, "
                 "sum(l_quantity) AS total FROM lineitem GROUP BY l_returnflag) t "
                 "WHERE total > 0 ORDER BY l_returnflag", 1),
    # q18-class: a group per order, a quarter of the base's rows
    "q18_class": ("SELECT count(*) AS n FROM (SELECT l_orderkey, sum(l_quantity) AS total "
                  "FROM lineitem GROUP BY l_orderkey) t WHERE total > 100", 0),
}


@pytest.mark.parametrize("name", sorted(ASSIST_SQL))
def test_calibrated_assist_decides_as_the_reference(tables, name):
    sql, assists = ASSIST_SQL[name]
    ref, port = _contexts(tables, device_assist_min_rows=0)
    want, got = ref.sql(sql), port.sql(sql)
    assert ref.last_metrics.assist_subplans == port.last_metrics.assist_subplans == assists
    modelled = [d for d in port.last_metrics.declines if d.startswith("assist: modelled")]
    assert len(modelled) == 1 - assists
    if modelled:
        assert "x 3 >= interpreter" in modelled[0] and "G=" in modelled[0]
    assert_frames_match(got, want)
    port.sql("SET device_assist_force = true")  # the gate skipped: the rules alone
    port.sql(sql)
    assert port.last_metrics.assist_subplans == 1


def test_missing_resident_bytes_counts_what_must_cross():
    port = TPUOlapContext(SessionConfig(result_cache_entries=0), device="cpu")
    tssb.register(port, scale=0.01)
    ds = port.catalog.get("lineorder")
    q = tssb.NATIVE_QUERIES["q4_1"]
    cols = port.engine._lowering_for(q, ds).columns
    every = sum(4 * s.num_rows * (len(cols) + 1) for s in ds.segments)
    assert port.engine.missing_resident_bytes(ds, cols) == every
    port.engine.execute(q, ds)
    assert port.engine.missing_resident_bytes(ds, cols) == 0
    port.engine.drop_residency()  # pinned host copies stay: they still cross the link
    assert port.engine.missing_resident_bytes(ds, cols) == every
