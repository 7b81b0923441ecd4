"""The sparse (sort-compaction) tier of the PyTorch port against the JAX
reference.

* Tier ops: the same numpy inputs through the reference's `compact_rows`,
  `segmented_reduce_sorted`, `sparse_partial_aggregate` (its CPU inner,
  "segment") and `merge_sparse_states`, and through the port's (inner
  "dense", the kernel's plain version): gids, counts, mins, maxs, flags,
  `n_rows` and `n_real` exactly equal, sums within rtol 1e-6.  Where a
  state overflowed, only its flags and counts are compared (its slots are
  discarded by the engine).
* Engine: the 11 high-cardinality queries (SSB q2.x, q3.x, q4.2, q4.3;
  TPC-H q3, q10) through the reference `Engine(strategy=s)` and the port's
  `Engine(device="cpu", strategy=s)` for s in adaptive, sparse and segment:
  frames equal under the parity contract, the same path taken, the same
  rungs and kept sets learned, and a second run bit-identical.
* Ladders, forced by setting the rungs in both packages as the reference's
  own tests do: the same frames, rungs, pins and paths.
"""

import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_engine import assert_frames_match, to_reference
from test_torch_sql import reference_config

import jax.numpy as jnp
import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu.catalog import segment as jseg
from spark_druid_olap_tpu.exec.engine import Engine as JaxEngine
from spark_druid_olap_tpu.ops import sparse_groupby as jsg
from spark_druid_olap_tpu.plan import cost as jcost
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu.workloads import tpch as jtpch
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.catalog.segment import datasource_from_numpy, datasource_to_numpy
from spark_druid_olap_tpu_torch.exec import sparse_exec as tsparse_exec
from spark_druid_olap_tpu_torch.exec.engine import Engine
from spark_druid_olap_tpu_torch.models import aggregations as A
from spark_druid_olap_tpu_torch.models.dimensions import DimensionSpec
from spark_druid_olap_tpu_torch.models.filters import InFilter
from spark_druid_olap_tpu_torch.models.query import GroupByQuery
from spark_druid_olap_tpu_torch.ops import sparse_groupby as tsg

RTOL = 1e-6
FLAGS = ("overflow", "row_overflow", "n_rows", "n_real")
HIGH_G = {
    "ssb": ["q2_1", "q2_2", "q2_3", "q3_1", "q3_2", "q3_3", "q3_4", "q4_2", "q4_3"],
    "tpch": ["q3", "q10"],
}


# -- tier ops ----------------------------------------------------------------


def _rows(seed, R, G, distinct, p, Ms=2, Mn=1, Mx=1):
    rng = np.random.default_rng(seed)
    pool = rng.choice(G, size=distinct, replace=False).astype(np.int32)
    gid = pool[rng.integers(0, distinct, R)]
    mask = rng.random(R) < p
    sv = (rng.random((R, Ms)) * 100 * mask[:, None]).astype(np.float32)
    mmv = (rng.random((R, Mn + Mx)) * 10 - 5).astype(np.float32)
    return gid, mask, sv, mmv, rng.random((R, Mn + Mx)) < 0.9


def _both(fn_j, fn_t, arrays, **kw):
    return (fn_j(*map(jnp.asarray, arrays), **kw),
            fn_t(*map(torch.from_numpy, arrays), **kw))


def _sparse(seed, R, G, distinct, p, slots, cap=None, Mn=1, Mx=1):
    arrays = _rows(seed, R, G, distinct, p, Mn=Mn, Mx=Mx)
    kw = dict(num_groups=G, num_min=Mn, num_max=Mx, slots=slots, row_capacity=cap)
    return (jsg.sparse_partial_aggregate(*map(jnp.asarray, arrays), inner_strategy="segment", **kw),
            tsg.sparse_partial_aggregate(*map(torch.from_numpy, arrays), inner_strategy="dense", **kw))


def _merged(*cases):
    (ja, ta), (jb, tb) = cases
    G = 1 << 20
    return jsg.merge_sparse_states(ja, jb, num_groups=G), tsg.merge_sparse_states(ta, tb, G)


def _exactly_slots():
    """SPARSE_SLOTS real groups and as many masked rows: no overflow (the
    trash run has its own state row)."""
    k = tsg.SPARSE_SLOTS
    gid = np.tile(np.arange(k, dtype=np.int32), 4)
    mask = np.arange(4 * k) % 2 == 0
    sv = np.where(mask, 1.0, 0.0).astype(np.float32)[:, None]
    arrays = (gid, mask, sv, np.zeros((4 * k, 0), np.float32), np.zeros((4 * k, 0), bool))
    kw = dict(num_groups=1 << 16, num_min=0, num_max=0)
    return (jsg.sparse_partial_aggregate(*map(jnp.asarray, arrays), inner_strategy="segment", **kw),
            tsg.sparse_partial_aggregate(*map(torch.from_numpy, arrays), inner_strategy="dense", **kw))


def _segmented():
    rng = np.random.default_rng(5)
    R, runs = 5000, 37  # runs longer than a block, single-row runs, R % 1024 != 0
    slot = np.zeros(R, np.int32)
    slot[np.sort(rng.choice(np.arange(1, R), size=runs - 1, replace=False))] = 1
    slot = np.cumsum(slot).astype(np.int32)
    mask = rng.random(R) < 0.8
    arrays = (slot, mask, (rng.random((R, 2)) * 10 * mask[:, None]).astype(np.float32),
              (rng.random((R, 2)) * 10 - 5).astype(np.float32), np.ones((R, 2), bool))
    j = jsg.segmented_reduce_sorted(*map(jnp.asarray, arrays), capacity=64, block_rows=1024,
                                    num_min=1, num_max=1)
    t = tsg.segmented_reduce_sorted(*map(torch.from_numpy, arrays), capacity=64, num_min=1, num_max=1)
    return dict(zip(("sums", "mins", "maxs"), j)), dict(zip(("sums", "mins", "maxs"), t))


def _compact(p, cap):
    arrays = _rows(21, 32768, 1 << 20, 5000, p)
    j, t = _both(jsg.compact_rows, tsg.compact_rows, arrays, capacity=cap)
    names = ("gid", "mask", "sv", "mmv", "mmm", "row_overflow", "n_rows")
    return dict(zip(names, j)), dict(zip(names, t))


OP_CASES = {
    "compact_rows": lambda: _compact(0.02, 2048),
    "compact_rows_overflow": lambda: _compact(0.5, 1024),
    "segmented_reduce_sorted": _segmented,
    "sparse_kernel_slots": lambda: _sparse(1, 8192, 1 << 20, 700, 0.5, 4096),
    "sparse_compacted": lambda: _sparse(2, 32768, 1 << 20, 700, 0.02, 4096, cap=2048),
    "sparse_row_overflow": lambda: _sparse(3, 8192, 1 << 16, 300, 0.5, 4096, cap=1024),
    "sparse_segmented_reduce": lambda: _sparse(4, 16384, 1 << 20, 9000, 0.9, 16384, Mn=0, Mx=0),
    "sparse_slot_overflow": lambda: _sparse(5, 8192, 1 << 20, 6000, 0.9, 4096),
    "sparse_exactly_slots_with_masked_rows": _exactly_slots,
    "merge": lambda: _merged(_sparse(6, 8192, 1 << 20, 2000, 0.7, 4096),
                             _sparse(7, 8192, 1 << 20, 2000, 0.7, 4096)),
    "merge_segmented_reduce": lambda: _merged(_sparse(8, 16384, 1 << 20, 9000, 0.9, 16384),
                                              _sparse(9, 16384, 1 << 20, 9000, 0.9, 16384)),
    "merge_overflow": lambda: _merged(_sparse(10, 8192, 1 << 20, 3000, 0.9, 4096),
                                      _sparse(11, 8192, 1 << 20, 3000, 0.9, 4096)),
}


@pytest.mark.parametrize("name", list(OP_CASES))
def test_tier_ops_match_reference(name):
    want, got = OP_CASES[name]()
    assert set(got) == set(want)
    overflowed = bool(np.asarray(want.get("overflow", False)))
    assert overflowed == (name in ("sparse_slot_overflow", "merge_overflow"))
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape, k
        if overflowed and k not in FLAGS:
            continue
        if k == "sums":
            np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    if "gids" in want and not overflowed:
        # the port's state is the same bits on a second run
        again = OP_CASES[name]()[1]
        for k in got:
            assert torch.equal(got[k], again[k]), k


# -- engine: the high-cardinality queries --------------------------------------


@pytest.fixture(scope="module")
def ctxs():
    """Reference and port contexts over the same tables: their planners and
    datasources."""
    tables = {"ssb": jssb.gen_tables(scale=0.01, seed=11), "tpch": jtpch.gen_tables(scale=0.03)}
    ref = sd.TPUOlapContext(reference_config())
    jssb.register(ref, tables=tables["ssb"], rows_per_segment=16384)
    jtpch.register(ref, tables=tables["tpch"])
    from spark_druid_olap_tpu_torch.workloads import ssb as tssb
    from spark_druid_olap_tpu_torch.workloads import tpch as ttpch

    port = TPUOlapContext(device="cpu")
    tssb.register(port, tables=tables["ssb"], rows_per_segment=16384)
    ttpch.register(port, tables=tables["tpch"])
    return ref, port


def _engines(strategy):
    je = JaxEngine(strategy=strategy)
    # the reference prices its compacted pass with its cost model; pin it
    # to the port's choice (the kernel's one-hot class at G' <= 4096)
    je._calibrated_cfg = reference_config()
    return je, Engine(device="cpu", strategy=strategy)


def _learned(eng):
    """What a tier learned, without the packages' memo keys."""
    kept = [
        (e[0], [np.asarray(k).tolist() for k in e[-1]]) for e in eng._adaptive_kept.values()
    ]
    return (kept, sorted(eng._sparse_slots.values()),
            sorted(map(str, eng._sparse_row_capacity.values())),
            len(eng._adaptive_declined), len(eng._sparse_disabled))


def _run_both(je, te, jq, tq, jds, tds):
    want, got = je.execute(jq, jds), te.execute(tq, tds)
    assert_frames_match(got, want)
    assert te.last_metrics.strategy == je.last_metrics.strategy
    assert _learned(te) == _learned(je)
    return got


@pytest.mark.parametrize("strategy", ["adaptive", "sparse", "segment"])
@pytest.mark.parametrize("workload,name", [(w, n) for w, ns in HIGH_G.items() for n in ns])
def test_high_cardinality_queries_match_reference(ctxs, workload, name, strategy):
    ref, port = ctxs
    mod = jssb if workload == "ssb" else jtpch
    jrw, trw = ref.plan_sql(mod.QUERIES[name]), port.plan_sql(mod.QUERIES[name])
    je, te = _engines(strategy)
    got = _run_both(je, te, jrw.query, trw.query, ref.catalog.get(jrw.datasource),
                    port.catalog.get(trw.datasource))
    m = te.last_metrics
    assert m.num_groups > tsg.SPARSE_SLOTS
    want_path = {"adaptive": ("adaptive", "sparse"), "sparse": ("sparse",), "segment": ("segment",)}
    assert m.strategy in want_path[strategy] or m.tier_declines, m.describe()
    pd.testing.assert_frame_equal(te.execute(trw.query, port.catalog.get(trw.datasource)), got)


# -- engine: the ladders -------------------------------------------------------


def _hc_data(n=60_000, da=300, db=300, populated=700, seed=3, segs=3, uniform=False):
    """Combined domain da * db >> 4096 with `populated` pairs present (or
    uniform over the domain): reference and port datasources of the same
    segments, and the columns."""
    rng = np.random.default_rng(seed)
    if uniform:
        a, b = rng.integers(0, da, n), rng.integers(0, db, n)
    else:
        pairs = rng.choice(da * db, size=populated, replace=False)
        pick = pairs[rng.integers(0, populated, n)]
        a, b = pick // db, pick % db
    cols = {"a": a.astype(np.int64), "b": b.astype(np.int64),
            "v": (rng.random(n) * 100).astype(np.float32)}
    jds = jseg.build_datasource(
        "hc", cols, dimension_cols=["a", "b"], metric_cols=["v"], rows_per_segment=n // segs,
        dicts={"a": jseg.DimensionDict(values=tuple(range(da))),
               "b": jseg.DimensionDict(values=tuple(range(db)))},
    )
    return jds, datasource_from_numpy(datasource_to_numpy(jds)), cols


def _hc_query(filt=None):
    return GroupByQuery(
        datasource="hc", dimensions=(DimensionSpec("a"), DimensionSpec("b")),
        aggregations=(A.Count("n"), A.DoubleSum("s", "v"), A.DoubleMin("lo", "v"),
                      A.DoubleMax("hi", "v")),
        filter=filt,
    )


LADDERS = {
    # case: (strategy, rows kept by `a`, data options, rungs set in both packages)
    "slots_ladder": ("sparse", None, dict(n=40_000, seed=11, uniform=True), {}),
    "slots_past_top_pins_to_scatter": (
        "sparse", None, dict(n=40_000, seed=11, uniform=True),
        {"SLOTS_LADDER": (tsg.SPARSE_SLOTS, 8192)}),
    "row_overflow_full_sort": ("sparse", 150, {}, {"ROW_CAPACITY": 1024}),
    "row_capacity_intermediate_rung": (
        "sparse", 30, {}, {"ROW_CAPACITY": 1024, "ROW_CAPACITY_LADDER": (1024, 4096, 16384),
                           "selectivity": 1e-4}),
    "row_capacity_past_top": (
        "sparse", 150, {}, {"ROW_CAPACITY": 1024, "ROW_CAPACITY_LADDER": (1024, 2048),
                            "selectivity": 1e-4}),
    "compacted_rows": ("sparse", 20, {}, {"ROW_CAPACITY": 8192}),
    "selectivity_picks_first_rung": (
        "sparse", 30, {}, {"ROW_CAPACITY_LADDER": (1024, 4096, 16384, 65536)}),
    "multi_segment_merge": ("sparse", None, dict(segs=5), {}),
    "low_cardinality_falls_through": ("sparse", None, dict(da=4, db=4, populated=10), {}),
    "empty_result": ("sparse", (99999,), {}, {}),
    "adaptive_then_sparse": ("adaptive", None, {}, {}),
}


@pytest.mark.parametrize("name", list(LADDERS))
def test_ladders_match_reference(monkeypatch, name):
    strategy, keep, data, rungs = LADDERS[name]
    for attr, value in rungs.items():
        if attr == "selectivity":
            monkeypatch.setattr(jcost, "estimate_selectivity", lambda f, ds: value)
            monkeypatch.setattr(tsparse_exec, "estimate_selectivity", lambda f, ds: value)
        else:
            monkeypatch.setattr(jsg, attr, value)
            monkeypatch.setattr(tsg, attr, value)
    jds, tds, cols = _hc_data(**data)
    keep = tuple(range(keep)) if isinstance(keep, int) else keep
    tq = _hc_query(None if keep is None else InFilter("a", keep))
    je, te = _engines(strategy)
    got = _run_both(je, te, to_reference(tq), tq, jds, tds)
    m = te.last_metrics
    # the float64 oracle: keys and counts exact
    mask = np.ones(len(cols["a"]), bool) if keep is None else np.isin(cols["a"], keep)
    want = pd.DataFrame({"a": cols["a"][mask], "b": cols["b"][mask]}).value_counts()
    assert len(got) == len(want) and int(got["n"].sum()) == int(mask.sum())
    if name == "slots_ladder":
        assert m.strategy == "sparse" and m.sparse_slots > tsg.SPARSE_SLOTS
        assert m.inner_strategy == "segmented_reduce" and not te._sparse_disabled
    if name == "slots_past_top_pins_to_scatter":
        assert m.strategy == "segment" and te._sparse_disabled and m.tier_declines
    if name == "row_capacity_intermediate_rung":
        assert list(te._sparse_row_capacity.values()) == [4096] == [m.sparse_row_capacity]
    if name == "row_capacity_past_top":
        assert list(te._sparse_row_capacity.values()) == [None] and m.sparse_row_capacity == 0
    if name == "selectivity_picks_first_rung":
        assert te._sparse_row_capacity == {} and m.sparse_passes == 1
    # a repeat starts on the learned rungs: one pass, the same bits
    pd.testing.assert_frame_equal(te.execute(tq, tds), got)
    if m.strategy == "sparse":
        assert te.last_metrics.sparse_passes == 1
