"""Adaptive domain compaction (`exec/adaptive_exec.py`) of the PyTorch port
against the JAX reference.

The cases of the reference's `tests/test_adaptive_domain.py` run through
both engines on the same segments: frames equal under the parity contract
(HLL columns exact: the states are the same bits), the same path taken,
the same kept sets (measured or derived from the filter) and declines, and
a repeat that skips the presence pass and gives the same bits.  Also: the
filter-derived sets equal the reference's function, and with the engine
resolving strategies as on a card, the presence pass and the compacted pass
go through the kernel's wrapper.
"""

import numpy as np
import pandas as pd
import pytest
from test_torch_engine import to_reference
from test_torch_sparse import _engines, _run_both

from spark_druid_olap_tpu.catalog import segment as jseg
from spark_druid_olap_tpu.exec import adaptive_exec as jadaptive
from spark_druid_olap_tpu.exec.lowering import lower_groupby as jlower
from spark_druid_olap_tpu_torch.catalog.segment import datasource_from_numpy, datasource_to_numpy
from spark_druid_olap_tpu_torch.exec import adaptive_exec as tadaptive
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.exec import engine as tengine
from spark_druid_olap_tpu_torch.exec.lowering import lower_groupby as tlower
from spark_druid_olap_tpu_torch.models import aggregations as A
from spark_druid_olap_tpu_torch.models.dimensions import DimensionSpec
from spark_druid_olap_tpu_torch.models.filters import And, Bound, InFilter, Or, Selector
from spark_druid_olap_tpu_torch.models.query import GroupByQuery
from spark_druid_olap_tpu_torch.ops import cuda_groupby as tcuda
from spark_druid_olap_tpu_torch.ops import groupby as tgroupby


@pytest.fixture(scope="module")
def data():
    """Combined domain 400 x 400 >> 4096; uniform rows, so a filter on
    each dimension shrinks the present codes: reference and port
    datasources of the same segments, and the columns."""
    n, da, db = 60_000, 400, 400
    rng = np.random.default_rng(3)
    cols = {"a": rng.integers(0, da, n), "b": rng.integers(0, db, n),
            "v": (rng.random(n) * 100).astype(np.float32), "k": rng.integers(0, 5000, n)}
    jds = jseg.build_datasource(
        "ad", cols, dimension_cols=["a", "b"], metric_cols=["v", "k"], rows_per_segment=n // 4,
        dicts={"a": jseg.DimensionDict(values=tuple(range(da))),
               "b": jseg.DimensionDict(values=tuple(range(db)))},
    )
    return jds, datasource_from_numpy(datasource_to_numpy(jds)), cols


PLAIN = (A.Count("n"), A.DoubleSum("s", "v"), A.DoubleMin("lo", "v"), A.DoubleMax("hi", "v"))


def _query(filt=None, aggs=PLAIN):
    return GroupByQuery(datasource="ad", dimensions=(DimensionSpec("a"), DimensionSpec("b")),
                        aggregations=aggs, filter=filt)


def _in(dim, n, start=0):
    return InFilter(dim, tuple(range(start, start + n)))


CASES = {
    # case: (strategy, filter, aggregations, the path the port takes)
    "parity_and_kept_cache": ("adaptive", And((_in("a", 12), _in("b", 9))), PLAIN, "adaptive"),
    "declines_without_shrink": ("adaptive", None, PLAIN, "sparse"),
    "hll_sketch": ("adaptive", And((_in("a", 6), _in("b", 6))),
                   (A.Count("n"), A.DoubleSum("s", "v"), A.HyperUnique("u", "k")), "adaptive"),
    # every segment pruned by its zone map: no tier runs
    "empty_filter_result": ("adaptive", Selector("a", 99999), PLAIN, "segment"),
    "not_used_for_explicit_segment": ("segment", And((_in("a", 5), _in("b", 5))), PLAIN, "segment"),
    "matches_scatter": ("adaptive", And((_in("a", 10), _in("b", 7))), PLAIN, "adaptive"),
    "derived_kept_skips_presence": (
        "adaptive", And((_in("a", 12, 3), Bound("b", lower=10, upper=30, ordering="numeric"))),
        PLAIN, "adaptive"),
    "derived_kept_declines_unpinned_dim": (
        "adaptive", And((_in("a", 3, 1), Or((Selector("b", 5), Selector("a", 1))))), PLAIN,
        "adaptive"),
    "compacted_above_cutover": ("adaptive", And((_in("a", 80), _in("b", 60))), PLAIN, "adaptive"),
    "auto": ("auto", And((_in("a", 12), _in("b", 9))), PLAIN, "adaptive"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_adaptive_matches_reference(data, monkeypatch, name):
    jds, tds, cols = data
    strategy, filt, aggs, path = CASES[name]
    tq = _query(filt, aggs)
    je, te = _engines("adaptive" if strategy == "auto" else strategy)
    te.strategy = strategy  # the reference's "auto" on a CPU routes as "adaptive" does
    if name == "derived_kept_skips_presence":
        def boom(*a, **k):
            raise AssertionError("the presence pass ran for a filter-derivable query")
        monkeypatch.setattr(te, "_presence_counts", boom)
    got = _run_both(je, te, to_reference(tq), tq, jds, tds)
    m = te.last_metrics
    assert m.strategy == path, m.describe()
    if name == "empty_filter_result":
        assert len(got) == 0
    if name == "compacted_above_cutover":
        assert m.compact_groups > tgroupby.SCATTER_CUTOVER and m.inner_strategy == "segment"
    if path == "adaptive":
        (entry,) = te._adaptive_kept.values()
        assert entry[0] == (
            "measured" if name == "derived_kept_declines_unpinned_dim" else "derived")
        # a repeat reads the kept sets from the memo: the same bits
        pd.testing.assert_frame_equal(te.execute(tq, tds), got)
        assert te.last_metrics.kept_source == "memo"
    if path == "sparse":
        assert te._adaptive_declined and m.tier_declines


def test_filter_derived_kept_matches_reference(data):
    jds, tds, _ = data
    for filt in (And((_in("a", 12, 3), Bound("b", lower=10, upper=30, ordering="numeric"))),
                 And((_in("a", 3, 1), Or((Selector("b", 5), Selector("a", 1))))),
                 And((Selector("a", 7), Bound("b", upper=3, upper_strict=True, ordering="numeric")))):
        tq = _query(filt)
        jq = to_reference(tq)
        want = jadaptive.filter_derived_kept(jq, jlower(jq, jds), jds)
        got = tadaptive.filter_derived_kept(tq, tlower(tq, tds), tds)
        assert (got is None) == (want is None)
        if want is not None:
            assert [k.tolist() for k in got] == [np.asarray(k).tolist() for k in want]


def test_tier_passes_reach_the_kernel_as_on_a_card(data, monkeypatch):
    """With the engine resolving strategies as on a CUDA device, the
    presence pass (per dimension of cardinality <= 4096) and the compacted
    pass (G' <= 4096) call the kernel's wrapper once per segment each, and
    nothing reaches the plain twin directly."""
    _, tds, _ = data
    resolve = tgroupby.resolve_strategy
    monkeypatch.setattr(tengine, "resolve_strategy", lambda s, g, device: resolve(s, g, "cuda"))
    calls = {"kernel": [], "dense": 0}

    def kernel_spy(gid, mask, sv, mmv, mmm, num_groups, num_min, num_max):
        calls["kernel"].append((num_groups, sv.shape[1]))
        return tcuda.plain_partial_aggregate(gid, mask, sv, mmv, mmm, num_groups, num_min, num_max)

    def dense_spy(*a, **k):
        calls["dense"] += 1
        raise AssertionError("the plain twin was reached on a card")

    monkeypatch.setattr(tcuda, "cuda_partial_aggregate", kernel_spy)
    monkeypatch.setattr(tgroupby, "dense_partial_aggregate", dense_spy)
    eng = tengine.Engine(device="cpu")
    # the card's constants (the class defaults): the compacted pass takes
    # the kernel's class, as on a card
    eng.cost_config = SessionConfig()
    # b is unpinned (an Or), so the kept sets are measured
    q = _query(And((_in("a", 10), Or((_in("b", 7), Selector("b", 300))))))
    eng.execute(q, tds)
    m = eng.last_metrics
    assert m.strategy == "adaptive" and m.kept_source == "measured" and m.inner_strategy == "cuda"
    Ms, segs = len(tlower(q, tds).la.sum_names), len(tds.segments)
    compacted = [(m.compact_groups, Ms)] * segs
    assert sorted(calls["kernel"]) == sorted([(401, 1)] * 2 * segs + compacted)
    calls["kernel"].clear()
    eng.execute(q, tds)  # the memo: the compacted pass alone
    assert calls["kernel"] == compacted and calls["dense"] == 0
