"""Engine: the PyTorch port's main path against the JAX reference.

* Every native query spec (the 13 SSB queries, TPC-H Q1 and the TopN)
  serializes to the same Druid JSON the reference's SQL planner emits for
  the same SQL.
* `Engine(device="cpu").execute` gives frames equal to the reference
  `Engine().execute` on the same segments for all 16 queries, under the
  parity contract: group keys and counts exact, float aggregates within
  rtol 1e-6 (float32 partial sums; products may round differently inside
  a block).
* `Engine()` with no CUDA device raises.
"""

import dataclasses
import importlib
import json

import numpy as np
import pandas as pd
import pytest
import torch

from spark_druid_olap_tpu.api import TPUOlapContext
from spark_druid_olap_tpu.catalog import segment as jseg
from spark_druid_olap_tpu.exec.engine import Engine as JaxEngine
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu.workloads import tpch as jtpch
from spark_druid_olap_tpu_torch.catalog.segment import (
    datasource_from_numpy,
    datasource_to_numpy,
)
from spark_druid_olap_tpu_torch.exec import engine as tengine
from spark_druid_olap_tpu_torch.workloads import ssb as tssb
from spark_druid_olap_tpu_torch.workloads import tpch as ttpch

RTOL = 1e-6

TOPN_SQL = (
    "SELECT c_nation, sum(lo_revenue) AS revenue FROM lineorder "
    "GROUP BY c_nation ORDER BY revenue DESC LIMIT 10"
)

# (workload, name, port spec); the reference's SQL is looked up by name
CASES = (
    [("ssb", n, q) for n, q in tssb.NATIVE_QUERIES.items()]
    + [("tpch", "q1", ttpch.NATIVE_QUERIES["q1"])]
    + [("ssb", "timeseries", tssb.TIMESERIES_QUERY), ("ssb", "topn", tssb.TOPN_QUERY)]
)


def to_reference(obj):
    """The reference package's equal of a port spec: the same dataclass
    tree, rebuilt from the reference's classes of the same names."""
    if isinstance(obj, tuple):
        return tuple(to_reference(x) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = importlib.import_module(
            type(obj).__module__.replace(
                "spark_druid_olap_tpu_torch", "spark_druid_olap_tpu"
            )
        )
        cls = getattr(mod, type(obj).__name__)
        return cls(**{
            f.name: to_reference(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        })
    return obj


@pytest.fixture(scope="module")
def planner():
    ctx = TPUOlapContext()
    jssb.register(ctx, scale=0.002)
    jtpch.register(ctx, scale=0.001)
    return ctx


@pytest.fixture(scope="module")
def datasources():
    """Reference datasources over several segments each, and the port's
    copies of the very same segments."""
    cols, dicts = jssb.flat_columns(jssb.gen_tables(0.002, seed=7))
    ssb_ds = jseg.build_datasource(
        "lineorder", cols, jssb.FLAT_DIMS, jssb.FLAT_METRICS,
        time_col="lo_orderdate", rows_per_segment=4096, dicts=dicts,
    )
    cols, dicts = jtpch.flat_columns(jtpch.gen_tables(0.001))
    tpch_ds = jseg.build_datasource(
        "lineitem", cols, jtpch.FLAT_DIMS, jtpch.FLAT_METRICS,
        time_col="l_shipdate", rows_per_segment=2048, dicts=dicts,
    )
    ref = {"ssb": ssb_ds, "tpch": tpch_ds}
    return ref, {k: datasource_from_numpy(datasource_to_numpy(v)) for k, v in ref.items()}


def _sql(workload, name):
    if name == "topn":
        return TOPN_SQL
    return (jssb.QUERIES if workload == "ssb" else jtpch.QUERIES)[name]


@pytest.mark.parametrize(
    "workload,name,spec", [c for c in CASES if c[1] != "timeseries"],
    ids=lambda x: x if isinstance(x, str) else "",
)
def test_spec_json_matches_planner(planner, workload, name, spec):
    want = planner.plan_sql(_sql(workload, name)).query.to_druid()
    assert json.dumps(spec.to_druid(), sort_keys=True, default=str) == json.dumps(
        want, sort_keys=True, default=str
    )
    assert to_reference(spec).to_druid() == spec.to_druid()


def assert_frames_match(got: pd.DataFrame, want: pd.DataFrame, rtol=RTOL):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    floats = [c for c in want.columns if want[c].dtype.kind == "f"]
    keys = [c for c in want.columns if c not in floats]
    if keys:
        got = got.sort_values(keys, kind="stable").reset_index(drop=True)
        want = want.sort_values(keys, kind="stable").reset_index(drop=True)
    for c in keys:
        np.testing.assert_array_equal(
            np.asarray(got[c]), np.asarray(want[c]), err_msg=c
        )
    for c in floats:
        np.testing.assert_allclose(
            np.asarray(got[c], dtype=np.float64),
            np.asarray(want[c], dtype=np.float64),
            rtol=rtol, err_msg=c,
        )


@pytest.mark.parametrize(
    "workload,name,spec", CASES, ids=lambda x: x if isinstance(x, str) else ""
)
def test_engine_matches_reference(datasources, workload, name, spec):
    ref, port = datasources
    jeng, teng = JaxEngine(), tengine.Engine(device="cpu")
    want = jeng.execute(to_reference(spec), ref[workload])
    got = teng.execute(spec, port[workload])
    assert_frames_match(got, want)
    assert teng.last_metrics.segments == jeng.last_metrics.segments
    assert teng.last_metrics.num_groups == jeng.last_metrics.num_groups
    # canonical fold order: a second run is bit-identical
    pd.testing.assert_frame_equal(teng.execute(spec, port[workload]), got)


def test_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.Engine()


def test_pruned_scope_gives_empty_answer(datasources):
    _, port = datasources
    q = dataclasses.replace(
        tssb.NATIVE_QUERIES["q2_1"], intervals=((0, 1),)  # 1970: no rows
    )
    eng = tengine.Engine(device="cpu")
    out = eng.execute(q, port["ssb"])
    assert len(out) == 0 and eng.last_metrics.segments == 0
