"""How the segment loop's cold columns reach the device
(`exec/pipeline.TransferPipeline`) on the CPU, against the JAX reference.

* Parity: cold scopes (nothing resident) with the pipeline on and off give
  the same bits, and frames equal to the reference `Engine` with its own
  pipeline on (keys and counts exact, float aggregates within rtol 1e-6).
* Residency: a cold scope ends with every column it read resident, the
  same bytes copied on and off; a warm run copies nothing.
* Failure: a copy that raises fails the query; nothing is swallowed, and
  the next run answers.
* Flags: `SET transfer_pipeline` reaches the engine; the reference's
  prefetch flags, which the port does not have, are refused.

The pinned host copies themselves exist only on a card
(`test_torch_cuda.py`).
"""

import pandas as pd
import pytest
from test_torch_arena import datasources  # the module fixture
from test_torch_engine import CASES, assert_frames_match, to_reference

from spark_druid_olap_tpu.exec.engine import Engine as JaxEngine
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.exec import arena
from spark_druid_olap_tpu_torch.exec.engine import Engine
from spark_druid_olap_tpu_torch.exec.pipeline import TransferPipeline, column_key
from spark_druid_olap_tpu_torch.workloads import ssb

COLD = [c for c in CASES if c[1] in ("q1_1", "q2_1", "q4_1", "q1", "timeseries")]


def _engine(pipeline=True):
    eng = Engine(device="cpu")
    eng.configure_pipeline(SessionConfig(transfer_pipeline=pipeline))
    return eng


def _exact(a, b):
    pd.testing.assert_frame_equal(a, b, check_exact=True)


@pytest.mark.parametrize("workload,name,spec", COLD, ids=[c[1] for c in COLD])
def test_cold_scope_parity_on_vs_off(datasources, workload, name, spec):
    ref, port = datasources
    want = JaxEngine().execute(to_reference(spec), ref[workload])
    on, off = _engine(), _engine(pipeline=False)
    with arena.arena_disabled():
        got = on.execute(spec, port[workload])
        _exact(got, off.execute(spec, port[workload]))
        _exact(on.execute(spec, port[workload]), got)  # warm
    assert_frames_match(got, want)
    assert on.last_metrics.h2d_bytes == 0  # warm: nothing to copy


@pytest.mark.parametrize("pipeline", [True, False], ids=["on", "off"])
def test_cold_columns_land_resident(datasources, pipeline):
    _, port = datasources
    ds = port["ssb"]
    q = ssb.NATIVE_QUERIES["q4_1"]
    eng = _engine(pipeline)
    eng.execute(q, ds)
    m = eng.last_metrics
    names = (*eng._lowering_for(q, ds).columns, None)
    keys = [column_key(s, n) for s in ds.segments for n in names]
    assert m.segments > 2 and all(k in eng._device_cache for k in keys)
    assert m.h2d_bytes == sum(int((s.valid if n is None else s.column(n)).nbytes)
                              for s in ds.segments for n in names)
    # pinned copies are made on a card only
    assert eng._pipeline.to_dict() == {"enabled": pipeline, "pinned_columns": 0,
                                       "pinned_bytes": 0}


def test_a_failed_copy_fails_the_query(datasources, monkeypatch):
    _, port = datasources
    ds = port["ssb"]
    q = ssb.NATIVE_QUERIES["q4_1"]
    eng = _engine()
    bad = column_key(ds.segments[2])
    put = TransferPipeline.put

    def failing(self, key, host):
        if key == bad:
            raise OSError("injected h2d failure")
        return put(self, key, host)

    monkeypatch.setattr(TransferPipeline, "put", failing)
    with pytest.raises(OSError, match="injected h2d failure"):
        eng.execute(q, ds)
    assert bad not in eng._device_cache
    monkeypatch.setattr(TransferPipeline, "put", put)
    with arena.arena_disabled():
        _exact(eng.execute(q, ds), _engine(pipeline=False).execute(q, ds))


def test_session_flags_reach_the_pipeline():
    ctx = TPUOlapContext(device="cpu")
    assert ctx.engine._pipeline.enabled is True
    ctx.sql("SET transfer_pipeline = false")
    assert ctx.engine._pipeline.to_dict() == {
        "enabled": False, "pinned_columns": 0, "pinned_bytes": 0,
    }
    for flag in ("prefetch_depth", "prefetch_speculative_mb"):
        with pytest.raises(KeyError, match="unknown session flag"):
            ctx.sql(f"SET {flag} = 2")
