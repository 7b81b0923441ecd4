"""Segments: the PyTorch port's catalog against the JAX reference.

`build_datasource` on the same rows must give identical dictionaries, codes,
zone maps and segment split in both packages, and `datasource_from_numpy`
of an exported reference datasource must scan the same segments.  The
workload generators must draw identical tables from the same seed.
"""

import numpy as np
import pytest

from spark_druid_olap_tpu.catalog import segment as jseg
from spark_druid_olap_tpu.utils import datagen as jdatagen
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu.workloads import tpch as jtpch
from spark_druid_olap_tpu_torch.catalog import segment as tseg
from spark_druid_olap_tpu_torch.utils import datagen as tdatagen
from spark_druid_olap_tpu_torch.workloads import ssb as tssb
from spark_druid_olap_tpu_torch.workloads import tpch as ttpch


def assert_same_datasource(a, b):
    assert a.name == b.name and a.time_column == b.time_column
    assert [
        (c.name, c.kind, c.dtype, c.cardinality) for c in a.columns
    ] == [(c.name, c.kind, c.dtype, c.cardinality) for c in b.columns]
    assert set(a.dicts) == set(b.dicts)
    for k in a.dicts:
        assert tuple(a.dicts[k].values) == tuple(b.dicts[k].values), k
    assert len(a.segments) == len(b.segments)
    for sa, sb in zip(a.segments, b.segments):
        assert sa.segment_id == sb.segment_id
        assert sa.num_rows == sb.num_rows
        assert sa.interval == sb.interval and sa.time_name == sb.time_name
        assert sa.stats == sb.stats
        np.testing.assert_array_equal(sa.valid, sb.valid)
        if sa.time is None:
            assert sb.time is None
        else:
            assert sa.time.dtype == sb.time.dtype
            np.testing.assert_array_equal(sa.time, sb.time)
        for kind in ("dims", "metrics"):
            ca, cb = getattr(sa, kind), getattr(sb, kind)
            assert list(ca) == list(cb)
            for k in ca:
                assert ca[k].dtype == cb[k].dtype, (kind, k)
                np.testing.assert_array_equal(ca[k], cb[k])


def test_constants_match():
    assert tseg.ROW_PAD == jseg.ROW_PAD and tseg.NULL_ID == jseg.NULL_ID
    for card in (1, 2, 127, 128, 129, 32767, 32768, 32769, 1 << 20):
        assert tseg.code_dtype(card) == jseg.code_dtype(card)


@pytest.mark.parametrize("rows_per_segment", [4096, 1 << 19])
def test_build_datasource_ssb_flat_identical(rows_per_segment):
    cols = jdatagen.gen_ssb_lineorder_flat(scale=0.002, seed=7)
    tcols = tdatagen.gen_ssb_lineorder_flat(scale=0.002, seed=7)
    for k in cols:
        np.testing.assert_array_equal(np.asarray(cols[k]), np.asarray(tcols[k]))
    args = (jdatagen.SSB_DIMS, jdatagen.SSB_METRICS, "lo_orderdate", rows_per_segment)
    assert_same_datasource(
        jseg.build_datasource("ssb", cols, *args),
        tseg.build_datasource("ssb", tcols, *args),
    )


def test_build_datasource_lineitem_identical():
    cols = jdatagen.gen_lineitem(scale=0.002, seed=42)
    args = (jdatagen.LINEITEM_DIMS, jdatagen.LINEITEM_METRICS, "l_shipdate", 4096)
    assert_same_datasource(
        jseg.build_datasource("tpch", cols, *args),
        tseg.build_datasource("tpch", tdatagen.gen_lineitem(scale=0.002, seed=42), *args),
    )


def test_ssb_workload_datasource_identical():
    jt, tt = jssb.gen_tables(0.002, seed=7), tssb.gen_tables(0.002, seed=7)
    for table in jt:
        for k in jt[table]:
            np.testing.assert_array_equal(
                np.asarray(jt[table][k]), np.asarray(tt[table][k])
            )
    jcols, jdicts = jssb.flat_columns(jt)
    jds = jseg.build_datasource(
        "lineorder", jcols, jssb.FLAT_DIMS, jssb.FLAT_METRICS,
        time_col="lo_orderdate", rows_per_segment=4096, dicts=jdicts,
    )
    assert_same_datasource(jds, tssb.datasource(*tssb.flat_columns(tt), rows_per_segment=4096))


def test_tpch_workload_datasource_identical():
    jt, tt = jtpch.gen_tables(0.001), ttpch.gen_tables(0.001)
    jcols, jdicts = jtpch.flat_columns(jt)
    jds = jseg.build_datasource(
        "lineitem", jcols, jtpch.FLAT_DIMS, jtpch.FLAT_METRICS,
        time_col="l_shipdate", rows_per_segment=2048, dicts=jdicts,
    )
    assert_same_datasource(jds, ttpch.datasource(*ttpch.flat_columns(tt), rows_per_segment=2048))


def test_datasource_from_numpy_scans_reference_segments():
    cols, dicts = jssb.flat_columns(jssb.gen_tables(0.002, seed=7))
    jds = jseg.build_datasource(
        "lineorder", cols, jssb.FLAT_DIMS, jssb.FLAT_METRICS,
        time_col="lo_orderdate", rows_per_segment=4096, dicts=dicts,
    )
    exported = tseg.datasource_to_numpy(jds)
    tds = tseg.datasource_from_numpy(exported)
    assert_same_datasource(jds, tds)
    # segments own their arrays: the export can be reused or mutated
    exported["segments"][0]["metrics"]["lo_revenue"][:] = -1
    assert (tds.segments[0].metrics["lo_revenue"] >= 0).all()
    assert len({s.uid for s in tds.segments}) == len(tds.segments)
