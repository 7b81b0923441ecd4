"""Streamed ingest of the PyTorch port (`spark_druid_olap_tpu_torch/ingest/`,
the delta segments of `catalog/segment.py`, the result cache's delta reuse,
the server's ingest route and `__sys` telemetry) against the JAX reference
on the CPU.

The same rows, drawn from a seed with numpy, go through both packages:

* builds: the sharded build equals the serial one and the reference's
  (dictionaries, codes, zone maps), and `ssb.register_streamed` registers
  the reference's segments;
* remaps: `extend_dict` LUTs and `remap_segment_codes` segments equal the
  reference's;
* appends: the same batches give the same delta segments (codes, `seq`,
  zone maps) and the same frames, through the engine and through the host
  fallback, held to a float64 oracle over every row appended; malformed
  payloads fail alike; a deadline stops a remap at its checkpoint; rollup
  pre-aggregates alike;
* compaction: the same historical segments as the reference's, the frames
  of before within rtol 1e-6 and the oracle, the version bumped, and the
  retired uids gone from the engine's residency, its pinned copies and its
  `ArenaCache`;
* delta-aware reuse: the refreshed frame equals a full run's within rtol,
  the refresh dispatches the appended segments alone, and a declined
  refresh is recorded on the metrics of the full run that follows;
* the HTTP ingest route: status codes and bodies equal the reference
  server's (200, 400, 503 with Retry-After);
* `__sys`: after the same ticks (`sample_once`, no sleeping) the same
  `sum(delta)` of `sdol_queries_total`;
* background threads: the compaction sweep runs without its thread
  (`run_pending`), and every started thread is stopped in teardown.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu import resilience as jres
from spark_druid_olap_tpu.catalog import segment as jseg
from spark_druid_olap_tpu.ingest import shard as jshard
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu_torch import resilience as tres
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.catalog import segment as tseg
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.ingest import shard as tshard
from spark_druid_olap_tpu_torch.obs.telemetry import SYS_TABLE
from spark_druid_olap_tpu_torch.workloads import ssb as tssb

from test_torch_segment import assert_same_datasource
from test_torch_sql import assert_frames_match, reference_config

RTOL = 1e-6
ORACLE_RTOL = 2e-5
T0 = int(np.datetime64("2022-01-01", "ms").astype(np.int64))
DAY = 86_400_000
CITIES = np.array(["austin", "boston", "chicago", "denver", "el paso"], dtype=object)
SEGMENT_ROWS = 2048


def rows(n, seed, cities=CITIES, years=(1995, 1999)):
    rng = np.random.default_rng(seed)
    return {
        "city": rng.choice(cities, n),
        "year": rng.integers(years[0], years[1], n).astype(np.int64),
        "qty": rng.integers(1, 100, n).astype(np.int64),
        "rev": (rng.random(n) * 100).astype(np.float32),
        "ts": T0 + rng.integers(0, 365, n) * DAY,
    }


def concat(*maps):
    return {k: np.concatenate([np.asarray(m[k]) for m in maps]) for k in maps[0]}


def register(ctx, cols, name="ev", **kw):
    return ctx.register_table(
        name, cols, dimensions=["city", "year"], metrics=["qty", "rev"],
        time_column="ts", rows_per_segment=SEGMENT_ROWS, **kw)


def pair(cols, ref_config=None, port_config=None):
    """(reference context, port context) with `cols` registered as `ev`."""
    ref = sd.TPUOlapContext(ref_config or reference_config())
    port = TPUOlapContext(port_config or SessionConfig(result_cache_entries=0), device="cpu")
    for c in (ref, port):
        register(c, cols)
    return ref, port


QUERIES = {
    "groupby": "SELECT city, sum(qty) AS q, sum(rev) AS r, count(*) AS n FROM ev "
               "GROUP BY city ORDER BY city",
    "groupby2": "SELECT city, year, sum(qty) AS q, min(rev) AS lo, max(rev) AS hi FROM ev "
                "WHERE year >= 1996 GROUP BY city, year ORDER BY city, year",
    "topn": "SELECT city, sum(qty) AS q FROM ev GROUP BY city ORDER BY q DESC LIMIT 3",
    "timeseries": "SELECT DATE_TRUNC('month', ts) AS m, sum(qty) AS q FROM ev "
                  "GROUP BY DATE_TRUNC('month', ts) ORDER BY m",
}


def oracle(cols, name):
    """The float64 pandas answer of QUERIES[name] over `cols`."""
    f = pd.DataFrame({k: np.asarray(v) for k, v in cols.items()})
    f["rev"] = f["rev"].astype(np.float64)
    if name == "groupby":
        g = f.groupby("city").agg(q=("qty", "sum"), r=("rev", "sum"), n=("qty", "size"))
    elif name == "groupby2":
        g = f[f.year >= 1996].groupby(["city", "year"]).agg(
            q=("qty", "sum"), lo=("rev", "min"), hi=("rev", "max"))
    elif name == "topn":
        g = f.groupby("city").agg(q=("qty", "sum")).sort_values("q", ascending=False).head(3)
    else:
        f["m"] = f["ts"].astype("datetime64[ms]").dt.to_period("M").dt.start_time
        g = f.groupby("m").agg(q=("qty", "sum"))
    return g.reset_index()


def assert_oracle(got, want):
    for c in want.columns:
        if c == "m":
            continue  # the bucket key: the frames' row order is the month order
        g, w = np.asarray(got[c]), np.asarray(want[c])
        if w.dtype.kind in "iuO":
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=c)
        else:
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=ORACLE_RTOL, err_msg=c)


def assert_same_segments(jds, tds):
    """The two packages' datasources hold the same segments, deltas with
    their sequence numbers."""
    assert_same_datasource(jds, tds)
    assert [getattr(s, "seq", None) for s in jds.segments] == [
        getattr(s, "seq", None) for s in tds.segments]
    assert [isinstance(s, jseg.DeltaSegment) for s in jds.segments] == [
        isinstance(s, tseg.DeltaSegment) for s in tds.segments]
    assert jds.version == tds.version and jds.delta_rows == tds.delta_rows


def check_queries(ref, port, cols, names=tuple(QUERIES)):
    for name in names:
        got, want = port.sql(QUERIES[name]), ref.sql(QUERIES[name])
        assert_frames_match(got, want, RTOL)
        assert_oracle(got, oracle(cols, name))


@pytest.fixture(autouse=True)
def _disarm():
    for inj in (jres.injector(), tres.injector()):
        inj.disarm()
    yield
    for inj in (jres.injector(), tres.injector()):
        inj.disarm()


# -- builds --------------------------------------------------------------------


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("chunked", [False, True], ids=["mapping", "chunks"])
def test_sharded_build_equals_serial_and_reference(workers, chunked):
    cols = rows(9000, 3)
    dims, mets = ["city", "year"], ["qty", "rev"]

    def source():
        if not chunked:
            return cols
        return [{k: v[i:i + 1700] for k, v in cols.items()} for i in range(0, 9000, 1700)]

    serial = tseg.build_datasource("ev", cols, dims, mets, "ts", SEGMENT_ROWS)
    got = tshard.build_datasource_sharded("ev", source(), dims, mets, "ts", SEGMENT_ROWS,
                                          workers=workers)
    want = jshard.build_datasource_sharded("ev", source(), dims, mets, "ts", SEGMENT_ROWS,
                                           workers=workers)
    assert_same_datasource(serial, got)
    assert_same_datasource(want, got)


def test_merge_shard_values_equals_reference_in_any_order():
    parts = [["b", None, "a"], ["c", "a"], [float("nan"), "d"]]
    want = jshard.merge_shard_values(parts).values
    for order in ([0, 1, 2], [2, 1, 0], [1, 2, 0]):
        assert tshard.merge_shard_values([parts[i] for i in order]).values == want
    assert tshard.merge_shard_values([[3, 1], [2, -0]]).values == (0, 1, 2, 3)


def test_csv_build_equals_reference(tmp_path):
    cols = rows(3000, 5)
    paths = []
    for i in range(3):
        p = tmp_path / f"part{i}.csv"
        pd.DataFrame({k: v[i * 1000:(i + 1) * 1000] for k, v in cols.items()}).to_csv(p, index=False)
        paths.append(str(p))
    args = (["city", "year"], ["qty", "rev"], "ts", 1024)
    got = tshard.build_datasource_from_csv("ev", paths, *args, workers=2)
    want = tseg.build_datasource("ev", {k: np.asarray(v) for k, v in cols.items()}, *args)
    assert_same_datasource(want, got)


def test_register_streamed_equals_reference():
    ref = sd.TPUOlapContext(reference_config())
    port = TPUOlapContext(device="cpu")
    jt = jssb.register_streamed(ref, 0.004, rows_per_segment=4096, chunk_rows=7000, workers=2)
    tt = tssb.register_streamed(port, 0.004, rows_per_segment=4096, chunk_rows=7000, workers=2)
    for k in jt:
        for c in jt[k]:
            np.testing.assert_array_equal(np.asarray(jt[k][c]), np.asarray(tt[k][c]))
    assert_same_datasource(ref.catalog.get("lineorder"), port.catalog.get("lineorder"))
    assert_frames_match(port.sql(tssb.QUERIES["q2_1"]), ref.sql(jssb.QUERIES["q2_1"]), RTOL)


# -- dictionary extension and remaps ---------------------------------------------


REMAPS = {
    "strings": (("b", "d", "f"), ["a", "c", "d", None, "g"]),
    "numbers": ((1995, 1997), [1994, 1996, 1997, 2001]),
    "none_novel": (("a", "b"), ["a", "b", None]),
    "from_empty": ((), [3, 1, 2]),
}


@pytest.mark.parametrize("case", list(REMAPS))
def test_extend_dict_equals_reference(case):
    old, new = REMAPS[case]
    jd, jlut = jseg.extend_dict(jseg.DimensionDict(values=old), new)
    td, tlut = tseg.extend_dict(tseg.DimensionDict(values=old), new)
    assert td.values == jd.values
    if jlut is None:
        assert tlut is None
    elif not old:
        assert tlut.shape == jlut.shape == (1,)  # no old code to map
    else:
        assert tlut.dtype == jlut.dtype
        np.testing.assert_array_equal(tlut, jlut)
        assert (np.diff(tlut) > 0).all()  # strictly monotone


def test_remap_segment_codes_equals_reference():
    cols = rows(3000, 8)
    jds = jseg.build_datasource("ev", cols, ["city", "year"], ["qty"], "ts", 1024)
    tds = tseg.datasource_from_numpy(tseg.datasource_to_numpy(jds))
    jnew, jlut = jseg.extend_dict(jds.dicts["city"], ["aardvark", "zed"])
    tnew, tlut = tseg.extend_dict(tds.dicts["city"], ["aardvark", "zed"])
    for js, ts in zip(jds.segments, tds.segments):
        jr = jseg.remap_segment_codes(js, {"city": jlut}, {"city": jnew.cardinality})
        tr = tseg.remap_segment_codes(ts, {"city": tlut}, {"city": tnew.cardinality})
        assert tr.uid != ts.uid and tr.stats == jr.stats
        for k in jr.dims:
            assert tr.dims[k].dtype == jr.dims[k].dtype
            np.testing.assert_array_equal(tr.dims[k], jr.dims[k])
        # the values under the new dictionary are the values under the old
        np.testing.assert_array_equal(
            tnew.decode(np.asarray(tr.dims["city"], dtype=np.int64)),
            tds.dicts["city"].decode(np.asarray(ts.dims["city"], dtype=np.int64)))


# -- append batches -----------------------------------------------------------------


def _novel(cols):
    out = dict(cols)
    out["city"] = np.where(np.arange(len(cols["city"])) % 3 == 0, "fresno", cols["city"])
    out["year"] = np.where(np.arange(len(cols["year"])) % 4 == 0, 2003, cols["year"])
    return out


def _row_objects(cols):
    return [
        {k: (v[i].item() if hasattr(v[i], "item") else v[i]) for k, v in cols.items()}
        for i in range(len(cols["qty"]))
    ]


BATCHES = {
    # known values: deltas only, nothing historical touched
    "known_columns": lambda: [rows(700, 11), rows(50, 12)],
    # novel city and year: dictionaries extend, every segment remaps
    "novel_values": lambda: [_novel(rows(400, 13)), rows(30, 14)],
    # a batch over delta_seal_rows splits into several deltas
    "sealed_split": lambda: [rows(5000, 15)],
    # the wire shape: a list of row objects
    "row_objects": lambda: [rows(20, 16)],
}


@pytest.mark.parametrize("case", list(BATCHES))
def test_appends_equal_reference_and_oracle(case):
    base = rows(5000, 1)
    ref, port = pair(base)
    seen = [base]
    for batch in BATCHES[case]():
        payload = _row_objects(batch) if case == "row_objects" else batch
        acks = [c.append_rows("ev", payload) for c in (ref, port)]
        assert acks[1] == acks[0]
        seen.append(batch)
        # visible at once: the next query answers over every appended row
        check_queries(ref, port, concat(*seen), names=("groupby",))
    assert_same_segments(ref.catalog.get("ev"), port.catalog.get("ev"))
    check_queries(ref, port, concat(*seen))
    assert port.catalog.get("ev").delta_rows == sum(len(b["qty"]) for b in seen[1:])


def test_appends_through_the_host_fallback():
    base = rows(3000, 2)
    ref, port = pair(base)
    batch = _novel(rows(300, 21))
    for c in (ref, port):
        c.append_rows("ev", batch)
    # a subquery: the planner cannot rewrite it, the fallback decodes the
    # deltas beside the historical segments
    sql = ("SELECT city, sum(qty) AS q FROM ev WHERE qty IN "
           "(SELECT qty FROM ev WHERE year = 2003) GROUP BY city ORDER BY city")
    got, want = port.sql(sql), ref.sql(sql)
    assert port.last_metrics.executor in ("fallback", "device+fallback")
    assert_frames_match(got, want, RTOL)
    f = pd.DataFrame(concat(base, batch))
    o = f[f.qty.isin(set(f.qty[f.year == 2003]))].groupby("city").agg(q=("qty", "sum")).reset_index()
    assert_oracle(got, o)


MALFORMED = {
    "unknown_column": [{"city": "x", "wat": 1, "ts": T0}],
    "ragged": {"city": ["a", "b"], "ts": [T0]},
    "not_objects": [1, 2],
    "null_time": [{"city": "x", "ts": None}],
    "missing_time": [{"city": "x", "qty": 1}],
    "bad_type": "rows",
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_appends_fail_alike(case):
    ref, port = pair(rows(500, 3))
    errs = []
    for c in (ref, port):
        with pytest.raises(ValueError) as ei:
            c.append_rows("ev", MALFORMED[case])
        errs.append(str(ei.value))
    assert errs[1] == errs[0]
    assert port.catalog.get("ev").version == ref.catalog.get("ev").version == 1
    for c in (ref, port):
        with pytest.raises(KeyError):
            c.append_rows("nope", [{"city": "x"}])
        assert c.append_rows("ev", [])["appended"] == 0


def test_append_deadline_stops_the_remap_at_its_checkpoint():
    ref, port = pair(rows(6000, 4))
    for c, res in ((ref, jres), (port, tres)):
        res.injector().arm("ingest.remap_segment", error_type=res.InjectedDeadline,
                           skip=1, times=1)
        with pytest.raises(res.DeadlineExceeded):
            c.append_rows("ev", _novel(rows(10, 5)))
        res.injector().disarm()
        # nothing published: the batch is absent, whole
        assert c.catalog.get("ev").version == 1 and c.catalog.get("ev").delta_rows == 0
    assert_same_segments(ref.catalog.get("ev"), port.catalog.get("ev"))


def test_rollup_equals_reference():
    base = rows(800, 6)
    ref = sd.TPUOlapContext(reference_config())
    port = TPUOlapContext(SessionConfig(result_cache_entries=0), device="cpu")
    for c in (ref, port):
        register(c, base, rollup_granularity="day")
    batch = rows(600, 7, cities=CITIES[:2], years=(1995, 1996))
    batch["ts"] = T0 + (np.arange(600) % 3) * DAY + np.arange(600)  # 3 days
    acks = [c.append_rows("ev", batch) for c in (ref, port)]
    assert acks[1] == acks[0]
    assert port.catalog.get("ev").delta_rows == ref.catalog.get("ev").delta_rows == 6
    assert_same_segments(ref.catalog.get("ev"), port.catalog.get("ev"))
    check_queries(ref, port, concat(base, batch), names=("timeseries",))
    for c in (ref, port):
        with pytest.raises(ValueError, match="fixed period"):
            register(c, base, name="ev2", rollup_granularity="month")


# -- compaction ---------------------------------------------------------------------


def test_compaction_equals_reference_and_retires_uids():
    base = rows(5000, 8)
    ref, port = pair(base, ref_config=dataclasses.replace(reference_config(),
                                                          compaction_rows_per_segment=4096),
                     port_config=SessionConfig(result_cache_entries=0,
                                               compaction_rows_per_segment=4096))
    batches = [rows(900, 30 + i) for i in range(4)]
    for b in batches:
        for c in (ref, port):
            c.append_rows("ev", b)
    before = {n: port.sql(QUERIES[n]) for n in QUERIES}
    before = {n: port.sql(QUERIES[n]) for n in QUERIES}  # the second run captures
    eng = port.engine
    ds = port.catalog.get("ev")
    retired = {s.uid for s in ds.delta_segments()} | {ds.historical_segments()[-1].uid}
    assert retired & eng.resident_uids()
    assert any(ck[0] in retired for ck in eng._arena._by_col)
    some = next(iter(retired))
    eng._pipeline._pinned[(some, "col", "qty")] = np.zeros(4)  # a kept copy (a card's)
    summaries = [c.compact("ev") for c in (ref, port)]
    assert summaries[1] == summaries[0]
    assert summaries[1]["compacted_rows"] == 3600
    after = port.catalog.get("ev")
    assert after.version == ds.version + 1 and after.delta_rows == 0
    assert_same_segments(ref.catalog.get("ev"), after)
    assert not retired & eng.resident_uids()
    assert not any(k[0] in retired for k in eng._pipeline._pinned)
    assert not any(ck[0] in retired for ck in eng._arena._by_col)
    full = concat(base, *batches)
    for n in QUERIES:
        got = port.sql(QUERIES[n])
        assert_frames_match(got, before[n], RTOL)
        assert_frames_match(got, ref.sql(QUERIES[n]), RTOL)
        assert_oracle(got, oracle(full, n))
    # nothing to fold: a summary, no publish
    assert port.compact("ev")["compacted_rows"] == 0
    assert port.catalog.get("ev").version == after.version


def test_remap_retires_every_uid_from_the_engine():
    base = rows(4000, 9)
    _, port = pair(base)
    for _ in range(2):
        port.sql(QUERIES["groupby"])
    old = {s.uid for s in port.catalog.get("ev").segments}
    assert old <= port.engine.resident_uids()
    port.append_rows("ev", _novel(rows(10, 10)))
    assert not old & port.engine.resident_uids()
    assert not any(ck[0] in old for ck in port.engine._arena._by_col)
    assert_oracle(port.sql(QUERIES["groupby"]), oracle(concat(base, _novel(rows(10, 10))), "groupby"))


def test_drop_hook_raises_a_device_fault_and_logs_others(monkeypatch):
    _, port = pair(rows(3000, 10))

    def sticky(uids):
        raise tres.KernelError("graph capture refused")

    monkeypatch.setattr(port.engine, "evict_segments", sticky)
    with pytest.raises(tres.KernelError):
        port.append_rows("ev", _novel(rows(5, 11)))

    def flaky(uids):
        raise ValueError("bookkeeping")

    monkeypatch.setattr(port.engine, "evict_segments", flaky)
    ack = port.append_rows("ev", _novel(rows(5, 12)) | {"city": np.array(["zzz"] * 5, dtype=object)})
    assert ack["appended"] == 5


def test_background_sweep_without_its_thread():
    ref, port = pair(rows(2000, 11), ref_config=dataclasses.replace(
        reference_config(), compaction_min_delta_rows=100),
        port_config=SessionConfig(compaction_min_delta_rows=100))
    for c in (ref, port):
        c.append_rows("ev", rows(50, 12))
        assert c.compactor.run_pending() == []  # under both thresholds
        c.append_rows("ev", rows(60, 13))
    outs = [c.compactor.run_pending() for c in (ref, port)]
    assert outs[1] == outs[0] and outs[1][0]["compacted_rows"] == 110
    port.start_compaction()
    try:
        assert port.compactor._thread.is_alive()
    finally:
        port.close()
    assert not port.compactor._thread.is_alive()


# -- the result cache's delta reuse -----------------------------------------------------


def test_delta_reuse_equals_a_full_run_and_scans_the_deltas():
    base = rows(6000, 14)
    # the cache on, delta reuse on; routed by the card's constants (the
    # class defaults) as `full` is, so no run declines the arena
    port = TPUOlapContext(SessionConfig(), device="cpu")
    register(port, base)
    full = TPUOlapContext(SessionConfig(result_cache_entries=0), device="cpu")
    register(full, base)
    sql = QUERIES["groupby2"]
    port.sql(sql)
    assert port.last_metrics.result_cache == "miss"
    seen = [base]
    for i in range(3):
        batch = rows(500 + i, 40 + i)
        seen.append(batch)
        for c in (port, full):
            c.append_rows("ev", batch)
        got = port.sql(sql)
        m = port.last_metrics
        assert m.strategy == "result-cache-delta" and m.result_cache == "delta"
        # the refresh scanned the new delta alone
        assert m.segments == 1 and m.rows_scanned == m.delta_rows_seen == len(batch["qty"])
        assert m.dispatch_count == 1
        want = full.sql(sql)
        assert_frames_match(got, want, RTOL)
        assert_oracle(got, oracle(concat(*seen), "groupby2"))
    stats = port.serve.result_cache.to_dict()
    assert stats["delta_hits"] == 3 and stats["delta_reuse"] is True
    # a compaction retires the covered uids: a recorded decline, a full run
    port.compact("ev")
    got = port.sql(sql)
    m = port.last_metrics
    assert m.result_cache == "miss" and m.strategy != "result-cache-delta"
    assert any(d.startswith("result-cache: segments retired") for d in m.declines)
    assert_frames_match(got, full.sql(sql), RTOL)
    # off: a version-exact cache only
    port.sql("SET result_cache_delta_reuse = false")
    port.append_rows("ev", rows(10, 50))
    port.sql(sql)
    assert port.last_metrics.result_cache == "miss" and port.last_metrics.declines == []


def test_delta_reuse_matches_the_reference_cache_outcomes():
    base = rows(3000, 15)
    ref = sd.TPUOlapContext(dataclasses.replace(reference_config(), result_cache_entries=64))
    port = TPUOlapContext(device="cpu")
    for c in (ref, port):
        register(c, base)
    outcomes = []
    for step in ("miss", "hit", "append", "delta", "hit"):
        if step == "append":
            for c in (ref, port):
                c.append_rows("ev", rows(100, 16))
            continue
        got, want = port.sql(QUERIES["topn"]), ref.sql(QUERIES["topn"])
        assert_frames_match(got, want, RTOL)
        outcomes.append((port.serve.result_cache.to_dict()["hits"],
                         port.serve.result_cache.to_dict()["delta_hits"]))
        j = ref.serve.result_cache.to_dict()
        assert outcomes[-1] == (j["hits"], j["delta_hits"])
    assert outcomes[-1] == (2, 1)


SKETCH_SQL = {
    "hll": "SELECT city, approx_count_distinct(qty) AS d, sum(qty) AS q FROM ev "
           "GROUP BY city ORDER BY city",
    "theta": "SELECT year, approx_count_distinct_ds_theta(qty) AS d FROM ev "
             "GROUP BY year ORDER BY year",
    "quantile": "SELECT city, APPROX_QUANTILE(rev, 0.5) AS p50, count(*) AS n FROM ev "
                "GROUP BY city ORDER BY city",
}


@pytest.mark.parametrize("kind", sorted(SKETCH_SQL))
def test_delta_reuse_merges_sketches_like_a_full_run(kind):
    """A delta refresh of a sketch query merges the cached sketch states
    with the deltas' on the host: the merged state is a full run's, bit for
    bit, and so is the frame; the reference answers alike."""
    sql = SKETCH_SQL[kind]
    base = rows(5000, 21)
    ref = sd.TPUOlapContext(dataclasses.replace(reference_config(), result_cache_entries=64))
    port = TPUOlapContext(device="cpu")
    full = TPUOlapContext(SessionConfig(result_cache_entries=0), device="cpu")
    for c in (ref, port, full):
        register(c, base)
    port.sql(sql)
    for i in range(2):
        batch = rows(700 + i, 60 + i)
        for c in (ref, port, full):
            c.append_rows("ev", batch)
        got = port.sql(sql)
        assert port.last_metrics.result_cache == "delta", port.last_metrics.describe()
        pd.testing.assert_frame_equal(got, full.sql(sql), check_exact=True)
        assert_frames_match(got, ref.sql(sql), RTOL)
    ds = port.catalog.get("ev")
    rw = port.plan_sql(sql)
    entry = port.serve.result_cache._cache.get(port._result_key(rw, ds))
    assert entry.version == ds.version
    whole, _ = full.engine.groupby_partials_host(rw.query, full.catalog.get("ev"))
    assert set(entry.state["sketches"]) == set(whole["sketches"]) != set()
    for name, st in whole["sketches"].items():
        np.testing.assert_array_equal(entry.state["sketches"][name], st, err_msg=name)


# -- the HTTP ingest route ----------------------------------------------------------------


@pytest.fixture()
def servers():
    from spark_druid_olap_tpu.server import OlapServer as JServer
    from spark_druid_olap_tpu_torch.server import OlapServer as TServer

    ref, port = pair(rows(2000, 17))
    srvs = [JServer(ref, port=0).start(), TServer(port, port=0).start()]
    try:
        yield [(ref, srvs[0]), (port, srvs[1])]
    finally:
        for s in srvs:
            s.shutdown()


def _post(srv, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


ROUTE_CASES = {
    "rows": ("/druid/v2/ingest/ev", {"rows": [
        {"city": "austin", "year": 1997, "qty": 40, "rev": 1.0, "ts": T0},
        {"city": "brand new", "year": 1995, "qty": 2, "rev": 2.0, "ts": T0 + DAY}],
        "context": {"queryId": "ingest-42", "timeout": "soon"}}),
    "columns": ("/druid/v2/ingest/ev", {"columns": {
        "city": ["austin"], "year": [1998], "qty": [3], "rev": [0.5], "ts": [T0 + 2 * DAY]}}),
    "unknown_datasource": ("/druid/v2/ingest/nope", {"rows": [{"city": "x", "ts": T0}]}),
    "no_rows": ("/druid/v2/ingest/ev", {"bogus": 1}),
    "unknown_column": ("/druid/v2/ingest/ev", {"rows": [{"city": "x", "wat": 1, "ts": T0}]}),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_ingest_route_equals_the_reference_server(servers, case):
    path, body = ROUTE_CASES[case]
    out = [_post(srv, path, body) for _, srv in servers]
    (rs, rbody, rh), (ps, pbody, ph) = out
    assert ps == rs and pbody == rbody
    if case == "rows":
        assert ph["X-Druid-Query-Id"] == rh["X-Druid-Query-Id"] == "ingest-42"
    if ps == 200:
        # the rows are in the next served query's answer
        sql = {"query": "SELECT city, sum(qty) AS q FROM ev GROUP BY city ORDER BY city"}
        got = [_post(srv, "/druid/v2/sql", sql)[1] for _, srv in servers]
        assert got[1] == got[0]
        assert servers[1][0].catalog.get("ev").delta_rows == pbody["appended"]


def test_ingest_route_answers_503_with_retry_after_when_full(servers):
    out = []
    for ctx, srv in servers:
        adm = ctx.resilience.ingest_admission
        adm.queue_timeout_ms = 50.0
        held = [adm.acquire() for _ in range(adm.max_concurrent)]
        try:
            out.append(_post(srv, "/druid/v2/ingest/ev", ROUTE_CASES["columns"][1]))
        finally:
            for _ in held:
                adm.release()
            adm.queue_timeout_ms = 2000.0
    (rs, rbody, rh), (ps, pbody, ph) = out
    assert ps == rs == 503 and pbody == rbody
    assert int(ph["Retry-After"]) >= 1 and "Retry-After" in rh
    assert servers[1][0].catalog.get("ev").delta_rows == 0
    with urllib.request.urlopen(f"http://127.0.0.1:{servers[1][1].port}/status/health",
                                timeout=30) as r:
        health = json.loads(r.read())
    assert health["ingest_admission"]["slots_total"] == 2
    assert health["storage"] == {"enabled": False}


# -- __sys telemetry -----------------------------------------------------------------------


def test_sys_table_answers_alike_after_the_same_ticks():
    ref, port = pair(rows(1000, 18))
    answers = []
    try:
        for c in (ref, port):
            # every series the queries below touch made first: a counter
            # series first appears with delta 0, and run alone no earlier
            # test of the process made them.  The reference counts its first
            # run of the topn SQL under groupBy and later runs under topN, so
            # topn runs twice here
            for name in ("groupby", "topn", "topn"):
                c.sql(QUERIES[name])
            sampler = c.start_sys_sampler(interval_s=3600)  # the thread never ticks here
            c.stop_sys_sampler()
            assert sampler.sample_once() > 0  # registers __sys
            for name in ("groupby", "topn", "groupby"):
                c.sql(QUERIES[name])
            assert sampler.sample_once() > 0
            answers.append(c.sql(
                f"SELECT sum(delta) AS d FROM {SYS_TABLE} WHERE metric = 'sdol_queries_total'"))
            assert c.catalog.get(SYS_TABLE).delta_rows > 0
    finally:
        for c in (ref, port):
            c.stop_sys_sampler()
    assert float(answers[1]["d"].iloc[0]) == float(answers[0]["d"].iloc[0]) == 3.0
    status = port.sys_sampler.status()
    assert status["ticks"] == 2 and status["errors"] == 0 and not status["running"]
