"""The durable tier of the PyTorch port (`storage.py`, `ingest/wal.py`,
`catalog/persist.py`) against the JAX reference on the CPU.

A "kill" is a new context over the same `storage_dir` with no shutdown of
the old one, which is what a process killed at a fault site leaves behind.

* WAL: `encode_batch` gives the reference's bytes for the same batch, and
  each package decodes the other's; a torn tail at every byte boundary of
  the last record, a corrupt record and bad magic end the scan at the last
  whole record.
* Stores across packages, both ways: a store (snapshot and WAL tail)
  written by the JAX package boots in the port and one written by the port
  boots in the reference; both serve equal frames.  `save_table`
  directories likewise, through `load_table` and through SQL.
* Crashes: at each of the seven storage fault sites
  (`resilience.STORAGE_SITES`), the restarted port recovers the state the
  restarted reference recovers: a batch is whole or absent, never torn.
* Restart: the frames after a restart are bit-identical to those before;
  historical segments come back memory-mapped (`LazyColumnMap`) and move
  to the device without a warning; versions never go back.
* The server answers 503 with Retry-After while a boot replays its WAL,
  and reports the storage state under /status/health.
"""

import json
import os
import struct
import urllib.error
import urllib.request
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu import resilience as jres
from spark_druid_olap_tpu.ingest import wal as jwal
from spark_druid_olap_tpu_torch import resilience as tres
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.catalog.persist import LazyColumnMap
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.ingest import wal as twal

from test_torch_sql import assert_frames_match, reference_config

RTOL = 1e-6
T0 = int(np.datetime64("2023-01-01", "ms").astype(np.int64))
DAY = 86_400_000
Q = "SELECT city, sum(qty) AS q, sum(rev) AS r, count(*) AS n FROM ev GROUP BY city ORDER BY city"


@pytest.fixture(autouse=True)
def _disarm():
    for inj in (jres.injector(), tres.injector()):
        inj.disarm()
    yield
    for inj in (jres.injector(), tres.injector()):
        inj.disarm()


def cols(n=120, seed=0, cities=("austin", "boston", "chicago")):
    rng = np.random.default_rng(seed)
    return {
        "city": rng.choice(np.array(cities, dtype=object), n),
        "qty": rng.integers(1, 100, n).astype(np.int64),
        "rev": (rng.random(n) * 10).astype(np.float32),
        "ts": T0 + rng.integers(0, 30, n) * DAY,
    }


def port_ctx(d, **kw):
    kw.setdefault("result_cache_entries", 0)
    return TPUOlapContext(SessionConfig(storage_dir=str(d), **kw), device="cpu")


def ref_ctx(d=None, **kw):
    import dataclasses

    return sd.TPUOlapContext(dataclasses.replace(reference_config(), storage_dir=(
        str(d) if d is not None else None), **kw))


def register(ctx, c=None, **kw):
    return ctx.register_table("ev", c if c is not None else cols(), dimensions=["city"],
                              metrics=["qty", "rev"], time_column="ts", rows_per_segment=64, **kw)


def oracle(*maps):
    f = pd.DataFrame({k: np.concatenate([np.asarray(m[k]) for m in maps]) for k in maps[0]})
    f["rev"] = f["rev"].astype(np.float64)
    return f.groupby("city").agg(q=("qty", "sum"), r=("rev", "sum"), n=("qty", "size")).reset_index()


def assert_oracle(got, want):
    assert list(got["city"]) == list(want["city"])
    np.testing.assert_array_equal(np.asarray(got["q"]), np.asarray(want["q"]))
    np.testing.assert_array_equal(np.asarray(got["n"]), np.asarray(want["n"]))
    np.testing.assert_allclose(np.asarray(got["r"], dtype=np.float64), want["r"], rtol=2e-5)


# -- the WAL ------------------------------------------------------------------------


BATCHES = {
    "strings_with_nulls": ({"city": np.asarray(["a", None, "c"], dtype=object),
                            "qty": np.asarray([1, 2, 3], dtype=np.int64)}, 3),
    "floats": ({"rev": np.asarray([0.5, 1.5, np.nan], dtype=np.float32),
                "x": np.asarray([1.0, 2.0, 3.0])}, 3),
    "numbers_as_objects": ({"year": np.asarray([1995, None, 1997], dtype=object),
                            "ts": np.asarray([T0, T0 + 1, T0 + 2], dtype=np.int64)}, 3),
    "empty_columns": ({"city": np.asarray([], dtype=object),
                       "qty": np.asarray([], dtype=np.int64)}, 0),
}


@pytest.mark.parametrize("case", list(BATCHES))
def test_encode_batch_bytes_equal_the_reference(case):
    batch, n = BATCHES[case]
    blob = twal.encode_batch("ev", batch, n)
    assert blob == jwal.encode_batch("ev", batch, n)
    for decode in (twal.decode_batch, jwal.decode_batch):
        ds, out, m = decode(blob)
        assert ds == "ev" and m == n and list(out) == list(batch)
        for k in batch:
            a, b = np.asarray(out[k]), np.asarray(batch[k])
            assert a.dtype == b.dtype or b.dtype.kind == "O"
            if b.dtype.kind == "O":
                assert list(a) == list(b)
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_wal_file_replays_in_either_package(tmp_path, writer):
    mod, other = (twal, jwal) if writer == "port" else (jwal, twal)
    p = str(tmp_path / "wal.log")
    w = mod.WriteAheadLog(p)
    assert [w.append("ev", BATCHES["strings_with_nulls"][0], 3) for _ in range(3)] == [0, 1, 2]
    w.close()
    got = list(other.WriteAheadLog(p).scan())
    assert [g[0] for g in got] == [0, 1, 2]
    assert other.WriteAheadLog(p).last_seq == 2
    w2 = other.WriteAheadLog(p)
    assert w2.truncate_through(1) == 1
    w2.close()
    assert [g[0] for g in mod.WriteAheadLog(p).scan()] == [2]


def _records(blob):
    head = struct.Struct("<4sIQI")
    sizes, off = [], 0
    while off < len(blob):
        _, plen, _, _ = head.unpack_from(blob, off)
        sizes.append(head.size + plen)
        off += head.size + plen
    return sizes


def test_wal_torn_tail_at_every_byte_boundary(tmp_path):
    p = str(tmp_path / "wal.log")
    w = twal.WriteAheadLog(p)
    batches = [{"city": np.asarray(["a", "b"], dtype=object),
                "qty": np.asarray([i, i + 1], dtype=np.int64)} for i in range(3)]
    for b in batches:
        w.append("ev", b, 2)
    w.close()
    blob = open(p, "rb").read()
    sizes = _records(blob)
    assert len(sizes) == 3
    torn = str(tmp_path / "torn.log")
    for cut in range(sizes[0] + sizes[1], len(blob)):
        with open(torn, "wb") as fh:
            fh.write(blob[:cut])
        got = list(twal.WriteAheadLog(torn).scan())
        want = list(jwal.WriteAheadLog(torn).scan())
        assert [g[0] for g in got] == [g[0] for g in want] == [0, 1], cut
        for i, (seq, ds, c, n) in enumerate(got):
            assert ds == "ev" and n == 2
            np.testing.assert_array_equal(c["qty"], batches[i]["qty"])
        # a reopened log continues past the last whole record
        assert twal.WriteAheadLog(torn).last_seq == 1
    assert len(list(twal.WriteAheadLog(p).scan())) == 3


@pytest.mark.parametrize("damage", ["corrupt_record", "bad_magic"])
def test_wal_damage_ends_the_scan(tmp_path, damage):
    p = str(tmp_path / "wal.log")
    w = twal.WriteAheadLog(p)
    for i in range(3):
        w.append("ev", {"x": np.asarray([i], dtype=np.int64)}, 1)
    w.close()
    blob = bytearray(open(p, "rb").read())
    sizes = _records(bytes(blob))
    if damage == "corrupt_record":
        blob[sizes[0] + sizes[1] // 2] ^= 0xFF  # a payload byte of record 1
        want = [0]
    else:
        blob[sizes[0]:sizes[0] + 4] = b"XXXX"
        want = [0]
    with open(p, "wb") as fh:
        fh.write(bytes(blob))
    assert [g[0] for g in twal.WriteAheadLog(p).scan()] == want
    assert [g[0] for g in jwal.WriteAheadLog(p).scan()] == want
    assert twal.MAGIC == jwal.MAGIC == b"SDW1"


# -- stores across packages ------------------------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_boots_in_the_other_package(tmp_path, writer):
    base, extra, novel = cols(), cols(40, 7), cols(9, 8, cities=("denver",))
    make, boot = (ref_ctx, port_ctx) if writer == "reference" else (port_ctx, ref_ctx)
    w = make(tmp_path)
    register(w, base)
    w.append_rows("ev", extra)
    w.compact("ev")  # a snapshot with the fold, then a WAL tail past it
    w.append_rows("ev", novel)
    want = w.sql(Q)
    got = boot(tmp_path).sql(Q)
    assert_frames_match(got, want, RTOL)
    assert_oracle(got, oracle(base, extra, novel))
    # the booted store takes appends and boots back in the writer's package
    b = boot(tmp_path)
    more = cols(11, 9)
    b.append_rows("ev", more)
    assert_oracle(make(tmp_path).sql(Q), oracle(base, extra, novel, more))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_saved_table_loads_in_the_other_package(tmp_path, writer):
    from spark_druid_olap_tpu.workloads import ssb as jssb
    from spark_druid_olap_tpu_torch.workloads import ssb as tssb

    ref, port = ref_ctx(), TPUOlapContext(device="cpu")
    for c in (ref, port):
        register(c)
        c.append_rows("ev", cols(30, 3))
    src, dst = (ref, port) if writer == "reference" else (port, ref)
    d = str(tmp_path / "saved")
    src.save_table("ev", d)
    dst.load_table(d, name="ev2")
    assert_frames_match(dst.sql(Q.replace("FROM ev", "FROM ev2")), src.sql(Q), RTOL)
    # through SQL, with a star schema carried in the directory
    tables = tssb.gen_tables(0.002, 7)
    (jssb if src is ref else tssb).register(src, tables=tables, rows_per_segment=4096)
    d2 = str(tmp_path / "lineorder")
    src.save_table("lineorder", d2)
    out = dst.sql(f"CREATE TABLE lo2 USING tpu_olap OPTIONS (path '{d2}')")
    assert out["status"][0].startswith("loaded lo2")
    assert dst.catalog.star_schema("lo2").fact_table == "lo2"
    sql = "SELECT d_year, sum(lo_revenue) AS r FROM {} GROUP BY d_year ORDER BY d_year"
    assert_frames_match(dst.sql(sql.format("lo2")), src.sql(sql.format("lineorder")), RTOL)


# -- crashes at every storage fault site -------------------------------------------------


APPEND_SITES = ["wal.journal_write", "wal.pre_fsync", "wal.post_fsync_pre_publish"]
COMPACT_SITES = ["persist.snapshot_rename", "compact.retire"]
REPLAY_SITES = ["wal.replay_record", "storage.replay_batch"]


def test_the_seven_sites_are_the_references():
    assert tres.STORAGE_SITES == tuple(APPEND_SITES + ["wal.replay_record"] + COMPACT_SITES
                                       + ["storage.replay_batch"])
    assert set(tres.STORAGE_SITES) <= set(jres.SITES)


def _crash(make, res, d, site, base, extra):
    """Runs the sequence for `site` in one package, with the fault raised
    there, and returns the frame a new context over `d` serves."""
    ctx = make(d)
    register(ctx, base)
    if site in APPEND_SITES:
        res.injector().arm(site, mode="error", times=1)
        with pytest.raises(res.InjectedFault):
            ctx.append_rows("ev", extra)
    elif site in COMPACT_SITES:
        ctx.append_rows("ev", extra)
        res.injector().arm(site, mode="error", times=1)
        with pytest.raises(res.InjectedFault):
            ctx.compact("ev")
    else:
        ctx.append_rows("ev", extra)
        res.injector().arm(site, mode="error", times=1)
        with pytest.raises(res.InjectedFault):
            make(d)  # the boot dies mid-replay
    res.injector().disarm()
    return make(d).sql(Q)


@pytest.mark.parametrize("site", APPEND_SITES + COMPACT_SITES + REPLAY_SITES)
def test_crash_recovers_the_references_state(tmp_path, site):
    base, extra = cols(), cols(40, 7, cities=("austin", "boston", "chicago", "denver"))
    want = _crash(ref_ctx, jres, tmp_path / "r", site, base, extra)
    got = _crash(port_ctx, tres, tmp_path / "p", site, base, extra)
    assert_frames_match(got, want, RTOL)
    # whole or absent, never torn; absent before the first journal byte
    # and present once the record was durable and acknowledged
    if site == "wal.journal_write":
        assert_oracle(got, oracle(base))
    elif site in APPEND_SITES:
        try:
            assert_oracle(got, oracle(base))
        except AssertionError:
            assert_oracle(got, oracle(base, extra))
    else:
        assert_oracle(got, oracle(base, extra))
    # the survivor is live: an append, a compaction and a restart agree
    ctx = port_ctx(tmp_path / "p")
    more = cols(17, 13)
    ctx.append_rows("ev", more)
    ctx.compact("ev")
    final = port_ctx(tmp_path / "p").sql(Q)
    pd.testing.assert_frame_equal(final, ctx.sql(Q), check_exact=True)


# -- restart --------------------------------------------------------------------------------


def test_restart_is_bit_identical_and_disk_backed(tmp_path):
    base, extra = cols(600, 1), cols(90, 2, cities=("austin", "boston"))
    ctx = port_ctx(tmp_path)
    register(ctx, base)
    ctx.append_rows("ev", extra)
    before = [ctx.sql(Q), ctx.sql("SELECT city, max(rev) AS m FROM ev WHERE qty > 50 "
                                  "GROUP BY city ORDER BY city")]
    ctx2 = port_ctx(tmp_path)
    rec = ctx2.storage.last_recovery
    assert rec == {"datasources": 1, "replayed_records": 1, "replayed_rows": 90}
    ds = ctx2.catalog.get("ev")
    assert all(isinstance(s.dims, LazyColumnMap) for s in ds.historical_segments())
    assert ds.version > ctx.catalog.get("ev").version  # never goes back
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a memmap reaches torch materialized
        after = [ctx2.sql(Q), ctx2.sql("SELECT city, max(rev) AS m FROM ev WHERE qty > 50 "
                                       "GROUP BY city ORDER BY city")]
    for a, b in zip(before, after):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    assert isinstance(ds.historical_segments()[0].dims["city"], np.memmap)
    assert ctx2.engine.bytes_resident() > 0
    assert_oracle(after[0], oracle(base, extra))


def test_a_pinned_disk_backed_column_reads_its_memmap_once(tmp_path, monkeypatch):
    """With the transfer pipeline on a card, a restored column (a read-only
    memmap) is read from disk once, straight into its page-locked copy, and
    a second copy of it reads that copy, never the file.  Page-locking needs
    a card, so here the pinning is a recording stand-in."""
    from spark_druid_olap_tpu_torch.exec import pipeline

    ctx = port_ctx(tmp_path)
    register(ctx, cols(600, 1))
    ctx.close()
    seg = port_ctx(tmp_path).catalog.get("ev").historical_segments()[0]
    host = seg.dims["city"]
    assert isinstance(host, np.memmap)
    reads = []

    def pin(arr):
        reads.append(arr)
        return torch.from_numpy(np.array(arr))

    monkeypatch.setattr(pipeline, "pin_host", pin)
    monkeypatch.setattr(pipeline, "materialize", lambda arr: pytest.fail("materialized"))
    tp = pipeline.TransferPipeline(engine=None)
    key = pipeline.column_key(seg, "city")
    first = tp.pinned(key, host)
    assert tp.pinned(key, host) is first and len(reads) == 1 and reads[0] is host
    np.testing.assert_array_equal(first.numpy(), np.asarray(host))


def test_flush_sweep_folds_deltas_into_the_snapshot(tmp_path):
    ctx = port_ctx(tmp_path)
    register(ctx)
    assert ctx.storage.sweep_once() == {"flushed": []}
    ctx.append_rows("ev", cols(40, 7))
    state = ctx.storage.state()["datasources"]["ev"]
    assert state["dirty_delta_rows"] == 40 and state["wal_last_seq"] == 0
    assert ctx.storage.sweep_once() == {"flushed": ["ev"]}
    ctx2 = port_ctx(tmp_path)
    assert ctx2.storage.last_recovery["replayed_rows"] == 0
    assert_oracle(ctx2.sql(Q), oracle(cols(), cols(40, 7)))
    # the timer thread starts and stops with the context
    ctx3 = port_ctx(tmp_path, snapshot_flush_s=3600)
    try:
        assert ctx3.storage.state()["flush_sweep"]["running"] is True
    finally:
        ctx3.close()
    assert ctx3.storage.state()["flush_sweep"]["running"] is False


def test_rollup_survives_a_restart_alike(tmp_path):
    batch = {"city": np.asarray(["austin"] * 4 + ["boston"] * 2, dtype=object),
             "qty": np.asarray([1, 2, 3, 4, 10, 20], dtype=np.int64),
             "rev": np.ones(6, dtype=np.float32),
             "ts": np.asarray([T0, T0 + 1, T0 + 2, T0 + DAY, T0, T0 + 3], dtype=np.int64)}
    out = []
    for make, sub in ((ref_ctx, "r"), (port_ctx, "p")):
        ctx = make(tmp_path / sub)
        register(ctx, rollup_granularity="day")
        ack = ctx.append_rows("ev", batch)
        assert ack["appended"] == 6 and ack["totalRows"] == 123
        out.append(make(tmp_path / sub).sql(Q))
    assert_frames_match(out[1], out[0], RTOL)


def test_server_503s_queries_during_replay_and_reports_storage(tmp_path):
    from spark_druid_olap_tpu_torch.server import OlapServer

    ctx = port_ctx(tmp_path)
    register(ctx)
    srv = OlapServer(ctx, port=0).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        with urllib.request.urlopen(base + "/status/health", timeout=30) as r:
            doc = json.loads(r.read())
        assert doc["storage"]["enabled"] is True and "ev" in doc["storage"]["datasources"]
        req = urllib.request.Request(
            base + "/druid/v2/sql", data=json.dumps({"query": "SELECT count(*) AS n FROM ev"}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        ctx.storage.replay_in_progress = True
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=30)
            assert ei.value.code == 503 and ei.value.headers.get("Retry-After")
            assert json.loads(ei.value.read())["errorClass"] == "QueryUnavailableException"
        finally:
            ctx.storage.replay_in_progress = False
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
    finally:
        srv.shutdown()
        ctx.close()
    assert os.path.exists(os.path.join(str(tmp_path), "ev", "snapshot.json"))


SET_FLAGS = {
    "compaction_rows_per_segment": ("4096", lambda c: c.compactor.rows_per_segment, 4096),
    "compaction_min_delta_rows": ("7", lambda c: c.compactor.min_delta_rows, 7),
    "sys_retention_s": ("60", lambda c: c.compactor.sys_retention_s, 60.0),
    "storage_fsync": ("false", lambda c: (c.storage.fsync, c.storage.wal("ev").fsync),
                      (False, False)),
    "max_concurrent_ingests": ("3", lambda c: c.resilience.ingest_admission.max_concurrent, 3),
    "result_cache_delta_reuse": ("false", lambda c: c.serve.result_cache.delta_reuse, False),
    "snapshot_flush_s": ("3600", lambda c: c.storage.state()["flush_sweep"]["running"], True),
    "sys_sampler_s": ("3600", lambda c: c.sys_sampler.status()["running"], True),
}


@pytest.mark.parametrize("flag", list(SET_FLAGS))
def test_set_reaches_ingest_and_storage_flags(tmp_path, flag):
    raw, read, want = SET_FLAGS[flag]
    ctx = port_ctx(tmp_path)
    try:
        register(ctx)
        ctx.sql(f"SET {flag} = {raw}")
        assert read(ctx) == want
        ctx.sql("SET slow_query_ms = 0")  # another flag leaves the threads as they are
        assert read(ctx) == want
    finally:
        ctx.close()
    # the reference takes the same flag
    ref = ref_ctx()
    ref.sql(f"SET {flag} = {raw}")
    assert str(getattr(ref.config, flag)).lower() == str(getattr(ctx.config, flag)).lower()
