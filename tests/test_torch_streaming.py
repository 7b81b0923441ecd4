"""Streaming executor: the PyTorch port's `StreamExecutor` against the JAX
reference's on the same chunks, on the CPU.

The chunks are the event stream's (`gen_event_chunk`, 4096 rows, 5 chunks,
the last one short by 777 rows so the padding path runs).  Parity contract:
group keys, counts, min, max and HLL registers exact; float32 sums within
rtol 1e-6 (the two packages sum a chunk in different orders).  Inside the
port a stream's frame is bit-identical with double buffering on and off
and with time narrowing on and off.
"""

import sys
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from spark_druid_olap_tpu.catalog import segment as jseg
from spark_druid_olap_tpu.exec import streaming as jstreaming
from spark_druid_olap_tpu.utils import datagen as jdatagen
from spark_druid_olap_tpu_torch.catalog.segment import build_datasource, schema_datasource
from spark_druid_olap_tpu_torch.exec import streaming as tstreaming
from spark_druid_olap_tpu_torch.exec.engine import Engine
from spark_druid_olap_tpu_torch.models.aggregations import (
    Count,
    DoubleMax,
    DoubleMin,
    DoubleSum,
    HyperUnique,
)
from spark_druid_olap_tpu_torch.models.dimensions import DimensionSpec
from spark_druid_olap_tpu_torch.models.filters import Bound, Selector
from spark_druid_olap_tpu_torch.models.query import GroupByQuery, TimeseriesQuery, TopNQuery
from spark_druid_olap_tpu_torch.utils import datagen
from test_torch_engine import assert_frames_match, to_reference

CHUNK = 4096
N_CHUNKS = 5
RTOL = 1e-6

QUERIES = {
    "groupby_bound": GroupByQuery(
        datasource="events",
        dimensions=(DimensionSpec("site", "site"), DimensionSpec("kind", "kind")),
        aggregations=(
            Count("n"),
            DoubleSum("v", "value"),
            DoubleMin("lo", "latency"),
            DoubleMax("hi", "latency"),
        ),
        filter=Bound("kind", lower=2, upper=None, ordering="numeric"),
    ),
    "timeseries_hour": TimeseriesQuery(
        datasource="events",
        granularity="hour",
        aggregations=(Count("n"), DoubleSum("v", "value"), DoubleMax("mx", "latency")),
        intervals=(datagen.event_stream_interval(),),
    ),
    "topn": TopNQuery(
        datasource="events",
        dimension=DimensionSpec("site", "site"),
        metric="v",
        threshold=5,
        aggregations=(DoubleSum("v", "value"),),
    ),
    "hll": GroupByQuery(
        datasource="events",
        dimensions=(DimensionSpec("kind", "kind"),),
        aggregations=(HyperUnique("u", "site"),),
    ),
}


@pytest.fixture(scope="module")
def chunks():
    out = [datagen.gen_event_chunk(i, CHUNK) for i in range(N_CHUNKS)]
    out[-1] = {k: v[: CHUNK - 777] for k, v in out[-1].items()}
    return out


def _executors(narrow=None, **kw):
    # the kernel's class pinned (the CPU profile would price the scatter
    # cheaper); `test_stream_class_follows_the_cost_model` holds "auto"
    port = tstreaming.StreamExecutor(engine=Engine(device="cpu", strategy="dense"), **kw)
    ref = jstreaming.StreamExecutor()
    if narrow is not None:
        port._narrow_time = ref._narrow_time = narrow
    return port, ref


def _capture(monkeypatch, module):
    """Record the merged host state (sums, mins, maxs, sketches) that a
    package's stream hands to `finalize_groupby`."""
    box = []
    orig = module.finalize_groupby

    def cap(*args, **kw):
        box.append(args[3:7])
        return orig(*args, **kw)

    monkeypatch.setattr(module, "finalize_groupby", cap)
    return box


def _run_both(q, chunks, narrow=None, monkeypatch=None):
    port, ref = _executors(narrow)
    boxes = (
        [_capture(monkeypatch, m) for m in (tstreaming, jstreaming)]
        if monkeypatch else None
    )
    got = port.execute(q, datagen.event_stream_schema(), iter(chunks), CHUNK)
    want = ref.execute(
        to_reference(q), jdatagen.event_stream_schema(), iter(chunks), CHUNK
    )
    return got, want, port, ref, boxes


def _assert_stats_match(port, ref):
    for f in ("rows", "chunks", "h2d_bytes"):
        assert getattr(port.stats, f) == getattr(ref.stats, f), f


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_stream_matches_reference(chunks, monkeypatch, name):
    got, want, port, ref, boxes = _run_both(
        QUERIES[name], chunks, monkeypatch=monkeypatch
    )
    assert_frames_match(got, want)
    _assert_stats_match(port, ref)
    assert port.stats.strategy == "dense"
    (tsums, tmins, tmaxs, tsk), (jsums, jmins, jmaxs, jsk) = (b[0] for b in boxes)
    np.testing.assert_allclose(tsums, np.asarray(jsums), rtol=RTOL)
    np.testing.assert_array_equal(tmins, np.asarray(jmins))
    np.testing.assert_array_equal(tmaxs, np.asarray(jmaxs))
    assert sorted(tsk) == sorted(jsk)
    for k in tsk:  # HLL registers, exact
        np.testing.assert_array_equal(np.asarray(tsk[k]), np.asarray(jsk[k]), err_msg=k)
    if name == "timeseries_hour":
        assert len(got) == datagen.EVENT_SPAN_HOURS


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_double_buffer_and_narrowing_are_bit_identical(chunks, name):
    """The fold is in chunk order whatever the copy order: double buffering
    off and time narrowing on give the same bits."""
    ds = datagen.event_stream_schema()
    frames = []
    for double_buffer, narrow in ((True, False), (False, False), (True, True)):
        ex = tstreaming.StreamExecutor(
            engine=Engine(device="cpu"), double_buffer=double_buffer
        )
        ex._narrow_time = narrow
        frames.append(ex.execute(QUERIES[name], ds, iter(chunks), CHUNK))
    for f in frames[1:]:
        pd.testing.assert_frame_equal(f, frames[0], check_exact=True)


def test_time_narrowing_matches_reference(chunks):
    """Narrowing forced on in both packages: int32 offsets plus a base
    rebuild the same time column, and the same bytes cross the link: 12 a
    row (time offset, value, latency) where unnarrowed time ships 16."""
    got, want, port, ref, _ = _run_both(QUERIES["timeseries_hour"], chunks, narrow=True)
    assert_frames_match(got, want)
    _assert_stats_match(port, ref)
    assert port.stats.h2d_bytes == N_CHUNKS * CHUNK * 12


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_stream_matches_resident_engine(chunks, name):
    """The stream against the port's Engine over a datasource of the same
    rows, resident in one segment."""
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    schema = datagen.event_stream_schema()
    ds = build_datasource(
        "events", cols, dimension_cols=["site", "kind"],
        metric_cols=["value", "latency"], time_col="ts", dicts=schema.dicts,
    )
    got = tstreaming.StreamExecutor(engine=Engine(device="cpu")).execute(
        QUERIES[name], schema, iter(chunks), CHUNK)
    want = Engine(device="cpu").execute(QUERIES[name], ds)
    assert_frames_match(got, want)


def test_stats_track_rows(chunks):
    q = GroupByQuery(datasource="events", dimensions=(), aggregations=(Count("n"),))
    got, want, port, ref, _ = _run_both(q, chunks)
    total = sum(len(c["ts"]) for c in chunks)
    assert port.stats.rows == total and port.stats.chunks == len(chunks)
    assert int(got["n"][0]) == total == int(want["n"][0])
    _assert_stats_match(port, ref)


@pytest.mark.parametrize(
    "aggs", [(Count("n"), DoubleSum("v", "value")), (Count("n"), HyperUnique("u", "kind"))],
    ids=["plain", "sketch"],
)
def test_empty_stream(aggs):
    q = GroupByQuery(
        datasource="events", dimensions=(DimensionSpec("site", "site"),), aggregations=aggs
    )
    got, want, port, ref, _ = _run_both(q, [])
    assert len(got) == 0 == len(want)
    assert list(got.columns) == list(want.columns)
    _assert_stats_match(port, ref)


def test_filter_matches_nothing(chunks):
    q = GroupByQuery(
        datasource="events",
        dimensions=(DimensionSpec("site", "site"),),
        aggregations=(Count("n"),),
        filter=Selector("kind", 9999),
    )
    got, want, _, _, _ = _run_both(q, chunks)
    assert len(got) == 0 == len(want)


def test_high_cardinality_routes_to_scatter():
    """A G = 811801 group-by takes the scatter path (dense states only: no
    adaptive or sparse tier for a stream) and matches the reference and a
    float64 oracle."""
    da = db = 900
    dicts = {d: tuple(range(da)) for d in ("a", "b")}
    rng = np.random.default_rng(11)
    n, chunk = 30_000, 10_240
    pairs = rng.choice(da * db, size=1500, replace=False)
    pick = pairs[rng.integers(0, 1500, n)]
    cols = {
        "a": (pick // db).astype(np.int32),
        "b": (pick % db).astype(np.int32),
        "v": rng.random(n).astype(np.float32),
    }
    chunks = [{k: v[i:i + chunk] for k, v in cols.items()} for i in range(0, n, chunk)]
    q = GroupByQuery(
        datasource="hs",
        dimensions=(DimensionSpec("a"), DimensionSpec("b")),
        aggregations=(Count("n"), DoubleSum("s", "v")),
    )
    port = tstreaming.StreamExecutor(engine=Engine(device="cpu"))
    got = port.execute(q, schema_datasource("hs", dicts, {"v": "double"}), iter(chunks), chunk)
    want = jstreaming.StreamExecutor().execute(
        to_reference(q), jseg.schema_datasource("hs", dicts, {"v": "double"}),
        iter(chunks), chunk,
    )
    assert port.stats.strategy == "segment"
    assert_frames_match(got, want)
    df = pd.DataFrame(cols)
    oracle = df.assign(v=df.v.astype(np.float64)).groupby(["a", "b"], as_index=False).agg(
        n=("v", "count"), s=("v", "sum"))
    got = got.sort_values(["a", "b"]).reset_index(drop=True)
    np.testing.assert_array_equal(got["n"], oracle["n"])
    np.testing.assert_allclose(got["s"], oracle["s"], rtol=2e-5)


def test_producer_error_propagates():
    def bad_chunks():
        yield datagen.gen_event_chunk(0, CHUNK)
        raise RuntimeError("source died")

    q = GroupByQuery(
        datasource="events", dimensions=(DimensionSpec("site", "site"),),
        aggregations=(Count("n"),),
    )
    with pytest.raises(RuntimeError, match="source died"):
        tstreaming.StreamExecutor(engine=Engine(device="cpu")).execute(
            q, datagen.event_stream_schema(), bad_chunks(), CHUNK)


@pytest.mark.parametrize("case", ["oversized_chunk", "no_intervals"])
def test_bad_streams_raise(chunks, case):
    ex = tstreaming.StreamExecutor(engine=Engine(device="cpu"))
    ds = datagen.event_stream_schema()
    if case == "oversized_chunk":
        with pytest.raises(ValueError, match="rows > chunk_rows"):
            ex.execute(QUERIES["topn"], ds, iter([datagen.gen_event_chunk(0, 2048)]), 1024)
    else:
        q = TimeseriesQuery(datasource="events", granularity="hour", aggregations=(Count("n"),))
        with pytest.raises(ValueError, match="explicit intervals"):
            ex.execute(q, ds, iter(chunks), CHUNK)


def test_consumer_abandons_stream_unblocks_producer():
    """A consumer that walks away must not leave the prefetch thread parked
    on a full queue or waiting for a staging slot."""
    before = threading.active_count()
    ex = tstreaming.StreamExecutor(engine=Engine(device="cpu"), prefetch=1)

    def chunks_forever():
        i = 0
        while True:
            yield datagen.gen_event_chunk(i % 8, CHUNK)
            i += 1

    gen = ex._prefetched_device_chunks(
        chunks_forever(), ["site", "value"], datagen.event_stream_schema(), CHUNK
    )
    next(gen)
    gen.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_stream_under_thread_switching_matches_oracle():
    """Producer and consumer hand 40 chunks through a ring of 4 slots
    (prefetch 1) with the interpreter switching threads every microsecond:
    every chunk is counted once, in its own buckets."""
    rows = 1024
    chunks = [datagen.gen_event_chunk(i, rows) for i in range(40)]
    q = TimeseriesQuery(
        datasource="events", granularity="hour", aggregations=(Count("n"),),
        intervals=(datagen.event_stream_interval(),),
    )
    lo, _ = datagen.event_stream_interval()
    want = np.bincount(np.concatenate([(c["ts"] - lo) // 3_600_000 for c in chunks]))
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for double_buffer in (True, False):
            ex = tstreaming.StreamExecutor(
                engine=Engine(device="cpu"), prefetch=1, double_buffer=double_buffer)
            got = ex.execute(q, datagen.event_stream_schema(), iter(chunks), rows)
            np.testing.assert_array_equal(got["n"].to_numpy(), want)
            assert ex.stats.chunks == 40
    finally:
        sys.setswitchinterval(before)


def test_stream_executor_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstreaming.StreamExecutor()


@pytest.mark.parametrize("i", [0, 7, 511])
def test_event_chunk_matches_reference(i):
    got, want = datagen.gen_event_chunk(i, 1000), jdatagen.gen_event_chunk(i, 1000)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    assert datagen.event_stream_interval() == jdatagen.event_stream_interval()
    schema, ref = datagen.event_stream_schema(), jdatagen.event_stream_schema()
    assert [(c.name, c.kind, c.dtype, c.cardinality) for c in schema.columns] == [
        (c.name, c.kind, c.dtype, c.cardinality) for c in ref.columns]
    assert {k: d.values for k, d in schema.dicts.items()} == {
        k: d.values for k, d in ref.dicts.items()}
    assert schema.interval() is None and schema.time_column == ref.time_column


# -- the mesh stream ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)], ids=["8x1", "4x2"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_mesh_stream_matches_reference(chunks, name, shape):
    """A mesh stream (8 logical CPU shards; the groups axis on (4, 2)) against
    the reference's `StreamExecutor(mesh=...)` on the conftest's 8 devices:
    the chunk pads to ROW_PAD x the data axis and splits over it, each shard
    runs the per-shard body, the states merge, and the frames match (keys,
    counts, extrema and HLL registers exact, sums within rtol 1e-6) with
    the same rows, chunks and bytes shipped."""
    from spark_druid_olap_tpu.parallel.mesh import make_mesh as jmake_mesh
    from spark_druid_olap_tpu_torch.parallel.mesh import make_mesh

    q = QUERIES[name]
    port = tstreaming.StreamExecutor(engine=Engine(device="cpu", strategy="dense"),
                                     mesh=make_mesh(*shape, devices=["cpu"] * 8))
    ref = jstreaming.StreamExecutor(mesh=jmake_mesh(n_data=shape[0], n_groups=shape[1]))
    got = port.execute(q, datagen.event_stream_schema(), iter(chunks), CHUNK)
    want = ref.execute(to_reference(q), jdatagen.event_stream_schema(), iter(chunks), CHUNK)
    assert_frames_match(got, want)
    _assert_stats_match(port, ref)
    single = tstreaming.StreamExecutor(engine=Engine(device="cpu", strategy="dense")).execute(
        q, datagen.event_stream_schema(), iter(chunks), CHUNK)
    assert_frames_match(got, single)
