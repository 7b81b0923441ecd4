"""The serving core of the PyTorch port (`spark_druid_olap_tpu_torch/serve/`,
`Engine.execute_fused`, admission and lanes in `resilience.py`), against
the JAX reference on the CPU at SSB scale 0.01.

* Fusion: `shared_row_plan` equals the reference's for the same inner
  specs; `Engine.execute_fused` gives every member its serial frame bit for
  bit (the fused eager loop at a member set's first batch, the arena's
  program at its second), and the reference's fused frames within rtol
  1e-6; the scheduler fuses concurrent members from their set's first
  batch, reroutes a deadline to the serial path and raises a device fault
  to every member.
* Result cache and lanes: the same sequence of hits and misses as the
  reference, what `store_native` and `store_result` publish (a truncated,
  uncacheable or keyless answer never), and the same lane for the same
  queries; `SET result_cache_entries` takes effect.
* Admission: a full pool rejects after its queue timeout with the
  reference's Retry-After; lanes are separate pools.
* Concurrency: eight threads hammer one port context, fusion on; every
  answer equals the serial one.  The engine's execution lock covers the
  device half and the fetch of an execution, never its finalizing or a
  retry's backoff.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu import resilience as jres
from spark_druid_olap_tpu.models import wire as jwire
from spark_druid_olap_tpu.serve import fusion as jfusion
from spark_druid_olap_tpu.serve import lanes as jlanes
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu_torch import resilience as tres
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.exec.lowering import timeseries_to_groupby, topn_to_groupby
from spark_druid_olap_tpu_torch.models import aggregations as A
from spark_druid_olap_tpu_torch.models import query as Q
from spark_druid_olap_tpu_torch.serve import fusion as tfusion
from spark_druid_olap_tpu_torch.serve import lanes as tlanes
from spark_druid_olap_tpu_torch.workloads import ssb as tssb

from test_torch_sql import assert_frames_match, reference_config

RTOL = 1e-6
SEGMENT_ROWS = 16384

# a fused batch: filters that prune different segments, a member sharing
# q1_1's mask and group ids, a Timeseries and a TopN
MEMBERS = {
    "q1_1": tssb.NATIVE_QUERIES["q1_1"],
    "q1_1_count": dataclasses.replace(
        tssb.NATIVE_QUERIES["q1_1"], aggregations=(A.Count("n"),), post_aggregations=()),
    "q1_3": tssb.NATIVE_QUERIES["q1_3"],
    "q4_1": tssb.NATIVE_QUERIES["q4_1"],
    "timeseries": tssb.TIMESERIES_QUERY,
    "topn": tssb.TOPN_QUERY,
}


@pytest.fixture(scope="module", autouse=True)
def _forget_reference_profile():
    """The reference's workload profiler is process-wide: drop the queries
    this module added, so a later file's profile window (`GET
    /status/profile`) holds its own."""
    yield
    from spark_druid_olap_tpu.obs import prof as jprof

    jprof.workload_profiler()._entries.clear()


def _ref_spec(q):
    return jwire.query_from_druid(json.loads(json.dumps(q.to_druid())))


@pytest.fixture(scope="module")
def tables():
    return jssb.gen_tables(scale=0.01, seed=11)


def _port_ctx(tables, **flags):
    ctx = TPUOlapContext(SessionConfig(**flags), device="cpu")
    tssb.register(ctx, tables=tables, rows_per_segment=SEGMENT_ROWS)
    return ctx


@pytest.fixture(scope="module")
def ctxs(tables):
    ref = sd.TPUOlapContext(reference_config())
    jssb.register(ref, tables=tables, rows_per_segment=SEGMENT_ROWS)
    return ref, _port_ctx(tables)


@pytest.fixture(scope="module")
def serial(ctxs):
    """Each member's serial frame on the port, the arena off."""
    _, port = ctxs
    ds = port.catalog.get("lineorder")
    port.sql("SET arena_execution = false")
    try:
        return {n: port.engine.execute(q, ds) for n, q in MEMBERS.items()}
    finally:
        port.sql("SET arena_execution = true")


def _bit_equal(got, want):
    assert list(got.columns) == list(want.columns)
    for c in want.columns:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert g.dtype == w.dtype and (g.tobytes() == w.tobytes() if g.dtype.kind != "O"
                                       else list(g) == list(w)), c


def test_shared_row_plan_equals_the_reference():
    inners = []
    for q in MEMBERS.values():
        if isinstance(q, Q.TimeseriesQuery):
            q = timeseries_to_groupby(q)
        elif isinstance(q, Q.TopNQuery):
            q = topn_to_groupby(q)
        inners.append(q)
    got = tfusion.shared_row_plan(inners)
    want = jfusion.shared_row_plan([_ref_spec(q) for q in inners])
    assert got == want
    assert got[1] == (0, 0)  # q1_1_count reuses q1_1's mask and group ids


@pytest.mark.parametrize("arena_on", [False, True], ids=["loop", "arena"])
def test_fused_batch_equals_serial_and_reference(ctxs, serial, arena_on):
    ref, port = ctxs
    ds = port.catalog.get("lineorder")
    port.sql(f"SET arena_execution = {str(arena_on).lower()}")
    names = list(MEMBERS)
    qs = [MEMBERS[n] for n in names]
    try:
        runs = [port.engine.execute_fused(qs, ds, query_ids=names) for _ in range(3)]
    finally:
        port.sql("SET arena_execution = true")
    for out in runs:
        for name, (df, state, m) in zip(names, out):
            _bit_equal(df, serial[name])
            assert m.fused_batch == len(names) and m.query_id == name
            # the member's merged host state (the result cache's delta reuse)
            assert state["sums"].shape[0] == m.num_groups and set(state) == {
                "sums", "mins", "maxs", "sketches"}
            # owned arrays: a cached state holds its own bytes, not the
            # batch's packed buffer
            assert all(state[k].base is None for k in ("sums", "mins", "maxs"))
    last = runs[-1][0][2]
    if arena_on:  # the third batch runs the member set's program: one dispatch
        assert last.dispatch_count == 1 and last.arena_segments == len(ds.segments)
    else:
        assert last.dispatch_count == len(ds.segments)
        assert "arena: arena_execution is off" in last.declines
    want = ref.engine.execute_fused([_ref_spec(q) for q in qs], ref.catalog.get("lineorder"))
    for name, (df, _, _), (wdf, _, _) in zip(names, runs[0], want):
        assert_frames_match(df, wdf, RTOL)


def test_fused_sketch_member_runs_the_fused_loop(ctxs):
    _, port = ctxs
    ds = port.catalog.get("lineorder")
    hll = dataclasses.replace(
        tssb.NATIVE_QUERIES["q4_1"],
        aggregations=(A.CardinalityAgg("custs", ("c_city",)),), post_aggregations=())
    qs = [tssb.NATIVE_QUERIES["q4_1"], hll]
    for _ in range(2):
        out = port.engine.execute_fused(qs, ds)
    assert "arena: sketch aggregations are not captured" in out[0][2].declines
    for q, (df, _, _) in zip(qs, out):
        _bit_equal(df, port.engine.execute(q, ds))


def _members(ctx, qs, window_ms=50.0):
    """Runs `qs` on threads through the context's fusion scheduler; returns
    (results or exceptions, in order)."""
    ds = ctx.catalog.get("lineorder")
    out = [None] * len(qs)
    barrier = threading.Barrier(len(qs))

    def run(i):
        barrier.wait(timeout=30)
        try:
            out[i] = ctx.serve.fusion.execute(ctx, qs[i], ds)
        except Exception as err:  # collected for the assertions
            out[i] = err

    ctx.serve.fusion.configure(window_ms, 16, False, 0.0)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(qs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    ctx.serve.fusion.configure(0.0, 16, False, 0.0)
    return out


def test_scheduler_fuses_concurrent_members(tables, serial):
    """A member set's first batch runs fused on the eager loop (a dispatch
    per segment), its second builds the set's program and later ones run
    it (one dispatch); every member gets its serial frame."""
    ctx = _port_ctx(tables)
    names = list(MEMBERS)
    fusion = ctx.serve.fusion
    segments = len(ctx.catalog.get("lineorder").segments)
    for k in range(3):
        out = _members(ctx, [MEMBERS[n] for n in names])
        assert fusion.batches_fused == k + 1
        assert fusion.members_fused == (k + 1) * len(names)
        for name, r in zip(names, out):
            _bit_equal(r[0], serial[name])
            assert r[2].fused_batch == len(names)
            assert r[2].dispatch_count == (segments if k == 0 else 1)


def test_scheduler_reroutes_a_deadline_and_raises_a_device_fault(tables):
    ctx = _port_ctx(tables)
    qs = [MEMBERS["q1_1"], MEMBERS["q4_1"], MEMBERS["topn"]]
    inj = tres.injector()
    try:
        inj.arm("engine.fused_loop", error_type=tres.InjectedDeadline, times=1)
        assert _members(ctx, qs) == [None, None, None]  # every member runs alone
        ctx.serve.fusion.configure(50.0, 16, False, 0.0)
        ds = ctx.catalog.get("lineorder")
        ctx.engine.execute_fused(qs, ds)  # the warm mark: the next batch builds
        inj.arm("compile", error_type=tres.KernelError, times=1)
        out = _members(ctx, qs)
        assert all(isinstance(r, tres.KernelError) for r in out), out
    finally:
        inj.disarm()


def test_result_cache_hits_and_misses_equal_the_reference(tables):
    ref = sd.TPUOlapContext(reference_config())
    jssb.register(ref, tables=tables, rows_per_segment=SEGMENT_ROWS)
    port = _port_ctx(tables)
    seq = ["q1_1", "q1_1", "q2_1", "q1_1", "q2_1", "SET", "q1_1", "q1_1"]
    got, want = [], []
    for ctx, w, out in ((port, tssb, got), (ref, jssb, want)):
        for step in seq:
            if step == "SET":
                ctx.sql("SET result_cache_entries = 1")
                continue
            ctx.sql(w.QUERIES[step])
            out.append(ctx.last_metrics.strategy == "result-cache")
        out.append((ctx.serve.result_cache.hits, ctx.serve.result_cache.misses,
                    len(ctx.serve.result_cache)))
    assert got == want
    assert got[:-1] == [False, True, False, True, True, False, True]


@pytest.mark.parametrize("case", ["stored", "truncated", "uncacheable", "cache_off",
                                  "explicit_key", "no_key"])
def test_store_native_and_store_result_equal_the_reference(tables, case):
    """What `ServingCore.store_native` / `store_result` publish, and what a
    lookup then serves, step for step as the reference's."""
    ref = sd.TPUOlapContext(reference_config())
    jssb.register(ref, tables=tables, rows_per_segment=SEGMENT_ROWS)
    port = _port_ctx(tables)
    outs = []
    for ctx, w, res in ((port, tssb, tres), (ref, jssb, jres)):
        q = w.NATIVE_QUERIES["q4_1"] if ctx is port else _ref_spec(tssb.NATIVE_QUERIES["q4_1"])
        if case == "uncacheable":  # a wire subtotalsSpec is never cached
            q = dataclasses.replace(q, subtotals=(("d_year",), ()))
        ds = ctx.catalog.get("lineorder")
        df = ctx.engine.execute(dataclasses.replace(q, subtotals=()), ds)
        core = ctx.serve
        if case == "cache_off":
            ctx.sql("SET result_cache_entries = 0")
        if case in ("explicit_key", "no_key"):
            key = ("explicit", ds.name) if case == "explicit_key" else None
            core.store_result(None, ds, key, df)
            hit = core.result_cache.get(key, ds.version) if key else None
        else:
            with res.partial_scope(True) as pc:
                if case == "truncated":
                    pc.trigger("engine.segment_loop")
                core.store_native(q, ds, df)
            hit = core.cached_native(q, ds) if case != "uncacheable" else None
        outs.append((len(core.result_cache), hit is not None))
        if hit is not None:
            _bit_equal(hit, df)
    assert outs[0] == outs[1]
    assert outs[0][1] == (case in ("stored", "explicit_key"))


def test_set_result_cache_entries_takes_effect(tables):
    port = _port_ctx(tables)
    port.sql("SET result_cache_entries = 8")
    assert port.config.result_cache_entries == 8
    assert port.serve.result_cache.entries == 8
    for name in list(tssb.QUERIES)[:10]:
        port.sql(tssb.QUERIES[name])
    assert len(port.serve.result_cache) == 8
    port.sql("SET result_cache_entries = 0")
    port.sql(tssb.QUERIES["q1_1"])
    assert len(port.serve.result_cache) == 0
    assert port.last_metrics.strategy != "result-cache"


@pytest.mark.parametrize("heavy_rows", [0, 1000, 1 << 30])
def test_lanes_equal_the_reference(ctxs, heavy_rows):
    ref, port = ctxs
    tcfg = dataclasses.replace(port.config, lane_heavy_rows=heavy_rows)
    jcfg = dataclasses.replace(ref.config, lane_heavy_rows=heavy_rows)
    tds, jds = port.catalog.get("lineorder"), ref.catalog.get("lineorder")
    got = [tlanes.classify_native(q, tds, tcfg) for q in MEMBERS.values()]
    want = [jlanes.classify_native(_ref_spec(q), jds, jcfg) for q in MEMBERS.values()]
    assert got == want
    got = [tlanes.classify_rewrite(port.plan_sql(s), port.catalog, tcfg)
           for s in tssb.QUERIES.values()]
    want = [jlanes.classify_rewrite(ref.plan_sql(s), ref.catalog, jcfg)
            for s in jssb.QUERIES.values()]
    assert got == want
    assert ("heavy" in got) == (heavy_rows == 1000)


def test_admission_pools_match_the_reference():
    for res in (tres, jres):
        pool = res.AdmissionController(max_concurrent=1, queue_timeout_ms=20)
        assert pool.acquire()
        assert not pool.acquire()  # full: rejected after the queue timeout
        assert pool.retry_after_s() == 1
        pool.release()
        assert pool.acquire()
        pool.release()
        assert pool.to_dict()["admitted_total"] == 2
        assert pool.to_dict()["rejected_total"] == 1
    port = tres.ResilienceState(SessionConfig(lane_heavy_slots=1, admission_queue_timeout_ms=20))
    assert port.lane("heavy").acquire()
    assert not port.lane("heavy").acquire()
    assert port.lane("interactive").acquire()  # a saturated heavy lane
    port.lane("interactive").release()
    with pytest.raises(RuntimeError):
        port.configure(SessionConfig(lane_heavy_slots=3))  # a slot is held
    port.lane("heavy").release()
    port.configure(SessionConfig(lane_heavy_slots=3))
    assert port.lane("heavy").max_concurrent == 3


def test_hammer_one_context_from_eight_threads(tables, serial):
    ctx = _port_ctx(tables, fusion_window_ms=2.0, result_cache_entries=0)
    ds = ctx.catalog.get("lineorder")
    sql_want = {n: ctx.sql(tssb.QUERIES[n]) for n in ("q1_1", "q2_1", "q3_1")}
    plan = [(kind, n) for n in MEMBERS for kind in ("native",)] + [
        ("sql", n) for n in sql_want]
    errors = []

    def client(k):
        rng = np.random.default_rng(k)
        try:
            for i in rng.permutation(len(plan)):
                kind, n = plan[i]
                if kind == "native":
                    got = ctx.engine.execute(MEMBERS[n], ds) if k % 2 else (
                        ctx.serve.fused_execute(MEMBERS[n], ds) or (
                            ctx.engine.execute(MEMBERS[n], ds),))[0]
                    _bit_equal(got, serial[n])
                else:
                    _bit_equal(ctx.sql(tssb.QUERIES[n]), sql_want[n])
        except Exception as err:  # collected for the assertion
            errors.append(err)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors[:3]
    assert not any(t.is_alive() for t in threads)


def _free_elsewhere(lock) -> bool:
    """Can another thread take `lock` now?"""
    got = []

    def probe():
        ok = lock.acquire(blocking=False)
        if ok:
            lock.release()
        got.append(ok)

    t = threading.Thread(target=probe)
    t.start()
    t.join(timeout=10)
    return got == [True]


@pytest.mark.parametrize("path", ["execute", "fused", "batch", "backoff"])
def test_host_work_runs_outside_the_execution_lock(tables, serial, monkeypatch, path):
    """Finalizing and a retry's backoff leave the card to other handler
    threads; the fetch of a group-by's state still holds the lock."""
    from spark_druid_olap_tpu_torch.exec import engine as tengine

    ctx = _port_ctx(tables, result_cache_entries=0)
    eng, ds = ctx.engine, ctx.catalog.get("lineorder")
    lock = eng._exec_lock
    free, held = [], []
    finalize, host_state = tengine.finalize_groupby, eng._host_state

    def finalize_groupby(*args, **kwargs):
        free.append(_free_elsewhere(lock))
        return finalize(*args, **kwargs)

    def fetch(*args):
        held.append(not _free_elsewhere(lock))
        return host_state(*args)

    names = ["q1_1", "q4_1"]
    qs = [MEMBERS[n] for n in names]
    if path == "backoff":
        sleep = tres.time.sleep

        def backoff(s):
            free.append(_free_elsewhere(lock))
            sleep(s)

        monkeypatch.setattr(tres.time, "sleep", backoff)
        tres.injector().arm("device_dispatch", times=1)
    else:
        monkeypatch.setattr(tengine, "finalize_groupby", finalize_groupby)
    monkeypatch.setattr(eng, "_host_state", fetch)
    try:
        if path == "fused":
            got = [df for df, _, _ in eng.execute_fused(qs, ds)]
        elif path == "batch":
            got = eng.execute_groupby_batch(qs, ds)
        else:
            got = [eng.execute(q, ds) for q in qs]
    finally:
        tres.injector().disarm()
    for name, df in zip(names, got):
        _bit_equal(df, serial[name])
    assert free and all(free), free
    assert path == "fused" or (held and all(held)), held
