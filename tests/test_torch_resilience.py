"""Query-lifecycle resilience of the PyTorch port (`resilience.py`) against
the JAX reference's, on the CPU.

* the error taxonomy: the reference's cases classify the same in both
  packages; the card's cases, built by hand, are the port's own: a
  `KernelError` (a kernel that does not build, launch or capture) and a
  CUDA error (any `AcceleratorError`, or a RuntimeError naming a sticky
  fault such as an illegal address) are static, a CUDA out-of-memory error
  transient;
* the breaker's three states under a fake clock, step for step;
* `SDOL_FAULTS` parsing into the same armed sites;
* fault schedules through both contexts (`ctx.sql` over the same SSB
  segments): the same `retries`, `degraded`, `circuit_state`,
  `error_class` and exception type name, frames within rtol 1e-6;
* a retry's eviction drops the scope's arena programs and resident
  columns, and its frame is bit-identical to the clean run's; static
  errors are never retried, counted or degraded;
* the degraded routes: `execute_native_degraded`, and the device assist
  declined while the device breaker is open or the device failed;
* `SET` reaches the six resilience flags.

No assertion reads the wall clock: deadlines are injected
(`InjectedDeadline`) and the breaker's clock is a counter.
"""

import builtins
import dataclasses
import json

import pandas as pd
import pytest
import torch
from test_torch_engine import assert_frames_match
from test_torch_sql import reference_config

import spark_druid_olap_tpu as sd
from spark_druid_olap_tpu import resilience as jres
from spark_druid_olap_tpu.config import SessionConfig as JaxSessionConfig
from spark_druid_olap_tpu.models import wire as jwire
from spark_druid_olap_tpu.workloads import ssb as jssb
from spark_druid_olap_tpu.workloads import tpch as jtpch
from spark_druid_olap_tpu_torch import resilience as tres
from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.config import SessionConfig
from spark_druid_olap_tpu_torch.exec.fallback import FallbackSizeError
from spark_druid_olap_tpu_torch.models import wire as twire
from spark_druid_olap_tpu_torch.workloads import ssb as tssb
from spark_druid_olap_tpu_torch.workloads import tpch as ttpch

RTOL = 1e-6

Q41 = tssb.QUERIES["q4_1"]


@pytest.fixture(autouse=True)
def _disarm():
    """Every case starts and ends with nothing armed in either package."""
    jres.injector().disarm()
    tres.injector().disarm()
    yield
    jres.injector().disarm()
    tres.injector().disarm()


def _configs(**flags):
    """(reference, port) session configs: the reference routed as the port
    routes (`reference_config`), its result cache off, no retry backoff."""
    ref = dataclasses.replace(reference_config(), result_cache_entries=0, retry_backoff_ms=0.0,
                              **flags)
    port = SessionConfig(result_cache_entries=0, retry_backoff_ms=0.0, **flags)
    return ref, port


@pytest.fixture(scope="module")
def ssb_tables():
    return jssb.gen_tables(scale=0.01, seed=11)


def _ssb_ctxs(tables, **flags):
    ref_cfg, port_cfg = _configs(**flags)
    ref = sd.TPUOlapContext(ref_cfg)
    jssb.register(ref, tables=tables, rows_per_segment=4096)
    port = TPUOlapContext(port_cfg, device="cpu")
    tssb.register(port, tables=tables, rows_per_segment=4096)
    return ref, port


# -- the error taxonomy ----------------------------------------------------------

REFERENCE_CASES = {
    "deadline": lambda m: m.DeadlineExceeded("engine.segment_loop", 10.0),
    "injected_deadline": lambda m: m.InjectedDeadline("x"),
    "injected_fault": lambda m: m.InjectedFault("x"),
    "circuit_open": lambda m: m.CircuitOpenError("x"),
    "runtime": lambda m: RuntimeError("device blip"),
    "os": lambda m: OSError("io"),
    "connection": lambda m: ConnectionError("reset"),
    "not_implemented": lambda m: NotImplementedError("gap"),
    "value": lambda m: ValueError("bad"),
    "key": lambda m: KeyError("k"),
    "timeout": lambda m: TimeoutError("slow"),
}


@pytest.mark.parametrize("name", list(REFERENCE_CASES))
def test_taxonomy_matches_reference(name):
    make = REFERENCE_CASES[name]
    assert tres.classify_error(make(tres)) == jres.classify_error(make(jres))


CARD_CASES = {
    "kernel_error": (tres.KernelError("nvcc failed (1)"), "static"),
    "kernel_launch": (tres.KernelError("group-by kernel launch failed: invalid argument"),
                      "static"),
    "out_of_memory": (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
                      "transient"),
    "illegal_address": (
        torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
        "static"),
    "launch_failure": (RuntimeError("CUDA error: unspecified launch failure"), "static"),
    "device_assert": (torch.AcceleratorError("CUDA error: device-side assert triggered"),
                      "static"),
    "misaligned_address": (torch.AcceleratorError("CUDA error: misaligned address"), "static"),
    "illegal_instruction": (
        torch.AcceleratorError("CUDA error: an illegal instruction was encountered"), "static"),
    "launch_timeout": (
        RuntimeError("CUDA error: the launch timed out and was terminated"), "static"),
    "hardware_stack_error": (RuntimeError("CUDA error: hardware stack error"), "static"),
    "any_accelerator_error": (torch.AcceleratorError("CUDA error: invalid program counter"),
                              "static"),
}


@pytest.mark.parametrize("name", list(CARD_CASES))
def test_taxonomy_card_cases(name):
    exc, kind = CARD_CASES[name]
    assert tres.classify_error(exc) == kind


def test_kernel_build_without_nvcc_raises_a_static_kernel_error(monkeypatch):
    import torch.utils.cpp_extension as ext

    from spark_druid_olap_tpu_torch.ops import cuda_groupby

    monkeypatch.setattr(cuda_groupby.shutil, "which", lambda name: None)
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(tres.KernelError, match="nvcc not found") as err:
        cuda_groupby._nvcc()
    assert tres.classify_error(err.value) == "static"


# -- the breaker -------------------------------------------------------------------

BREAKER_SCRIPTS = {
    # op: "f" failure, "s" success, "a" allow, "t" the cooldown elapses
    "opens_after_threshold": "ffaf" + "a",
    "half_open_probe_closes": "fffa" + "t" + "aa" + "s" + "a",
    "half_open_probe_reopens": "fff" + "t" + "a" + "f" + "a" + "t" + "a" + "s",
    "success_resets_count": "ffsff" + "a" + "f" + "a",
    "stale_probe_lease": "fff" + "t" + "a" + "t" + "a" + "s",
}


@pytest.mark.parametrize("name", list(BREAKER_SCRIPTS))
def test_breaker_states_match_reference(name):
    now = {"t": 0.0}
    clock = lambda: now["t"]  # noqa: E731
    brs = [m.CircuitBreaker(failure_threshold=3, cooldown_ms=100.0, clock=clock)
           for m in (jres, tres)]
    seen = [[], []]
    for op in BREAKER_SCRIPTS[name]:
        if op == "t":
            now["t"] += 0.1
            continue
        for i, br in enumerate(brs):
            out = {"f": br.record_failure, "s": br.record_success, "a": br.allow}[op]()
            seen[i].append((op, out, br.state))
    assert seen[1] == seen[0]
    ref, port = (br.to_dict() for br in brs)
    assert port == {k: v for k, v in ref.items() if k in port}
    assert {s for _, _, s in seen[1]} >= {"closed"}


# -- SDOL_FAULTS -------------------------------------------------------------------

FAULT_SPECS = {
    "error_every_call": "device_dispatch:error",
    "error_times": "device_dispatch:error:2",
    "bare_site": "h2d",
    "delay": "h2d:delay:5",
    "partial": "fallback_decode:partial:0.25",
    "several": " device_dispatch:error:1 , compile , fallback_decode:partial:0.5,",
}


@pytest.mark.parametrize("name", list(FAULT_SPECS))
def test_sdol_faults_parsing_matches_reference(name):
    ref, port = jres.FaultInjector(), tres.FaultInjector()
    ref.arm_from_env(FAULT_SPECS[name])
    port.arm_from_env(FAULT_SPECS[name])
    assert port.state() == ref.state()
    for site in ("device_dispatch", "h2d", "compile", "fallback_decode"):
        assert port.partial_fraction(site) == ref.partial_fraction(site)


def test_sdol_faults_environment_arms_the_injector(monkeypatch):
    monkeypatch.setattr(tres, "_injector", None)
    monkeypatch.setenv("SDOL_FAULTS", "device_dispatch:error:1")
    with pytest.raises(tres.InjectedFault):
        tres.fire("device_dispatch")
    tres.fire("device_dispatch")  # times=1: disarmed after one
    assert tres.injector().state()["fired"] == {"device_dispatch": 1}


# -- fault schedules through both contexts ----------------------------------------------

def _arm(mod, arm):
    if arm is None:
        return
    site, kw = arm
    kw = dict(kw)
    if "error_type" in kw:
        kw["error_type"] = getattr(mod, kw["error_type"], None) or getattr(builtins, kw["error_type"])
    mod.injector().arm(site, **kw)


def _observe(ctx, mod, sql, arm):
    _arm(mod, arm)
    try:
        df, exc = ctx.sql(sql), None
    except Exception as err:  # the schedule's expected failures are compared
        df, exc = None, type(err).__name__
    finally:
        mod.injector().disarm()
    m = ctx.last_metrics
    return df, {"retries": m.retries, "degraded": m.degraded,
                "circuit_state": m.circuit_state, "error_class": m.error_class, "exc": exc}


ALWAYS = ("device_dispatch", {})
SCHEDULES = {
    "clean": [None],
    "one_fault_retried": [("device_dispatch", {"times": 1})],
    "faults_outlive_retries": [("device_dispatch", {"times": 2})],
    "breaker_opens_then_routes_around": [ALWAYS, ALWAYS, ALWAYS, None],
    "static_error_surfaces": [("device_dispatch", {"error_type": "NotImplementedError"})],
    "deadline_without_partials": [("engine.segment_loop",
                                   {"error_type": "InjectedDeadline", "times": 1})],
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_fault_schedule_matches_reference(ssb_tables, name):
    # a cooldown no run outlasts: the breaker reopens by the schedule alone
    flags = {"breaker_cooldown_ms": 600_000}
    if name == "deadline_without_partials":
        flags["partial_results"] = False
    ref, port = _ssb_ctxs(ssb_tables, **flags)
    clean = port.sql(Q41)
    for arm in SCHEDULES[name]:
        want, ref_obs = _observe(ref, jres, Q41, arm)
        got, port_obs = _observe(port, tres, Q41, arm)
        assert port_obs == ref_obs, arm
        if want is None:
            assert got is None
            continue
        assert_frames_match(got, want, RTOL)
        if not port_obs["degraded"]:
            pd.testing.assert_frame_equal(got, clean, check_exact=True)
    if name == "breaker_opens_then_routes_around":
        assert port.resilience.breaker.state == ref.resilience.breaker.state == "open"
        assert port.resilience.degraded_total == ref.resilience.degraded_total == 4
    if name == "deadline_without_partials":
        assert port.last_metrics.deadline_exceeded
        assert port.resilience.deadline_exceeded_total == 1


def test_retry_evicts_programs_and_columns(ssb_tables):
    ref, port = _ssb_ctxs(ssb_tables)
    eng = port.engine
    for _ in range(3):  # eager, program built, program run
        clean = port.sql(Q41)
    assert eng.last_metrics.arena_segments > 0 and eng._arena.keys()
    resident = set(eng._device_cache)
    dropped = []
    eng._device_cache._on_evict = lambda k, v: (dropped.append(k), eng._on_evict(k, v))
    for mod, ctx in ((jres, ref), (tres, port)):
        mod.injector().arm("device_dispatch", times=1)
        ctx.sql(Q41)
    m = port.last_metrics
    assert m.retries == ref.last_metrics.retries == 1 and not m.degraded
    # the failed replay's program and every resident column went through
    # the residency cache's eviction; the retry ran the loop over fresh copies
    assert resident and set(dropped) >= resident
    assert m.arena_segments == 0 and m.h2d_bytes > 0
    assert not eng._arena.keys()
    pd.testing.assert_frame_equal(port.sql(Q41), clean, check_exact=True)


STATIC = {
    "kernel_error": lambda: tres.KernelError("group-by kernel launch failed: invalid argument"),
    "illegal_address": lambda: torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"),
    "misaligned_address": lambda: torch.AcceleratorError("CUDA error: misaligned address"),
}


@pytest.mark.parametrize("name", list(STATIC))
@pytest.mark.parametrize("site", ["device_dispatch", "compile"])
def test_static_errors_are_never_retried_or_degraded(ssb_tables, name, site):
    _, port = _ssb_ctxs(ssb_tables)
    port.sql(Q41)  # the scope's warm-up: the next run builds its program
    err = STATIC[name]()
    tres.injector().arm(site, error_type=lambda msg, err=err: err, times=1)
    with pytest.raises(type(err)):
        port.sql(Q41)
    m = port.last_metrics
    assert (m.retries, m.degraded, m.executor) == (0, False, "device")
    br = port.resilience.breaker
    assert br.state == "closed" and br.to_dict()["failures_total"] == 0
    assert port.resilience.degraded_total == 0


def test_out_of_memory_is_evicted_and_retried(ssb_tables):
    _, port = _ssb_ctxs(ssb_tables)
    clean = port.sql(Q41)
    tres.injector().arm("device_dispatch", times=1, error_type=torch.cuda.OutOfMemoryError)
    got = port.sql(Q41)
    m = port.last_metrics
    # the class stays on the failed attempt's metrics, as in the reference
    assert (m.retries, m.degraded, m.error_class) == (1, False, None)
    pd.testing.assert_frame_equal(got, clean, check_exact=True)


def test_degraded_route_at_scale_raises_size_error(ssb_tables):
    _, port = _ssb_ctxs(ssb_tables, fallback_max_rows=1000)
    tres.injector().arm("device_dispatch")
    with pytest.raises(FallbackSizeError):
        port.sql(Q41)
    # a static refusal of the fallback is not the fallback backend's failure
    assert port.resilience.breaker_for("fallback").state == "closed"


# -- degraded routes -----------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_tables():
    return jtpch.gen_tables(scale=0.004)


def _tpch_ctxs(tables, assist=False):
    """(reference, port) over TPC-H; `assist` pins the device assist on
    (off, every table is under its row floor)."""
    ref_cfg, port_cfg = _configs()
    for cfg in (ref_cfg, port_cfg) if assist else ():
        cfg.device_assist_force = True
        cfg.device_assist_min_rows = 0
    ref = sd.TPUOlapContext(ref_cfg)
    jtpch.register(ref, tables=tables, rows_per_segment=8192)
    port = TPUOlapContext(port_cfg, device="cpu")
    ttpch.register(port, tables=tables, rows_per_segment=8192)
    return ref, port


NATIVE = {
    "groupby": {"queryType": "groupBy", "dataSource": "lineitem", "granularity": "all",
                "dimensions": ["l_returnflag", "l_linestatus"],
                "aggregations": [{"type": "count", "name": "n"},
                                 {"type": "doubleSum", "name": "q", "fieldName": "l_quantity"}]},
    "timeseries": {"queryType": "timeseries", "dataSource": "lineitem", "granularity": "year",
                   "intervals": ["1992-01-01T00:00:00.000Z/1999-01-01T00:00:00.000Z"],
                   "aggregations": [{"type": "doubleSum", "name": "p",
                                     "fieldName": "l_extendedprice"}]},
}


@pytest.mark.parametrize("name", list(NATIVE))
def test_execute_native_degraded_matches_reference(tpch_tables, name):
    ref, port = _tpch_ctxs(tpch_tables)
    body = json.loads(json.dumps(NATIVE[name]))
    want = ref.execute_native_degraded(jwire.query_from_druid(body))
    got = port.execute_native_degraded(twire.query_from_druid(body))
    assert_frames_match(got, want, RTOL)
    m, rm = port.last_metrics, ref.last_metrics
    assert (m.degraded, m.executor, m.circuit_state) == (rm.degraded, "fallback", rm.circuit_state)
    assert m.assist_subplans == 0
    assert port.resilience.degraded_total == 1


DERIVED = ("SELECT l_returnflag, q FROM (SELECT l_returnflag, sum(l_quantity) AS q "
           "FROM lineitem GROUP BY l_returnflag) t WHERE q > 0 ORDER BY l_returnflag")


@pytest.mark.parametrize("route", ["breaker_open", "device_failed", "healthy"])
def test_assist_declined_on_degraded_routes(tpch_tables, route):
    _, port = _tpch_ctxs(tpch_tables, assist=True)
    sql = DERIVED
    if route == "breaker_open":
        for _ in range(port.config.breaker_failure_threshold):
            port.resilience.breaker.record_failure()
    elif route == "device_failed":
        tres.injector().arm("device_dispatch")
        sql = ttpch.QUERIES["q1"]
    df = port.sql(sql)
    m = port.last_metrics
    if route == "healthy":
        assert m.executor == "device+fallback" and m.assist_subplans == 1
        return
    assert m.executor == "fallback" and m.assist_subplans == 0 and len(df)
    want = {"breaker_open": "assist: device breaker open",
            "device_failed": "assist: device failed"}[route]
    assert want in m.declines
    if route == "device_failed":
        assert m.degraded and m.error_class == "InjectedFault"


# -- SET ---------------------------------------------------------------------------------

FLAGS = {
    "query_timeout_ms": ("250", 250),
    "partial_results": ("false", False),
    "retry_max_attempts": ("4", 4),
    "retry_backoff_ms": ("1.5", 1.5),
    "breaker_failure_threshold": ("7", 7),
    "breaker_cooldown_ms": ("900", 900),
}


@pytest.mark.parametrize("flag", list(FLAGS))
def test_set_reaches_resilience_flags(flag):
    raw, want = FLAGS[flag]
    ref = sd.TPUOlapContext(JaxSessionConfig())
    port = TPUOlapContext(device="cpu")
    for ctx in (ref, port):
        ctx.sql(f"SET {flag} = {raw}")
        assert getattr(ctx.config, flag) == want
    eng, br = port.engine, port.resilience.breaker
    reached = {
        "retry_max_attempts": lambda: eng._retry_attempts,
        "retry_backoff_ms": lambda: eng._retry_backoff_ms,
        "breaker_failure_threshold": lambda: br.failure_threshold,
        "breaker_cooldown_ms": lambda: br.cooldown_ms,
    }.get(flag)
    if reached is not None:
        assert reached() == want
    with pytest.raises(KeyError, match=flag):
        port.sql("SET no_such_flag = 1")


def test_query_timeout_arms_the_deadline(ssb_tables, monkeypatch):
    """The session's timeout arms a deadline around the query (checked
    through the collector, not the clock): with an expired deadline every
    checkpoint stops its loop at once."""
    _, port = _ssb_ctxs(ssb_tables, query_timeout_ms=60_000)
    monkeypatch.setattr(tres.Deadline, "expired", lambda self: True)
    df = port.sql(Q41)
    assert df.attrs["partial"] and df.attrs["coverage"] == 0.0 and len(df) == 0
    assert port.last_metrics.partial and port.last_metrics.coverage == 0.0
