"""Query-lifecycle resilience: deadlines, partial answers, retries, circuit
breakers, error classification and deterministic fault injection.

A failed rewrite is never an error: the query runs on the host fallback
(`exec/fallback.py`).  This module extends that stance to failures at run
time:

  * **Deadlines.**  A query may carry a wall-clock budget
    (`SessionConfig.query_timeout_ms`).  The executor loops (the segment
    loop, the arena's chunked replays, the tiers' passes, Scan and Search,
    the stream's chunks, the fallback's decode and interpreter) call
    `checkpoint(site)` between units of work, so cancellation is
    cooperative and lands on a segment boundary.  A checkpoint runs on the
    host, between launches: it bounds what the host launches, and work
    already queued on the card runs to the end at the fetch.
  * **Partial answers.**  With `SessionConfig.partial_results` on, a
    deadline that expires at a `checkpoint_partial` site stops the loop and
    the partials merged so far are finalized as the answer, stamped with
    their coverage (`PartialCollector`): every aggregate state is
    mergeable, so the rows seen so far are a sound answer.
  * **Retries.**  A transient failure of one group-by execution evicts what
    the failed dispatch may have poisoned and runs again under a budget
    (`run_device_attempts`).
  * **Circuit breakers.**  Consecutive transient failures open a backend's
    breaker; while it is open, queries go straight to the host fallback
    (degraded but correct), and after a cooldown one half-open probe decides
    recovery (`CircuitBreaker`).
  * **Error taxonomy.**  `classify_error` splits failures into `transient`
    (retry, count on the breaker, then degrade), `static` (surface at once)
    and `deadline` (stop now, never retry).  On a card a failed kernel
    build, launch configuration or graph capture (`KernelError`) and a
    sticky CUDA error (an illegal address, an unspecified launch failure, a
    device-side assert: the context is lost) are static, so a broken kernel
    never turns into a correct-looking answer from the host.
  * **Fault injection.**  `FaultInjector` arms named sites
    (`device_dispatch`, `h2d`, `compile`, `fallback_decode` and every
    checkpoint site) to raise, delay or truncate deterministically, from
    tests or the `SDOL_FAULTS` environment variable, so every degradation
    path above runs on the CPU and on the card alike.
    The durable storage tier's stages are sites too (`STORAGE_SITES`): a
    test raises at one and boots a new context over the same directory,
    which is what a process killed there leaves behind.  So are the
    cluster's (`CLUSTER_SITES`): a refused or slow replica, a torn
    response, a historical that dies serving.

  * **Admission control.**  The server gates every query on a bounded slot
    pool with a queue-wait timeout (`AdmissionController`), after the
    slot pool of its priority lane (`serve/lanes.py`); a full pool answers
    503 with a Retry-After estimated from observed load.  Streamed appends
    gate on a pool of their own (`ResilienceState.ingest_admission`).

Every decision is observable on `QueryMetrics`: `retries`, `degraded`,
`deadline_exceeded`, `circuit_state`, `error_class`, `partial` and
`coverage`; `ResilienceState.health()` reports the breakers, the admission
and lane pools and the counters, and the process metrics registry
(`obs/registry.py`) counts retries, breaker transitions, degradations,
deadlines and admission decisions under the JAX package's series names.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import Callable, Dict, Optional

import torch

from .obs import SPAN_RETRY, get_registry, span
from .utils.log import get_logger

log = get_logger("resilience")


def _count(name: str, help_text: str, labels=(), **labelvals) -> None:
    """Publish one event into the process metrics registry (obs/)."""
    fam = get_registry().counter(name, help_text, labels=labels)
    (fam.labels(**labelvals) if labels else fam).inc()


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------


class DeadlineExceeded(Exception):
    """A query ran past its deadline.  Not a RuntimeError: the retry path
    catches RuntimeError, and a timed-out query must never be retried (it
    would only time out slower)."""

    def __init__(self, site: str, timeout_ms: float):
        super().__init__(f"query deadline of {timeout_ms:.0f}ms exceeded at {site!r}")
        self.site = site
        self.timeout_ms = timeout_ms


class InjectedDeadline(DeadlineExceeded):
    """Deterministic deadline expiry raised by an armed fault site.  It walks
    the path a wall-clock expiry walks (never retried, triggers partial
    collection), and armed with `skip=K` it pins the expiry to the K-th
    checkpoint of a loop instead of racing a clock."""

    def __init__(self, msg: str):
        Exception.__init__(self, msg)
        self.site = msg
        self.timeout_ms = 0.0


class InjectedFault(RuntimeError):
    """Deterministic fault raised by an armed site.  A RuntimeError, so it
    walks the path a real transient device failure walks (retry, breaker,
    degradation to the host)."""


class CircuitOpenError(RuntimeError):
    """Execution refused: the breaker is open and no healthier backend is
    left to degrade to."""


class KernelError(RuntimeError):
    """The group-by kernel could not be built, its launch was refused, or a
    CUDA graph could not be captured.  A property of the code or the
    toolchain, not of the moment: `classify_error` calls it static, so it is
    never retried, never counted on a breaker and never degraded to the
    host."""


# every CUDA error torch raises from a runtime call is a `torch.AcceleratorError`
# (the caching allocator's OOM is a separate `torch.cuda.OutOfMemoryError`);
# absent from torch builds older than 2.8
_ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", ())

# substrings of the messages of CUDA errors that poison the context: every
# later call on it fails too, so neither a retry nor the device assist can
# succeed.  A backstop for a plain RuntimeError carrying one of them.
_STICKY_CUDA_ERRORS = (
    "illegal memory access",
    "illegal address",
    "unspecified launch failure",
    "device-side assert",
    "misaligned address",
    "illegal instruction",
    "hardware stack error",
    "invalid program counter",
    "launch timed out",
)


def _sticky_cuda_error(exc: BaseException) -> bool:
    if isinstance(exc, _ACCELERATOR_ERROR):
        return True
    msg = str(exc).lower()
    return any(s in msg for s in _STICKY_CUDA_ERRORS)


def device_fault(exc: BaseException) -> bool:
    """A fault of the card or the code that runs on it, not of one query: a
    kernel that does not build, launch or capture (`KernelError`) or a
    sticky CUDA error.  A fused batch raises it to every member instead of
    rerouting them."""
    return isinstance(exc, KernelError) or (
        isinstance(exc, RuntimeError) and _sticky_cuda_error(exc))


def classify_error(exc: BaseException) -> str:
    """"transient" | "static" | "deadline".

    transient: safe to retry or degrade (queries are read-only, so a
    re-dispatch is idempotent): a RuntimeError, an OSError, a
    `torch.cuda.OutOfMemoryError` (evict, then retry), an injected fault.
    static: a property of the query or the code, which a retry would pay
    again: NotImplementedError, `KernelError`, every `torch.AcceleratorError`
    (a CUDA error: after a kernel fault the context is lost), a RuntimeError
    naming a sticky CUDA error (an illegal address or instruction, a
    misaligned address, an unspecified launch failure, a device-side
    assert, ...), and every other exception type.  deadline: stop now."""
    if isinstance(exc, DeadlineExceeded):
        return "deadline"
    if isinstance(exc, (NotImplementedError, KernelError)):
        return "static"
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "transient"
    if isinstance(exc, RuntimeError) and _sticky_cuda_error(exc):
        return "static"
    if isinstance(exc, (RuntimeError, OSError, ConnectionError)):
        return "transient"
    return "static"


# ---------------------------------------------------------------------------
# Deadlines (cooperative cancellation)
# ---------------------------------------------------------------------------


class Deadline:
    __slots__ = ("expires_at", "timeout_ms")

    def __init__(self, timeout_ms: float):
        self.timeout_ms = float(timeout_ms)
        self.expires_at = time.monotonic() + self.timeout_ms / 1e3

    def remaining_ms(self) -> float:
        return (self.expires_at - time.monotonic()) * 1e3

    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at

    def check(self, site: str) -> None:
        if self.expired():
            raise DeadlineExceeded(site, self.timeout_ms)


_active_deadline: "contextvars.ContextVar[Optional[Deadline]]" = contextvars.ContextVar(
    "sdol_torch_active_deadline", default=None
)


def current_deadline() -> Optional[Deadline]:
    return _active_deadline.get()


@contextlib.contextmanager
def deadline_scope(timeout_ms: Optional[float]):
    """Arms a deadline for the enclosed block.  A no-op when `timeout_ms` is
    falsy or a deadline is already active: the outermost scope wins."""
    if not timeout_ms or timeout_ms <= 0 or _active_deadline.get() is not None:
        yield current_deadline()
        return
    token = _active_deadline.set(Deadline(timeout_ms))
    try:
        yield _active_deadline.get()
    finally:
        _active_deadline.reset(token)


def checkpoint(site: str) -> None:
    """Cooperative cancellation and fault-injection point: one contextvar
    read when nothing is armed.  Every checkpoint is also a fault site
    (`fire(site)`), so arming it with `error_type=InjectedDeadline` and
    `skip=K` expires the deadline at exactly the K-th call.  While an armed
    partial collector is triggered the deadline check is suppressed: the
    query is draining its partials into an answer."""
    fire(site)
    d = _active_deadline.get()
    if d is None:
        return
    pc = _active_partial.get()
    if pc is not None and pc.triggered:
        return
    d.check(site)


def checkpoint_partial(site: str) -> bool:
    """The checkpoint of a loop that can answer with the partials it has
    merged.  True when the loop must stop dispatching: the deadline expired
    here (the collector is triggered, and every later checkpoint becomes a
    no-op so the drain completes), or an earlier site triggered it.  Without
    an armed collector this is `checkpoint` (expiry raises)."""
    pc = current_partial()
    if pc is not None and pc.triggered:
        return True
    try:
        checkpoint(site)
    except DeadlineExceeded as err:
        if pc is None:
            raise
        pc.trigger(err.site or site)
        return True
    return False


# ---------------------------------------------------------------------------
# Partial-result collection
# ---------------------------------------------------------------------------


class PartialCollector:
    """Per-query accounting for deadline-bounded partial answers.

    Armed by `partial_scope`.  Executors declare the scope they intend to
    scan (`begin_pass` + `add_scope`) and what they merged (`add_seen`, per
    segment or chunk).  When a deadline expires at a `checkpoint_partial`
    site the collector is triggered: the executor stops dispatching, every
    later checkpoint is a no-op, and the merged partials flow through the
    normal finalize path stamped with a coverage fraction.

    Coverage is rows_seen / rows_total (segments when no rows were
    declared; None when no scope was ever declared, as for a stream).  A
    declared empty scope is complete: coverage 1.0, never partial.
    `is_partial` is False when the trigger fired after every unit had
    already been dispatched.  With `collect_sets` armed (a grouping-set
    expansion) `begin_pass` archives the superseded pass under its set
    label, and the aggregate covers every set."""

    __slots__ = (
        "enabled", "triggered_site", "in_fallback", "scope_declared",
        "segments_total", "segments_seen", "rows_total", "rows_seen",
        "delta_rows_total", "delta_rows_seen", "collect_sets", "set_label", "set_records", "_pass_label", "_lock",
    )

    def __init__(self, enabled: bool = True):
        # a disabled collector still occupies the scope: an explicit opt-out
        # must not be re-armed by an inner session default
        self.enabled = enabled
        self.triggered_site: Optional[str] = None
        # set while the host fallback owns the pass: its device-assist
        # subtrees run engine passes whose begin_pass would otherwise zero
        # the interpreter's multi-table accounting
        self.in_fallback = False
        self.scope_declared = False
        self.segments_total = self.segments_seen = 0
        self.rows_total = self.rows_seen = 0
        # rows of delta segments (streamed appends), apart from historical
        # ones: how much of a best-effort answer came from fresh rows
        self.delta_rows_total = self.delta_rows_seen = 0
        self.collect_sets = False
        self.set_label: Optional[str] = None
        # the label the live pass started under (the expansion moves
        # set_label to the next set before that set's begin_pass)
        self._pass_label: Optional[str] = None
        self.set_records: list = []
        self._lock = threading.Lock()

    @property
    def triggered(self) -> bool:
        return self.triggered_site is not None

    def trigger(self, site: str) -> None:
        with self._lock:
            if self.triggered_site is None:
                self.triggered_site = site
        log.warning("deadline expired at %r; answering with the partials merged so far", site)

    def _zero_locked(self) -> None:
        self.scope_declared = False
        self.segments_total = self.segments_seen = 0
        self.rows_total = self.rows_seen = 0
        self.delta_rows_total = self.delta_rows_seen = 0

    def begin_pass(self) -> None:
        """A fresh pass over the query's scope supersedes earlier accounting
        (a tier declining into a rescan must not double-count).  A no-op
        inside a fallback-owned pass.  With `collect_sets` armed the
        superseded pass is archived under its set label first; a repeat
        pass of the same label replaces its record."""
        if self.in_fallback:
            return
        with self._lock:
            if self.collect_sets and self.scope_declared:
                self._archive_pass_locked()
            self._zero_locked()
            self._pass_label = self.set_label

    def _archive_pass_locked(self) -> None:
        rec = {
            "set": self._pass_label,
            "coverage": _round(_coverage(self.rows_total, self.rows_seen, self.segments_total,
                                         self.segments_seen, self.scope_declared)),
            "segments_seen": self.segments_seen,
            "segments_total": self.segments_total,
            "rows_seen": self.rows_seen,
            "rows_total": self.rows_total,
            "delta_rows_seen": self.delta_rows_seen,
            "delta_rows_total": self.delta_rows_total,
        }
        for i, old in enumerate(self.set_records):
            if old.get("set") == rec["set"]:
                self.set_records[i] = rec
                return
        self.set_records.append(rec)

    def arm_set_collection(self) -> None:
        with self._lock:
            self.collect_sets = True

    def finish_sets(self) -> list:
        """Closes grouping-set collection: archives the live pass and zeroes
        the live counters, so the aggregate reads from the records alone."""
        with self._lock:
            if self.scope_declared:
                self._archive_pass_locked()
            self.collect_sets = False
            self._zero_locked()
            return list(self.set_records)

    def _agg_locked(self):
        """(segments_total, segments_seen, rows_total, rows_seen,
        delta_rows_total, delta_rows_seen, declared) over the archived set
        records and the live pass."""
        st, ss = self.segments_total, self.segments_seen
        rt, rs = self.rows_total, self.rows_seen
        dt, dsn = self.delta_rows_total, self.delta_rows_seen
        declared = self.scope_declared
        for r in self.set_records:
            st += r["segments_total"]
            ss += r["segments_seen"]
            rt += r["rows_total"]
            rs += r["rows_seen"]
            dt += r["delta_rows_total"]
            dsn += r["delta_rows_seen"]
            declared = True
        return st, ss, rt, rs, dt, dsn, declared

    def reset_for_drain(self) -> None:
        """Zeroes the accounting for the fallback's drain rerun, whose own
        scope and seen counts then describe what the final answer saw.
        Unlike begin_pass it applies inside a fallback-owned pass."""
        with self._lock:
            self._zero_locked()

    def add_scope(self, segments: int, rows: int, delta_rows: int = 0) -> None:
        with self._lock:
            self.scope_declared = True
            self.segments_total += int(segments)
            self.rows_total += int(rows)
            self.delta_rows_total += int(delta_rows)

    def add_seen(self, segments: int, rows: int, delta_rows: int = 0) -> None:
        with self._lock:
            self.segments_seen += int(segments)
            self.rows_seen += int(rows)
            self.delta_rows_seen += int(delta_rows)

    def coverage(self) -> Optional[float]:
        with self._lock:
            st, ss, rt, rs, _dt, _ds, declared = self._agg_locked()
        return _coverage(rt, rs, st, ss, declared)

    @property
    def is_partial(self) -> bool:
        """Triggered and genuinely incomplete."""
        if not self.triggered:
            return False
        with self._lock:
            st, ss, rt, rs, _dt, _ds, declared = self._agg_locked()
        if rt > 0:
            return rs < rt
        if st > 0:
            return ss < st
        return not declared  # an unknown denominator claims nothing

    def to_dict(self) -> dict:
        cov = self.coverage()
        with self._lock:
            st, ss, rt, rs, dt, dsn, _ = self._agg_locked()
            d = {
                "partial": True,
                "coverage": _round(cov),
                "site": self.triggered_site,
                "segments_seen": ss,
                "segments_total": st,
                "rows_seen": rs,
                "rows_total": rt,
                "delta_rows_seen": dsn,
                "delta_rows_total": dt,
            }
            if self.set_records:
                d["sets"] = [dict(r) for r in self.set_records]
        return d


def _coverage(rt, rs, st, ss, declared) -> Optional[float]:
    if rt > 0:
        return min(1.0, rs / rt)
    if st > 0:
        return min(1.0, ss / st)
    return 1.0 if declared else None


def _round(cov: Optional[float]) -> Optional[float]:
    return round(cov, 6) if cov is not None else None


_active_partial: "contextvars.ContextVar[Optional[PartialCollector]]" = contextvars.ContextVar(
    "sdol_torch_active_partial", default=None
)


def current_partial() -> Optional[PartialCollector]:
    pc = _active_partial.get()
    return pc if pc is not None and pc.enabled else None


@contextlib.contextmanager
def partial_scope(enabled: bool = True):
    """Arms a partial-result collector for the enclosed query; the outermost
    scope wins.  `enabled=False` still occupies the scope with a disabled
    collector, so deadline expiry stays an error."""
    if _active_partial.get() is not None:
        yield current_partial()
        return
    token = _active_partial.set(PartialCollector(enabled=enabled))
    try:
        yield current_partial()
    finally:
        _active_partial.reset(token)


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

# the fault sites of the durable storage tier (storage.py, ingest/wal.py,
# catalog/persist.py), each a `checkpoint`: every stage of the append and
# flush order (journal -> fsync -> publish -> snapshot rename -> retire ->
# truncate) and of boot replay is a point where a test kills the process
STORAGE_SITES = (
    "wal.journal_write",  # before any byte of the record lands
    "wal.pre_fsync",  # bytes written, not yet durable (the torn-tail zone)
    "wal.post_fsync_pre_publish",  # durable but unpublished (not acknowledged)
    "wal.replay_record",  # between replayed records at boot
    "persist.snapshot_rename",  # before the snapshot.json commit rename
    "compact.retire",  # before retired column files are deleted
    "storage.replay_batch",  # before a replayed batch is applied
)

# the cluster tier's fault sites (cluster/): the broker fires the first two
# in its scatter and gather loops (checkpoints, so deadlines stop there
# too), the next two inside one replica attempt (the network's failures),
# the historical the fifth while it serves a partial, and the federated
# scrape the last once per node
CLUSTER_SITES = (
    "cluster.scatter",  # broker: before each replica attempt of a chain walk
    "cluster.gather",  # broker: before each replica state is merged
    "cluster.rpc",  # broker: inside one attempt (error: refused or timed out; delay: slow)
    "cluster.torn_response",  # broker: partial mode truncates the response body
    "cluster.historical_kill",  # historical: dies while serving a partial
    "cluster.federate",  # broker: before each node's scrape
)


class _FaultSpec:
    __slots__ = ("mode", "times", "delay_ms", "fraction", "error_type", "skip")

    def __init__(self, mode, times=None, delay_ms=0.0, fraction=1.0,
                 error_type=InjectedFault, skip=0):
        if mode not in ("error", "delay", "partial"):
            raise ValueError(f"unknown fault mode {mode!r}")
        self.mode = mode
        self.times = times  # None: every call; else the first N calls
        self.delay_ms = float(delay_ms)
        self.fraction = float(fraction)
        self.error_type = error_type
        # calls passed through untouched before the spec fires
        self.skip = int(skip)


class FaultInjector:
    """Deterministic fault injection at named sites.

    Modes: `error` raises `error_type` (InjectedFault by default); `delay`
    sleeps `delay_ms` and continues; `partial` makes `partial_fraction(site)`
    return `fraction`, and the site truncates its output to it.  `times=N`
    fires for the first N calls (after `skip`) and then disarms.  The
    `SDOL_FAULTS` environment variable arms sites when the injector is first
    used: `SDOL_FAULTS="device_dispatch:error:1,h2d:delay:100"`, with the
    forms `site:error[:N]`, `site:delay:MS` and `site:partial:FRACTION`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sites: Dict[str, _FaultSpec] = {}
        self._fired: Dict[str, int] = {}

    def arm(self, site: str, mode: str = "error", times: Optional[int] = None,
            delay_ms: float = 0.0, fraction: float = 1.0,
            error_type=InjectedFault, skip: int = 0) -> None:
        with self._lock:
            self._sites[site] = _FaultSpec(mode, times, delay_ms, fraction, error_type, skip)
            self._fired.setdefault(site, 0)

    def disarm(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._sites.clear()
            else:
                self._sites.pop(site, None)

    def armed(self, site: str) -> bool:
        with self._lock:
            return site in self._sites

    def arm_from_env(self, env: Optional[str] = None) -> None:
        spec = env if env is not None else os.environ.get("SDOL_FAULTS", "")
        for part in filter(None, (p.strip() for p in spec.split(","))):
            bits = part.split(":")
            site, mode = bits[0], bits[1] if len(bits) > 1 else "error"
            arg = bits[2] if len(bits) > 2 else None
            if mode == "delay":
                self.arm(site, "delay", delay_ms=float(arg or 0))
            elif mode == "partial":
                self.arm(site, "partial", fraction=float(arg or 1.0))
            else:
                self.arm(site, "error", times=int(arg) if arg is not None else None)

    def _take(self, site: str, partial: bool = False) -> Optional[_FaultSpec]:
        with self._lock:
            spec = self._sites.get(site)
            if spec is None or (spec.mode == "partial") != partial:
                return None
            if spec.skip > 0:
                spec.skip -= 1
                return None
            if spec.times is not None:
                if spec.times <= 0:
                    self._sites.pop(site, None)
                    return None
                spec.times -= 1
                if spec.times == 0:
                    self._sites.pop(site, None)
            self._fired[site] = self._fired.get(site, 0) + 1
            return spec

    def fire(self, site: str) -> None:
        """Raises or delays if `site` is armed; a no-op otherwise.  The
        unarmed path is one lock-free dict read."""
        if not self._sites:
            return
        spec = self._take(site)
        if spec is None:
            return
        if spec.mode == "delay":
            time.sleep(spec.delay_ms / 1e3)
            return
        err = spec.error_type(f"injected fault at site {site!r}")
        if isinstance(err, DeadlineExceeded):
            err.site = site  # a partial trigger names the site
        raise err

    def partial_fraction(self, site: str) -> Optional[float]:
        spec = self._take(site, partial=True)
        return None if spec is None else spec.fraction

    def state(self) -> dict:
        with self._lock:
            return {
                "armed": {s: {"mode": sp.mode, "times": sp.times} for s, sp in self._sites.items()},
                "fired": dict(self._fired),
            }


_injector: Optional[FaultInjector] = None
_injector_lock = threading.Lock()


def injector() -> FaultInjector:
    """The process-wide injector: a fault hits every engine and context of
    the process, as a broken device would."""
    global _injector
    if _injector is None:
        with _injector_lock:
            if _injector is None:
                inj = FaultInjector()
                if os.environ.get("SDOL_FAULTS"):
                    inj.arm_from_env()
                _injector = inj
    return _injector


def fire(site: str) -> None:
    """Module-level shorthand for the hot sites: skips even building the
    injector when nothing was ever armed."""
    inj = _injector
    if inj is None:
        if not os.environ.get("SDOL_FAULTS"):
            return
        inj = injector()
    inj.fire(site)


def site_armed(site: str) -> bool:
    """Is `site` armed?  False without building the injector."""
    inj = _injector
    return inj is not None and inj.armed(site)


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------


def run_device_attempts(engine, run_once, evict, what: str = "device"):
    """Retry with backoff for one idempotent device execution.  `engine`
    supplies `breaker`, `_retry_attempts`, `_retry_backoff_ms` and
    `last_metrics`; `run_once` makes one attempt; `evict` drops whatever a
    failed dispatch may have poisoned.  A transient failure is counted on
    the breaker and retried under the budget with doubling backoff, failing
    at once when the active deadline cannot afford the backoff; static
    errors and DeadlineExceeded propagate untouched."""
    attempts = max(1, int(engine._retry_attempts))
    for i in range(attempts):
        try:
            if i == 0:
                out = run_once()
            else:
                # a re-attempt gets its own span: the trace shows where the
                # query's latency went when a transient failure struck
                with span(SPAN_RETRY, attempt=i, what=what):
                    out = run_once()
            if engine.breaker is not None:
                engine.breaker.record_success()
            if i and engine.last_metrics is not None:
                engine.last_metrics.retries = i
            return out
        except RuntimeError as err:
            if classify_error(err) != "transient":
                raise
            if engine.breaker is not None:
                engine.breaker.record_failure()
            if engine.last_metrics is not None:
                engine.last_metrics.retries = i
                engine.last_metrics.error_class = type(err).__name__
            if i + 1 >= attempts:
                raise
            evict()
            backoff_ms = engine._retry_backoff_ms * (2.0 ** i)
            d = current_deadline()
            if d is not None and d.remaining_ms() <= backoff_ms:
                raise  # the backoff alone would spend the budget
            log.warning(
                "transient %s failure (%s: %s); evicting cached state and "
                "dispatching again (attempt %d/%d, backoff %.0fms)",
                what, type(err).__name__, err, i + 2, attempts, backoff_ms,
            )
            if backoff_ms > 0:
                time.sleep(backoff_ms / 1e3)
    raise AssertionError("unreachable")


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Three-state breaker over transient failures of one backend.

    closed -> open after `failure_threshold` consecutive failures;
    open -> half_open once `cooldown_ms` has elapsed (`allow` admits one
    probe at a time); half_open -> closed on a success, open on a failure.
    The breaker informs routing (`api._execute_with_resilience`); static
    errors never reach it."""

    def __init__(self, failure_threshold: int = 3, cooldown_ms: float = 2000.0,
                 clock: Callable[[], float] = time.monotonic, backend: str = "device"):
        self.backend = backend
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_ms = float(cooldown_ms)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._failures_total = 0
        self._successes_total = 0
        self._trips = 0
        # the half-open probe lease; stale after another cooldown, so a
        # probe that never reports cannot wedge the breaker
        self._probe_started_at: Optional[float] = None

    @property
    def state(self) -> str:
        with self._lock:
            return self._peek_state()

    def _peek_state(self) -> str:
        if self._state == "open" and (self._clock() - self._opened_at) * 1e3 >= self.cooldown_ms:
            return "half_open"
        return self._state

    def allow(self) -> bool:
        """May a query try this backend now?  In half-open only the probe
        holder gets True."""
        with self._lock:
            st = self._peek_state()
            if st == "open":
                return False
            if st == "half_open":
                self._state = "half_open"
                now = self._clock()
                if self._probe_started_at is not None and (
                    (now - self._probe_started_at) * 1e3 < self.cooldown_ms
                ):
                    return False
                self._probe_started_at = now
            return True

    def release_probe(self) -> None:
        """Hand back a probe lease without a verdict: the admitted query
        never touched the device (the result cache answered it), so the
        next caller may probe at once."""
        with self._lock:
            self._probe_started_at = None

    def record_success(self) -> None:
        with self._lock:
            self._successes_total += 1
            self._consecutive_failures = 0
            self._probe_started_at = None
            if self._state != "closed":
                log.info("%s circuit breaker closing (probe succeeded)", self.backend)
                _count("sdol_breaker_transitions_total", "circuit breaker state transitions",
                       labels=("to", "backend"), to="closed", backend=self.backend)
            self._state = "closed"

    def record_failure(self) -> None:
        with self._lock:
            self._failures_total += 1
            self._consecutive_failures += 1
            self._probe_started_at = None
            if self._state == "half_open":
                self._state = "open"
                self._opened_at = self._clock()
                self._trips += 1
                log.warning("%s circuit breaker re-opened (probe failed)", self.backend)
                _count("sdol_breaker_transitions_total", "circuit breaker state transitions",
                       labels=("to", "backend"), to="open", backend=self.backend)
            elif self._state == "closed" and self._consecutive_failures >= self.failure_threshold:
                self._state = "open"
                self._opened_at = self._clock()
                self._trips += 1
                log.warning(
                    "%s circuit breaker OPEN after %d consecutive failures; "
                    "traffic routes around it for %.0fms",
                    self.backend, self._consecutive_failures, self.cooldown_ms,
                )
                _count("sdol_breaker_transitions_total", "circuit breaker state transitions",
                       labels=("to", "backend"), to="open", backend=self.backend)

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "backend": self.backend,
                "state": self._peek_state(),
                "consecutive_failures": self._consecutive_failures,
                "failure_threshold": self.failure_threshold,
                "cooldown_ms": self.cooldown_ms,
                "failures_total": self._failures_total,
                "successes_total": self._successes_total,
                "trips": self._trips,
            }


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------


class AdmissionController:
    """Bounded slot pool with a queue-wait timeout.

    `acquire()` waits up to `queue_timeout_ms` for a slot and returns False
    on timeout: the server answers 503 with Retry-After instead of piling
    handler threads behind a busy card.  The Retry-After hint comes from
    observed load: the callers queued now (`queue_depth`) and an EWMA of
    how long admitted queries hold a slot, so an idle pool that rejected a
    burst says 1 s and a pool behind a slow card scales with its backlog."""

    # weight of the newest hold-time observation: enough to follow a phase
    # change within a few queries, not enough for one outlier to swing it
    _HOLD_EWMA_ALPHA = 0.2

    def __init__(self, max_concurrent: int = 8, queue_timeout_ms: float = 2000.0,
                 clock: Callable[[], float] = time.monotonic, lane: str = ""):
        self.max_concurrent = max(1, int(max_concurrent))
        self.queue_timeout_ms = float(queue_timeout_ms)
        # set when this pool is one priority lane of the serving core
        # (serve/lanes.py): decisions also publish under `sdol_lane_*`
        self.lane = lane
        self._clock = clock
        self._sem = threading.BoundedSemaphore(self.max_concurrent)
        self._lock = threading.Lock()
        self._in_use = 0
        self.admitted_total = 0
        self.rejected_total = 0
        self._waiting = 0  # callers blocked in acquire()
        self._hold_ewma_ms: Optional[float] = None
        self._held_since: Dict[int, float] = {}  # thread id -> acquire time

    def resize(self, max_concurrent: int, queue_timeout_ms: float) -> None:
        """`SET max_concurrent_queries` (or a lane's slots): a new slot count
        takes effect at once while no slot is held, else raises."""
        n = max(1, int(max_concurrent))
        with self._lock:
            self.queue_timeout_ms = float(queue_timeout_ms)
            if n == self.max_concurrent:
                return
            if self._in_use or self._waiting:
                raise RuntimeError(
                    f"cannot resize an admission pool with {self._in_use} slots held "
                    f"and {self._waiting} callers waiting")
            self.max_concurrent = n
            self._sem = threading.BoundedSemaphore(n)

    def acquire(self) -> bool:
        with self._lock:
            self._waiting += 1
            sem = self._sem
        ok = sem.acquire(timeout=self.queue_timeout_ms / 1e3)
        with self._lock:
            self._waiting -= 1
            if ok:
                self._in_use += 1
                self.admitted_total += 1
                self._held_since[threading.get_ident()] = self._clock()
            else:
                self.rejected_total += 1
        _count("sdol_admission_decisions_total",
               "admission-pool outcomes (admitted vs 503-rejected)",
               labels=("outcome",), outcome="admitted" if ok else "rejected")
        if self.lane:
            _count("sdol_lane_decisions_total", "per-lane admission outcomes (serve/lanes.py)",
                   labels=("lane", "outcome"), lane=self.lane,
                   outcome="admitted" if ok else "rejected")
        return ok

    def release(self) -> None:
        with self._lock:
            self._in_use -= 1
            t0 = self._held_since.pop(threading.get_ident(), None)
            if t0 is not None:
                held_ms = (self._clock() - t0) * 1e3
                a = self._HOLD_EWMA_ALPHA
                self._hold_ewma_ms = (
                    held_ms if self._hold_ewma_ms is None
                    else (1 - a) * self._hold_ewma_ms + a * held_ms)
            sem = self._sem
        sem.release()

    @property
    def in_use(self) -> int:
        with self._lock:
            return self._in_use

    @property
    def queue_depth(self) -> int:
        """Callers blocked waiting for a slot."""
        with self._lock:
            return self._waiting

    def retry_after_s(self) -> int:
        """Client backoff hint: the queue ahead of a returning client
        drains in `depth / slots` hold intervals, plus its own tenure.
        Before any hold time is observed the configured queue wait stands
        in.  Clamped to [1 s, 60 s]."""
        with self._lock:
            depth = self._waiting
            hold_ms = (self._hold_ewma_ms if self._hold_ewma_ms is not None
                       else self.queue_timeout_ms)
        eta_ms = hold_ms * (depth / self.max_concurrent + 1.0)
        return max(1, min(60, int(-(-eta_ms // 1000))))

    def to_dict(self) -> dict:
        with self._lock:
            hold = self._hold_ewma_ms
            return {
                "slots_in_use": self._in_use,
                "slots_total": self.max_concurrent,
                "queue_depth": self._waiting,
                "hold_ewma_ms": round(hold, 3) if hold is not None else None,
                "queue_timeout_ms": self.queue_timeout_ms,
                "admitted_total": self.admitted_total,
                "rejected_total": self.rejected_total,
            }


# numeric breaker states of the `sdol_breaker_state` gauge
BREAKER_STATE_CODES = {"closed": 0, "half_open": 1, "open": 2}

# ---------------------------------------------------------------------------
# Per-context state
# ---------------------------------------------------------------------------

# the backends with breakers of their own: a host fallback wedged on bad
# data fails fast instead of re-grinding every degraded query, and a sick
# mesh trips only its own, leaving single-device queries routed
BREAKER_BACKENDS = ("device", "mesh", "fallback")


class ResilienceState:
    """One context's breakers, its admission, ingest and lane pools and its
    failure counters.  The fault injector is process-wide."""

    def __init__(self, config):
        self.breakers: Dict[str, CircuitBreaker] = {
            b: CircuitBreaker(
                failure_threshold=config.breaker_failure_threshold,
                cooldown_ms=config.breaker_cooldown_ms,
                backend=b,
            )
            for b in BREAKER_BACKENDS
        }
        self.admission = AdmissionController(
            max_concurrent=config.max_concurrent_queries,
            queue_timeout_ms=config.admission_queue_timeout_ms,
        )
        # streamed appends (the server's ingest route, boot replay) take
        # slots of their own pool, so appends and queries cannot starve
        # each other; a full pool answers 503 with Retry-After
        self.ingest_admission = AdmissionController(
            max_concurrent=config.max_concurrent_ingests,
            queue_timeout_ms=config.ingest_queue_timeout_ms,
        )
        # priority lanes (serve/lanes.py): separate slot pools, so cheap
        # dashboard queries never queue behind large scans
        self.lanes: Dict[str, AdmissionController] = {
            "interactive": AdmissionController(
                max_concurrent=config.lane_interactive_slots,
                queue_timeout_ms=config.admission_queue_timeout_ms,
                lane="interactive",
            ),
            "heavy": AdmissionController(
                max_concurrent=config.lane_heavy_slots,
                queue_timeout_ms=config.admission_queue_timeout_ms,
                lane="heavy",
            ),
        }
        self._lock = threading.Lock()
        self.degraded_total = 0
        self.deadline_exceeded_total = 0
        self.server_errors_total = 0
        self.last_error: Optional[Dict] = None
        # live gauges, read by callback at scrape time so the acquire and
        # release paths pay nothing; a new context takes over the series
        reg = get_registry()
        reg.gauge(
            "sdol_admission_queue_depth",
            "callers currently blocked waiting for an admission slot",
        ).set_function(lambda a=self.admission: a.queue_depth)
        reg.gauge(
            "sdol_admission_slots_in_use",
            "admission slots currently held by executing queries",
        ).set_function(lambda a=self.admission: a.in_use)
        state_gauge = reg.gauge(
            "sdol_breaker_state",
            "circuit breaker state by backend (0=closed 1=half_open 2=open)",
            labels=("backend",),
        )
        for b, cb in self.breakers.items():
            state_gauge.labels(backend=b).set_function(
                lambda cb=cb: BREAKER_STATE_CODES.get(cb.state, -1))
        lane_depth = reg.gauge(
            "sdol_lane_queue_depth",
            "callers blocked waiting for a lane slot, by lane",
            labels=("lane",),
        )
        lane_in_use = reg.gauge(
            "sdol_lane_slots_in_use",
            "lane slots currently held by executing queries, by lane",
            labels=("lane",),
        )
        for name, pool in self.lanes.items():
            lane_depth.labels(lane=name).set_function(lambda p=pool: p.queue_depth)
            lane_in_use.labels(lane=name).set_function(lambda p=pool: p.in_use)

    def configure(self, config) -> None:
        """`SET` on an admission or lane flag: the pools take the new sizes
        and queue timeout (a pool with held slots cannot resize)."""
        t = config.admission_queue_timeout_ms
        self.admission.resize(config.max_concurrent_queries, t)
        self.lanes["interactive"].resize(config.lane_interactive_slots, t)
        self.lanes["heavy"].resize(config.lane_heavy_slots, t)
        self.ingest_admission.resize(config.max_concurrent_ingests,
                                     config.ingest_queue_timeout_ms)

    @property
    def breaker(self) -> CircuitBreaker:
        return self.breakers["device"]

    def breaker_for(self, backend: str) -> CircuitBreaker:
        return self.breakers.get(backend, self.breakers["device"])

    def lane(self, name: str) -> AdmissionController:
        """The slot pool of one priority lane; an unknown name gates on
        the interactive lane."""
        return self.lanes.get(name, self.lanes["interactive"])

    def note_degraded(self) -> None:
        with self._lock:
            self.degraded_total += 1
        _count("sdol_degraded_total", "queries answered DEGRADED on the host fallback")

    def note_deadline_exceeded(self) -> None:
        with self._lock:
            self.deadline_exceeded_total += 1
        _count("sdol_deadline_exceeded_total", "queries cancelled on their wall-clock deadline")

    def note_server_error(self, exc: BaseException) -> None:
        with self._lock:
            self.server_errors_total += 1
            self.last_error = {
                "errorClass": type(exc).__name__,
                "classification": classify_error(exc),
            }
        _count("sdol_server_errors_total",
               "unhandled query failures surfaced as structured 500s")

    def health(self) -> dict:
        with self._lock:
            counters = {
                "degraded_total": self.degraded_total,
                "deadline_exceeded_total": self.deadline_exceeded_total,
                "server_errors_total": self.server_errors_total,
                "last_error": self.last_error,
            }
        return {
            "healthy": True,
            "breaker": self.breaker.to_dict(),
            "breakers": {b: cb.to_dict() for b, cb in self.breakers.items()},
            "admission": self.admission.to_dict(),
            "ingest_admission": self.ingest_admission.to_dict(),
            "lanes": {name: pool.to_dict() for name, pool in self.lanes.items()},
            "counters": counters,
            "faults": injector().state(),
        }
