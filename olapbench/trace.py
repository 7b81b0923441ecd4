"""What a run hands its metric readers: the window's requests, the span
tree of each (by query id), the card's utilisation over the window, and,
from a short burst after it, the device profile of a steady interval and
the requests answered in it; and what the reference counted.

Spans come from the program's tracer, kept whole for the traced run by
`KeepAll`.  The window runs with no profiler: CUPTI, at the arena's some
hundred thousand device operations a second, costs the served path about
half its rate, so what the window reads (spans, NVML's utilisation) is
read at full load.  Device time comes from `torch.profiler` (CUPTI) over
the burst, placed on the host's clock through the offset between the two
clocks read when recording starts."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Tuple

PROFILE_S = 2.0  # the profiled interval: the end of the burst


@dataclasses.dataclass
class Request:
    kind: str
    form: str
    t_send: float
    t_end: float
    status: int
    qid: str
    ok: bool

    @property
    def ms(self) -> float:
        return (self.t_end - self.t_send) * 1e3


@dataclasses.dataclass
class Profile:
    """Device activity over [t0, t1] (host `perf_counter` seconds): the
    merged intervals in which a kernel, copy or set ran, and device seconds
    by operation name."""

    t0: float
    t1: float
    busy: List[Tuple[float, float]]
    ops: Dict[str, float]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def gaps(self) -> List[Tuple[float, float]]:
        out, at = [], self.t0
        for a, b in self.busy:
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            out.append((at, self.t1))
        return out


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float
    depth: int
    children: List["Span"]

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e3


def span_tree(origin: float, d: dict, depth: int = 0) -> Span:
    start = origin + d["start_ms"] / 1e3
    return Span(d["name"], start, start + d["duration_ms"] / 1e3, depth,
                [span_tree(origin, c, depth + 1) for c in d.get("children", ())
                 if "name" in c and "start_ms" in c])


def walk(s: Span) -> Iterator[Span]:
    yield s
    for c in s.children:
        yield from walk(c)


@dataclasses.dataclass
class Run:
    """One run as its metric readers see it.  `requests` are the window's,
    `spans[qid]` is the root span of the request with that id (the
    window's and the burst's); `profile` is the burst's device profile and
    `profiled` the burst's requests; `busy_pct` is NVML's mean utilisation
    over the window; `in_scope_rows[kind]` and `result_cells[kind]` are the
    reference's counts for a request kind."""

    cell: object
    requests: List[Request]
    spans: Dict[str, Span]
    profile: Optional[Profile]
    in_scope_rows: Dict[str, int]
    result_cells: Dict[str, int]
    profiled: List[Request] = dataclasses.field(default_factory=list)
    busy_pct: Optional[float] = None

    def traced(self) -> List[Tuple[Request, Span]]:
        return [(r, self.spans[r.qid]) for r in self.requests if r.qid in self.spans]


class KeepAll:
    """Stands in for the tracer's bounded ring while a traced run lasts:
    every finished trace is kept with the `perf_counter` reading of its
    root's start, and passed on to the ring as before."""

    def __init__(self, tracer):
        self.tracer, self.ring = tracer, tracer.ring
        self.docs: Dict[str, Tuple[float, dict]] = {}

    def put(self, doc: dict) -> None:
        last = self.tracer.last
        qid = doc.get("query_id", "")
        if last is not None and last.query_id == qid:
            origin = last.root.start
        else:  # another query finished in between: its close, less its length
            origin = time.perf_counter() - doc.get("total_ms", 0.0) / 1e3
        self.docs[qid] = (origin, doc)
        self.ring.put(doc)

    def __getattr__(self, name):
        return getattr(self.ring, name)


class DeviceProfiler:
    """`torch.profiler` (CUPTI, device activity only) over one interval of
    a burst of load.  `prepare()`, called while no request is in flight,
    pays CUPTI's start-up (seconds, with the interpreter's lock held);
    `start_at()` switches recording on; `stop()` and `profile()`, called
    once the burst's answers are in, switch it off and read the raw
    events, so that neither stalls a request.
    Their timestamps are the epoch clock's; they are placed on
    `perf_counter`'s by the offset between the two, read when recording
    starts."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        self.prof = profile(activities=[ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self.t0 = self.t1 = self.offset_ns = 0

    def prepare(self) -> float:
        t = time.perf_counter()
        self.prof.start()  # the schedule's warm-up step: tracing prepared, nothing kept
        return time.perf_counter() - t

    def start_at(self, t_start: float) -> None:
        """Switch recording on at `t_start` (host `perf_counter`)."""
        time.sleep(max(0.0, t_start - time.perf_counter()))
        self.prof.step()
        self.t0 = time.perf_counter()
        self.offset_ns = min(time.time_ns() - time.perf_counter_ns() for _ in range(5))

    def stop(self, t_stop: float) -> float:
        """Switch recording off; the profile ends at `t_stop`.  Called once
        every request has been answered, since stopping holds the
        interpreter for seconds.  Returns the seconds it took."""
        t = time.perf_counter()
        self.t1 = t_stop
        self.prof.step()
        self.prof.stop()
        return time.perf_counter() - t

    def profile(self) -> Profile:
        from torch.autograd import DeviceType

        spans, ops = [], {}
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            a = max((e.start_ns() - self.offset_ns) / 1e9, self.t0)
            b = min((e.end_ns() - self.offset_ns) / 1e9, self.t1)
            if b <= a:
                continue
            spans.append((a, b))
            name = e.name()
            ops[name] = ops.get(name, 0.0) + (b - a)
        spans.sort()
        busy: List[Tuple[float, float]] = []
        for a, b in spans:
            if busy and a <= busy[-1][1]:
                busy[-1] = (busy[-1][0], max(busy[-1][1], b))
            else:
                busy.append((a, b))
        return Profile(self.t0, self.t1, busy, ops)


def innermost(spans: List[Span], at: float) -> Optional[Span]:
    """The deepest span of any request open at `at` (the latest started
    among equals)."""
    best = None
    for root in spans:
        if not root.start <= at <= root.end:
            continue
        for s in walk(root):
            if s.start <= at <= s.end and (
                    best is None or (s.depth, s.start) > (best.depth, best.start)):
                best = s
    return best


def breakdown(run: Run, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost span of the program open at its
    middle ("no_request" where none is)."""
    p = run.profile
    ops = sorted(p.ops.items(), key=lambda kv: kv[1], reverse=True)[:top]
    roots = list(run.spans.values())
    gaps = sorted(p.gaps(), key=lambda g: g[1] - g[0], reverse=True)[:top]
    named = []
    for a, b in gaps:
        s = innermost(roots, (a + b) / 2)
        named.append([s.name if s is not None else "no_request", b - a])
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": named}
