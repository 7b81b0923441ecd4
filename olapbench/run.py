"""Run one cell of the benchmark once.

    python3 -m olapbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

0. The process re-executes itself once with a fixed `PYTHONHASHSEED`, and
   hands it to the clients' process, so that every run hashes alike.
1. Set-up: the cell's data is drawn from the seed on the card and
   registered with the program (`spark_druid_olap_tpu_torch.api.
   TPUOlapContext`) as users register it; its `OlapServer` starts on
   127.0.0.1 at a free port; each request of the cell's mix is sent three
   times (its graph captures on the second and replays from the third),
   then the clients run a short burst.
2. The window: the mix's closed-loop clients, in one spawned child process
   (`olapbench/client.py`), for `--seconds`; every request is timed on the
   client from its send to the last byte of its answer.  With `--trace 1`
   the program's span trees are kept for every request and NVML's
   utilisation is sampled over the window; once it has closed, the
   profiler is started and covers the last seconds of a short burst of
   the same load (`olapbench/trace.py` says why not the window itself).
3. Correctness: once the load has stopped, the program's state is freed
   and the plain reference (`olapbench/reference/`) answers every request
   kind from the normalized tables; every distinct answer served is
   compared with it (`olapbench/compare.py`).
4. The result: one JSON line on standard output, last; the compared numbers
   beside their limits also as the last lines of standard error.

Exits non-zero with no result when there is no card or fewer than the cell
asks for, when the set-up fails, or when `jax`, `jaxlib`, `flax` or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# the start of the process that re-executed itself into this one (same clock)
T_START = float(os.environ.get("OLAPBENCH_T_START", T_START))

FORBIDDEN = ("jax", "jaxlib", "flax", "spark_druid_olap_tpu")
WARM_REPEATS = 3  # a request's first run, its capture, its first replay
WARM_BURST_S = 3.0  # the clients' own warm-up, before the window
PROFILE_LEAD_S = 1.0  # the profiled burst's load settles this long before recording
HASH_SEED = "0"  # every process of a run hashes strings alike
MAX_INT_SEED = 2 ** 63 - 1


def log(msg: str) -> None:
    print(f"[olapbench {time.perf_counter() - T_START:8.2f}s] {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is one that no run may load."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _session(cell, device):
    from spark_druid_olap_tpu_torch.config import SessionConfig

    cfg = SessionConfig.load_calibrated(device=device)
    for k, v in cell.config["session"].items():
        if not hasattr(cfg, k):
            raise KeyError(f"session setting {k!r} is not one of the program's")
        setattr(cfg, k, v)
    return cfg


def _kinds(cell):
    kinds = []
    for req in cell.mix["requests"]:
        q = cell.queries[req["query"]]
        bodies = {}
        for form in req["forms"]:
            doc = q["native"] if form == "native" else {"query": q["sql"]}
            bodies[form] = json.dumps(doc).encode()
        kinds.append({"name": req["query"], "forms": list(req["forms"]), "bodies": bodies})
    return kinds


def _post(port, form, body):
    import http.client

    from olapbench.client import PATHS

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", PATHS[form], body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _compiles():
    from spark_druid_olap_tpu_torch.obs import get_registry

    values = get_registry().to_dict().get("sdol_compiles_total", {}).get("values", {})
    return int(sum(values.values()))


def _cpu_s() -> float:
    """CPU seconds this process has used, all its threads together."""
    t = os.times()
    return t.user + t.system


def _percentile(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _log_kinds(kinds, records):
    """Per request kind and form: requests, and median and worst latency;
    and the answers completed in each second of the window."""
    import statistics

    if records:
        t0 = min(r[3] for r in records)
        per_s = {}
        for r in records:
            per_s[int(r[4] - t0)] = per_s.get(int(r[4] - t0), 0) + 1
        log("answers per second: " + " ".join(str(per_s.get(i, 0)) for i in range(max(per_s) + 1)))
    by = {}
    for _, k, form, ts, te, status, _, _ in records:
        by.setdefault((kinds[k]["name"], form), []).append((te - ts) * 1e3)
    for (name, form), ms in sorted(by.items()):
        log(f"  {name:10s} {form:6s} n={len(ms):4d} median {statistics.median(ms):8.1f} ms "
            f"max {max(ms):8.1f} ms")


def run_cell(root, workload, seed, seconds, trace, device="cuda", overrides=None, fault=None,
             bench=None):
    """One run of `workload`; returns the result's dict.  `overrides`
    replaces configuration keys (the tests' tiny scales); `fault(ctx)`,
    when given, breaks the program after its set-up (the tests' planted
    faults); `bench`, when given, stands for BENCHMARK.json (the tests'
    cells held back from it)."""
    import gc
    import multiprocessing

    import torch

    from olapbench import client, compare, nvml, spec
    from olapbench import trace as tr

    cell = spec.cell(root, workload, bench)
    if overrides:
        cell.config.update(overrides)
    cfg = cell.config
    device = torch.device(device)
    on_card = device.type == "cuda"
    data, reference = cell.data_module(), cell.reference_module()

    # -- set-up --------------------------------------------------------------
    from spark_druid_olap_tpu_torch.api import TPUOlapContext
    from spark_druid_olap_tpu_torch.server import OlapServer

    star = data.generate(float(cfg["scale_factor"]), seed, device)
    if on_card:
        torch.cuda.synchronize(device)
    log(f"data drawn: {', '.join(f'{t} {star.rows(t)}' for t in star.tables)}")
    ctx = TPUOlapContext(_session(cell, device), device=str(device))
    data.register(ctx, star, cfg)
    star = star.to("cpu")  # the reference's, until the program is gone
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    log("registered")
    keep = None
    if trace:
        keep = tr.KeepAll(ctx.tracer)
        ctx.tracer.ring = keep
    server = OlapServer(ctx, port=0).start()
    kinds = _kinds(cell)
    mp = multiprocessing.get_context("spawn")
    parent, child = mp.Pipe()
    os.environ["PYTHONHASHSEED"] = HASH_SEED  # the clients' process hashes alike too
    proc = mp.Process(target=client.serve_load,
                      args=(child, server.port, kinds, int(cell.mix["clients"]),
                            float(cell.mix["think_ms"])), daemon=True)
    try:
        proc.start()
        child.close()
        for k in kinds:
            for form in k["forms"]:
                for _ in range(WARM_REPEATS):
                    status, body = _post(server.port, form, k["bodies"][form])
                    if status != 200:
                        raise RuntimeError(f"warm-up {k['name']} {form}: {status} {body[:300]!r}")
        log("every request warm")
        parent.send(("run", seed + 1, WARM_BURST_S))
        _, warm, _ = parent.recv()
        bad = [r for r in warm if r[5] != 200]
        if bad:
            raise RuntimeError(f"warm-up burst: {len(bad)} of {len(warm)} requests failed")
        if fault is not None:
            fault(ctx)

        sampler = profiler = profile = None
        if trace and on_card:
            sampler = nvml.Sampler(nvml.pci_bus_id(device), device.index or 0)

        # -- the window ------------------------------------------------------
        compiles0, cpu0 = _compiles(), _cpu_s()
        if sampler is not None:
            sampler.start()
        parent.send(("run", seed, float(seconds)))
        t0, records, bodies = parent.recv()
        if sampler is not None:
            sampler.stop()
        compiles = _compiles() - compiles0
        cpu_s = _cpu_s() - cpu0

        # -- traced: a second, short burst under the profiler -----------------
        burst = []
        if trace and on_card:
            profiler = tr.DeviceProfiler()
            log(f"profiler prepared in {profiler.prepare():.2f}s")
            t_send = time.perf_counter()
            parent.send(("run", seed + 2, PROFILE_LEAD_S + tr.PROFILE_S))
            profiler.start_at(t_send + PROFILE_LEAD_S)
            tb, burst, more = parent.recv()
            for key, body in more.items():
                bodies.setdefault(key, body)
            log(f"profiler stopped in {profiler.stop(tb + PROFILE_LEAD_S + tr.PROFILE_S):.2f}s")
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        parent.send(("stop",))
        proc.join(timeout=60)
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)
        server.shutdown()
    setup_s = t0 - T_START
    log(f"window closed: {len(records)} requests, {compiles} compiles inside it")
    log(f"the server's CPU in the window: {cpu_s:.2f} s "
        f"({1e3 * cpu_s / max(1, len(records)):.2f} ms a request)")
    if sampler is not None:
        log(f"NVML: {len(sampler.in_window())} utilisation samples in the window, "
            f"mean {sampler.busy_pct()} % {sampler.error}")
    if profiler is not None:
        profile = profiler.profile()
        log(f"profiled {profile.window_s:.3f}s: {len(profile.busy)} busy intervals; "
            f"{len(burst)} requests in the burst")
    _log_kinds(kinds, records)

    # -- the program's state freed; the reference --------------------------
    traces = keep.docs if keep is not None else {}
    ctx.close()
    del ctx, server, keep
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    star = star.to(device)
    t_ref = time.perf_counter()
    limits = cfg["limits"]
    judged = {}  # (kind index, form, digest) -> judgement
    exp_by_kind = {}
    for (k, form, digest), body in bodies.items():
        name = kinds[k]["name"]
        if name not in exp_by_kind:
            exp_by_kind[name] = reference.expected(star, name, device)
        j = compare.Judgement()
        compare.judge(f"{name} {form}", body, exp_by_kind[name], j)
        judged[(k, form, digest)] = j
    log(f"reference and comparison: {time.perf_counter() - t_ref:.2f}s")

    def judged_requests(recs):
        out = []
        for c, k, form, ts, te, status, qid, digest in recs:
            j = judged.get((k, form, digest))
            ok = (status == 200 and j is not None and j.mismatched == 0
                  and j.max_rel_err <= limits["max_rel_err"])
            out.append(tr.Request(kinds[k]["name"], form, ts, te, status, qid, ok))
        return out

    requests, profiled = judged_requests(records), judged_requests(burst)
    every = records + burst  # a traced run's burst is judged as the window is
    answered = {(r[1], r[2], r[7]) for r in every if r[5] == 200}
    served = [j for key, j in judged.items() if key in answered]
    digests = {}
    for r in every:
        if r[5] == 200:
            digests.setdefault((r[1], r[2]), set()).add(r[7])
    checks = {
        "failed_requests": [sum(1 for r in every if r[5] != 200), 0],
        "mismatched_answers": [sum(j.mismatched for j in served), 0],
        "varying_answers": [sum(1 for d in digests.values() if len(d) > 1), 0],
        "max_rel_err": [max((j.max_rel_err for j in served), default=0.0), limits["max_rel_err"]],
    }
    correct = bool(records) and all(v <= lim for v, lim in checks.values())
    faults = [j.first_fault for j in served if j.first_fault]

    # -- metrics ---------------------------------------------------------
    attempted = len(requests)
    failed = sum(1 for r in requests if not r.ok)
    if trace:
        dates = reference.fact_dates(star)
        in_scope, cells = {}, {}
        for name, q in cell.queries.items():
            lo, hi = q["in_scope"]
            m = torch.ones_like(dates, dtype=torch.bool)
            if lo is not None:
                m &= dates >= _ms(lo)
            if hi is not None:
                m &= dates < _ms(hi)
            in_scope[name] = int(m.sum())
            e = exp_by_kind.get(name) or reference.expected(star, name, device)
            cells[name] = len(e.rows) * (len(e.keys) + len(e.values) + len(e.exact))
        spans = {qid: tr.span_tree(origin, doc["spans"]) for qid, (origin, doc) in traces.items()}
        run = tr.Run(cell, requests, spans, profile, in_scope, cells, profiled,
                     sampler.busy_pct() if sampler is not None else None)
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        lat = [r.ms for r in requests]
        values = {
            "qps": _rate(requests, t0),
            "p50_ms": _percentile(lat, 50),
            "p95_ms": _percentile(lat, 95),
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else device.type,
            "kind": torch.cuda.get_device_name(device) if on_card else device.type,
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if profile is not None:
        result["device"].update(busy_s=profile.busy_s, window_s=profile.window_s)
        result["breakdown"] = tr.breakdown(run)
    result["notes"] = {"setup_s": setup_s, "compiles_in_window": compiles,
                       "window_qps": _rate(requests, t0), "first_fault": faults[0] if faults else ""}
    if profile is not None:
        result["notes"]["profiled_qps"] = _rate(profiled, tb)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def _rate(requests, t0) -> float:
    """Requests answered correctly per second, from `t0` to the last answer."""
    if not requests:
        return 0.0
    return sum(1 for r in requests if r.ok) / (max(r.t_end for r in requests) - t0)


def _ms(day: str) -> int:
    import numpy as np

    return int(np.datetime64(day, "ms").astype(np.int64))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not 0 <= args.seed <= MAX_INT_SEED:
        print(f"--seed {args.seed} is out of range", file=sys.stderr)
        return 2
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        # string hashing, and so the order of every set of names the program
        # walks, is then the same in every run; setup_s keeps this start
        env = dict(os.environ, PYTHONHASHSEED=HASH_SEED, OLAPBENCH_T_START=repr(T_START))
        os.execve(sys.executable, [sys.executable, "-m", "olapbench.run",
                                   *(sys.argv[1:] if argv is None else argv)], env)
    root = os.getcwd()
    from olapbench import spec

    cell = spec.cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {cell.chips} CUDA device(s); {n} available", file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded, and no run may load: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
