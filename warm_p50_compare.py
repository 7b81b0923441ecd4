#!/usr/bin/env python3
"""Warm p50s of `chip_smoke.py`'s phase 4 (the native main path), phase 6
(SQL against native) and phase 9 (every query with the arena on and off,
and the CUBEs' batch against serial) for checkouts of this repository, on
one card.

    python3 warm_p50_compare.py --tree build/parent --tree . --tree . --tree build/parent

runs each tree in its own process, in the order given (parent, change,
change, parent keeps a drift of the card or the host out of the
difference), each tree's own `chip_smoke.py` driving its own package at
the same repeat counts (`--warm`, `--pairs`, `--arena-warm`) whatever its
defaults.  Prints each process's phase lines, prefixed by its tree, then
the card's name and power limit, then as its last line one JSON object:
per query, every run's p50s by tree, and the ratio of the second tree's
median p50 to the first tree's.  Needs one card; imports nothing of JAX.

    python3 warm_p50_compare.py --summarize LOG

prints that last line again from a saved output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

# (phase line, the fields that are warm p50s)
P50_FIELDS = {
    "query": ("p50_ms",),
    "sql_query": ("sql_p50_ms", "native_p50_ms"),
    "arena_query": ("p50_on_ms", "p50_off_ms", "batch_p50_ms", "serial_p50_ms"),
}


def child(args) -> int:
    tree = Path(args.child).resolve()
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from spark_druid_olap_tpu_torch.api import TPUOlapContext
    from spark_druid_olap_tpu_torch.config import SessionConfig

    if Path(cs.__file__).resolve().parent != tree:
        raise SystemExit(f"imported {cs.__file__}, not the tree {tree}")
    if not torch.cuda.is_available():
        print("warm_p50_compare: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cs.cuda_groupby.build()
    workloads = cs.build_workloads(args.ssb_scale, args.tpch_scale)
    # a tree with a result cache turns it off: every run executes
    flags = {f.name for f in dataclasses.fields(SessionConfig)}
    cfg = {"result_cache_entries": 0} if "result_cache_entries" in flags else {}
    ctxs = {w: TPUOlapContext(SessionConfig(**cfg), device=device) for w in ("ssb", "tpch")}
    cs.run_main_path({w: c.engine for w, c in ctxs.items()}, workloads, args.warm)
    cs.register_sql(ctxs, workloads)
    cs.run_sql_path(ctxs, workloads, args.pairs)
    cs.run_arena_queries(ctxs, workloads, warm=args.arena_warm)
    return 0


def summarize(lines) -> dict:
    """The comparison from the prefixed phase lines: per query and p50
    field, every run's p50 by tree, and the second tree's median over the
    first's."""
    labels = []
    runs = {}  # (phase, query, field) -> label -> [p50 per run]
    for ln in lines:
        if not ln.startswith("[") or "] {" not in ln:
            continue
        label, text = ln[1:].split("] ", 1)
        if label not in labels:
            labels.append(label)
        row = json.loads(text)
        for field in P50_FIELDS.get(row.get("phase"), ()):
            if row.get(field) is not None:
                key = (row["phase"], row["query"], field)
                runs.setdefault(key, {}).setdefault(label, []).append(row[field])
    base, other = labels[0], labels[-1] if len(labels) < 2 else labels[1]
    out = []
    for (phase, query, field), by in runs.items():
        row = {"phase": phase, "query": query, "field": field, "p50_ms": by}
        if base != other and base in by and other in by:
            row["ratio"] = statistics.median(by[other]) / statistics.median(by[base])
        out.append(row)
    ratios = sorted(r["ratio"] for r in out if "ratio" in r)
    return {"trees": labels, "ratio_of": [other, base], "queries": out,
            "ratio_median": statistics.median(ratios) if ratios else None,
            "ratio_min": ratios[0] if ratios else None,
            "ratio_max": ratios[-1] if ratios else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout's root; repeat it, in the order to run")
    ap.add_argument("--ssb-scale", type=float, default=10.0)
    ap.add_argument("--tpch-scale", type=float, default=1.0)
    ap.add_argument("--warm", type=int, default=3, help="phase 4's warm runs")
    ap.add_argument("--pairs", type=int, default=4, help="phase 6's SQL/native pairs")
    ap.add_argument("--arena-warm", type=int, default=3, help="phase 9's runs each way")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--summarize", metavar="LOG", help="summarize a saved output")
    args = ap.parse_args(argv)
    if args.child:
        return child(args)
    if args.summarize:
        print(json.dumps(summarize(Path(args.summarize).read_text().splitlines())))
        return 0
    if not args.tree:
        ap.error("give at least one --tree")
    common = ["--ssb-scale", str(args.ssb_scale), "--tpch-scale", str(args.tpch_scale),
              "--warm", str(args.warm), "--pairs", str(args.pairs),
              "--arena-warm", str(args.arena_warm)]
    lines = []
    for tree in args.tree:
        label = str(Path(tree))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", tree,
                               *common], capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"warm_p50_compare: {tree} exited {proc.returncode}", file=sys.stderr)
            return 1
        for ln in proc.stdout.splitlines():
            lines.append(f"[{label}] {ln}")
            print(lines[-1])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    print(json.dumps(summarize(lines)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
