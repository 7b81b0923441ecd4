#!/usr/bin/env python3
"""Rank error of the port's APPROX_QUANTILE over SSB data made from several
seeds: the evidence for the bound `chip_smoke.py` phase 7 holds it to.

    python3 quantile_rank_sweep.py [--scale 10] [--seeds 1 2 3 4 5 6 7 8]
                                   [--device cuda]

For each seed: the SSB tables at `scale` (`ssb.gen_tables`), flattened into
512K-row time-sorted segments and registered into a `TPUOlapContext` as in
`chip_smoke.py`, the `quantiles` sketch query (p50 and p90 of lo_revenue by
d_year, K = 1024) through `ctx.sql`, and per fraction the largest rank error
over the groups (`ssb.quantile_rank_error`, against each group's sorted
exact values).  One JSON line per seed, then a summary line: the largest
error of each fraction over the seeds, and the seeds whose error passes
±3% in rank and the checks' four standard errors (`ssb.quantile_rank_bound`).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from spark_druid_olap_tpu_torch.api import TPUOlapContext
from spark_druid_olap_tpu_torch.workloads import ssb


def seed_errors(scale: float, seed: int, device) -> dict:
    t0 = time.perf_counter()
    tables = ssb.gen_tables(scale, seed=seed)
    cols, dicts = ssb.flat_columns(tables)
    del tables
    ctx = TPUOlapContext(device=device)
    ctx.register_datasource(ssb.datasource(cols, dicts), star_schema=ssb.STAR_SCHEMA)
    frame = ssb.coded_frame(cols, dicts)
    del cols
    got = ctx.sql(ssb.SKETCH_QUERIES["quantiles"])
    want = ssb.sketch_oracle(frame, "quantiles")
    values = dict(zip(want.d_year.astype(str), want["values"]))
    out = {"seed": seed, "groups": len(got)}
    for p, frac in ssb.QUANTILE_FRACTIONS.items():
        out[f"{p}_rank_err"] = max(
            ssb.quantile_rank_error(values[str(y)], e, frac) for y, e in zip(got.d_year, got[p])
        )
    ctx.engine.clear_cache()
    return {**out, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(1, 9)))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    device = args.device or ("cuda" if torch.cuda.is_available() else None)
    if device is None:
        raise SystemExit("quantile_rank_sweep: no CUDA device; pass --device cpu")
    rows = []
    for seed in args.seeds:
        rows.append(seed_errors(args.scale, seed, device))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"scale": args.scale, "seeds": args.seeds}
    for p, frac in ssb.QUANTILE_FRACTIONS.items():
        errs = [r[f"{p}_rank_err"] for r in rows]
        summary[p] = {
            "max_rank_err": max(errs),
            "within_3pct": sum(e <= 0.03 for e in errs),
            "bound": ssb.quantile_rank_bound(frac),
            "within_bound": sum(e <= ssb.quantile_rank_bound(frac) for e in errs),
        }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
