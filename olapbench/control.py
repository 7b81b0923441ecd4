"""The control of `correct`: the reference put in the program's place,
computed over metrics rounded to bfloat16 (the nearest precision below the
float32 the configurations state), and judged as a served answer is.

    python3 -m olapbench.control --workload <cell> --seeds 1,2,3

For each seed it draws the cell's data at the cell's own size, answers
every request kind of the mix with the control, and prints per seed the
numbers the run compares (`mismatched_answers`, `max_rel_err`); a limit
that the control does not fail is no limit.  No program is started: the
control stands where its answers would be."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def as_served(exp) -> bytes:
    """An expected answer as SQL's row objects, in the query's order (and
    cut to its top rows): what a server answering these numbers would send."""
    rows = list(exp.rows)
    for col, desc in reversed(exp.order):
        rows.sort(key=lambda r: r[col], reverse=desc)
    if exp.top is not None:
        rows = rows[:exp.top]
    return json.dumps(rows).encode()


def control_numbers(cell, star, device, metric_dtype) -> dict:
    """The compared numbers of the control's answers to every kind of the
    cell's mix."""
    from olapbench.compare import Judgement, judge

    reference = cell.reference_module()
    j = Judgement()
    for name in cell.queries:
        want = reference.expected(star, name, device)
        got = reference.expected(star, name, device, metric_dtype)
        judge(name, as_served(got), want, j)
    return {"mismatched_answers": j.mismatched, "max_rel_err": j.max_rel_err,
            "first_fault": j.first_fault}


def main(argv=None) -> int:
    import torch

    from olapbench import spec

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    cell = spec.cell(os.getcwd(), args.workload)
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        star = cell.data_module().generate(float(cell.config["scale_factor"]), seed, device)
        out = control_numbers(cell, star, device, torch.bfloat16)
        out.update(workload=args.workload, seed=seed, control="bfloat16 metrics",
                   seconds=time.perf_counter() - t)
        print(json.dumps(out), flush=True)
        del star
    return 0


if __name__ == "__main__":
    sys.exit(main())
