"""scan_roofline_pct: the least time the card could take for the scans of
the requests completed in the profiled interval (the traced run's burst,
after the window), as a share of the device's busy time over that
interval.

Bytes: for each such request, every fact column its query reads
(`columns` of its query file), once over its in-scope rows (the rows its
own predicate on the fact's date selects, counted by the reference from
the data), at the column's width in the configuration's `column_bytes`
(the narrowest whole bytes its schema needs), plus its result written
once, 4 bytes a cell.  The least time is those bytes at the H100's
published HBM rate (olapbench/peaks.py).  The work the queries need,
whatever implements it."""

from olapbench.peaks import HBM_BYTES_PER_S


def read(run):
    p = run.profile
    if p is None or p.busy_s <= 0:
        return None
    widths = run.cell.config["column_bytes"]
    nbytes = 0
    for r in run.profiled:
        if not (r.ok and p.t0 <= r.t_end <= p.t1):
            continue
        cols = run.cell.queries[r.kind]["columns"]
        nbytes += run.in_scope_rows[r.kind] * sum(widths[c] for c in cols)
        nbytes += 4 * run.result_cells[r.kind]
    if nbytes == 0:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / p.busy_s
