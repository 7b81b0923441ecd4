"""Helpers the span readers share (not a metric: no entry names it)."""

from olapbench.trace import walk


def mean_per_request(run, names):
    """Mean over the window's traced requests of the summed length (ms) of
    their spans named in `names`.  None where no request was traced."""
    totals = [sum(s.ms for s in walk(root) if s.name in names) for _, root in run.traced()]
    return sum(totals) / len(totals) if totals else None
