"""finalize_ms: mean `finalize` span per request of the window
(exec/finalize, api._post_process)."""

from olapbench.metrics._spans import mean_per_request


def read(run):
    return mean_per_request(run, {"finalize"})
