"""queue_ms: mean time a request waits for admission, per request of the
window: its `admission` and `lane` spans (server._Handler, resilience.
AdmissionController, serve/lanes)."""

from olapbench.metrics._spans import mean_per_request


def read(run):
    return mean_per_request(run, {"admission", "lane"})
