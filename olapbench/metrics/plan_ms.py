"""plan_ms: mean `plan` span per request of the window (sql/parser,
plan/planner and the context's plan cache); a native request plans
nothing and counts 0."""

from olapbench.metrics._spans import mean_per_request


def read(run):
    return mean_per_request(run, {"plan"})
