"""dispatches_per_query: mean count of `segment_dispatch` spans (a graph
replay or an eager segment loop: exec/engine, exec/lowering, exec/arena)
per request of the window."""

from olapbench.trace import walk


def read(run):
    counts = [sum(1 for s in walk(root) if s.name == "segment_dispatch")
              for _, root in run.traced()]
    return sum(counts) / len(counts) if counts else None
