"""The benchmark's own tests: the CPU at a tiny scale, run from the
checkout's root with `python -m pytest olapbench/tests`.  Tests that need
the card carry the `cuda` marker and skip without one, decided in a
fixture."""

import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# a tiny scale for CPU runs: every query still has rows, several segments
TINY = {"scale_factor": 0.03, "rows_per_segment": 16384}

# cells whose files are here but which BENCHMARK.json leaves out for now
# (PERF.md, Open questions): the tests keep them working, at a tiny scale
HELD_BACK = {
    "configs": [{"name": "ssb_sf10", "file": "olapbench/configs/ssb_sf10.json"}],
    "workloads": [{"name": "ssb_sf10.flights", "config": "ssb_sf10", "traffic": "flights",
                   "chips": 1}],
}
CELLS = ["ssb_sf10.flights", "tpch_sf10.report"]


def bench_for_tests(root=ROOT):
    """BENCHMARK.json with the held-back cells put in, each reporting every
    metric that a committed cell reports."""
    from olapbench import spec

    bench = spec.benchmark(root)
    added = []
    for section, entries in HELD_BACK.items():
        names = {e["name"] for e in bench[section]}
        bench[section] += [e for e in entries if e["name"] not in names]
        added += [e["name"] for e in entries if section == "workloads" and e["name"] not in names]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + added
    return bench


def cell(name, root=ROOT):
    from olapbench import spec

    return spec.cell(root, name, bench_for_tests(root))


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
