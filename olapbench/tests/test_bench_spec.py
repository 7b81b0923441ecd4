"""BENCHMARK.json against the contract's form, and every cell, configuration,
mix, query and metric reader found by name from files."""

import json
import os
import re

import pytest

from olapbench import spec
from olapbench.tests.conftest import CELLS
from olapbench.tests.conftest import cell as bench_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    from olapbench.tests.conftest import ROOT

    return spec.benchmark(ROOT)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert bench["paths"] == ["olapbench"]
    assert len(bench["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_use_allowed_characters(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for e in bench[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("config", "traffic"):
            if k in e:
                assert NAME.match(e[k]), e[k]
        for k in e.get("reduced", ()):
            assert NAME.match(k), k
        for k in ("why", "layer") + (("source",) if section == "configs" else ()):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k], (k, e[k])


def test_metric_sources_and_bounds(bench):
    names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in names
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_moves_names_an_end_to_end_metric_each_of_its_cells_reports(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for c in m.get("workloads", cells):
            assert c in cells, (m["name"], c)
            assert c in e2e[m["moves"]], (m["name"], c)


@pytest.mark.parametrize("cell", CELLS)
def test_cells_are_found_by_name(root, cell):
    c = bench_cell(cell, root)
    assert c.chips == 1
    assert c.mix["clients"] >= 1 and c.mix["loop"] == "closed"
    assert {r["query"] for r in c.mix["requests"]} == set(c.queries)
    ref = c.reference_module()
    for name, q in c.queries.items():
        assert name in ref.QUERIES
        assert set(q["columns"]) <= set(c.config["column_bytes"])
        assert any(f in q for f in ("native", "sql"))
    for r in c.mix["requests"]:
        for form in r["forms"]:
            assert form in c.queries[r["query"]]
    assert c.data_module().generate is not None
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


def test_every_config_file_is_its_own_and_names_its_source(bench, root):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith("olapbench/")
        doc = spec.load_json(os.path.join(root, c["file"]))
        assert doc["source"] == c["source"]
        for k in ("family", "scale_factor", "session", "limits", "star_schema", "column_bytes"):
            assert k in doc, (c["name"], k)
        used = [w for w in bench["workloads"] if w["config"] == c["name"]]
        assert used, c["name"]


@pytest.mark.parametrize("metric", ["queue_ms", "wire_ms", "plan_ms", "dispatches_per_query",
                                    "finalize_ms", "scan_roofline_pct",
                                    "device_idle_pct"])
def test_every_per_layer_metric_has_its_reader(bench, metric):
    assert metric in {m["name"] for m in bench["per_layer"]}
    assert callable(spec.metric_reader(metric))


def test_a_new_cell_needs_only_new_files_and_an_entry(tmp_path, root, bench):
    """A mix added as a file and a `workloads` entry: found with no edit."""
    import shutil

    shutil.copytree(os.path.join(root, "olapbench"), tmp_path / "olapbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = {"loop": "closed", "clients": 8, "think_ms": 0, "requests": [
        {"query": q, "forms": ["sql"]} for q in ("q1", "q6", "q14")]}
    (tmp_path / "olapbench" / "mixes" / "pricing.json").write_text(json.dumps(mix))
    b = json.loads(json.dumps(bench))
    b["workloads"].append({"name": "tpch_sf10.pricing", "config": "tpch_sf10",
                           "traffic": "pricing", "chips": 1, "why": "the pricing reports alone"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    c = spec.cell(str(tmp_path), "tpch_sf10.pricing")
    assert set(c.queries) == {"q1", "q6", "q14"}
