"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the program: top-level module names compared whole (the
program's name begins with the JAX package's)."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

FORBIDDEN = {"jax", "jaxlib", "flax", "spark_druid_olap_tpu"}
PROGRAM = "spark_druid_olap_tpu_torch"
RUN = """
import json, sys
from olapbench.run import forbidden_modules, run_cell
if __name__ == "__main__":
    r = run_cell(sys.argv[1], "tpch_sf10.report", 7, 1.0, True, device="cpu",
                 overrides={"scale_factor": 0.01, "rows_per_segment": 16384})
    print(json.dumps({"correct": r["correct"], "forbidden": forbidden_modules(),
                      "tops": sorted({m.split(".", 1)[0] for m in sys.modules})}))
"""


def _fresh(code, root, *args):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env["PYTHONPATH"] = root
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_whole_run_loads_no_jax(root):
    got = _fresh(RUN, root, root)
    assert got["correct"]
    assert got["forbidden"] == []
    assert not FORBIDDEN & set(got["tops"])
    assert PROGRAM in got["tops"]  # the check compares whole names


@pytest.mark.parametrize("family", ["ssb", "tpch"])
def test_the_reference_loads_nothing_of_the_program(root, family):
    code = (f"import json, sys; import olapbench.reference.{family}; "
            "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    env = {**os.environ, "PYTHONPATH": root}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not (FORBIDDEN | {PROGRAM}) & tops


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_and_the_reference_no_program(root):
    for path in glob.glob(os.path.join(root, "olapbench", "**", "*.py"), recursive=True):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not FORBIDDEN & tops, path
        if os.sep + "reference" + os.sep in path:
            assert PROGRAM not in tops, path
            assert tops <= {"__future__", "dataclasses", "typing", "numpy", "torch"}, (path, tops)
