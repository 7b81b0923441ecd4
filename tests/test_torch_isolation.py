"""The PyTorch port stands alone: neither the package nor its scripts
(`chip_smoke.py`, `quantile_rank_sweep.py`) import JAX or anything of the
JAX package.

A subprocess imports every module of the port and the scripts' helpers
and checks what that added to `sys.modules`; an AST scan checks
every import statement, including the ones inside functions.  The native
CSV decoder decodes a file in a subprocess that maps the port's own
library alone.
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import spark_druid_olap_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "spark_druid_olap_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "spark_druid_olap_tpu")
SCRIPTS = ("chip_smoke", "quantile_rank_sweep")


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            spark_druid_olap_tpu_torch.__path__, "spark_druid_olap_tpu_torch."
        )
    )


def _is_forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    mods = _port_modules() + list(SCRIPTS)
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('\\n'.join(sorted(set(sys.modules) - before)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, check=True,
    ).stdout.split()
    assert {
        f"spark_druid_olap_tpu_torch.{m}"
        for m in ("exec.engine", "exec.adaptive_exec", "exec.sparse_exec",
                  "ops.sparse_groupby", "plan.cost", "exec.streaming",
                  "exec.pipeline", "exec.fallback", "exec.arena",
                  "ingest", "ingest.shard", "ingest.delta", "ingest.compact",
                  "ingest.wal", "catalog.persist", "storage", "obs.telemetry",
                  "config", "plan.calibrate", "plan.planner", "parallel.mesh",
                  "parallel.distributed", "parallel.spmd_arena", "parallel.multihost",
                  "cluster", "cluster.wire", "cluster.assignment", "cluster.historical",
                  "cluster.broker", "cluster.federation", "native", "native.csv_decode")
    } <= set(out)
    assert set(SCRIPTS) <= set(out)
    assert [m for m in out if _is_forbidden(m)] == []


def test_no_import_statement_names_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / f"{s}.py" for s in SCRIPTS]
    assert len(files) > 20
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                # relative imports stay inside the port
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {n}" for n in names if _is_forbidden(n)]
    assert bad == []


def test_native_decoder_loads_its_own_library(tmp_path):
    """The port's CSV decoder is built from the port's own source into
    `build/native/` and loaded from there: the JAX package's library is
    never mapped, nor its package imported."""
    csv = tmp_path / "t.csv"
    csv.write_text("a,b\nx,1\ny,2\n")
    code = (
        "import sys\n"
        "from spark_druid_olap_tpu_torch.native import _SRC, csv_decode, load\n"
        f"cols, dicts = csv_decode.read_csv_encoded({str(csv)!r})\n"
        "assert list(cols['b']) == [1, 2] and dicts['a'].values == ('x', 'y')\n"
        "maps = [l.split()[-1] for l in open('/proc/self/maps') if l.rstrip().endswith('.so')]\n"
        "print(load()._name)\n"
        "print(_SRC)\n"
        "print('\\n'.join(m for m in maps if 'olap_native' in m))\n"
        "print('\\n'.join(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True,
    ).stdout.split()
    lib, src, mapped = out[0], out[1], out[2:]
    assert lib.startswith(str(ROOT / "build" / "native" / "olap_native_"))
    assert src == str(PKG / "native" / "olap_native.cc")
    assert set(mapped) == {lib}  # no other olap_native library, no forbidden module
