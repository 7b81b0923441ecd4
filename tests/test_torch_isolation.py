"""The PyTorch port stands alone: neither the package nor its scripts
(`chip_smoke.py`, `quantile_rank_sweep.py`) import JAX or anything of the
JAX package.

A subprocess imports every module of the port and the scripts' helpers
and checks what that added to `sys.modules`; an AST scan checks
every import statement, including the ones inside functions.
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
    assert "spark_druid_olap_tpu_torch.exec.engine" in out
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
