"""Nothing the harness runs loads JAX or the JAX package, the reference
loads nothing of the program, and no harness file reads the JAX-era
harness or its records."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.run import FORBIDDEN, ROOT

BENCH = ROOT / "benchmark"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "leccr_torch" not in _top_level_imports(path)
    assert {n for n in _top_level_imports(path)} <= {
        "__future__", "dataclasses", "math", "re", "typing", "torch", "numpy",
        "benchmark"}


def test_no_harness_file_reads_the_jax_era_harness():
    for path in SOURCES:
        text = path.read_text()
        for name in ("bench.py", "chip_smoke", "BENCH_r", "BASELINE",
                     "bench_baseline"):
            assert name not in text, (path, name)


def test_a_dry_set_up_loads_no_jax():
    """A whole CPU run in a fresh process leaves no forbidden module in
    sys.modules (compared by top-level name)."""
    code = (
        "import sys, json\n"
        "from benchmark.tests.conftest import tiny_meta\n"
        "from leccr_torch.config import LECCRConfig\n"
        "from benchmark.run import run_cell, FORBIDDEN\n"
        "meta = tiny_meta()\n"
        "cfg = LECCRConfig.from_dict(meta['config'])\n"
        "for cell in ('flagship.train', 'flagship.eval'):\n"
        "    run_cell(cell, 3, 0.2, False, device='cpu', cfg_override=cfg,\n"
        "             meta_override=meta, watchdog=False)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & set(FORBIDDEN)
    assert "leccr_torch" in loaded
