"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the program either. Names are compared by
their top-level part whole, so ``repro_torch`` is not ``repro``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

RUN_ALL = """
import sys, time
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
from pathlib import Path
from mgitbench import harness
from tiny import tiny_run, drive
bench = harness.load_json(Path({root!r}) / "BENCHMARK.json")
for cell in [w["name"] for w in bench["workloads"]]:
    for trace in (False, True):
        run = drive(tiny_run(cell, seconds=0.3, trace=trace))
        harness.result(run, bench)
print(harness.forbidden_modules())
"""

REFERENCES = """
import sys, json
sys.path[:0] = [{root!r}]
import mgitbench.reference.algorithm1, mgitbench.reference.model
import mgitbench.families.dense, mgitbench.families.ssm
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_of_every_cell_loads_no_jax():
    code = RUN_ALL.format(src=str(ROOT / "src"), root=str(ROOT),
                          tests=str(HERE / "tests"))
    assert _python(code) == "[]"


def test_references_load_nothing_of_the_program():
    top = set(json.loads(_python(REFERENCES.format(root=str(ROOT)))))
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_sources_import_no_jax_and_no_old_benchmarks(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    if "reference" in path.parts or "families" in path.parts:
        assert "repro_torch" not in tops
