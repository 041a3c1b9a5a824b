"""Nothing the benchmark runs imports the JAX stack or the JAX package
(compared by whole top-level module name: the port's name begins with the
JAX package's), and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from capbench import core  # noqa: E402

CELLS = sorted(p.stem for p in (core.HERE / "workloads").glob("*.json"))

# a whole rehearsal of the cell in a fresh interpreter, then the top-level
# names of every module it loaded
PROBE = """
import contextlib, io, json, sys
sys.path.insert(0, {root!r})
from capbench import run
with contextlib.redirect_stdout(io.StringIO()):
    run.main(["--workload", {cell!r}, "--seed", "3", "--seconds", "1",
              "--trace", "1", "--rehearse"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax_and_not_the_jax_package(cell):
    proc = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), cell=cell)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "mit_tpu_torch" in top                 # the program did run
    assert not top & {"jax", "jaxlib", "flax", "mit_tpu"}, \
        sorted(top & {"jax", "jaxlib", "flax", "mit_tpu"})


def test_the_reference_loads_nothing_of_the_program():
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
         "import capbench.reference.model, capbench.reference.dropout; "
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    top = set(proc.stdout.split())
    assert not top & {"mit_tpu_torch", "mit_tpu", "jax"}


@pytest.mark.parametrize(
    "path", sorted((core.HERE / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_sources_import_only_the_reference(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("mit_tpu_torch", "mit_tpu", "jax", "jaxlib",
                               "flax"), (path.name, n)
            if top == "capbench":
                assert n.startswith("capbench.reference"), (path.name, n)
