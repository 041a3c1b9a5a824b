"""The benchmark's files agree with each other, and a new cell,
configuration, traffic kind or per-layer metric is found by adding files
alone."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from capbench import core  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = sorted(p.stem for p in (core.HERE / "workloads").glob("*.json"))
KINDS = sorted(p.stem for p in (core.HERE / "traffic").glob("*.py"))


def bench():
    path = ROOT / "BENCHMARK.json"
    return core.load_json(path) if path.is_file() else None


@pytest.mark.parametrize("cell", CELLS)
def test_workload_names_what_exists(cell):
    w = core.workload(cell)
    assert NAME.match(cell)
    assert (core.HERE / "configs" / f"{w['config']}.json").is_file()
    assert w["traffic"] in KINDS
    assert w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    kind = core.traffic(w["traffic"])
    for name in w["end_to_end"]:
        assert name in kind.PRODUCES and UNIT.match(kind.PRODUCES[name])
    assert set(w["limits"]) and all(v > 0 for v in w["limits"].values())
    assert core.metrics_for(w), "no per-layer metric reads it"


@pytest.mark.parametrize("name", core.metric_names())
def test_metric_file_reads_a_traffic_kind_that_exists(name):
    mod = core.metric(name)
    assert NAME.match(name) and UNIT.match(mod.UNIT)
    assert mod.TRAFFIC and set(mod.TRAFFIC) <= set(KINDS)
    assert any(mod.MOVES in core.traffic(k).PRODUCES for k in mod.TRAFFIC)
    assert callable(mod.read)


def test_benchmark_json_matches_the_files():
    b = bench()
    if b is None:
        pytest.skip("no BENCHMARK.json in this tree")
    assert b["paths"] == ["capbench"]
    assert b["command"] == ["python3", "capbench/run.py"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"capbench/configs/{c['name']}.json"
        assert c["reduced"] == core.config(c["name"])["reduced"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for cell in b["workloads"]:
        w = core.workload(cell["name"])
        assert cell["config"] == w["config"] in configs
        assert cell["traffic"] == w["traffic"] and cell["chips"] == w["chips"]
        assert cell["why"] == w["why"]
        for name, m in e2e.items():
            if name == "setup_s":
                continue
            listed = cell["name"] in m.get("workloads", [cell["name"]])
            assert listed == (name in w["end_to_end"]), (cell, name)
        assert set(w["end_to_end"]) <= set(e2e)
    for m in b["per_layer"]:
        mod = core.metric(m["name"])
        assert m["unit"] == mod.UNIT and m["moves"] == mod.MOVES in e2e
        reads = {c["name"] for c in b["workloads"]
                 if m["name"] in core.metrics_for(core.workload(c["name"]))}
        assert set(m["workloads"]) == reads, m["name"]
    for m in list(b["end_to_end"]) + list(b["per_layer"]):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


NEW_METRIC = '''"""Batches of the throwaway traffic kind, counted."""

TRAFFIC = ("batch_again",)
MOVES = "captions_per_s"
UNIT = "batches"


def read(r):
    return r.counts.get("batch.batches")
'''


def test_new_files_alone_add_a_cell(tmp_path):
    """A copy of the checkout gains a configuration, a traffic kind, a cell
    and a per-layer metric as four new files, and a rehearsal of the new
    cell finds and reports them all."""
    ignore = shutil.ignore_patterns("__pycache__", "_build", "*.so")
    for d in ("capbench", "mit_tpu_torch"):
        shutil.copytree(ROOT / d, tmp_path / d, ignore=ignore)
    cb = tmp_path / "capbench"
    cfg = json.loads((cb / "configs" / "vitb16-dec6x512.json").read_text())
    (cb / "configs" / "toy-again.json").write_text(json.dumps(cfg))
    shutil.copy(cb / "traffic" / "batch_closed_loop.py",
                cb / "traffic" / "batch_again.py")
    cell = json.loads((cb / "workloads" / "clipl14.batch64-greedy.json")
                      .read_text())
    cell.update(config="toy-again", traffic="batch_again")
    (cb / "workloads" / "toy.again.json").write_text(json.dumps(cell))
    (cb / "metrics" / "again.batches.py").write_text(NEW_METRIC)
    before = {p: p.read_bytes() for p in cb.rglob("*") if p.is_file()
              and p.name not in ("toy-again.json", "batch_again.py",
                                 "toy.again.json", "again.batches.py")}
    proc = subprocess.run(
        [sys.executable, "capbench/run.py", "--workload", "toy.again",
         "--seed", "5", "--seconds", "1", "--trace", "1", "--rehearse"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["rehearsal_metrics"]["again.batches"] >= 1
    assert all(p.read_bytes() == b for p, b in before.items())
