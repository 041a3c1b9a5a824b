"""``program_spans`` reads the program's ``mit.*`` spans and the device work
they launched from a profiler's Chrome trace; the program's spans move no
metric the benchmark already has; a traced rehearsal's profiled stretch
holds the program's spans.

``program_spans.trace.json`` is a synthetic trace of one profiled stretch
(``capbench.window``, 10 ms): an encode and a 4-step decode of one batch,
then two train steps whose backward launches from a second host thread,
with the benchmark's own spans, launch calls and device operations tied by
their correlations, and ``mit.*`` spans across the stretch's start and
after its end (left out).
"""

import json
import math
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from capbench import core, program_spans  # noqa: E402

TRACE = Path(__file__).resolve().parent / "program_spans.trace.json"
CELLS = sorted(p.stem for p in (core.HERE / "workloads").glob("*.json"))

# the per-layer metrics the benchmark had before the program had spans
EXISTING = (
    "batch.attention_roofline", "batch.decode_ms", "batch.encode_ms",
    "batch.idle_share", "batch.mfu", "batch.preprocess_ms",
    "beam.attention_roofline", "beam.decode_ms", "beam.encode_ms",
    "beam.idle_share", "beam.mfu", "beam.preprocess_ms",
    "serve.decode_layer_roofline", "serve.encode_ms", "serve.idle_share",
    "serve.mfu", "serve.window_ms", "train.dropout_attention_roofline",
    "train.idle_share", "train.mfu", "train.step_device_ms",
)


# the readings of the ten per-layer metrics in the synthetic trace
KNOWN = {"decode_step_host_us": 500.0, "decode_idle_share": 48.0,
         "reorder_device_us": 40.0, "encode_device_ms": 0.65,
         "forward_host_ms": 0.6, "backward_host_ms": 1.15,
         "optimizer_host_ms": 0.6, "optimizer_launches": 3.0}


@pytest.mark.parametrize("name", sorted(program_spans.READINGS))
def test_each_reading_takes_its_known_value(name):
    got = program_spans.READINGS[name](program_spans.read(str(TRACE)))
    assert got == pytest.approx(KNOWN[name], rel=1e-12)


def test_spans_outside_the_stretch_and_other_threads():
    s = program_spans.read(str(TRACE))
    # the encode across the stretch's start and the loop after its end
    assert len(s.of("mit.encode")) == len(s.of("mit.decode.loop")) == 1
    # the backward's four launches came from autograd's thread
    assert s.device("mit.train.backward") == (4, 200.0)
    # nested at any depth: the decode holds its steps' and readback's work
    assert s.device("mit.decode")[0] == 1 + 4 * 4 + 1
    assert s.count_inside("mit.decode.step", "mit.decode") == 4
    assert s.count_inside("mit.decode.step", "mit.train.forward") == 0


def stripped(tmp_path) -> str:
    """The trace without the program's spans."""
    events = json.loads(TRACE.read_text())
    events["traceEvents"] = [e for e in events["traceEvents"]
                             if not e.get("name", "").startswith("mit.")]
    path = tmp_path / "stripped.pt.trace.json"
    path.write_text(json.dumps(events))
    return str(path)


def test_a_trace_without_the_programs_spans_reads_as_empty(tmp_path):
    s = program_spans.read(stripped(tmp_path))
    assert s.spans == [] and s.device("mit.encode") == (0, 0.0)
    assert all(v is None for v in program_spans.summary(s)["readings"]
               .values())


def readings(path: str, cell: dict):
    """``core.Readings`` of a traced run whose profiled stretch is the
    trace, with the benchmark's own spans and counters of such a run."""
    tr = core.read_trace(path)
    busy_s, gaps = core.busy_and_gaps(tr)
    rec = core.Recorder(True, lambda: None)
    for name, s in (("batch.preprocess", 1e-3), ("batch.encode", 1e-3),
                    ("batch.decode", 3e-3), ("serve.encode", 2e-3),
                    ("serve.window", 4e-3)):
        rec.spans[name].append(s)
    rec.profiled.update({"batch.flops": 2e9, "train.flops": 1e9,
                         "train.steps": 2, "serve.encode_flops": 1e9,
                         "serve.decode_flops": 1e9,
                         "serve.decode_layer_bound_ms": 0.1})
    window_s = (tr["window"][1] - tr["window"][0]) * 1e-6
    return core.Readings(cell, core.config(cell["config"]), rec,
                         tr["kernels"], busy_s, window_s), tr, gaps


@pytest.mark.parametrize("name", EXISTING)
def test_existing_metrics_read_the_same_with_the_programs_spans(name,
                                                                tmp_path):
    mod = core.metric(name)
    cell = core.workload(next(c for c in CELLS if core.workload(c)["traffic"]
                              in mod.TRAFFIC))
    with_spans = mod.read(readings(str(TRACE), cell)[0])
    without = mod.read(readings(stripped(tmp_path), cell)[0])
    assert with_spans is not None and math.isfinite(with_spans)
    assert with_spans == without


def test_idle_gaps_name_the_programs_spans(tmp_path):
    """The same device operations and idle seconds either way; with the
    program's spans the innermost label of a decode's gap is one of them."""
    cell = core.workload(CELLS[0])
    out = {}
    for key, path in (("with", str(TRACE)), ("without", stripped(tmp_path))):
        _, tr, gaps = readings(path, cell)
        out[key] = core.breakdown(tr, gaps, top=100)
    assert out["with"]["device_ops"] == out["without"]["device_ops"]
    idle = {k: sum(v for _, v in b["idle_gaps"]) for k, b in out.items()}
    assert idle["with"] == pytest.approx(idle["without"], rel=1e-12)
    labels = {k: {n.split(" / ")[0] for n, _ in b["idle_gaps"]}
              for k, b in out.items()}
    assert {"mit.decode.sync", "mit.decode.reorder", "mit.train.backward",
            "mit.train.optimizer"} <= labels["with"]
    assert not any(n.startswith("mit.") for n in labels["without"])


@pytest.mark.parametrize("cell", [c for c in CELLS if core.workload(c)[
    "traffic"] in ("batch_closed_loop", "train_steps")])
def test_a_traced_rehearsal_profiles_the_programs_spans(cell, capsys):
    """A CPU rehearsal with ``--trace 1`` through this file: the line is
    printed as ``run.py`` prints it, and the profiled stretch holds the
    program's spans (host readings; the CPU runs no device operation, so
    the device readings are absent)."""
    read_trace = core.read_trace
    assert program_spans.main([
        "--workload", cell, "--seed", str(2**31 + 9), "--seconds", "1",
        "--trace", "1", "--rehearse"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["rehearsal"] is True
    assert core.read_trace is read_trace
    found = json.loads(next(l for l in err.splitlines()
                            if l.startswith("SPANS "))[6:])
    got, spans = found["readings"], found["spans"]
    for name in ("reorder_device_us", "encode_device_ms",
                 "decode_idle_share", "optimizer_launches"):
        assert got[name] is None
    if core.workload(cell)["traffic"] == "train_steps":
        assert all(got[n] > 0 for n in ("forward_host_ms",
                                        "backward_host_ms",
                                        "optimizer_host_ms"))
    else:
        assert got["decode_step_host_us"] > 0 and spans["mit.encode"]["n"]
        assert spans["mit.decode.sync"]["n"] >= \
            spans["mit.decode.step"]["n"] > 0
        if core.workload(cell)["params"]["method"] == "beam":
            assert spans["mit.decode.reorder"]["n"] == \
                spans["mit.decode.step"]["n"]
