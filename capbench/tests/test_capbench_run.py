"""Each traffic kind runs end to end at a toy size on the CPU (the
``--rehearse`` flag), its last line has the result line's shape, the
measuring path refuses to run without a card, a run with its timed path
broken comes out not correct, and the control reads above a limit."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from capbench import core, run  # noqa: E402

CELLS = sorted(p.stem for p in (core.HERE / "workloads").glob("*.json"))
RUN = [sys.executable, "capbench/run.py"]


def last_line(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_line_has_the_result_shape(cell, trace):
    proc = subprocess.run(
        RUN + ["--workload", cell, "--seed", str(2**31 + 5), "--seconds",
               "1", "--trace", str(trace), "--rehearse"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = last_line(proc.stdout)
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert dev["platform"] == "cpu" and line["metrics"] == {}
    w = core.workload(cell)
    got = set(line["rehearsal_metrics"])
    if trace:
        # the CPU has no device trace: the span and host readers answer
        assert got and got <= set(core.metrics_for(w))
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == set(w["end_to_end"]) | {"setup_s"}
    for name, c in line["checks"].items():
        assert c["limit"] == w["limits"][name] and c["value"] <= c["limit"]
    tail = proc.stderr.strip().splitlines()
    assert any(l.startswith("check ") for l in tail[-len(line["checks"]) - 1:])


@pytest.mark.parametrize("cell", CELLS[:1])
def test_measuring_path_refuses_without_a_card(cell):
    proc = subprocess.run(
        RUN + ["--workload", cell, "--seed", "1", "--seconds", "1",
               "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_a_checkout_without_the_program_refuses(tmp_path):
    shutil.copytree(ROOT / "capbench", tmp_path / "capbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if (ROOT / "BENCHMARK.json").is_file():
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        RUN + ["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
               "--trace", "0", "--rehearse"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert not any(l.startswith("{") for l in proc.stdout.splitlines())


# ----------------------------------------------------------------------
# the timed path broken underneath: the check must come out false
# ----------------------------------------------------------------------
def rehearse(cell, capsys, seconds="1"):
    run.main(["--workload", cell, "--seed", "77", "--seconds", seconds,
              "--trace", "0", "--rehearse"])
    return last_line(capsys.readouterr().out)


def serve_cell():
    return next(c for c in CELLS
                if core.workload(c)["traffic"] == "serve_open_loop")


def batch_cell(method="greedy"):
    return next(c for c in CELLS
                if core.workload(c)["traffic"] == "batch_closed_loop"
                and core.workload(c)["params"]["method"] == method)


def train_cell():
    return next(c for c in CELLS
                if core.workload(c)["traffic"] == "train_steps")


def test_a_served_token_altered_is_caught(monkeypatch, capsys):
    from mit_tpu_torch.decode import service

    finish = service.CaptionService._finish

    def altered(self, slot):
        row = self.tokens[slot]
        row[1] = (row[1] + 1) % self.cfg.vocab_size
        return finish(self, slot)

    monkeypatch.setattr(service.CaptionService, "_finish", altered)
    line = rehearse(serve_cell(), capsys)
    assert line["correct"] is False


def test_a_batch_token_altered_is_caught(monkeypatch, capsys):
    from mit_tpu_torch.decode import api

    generate = api.Captioner.generate_from_memory

    def altered(self, *a, **k):
        out = generate(self, *a, **k)
        v = self.mcfg.decoder.vocab_size
        return [[t[0], (t[1] + 1) % v] + t[2:] for t in out]

    monkeypatch.setattr(api.Captioner, "generate_from_memory", altered)
    line = rehearse(batch_cell(), capsys)
    assert line["correct"] is False


def test_greedy_decoding_in_place_of_the_beam_is_caught(monkeypatch, capsys):
    """Every greedy token is among a beam search's best, so only the
    captions' totals against the reference's own beam search tell a
    greedy decode from a beam search."""
    from mit_tpu_torch.decode import api

    generate = api.Captioner.generate_from_memory

    def greedy(self, *a, **k):
        return generate(self, *a, **dict(k, method="greedy"))

    monkeypatch.setattr(api.Captioner, "generate_from_memory", greedy)
    line = rehearse(batch_cell("beam"), capsys)
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["max_logit_gap"]["value"] <= checks["max_logit_gap"]["limit"]
    assert any(c["value"] > c["limit"] for k, c in checks.items()
               if k.startswith("beam_score"))


def test_a_stale_batch_in_the_window_is_caught(monkeypatch, capsys):
    """A step that, once warmed up, goes on training on the batch it first
    saw in the window passes the set-up's check; the check after the
    window catches it."""
    from mit_tpu_torch.train import steps

    make = steps.make_train_step

    def stale(*a, **k):
        step, seen = make(*a, **k), []

        def run(state, frz, batch, seed):
            seen.append(batch)
            use = seen[3] if len(seen) > 3 else batch
            return step(state, frz, use, seed)
        return run

    monkeypatch.setattr(steps, "make_train_step", stale)
    line = rehearse(train_cell(), capsys)
    assert line["correct"] is False
    checks = line["checks"]
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if not k.startswith("end_"))


def test_a_train_step_that_keeps_its_state_is_caught(monkeypatch, capsys):
    from mit_tpu_torch.train import steps

    make = steps.make_train_step

    def frozen(*a, **k):
        step = make(*a, **k)
        return lambda state, frz, batch, seed: (
            state._replace(step=state.step + 1),
            step(state, frz, batch, seed)[1])

    monkeypatch.setattr(steps, "make_train_step", frozen)
    line = rehearse(train_cell(), capsys)
    assert line["correct"] is False
    assert line["checks"]["param_change_norm_gap"]["value"] > 0.99


def test_a_train_step_over_half_its_batch_is_caught(monkeypatch, capsys):
    from mit_tpu_torch.train import steps

    make = steps.make_train_step

    def halved(*a, **k):
        step = make(*a, **k)

        def run_half(state, frz, batch, seed):
            n = batch["decoder_input_tokens"].shape[0] // 2
            return step(state, frz, {k: v[:n] for k, v in batch.items()},
                        seed)
        return run_half

    monkeypatch.setattr(steps, "make_train_step", halved)
    line = rehearse(train_cell(), capsys)
    assert line["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_above_the_program(cell, capsys):
    """The reference in the program's place at fp8, the precision below
    the configuration's bf16, reads above the program on the cell's
    numbers. At this toy size the program runs in f32 and reads about 0;
    a training cell's control fails its limits here too, while a served
    cell's toy decoder flips too few tokens to reach the limits set at
    the cell's own size (their readings on the chip are in PERF.md)."""
    from capbench import readings

    readings.main(["--workload", cell, "--seeds", "3", "4", "5",
                   "--seconds", "2", "--control", "--rehearse"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    limits = core.workload(cell)["limits"]
    above = [any(line["control"][k] > line["program"][k] + 1e-3
                 for k in limits) for line in lines]
    assert sum(above) >= 2, lines
    for line in lines:
        assert all(line["program"][k] <= limits[k] for k in limits), line
    if core.workload(cell)["traffic"] == "train_steps":
        assert all(any(line["control"][k] > limits[k] for k in limits)
                   for line in lines), lines
