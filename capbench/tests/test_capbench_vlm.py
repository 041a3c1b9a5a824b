"""The vision-language cell (``vlm_batch_closed_loop``, Kimi-VL-A3B's
language model): its check catches the two routing faults and an altered
token when the program makes them, the faults planted in the reference
read above the limits, an older program without the family fails the cell
at once, and the yardstick's arithmetic and the roofline reader count what
they say."""

import functools
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from capbench import arith_vlm, core, run  # noqa: E402

CELL = next(p.stem for p in (core.HERE / "workloads").glob("*.json")
            if core.workload(p.stem)["traffic"] == "vlm_batch_closed_loop")


def rehearse(capsys, seed="77"):
    run.main(["--workload", CELL, "--seed", seed, "--seconds", "1",
              "--trace", "0", "--rehearse"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_program_as_it_is_passes(capsys):
    assert rehearse(capsys)["correct"] is True


@pytest.mark.parametrize("fault", ["no_correction_bias",
                                   "no_renormalization"])
def test_a_routing_fault_in_the_program_is_caught(fault, monkeypatch,
                                                  capsys):
    from mit_tpu_torch.ops import moe

    route = moe.moe_route

    @functools.wraps(route)
    def faulty(x, w, bias, k, scale, normalize=True):
        if fault == "no_correction_bias":
            return route(x, w, bias * 0, k, scale, normalize)
        return route(x, w, bias, k, scale, False)

    monkeypatch.setattr(moe, "moe_route", faulty)
    line = rehearse(capsys)
    assert line["correct"] is False
    assert all(c["value"] > c["limit"] for c in line["checks"].values())


def test_an_altered_token_is_caught(monkeypatch, capsys):
    from mit_tpu_torch.decode.kimi_vl import KimiVLCaptioner

    generate = KimiVLCaptioner.generate_from_memory
    v = core.config(core.workload(CELL)["config"])["rehearsal_lm"][
        "vocab_size"]

    def altered(self, *a, **k):
        out = generate(self, *a, **k)
        return [[t[0], (t[1] + 1) % v] + t[2:] for t in out]

    monkeypatch.setattr(KimiVLCaptioner, "generate_from_memory", altered)
    assert rehearse(capsys)["correct"] is False


def test_the_reference_faults_read_above_the_limits(capsys):
    from capbench import readings

    readings.main(["--workload", CELL, "--seeds", "5", "--seconds", "1",
                   "--faults", "--rehearse"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = core.workload(CELL)["limits"]
    for fault in ("no_correction_bias", "no_renormalization"):
        assert any(line[fault][k] > limits[k] for k in limits), line
    assert all(line["program"][k] <= limits[k] for k in limits)


def test_a_program_without_the_family_fails_at_once(tmp_path):
    """The parent of the family has no ``models/kimi_vl.py``: the cell
    stops with an error before it makes any weight."""
    ignore = shutil.ignore_patterns("__pycache__", "_build", "*.so")
    for d in ("capbench", "mit_tpu_torch"):
        shutil.copytree(ROOT / d, tmp_path / d, ignore=ignore)
    (tmp_path / "mit_tpu_torch" / "models" / "kimi_vl.py").unlink()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "capbench/run.py", "--workload", CELL, "--seed",
         "1", "--seconds", "1", "--trace", "0", "--rehearse"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert time.perf_counter() - t0 < 60
    assert "kimi_vl" in proc.stderr
    assert not any(l.startswith("{") for l in proc.stdout.splitlines())


# ----------------------------------------------------------------------
# the arithmetic and the roofline reader
# ----------------------------------------------------------------------
def published():
    cfg = core.config(core.workload(CELL)["config"])
    c = {k: v for k, v in cfg.items() if not isinstance(v, (dict, list))}
    c.update(merge=2, vision_width=cfg["encoder"]["hidden_size"])
    return cfg, c


def test_a_token_costs_twice_the_active_parameters():
    """A token with logits and no keys costs two operations a parameter it
    multiplies by: 2.58 B (attention 373 M, the dense layer 69 M, the
    router, six experts and the shared ones 1.80 B, ``lm_head`` 336 M), the
    published "A2.8B" less what it counts beside the products."""
    _, c = published()
    active = arith_vlm.lm_token_flops(c, 0, True) / 2
    assert 2.57e9 < active < 2.59e9
    assert arith_vlm.lm_token_flops(c, 100, False) > \
        arith_vlm.lm_token_flops(c, 1, False)


def test_the_expert_bound_is_bytes_at_decode_and_operations_at_prefill():
    decode = arith_vlm.experts_bound(384, 64, 2048, 1408)
    prefill = arith_vlm.experts_bound(30720, 64, 2048, 1408)
    assert decode["bound_by"] == "bytes"
    assert 0.32 < decode["bound_ms"] < 0.34        # 1.1 GB at 3.35 TB/s
    assert prefill["bound_by"] == "operations"
    assert 0.53 < prefill["bound_ms"] < 0.55       # 531 GFLOP at 989 T


class _Rec:
    spans = counts = {}

    def __init__(self, profiled):
        self.profiled = profiled


def test_the_roofline_reads_the_counters_over_the_matched_kernels():
    cfg, _ = published()
    mod = core.metric("vlm.moe_roofline")
    profiled = {"vlm.moe.decode.rows": 384 * 10,
                "vlm.moe.decode.experts_hit": 64 * 10,
                "vlm.moe.prefill.rows": 30720,
                "vlm.moe.prefill.experts_hit": 64}
    least = 10 * arith_vlm.experts_bound(384, 64, 2048, 1408)["bound_ms"] \
        + arith_vlm.experts_bound(30720, 64, 2048, 1408)["bound_ms"]
    kernels = [("void (anonymous namespace)::moe_gate_up_kernel(...)",
                0.004), ("void (anonymous namespace)::moe_down_kernel(...)",
                         0.004), ("other_kernel", 1.0)]
    r = core.Readings(core.workload(CELL), cfg, _Rec(profiled), kernels,
                      1.0, 1.5)
    assert mod.read(r) == pytest.approx(100 * least * 1e-3 / 0.008)
    r = core.Readings(core.workload(CELL), cfg, _Rec(profiled),
                      [("other_kernel", 1.0)], 1.0, 1.5)
    assert mod.read(r) is None
    r = core.Readings(core.workload(CELL), cfg, _Rec({}), kernels, 1.0, 1.5)
    assert mod.read(r) is None
