"""Port parity: ``mit_tpu_torch.utils.profiling`` against
``mit_tpu.utils.profiling`` (StepTimer's arithmetic on a patched clock),
the CPU trace, ``fence``, and the profiling runbook
``python -m mit_tpu_torch.tools.profile_pipeline`` on the CPU.
"""

import glob
import json

import pytest
import torch

import jax

from mit_tpu.utils import profiling as jprof
from mit_tpu_torch.utils import profiling as tprof


class _Clock:
    """perf_counter stand-in: every call moves on by the next interval."""

    def __init__(self, intervals):
        self.t, self.intervals = 100.0, iter(intervals)

    def __call__(self):
        self.t += next(self.intervals)
        return self.t


@pytest.mark.parametrize("window", [50, 3])
def test_step_timer_arithmetic_matches_jax(monkeypatch, window):
    steps = [(4, 0.5), (8, 0.25), (2, 1.5), (16, 0.125), (1, 2.0)]
    intervals = [x for _, d in steps for x in (0.0, d)]
    timers = {}
    for mod in (tprof, jprof):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(intervals))
        timers[mod] = mod.StepTimer(window=window)
        for n, _ in steps:
            with timers[mod].step(n):
                pass
    ours, theirs = timers[tprof], timers[jprof]
    assert ours.durations == theirs.durations and ours.items == theirs.items
    assert len(ours.durations) == min(window, len(steps))
    assert ours.items_per_sec == theirs.items_per_sec
    assert ours.mean_step_seconds == theirs.mean_step_seconds
    for n in (1, 4):
        assert ours.per_chip(n) == theirs.per_chip(n)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(jax, "device_count", lambda: 2)
    assert ours.summary() == theirs.summary()
    empty = tprof.StepTimer()
    assert empty.items_per_sec == empty.mean_step_seconds == 0.0


def test_step_timer_fences_its_sync(monkeypatch):
    fenced = []
    monkeypatch.setattr(tprof, "fence", fenced.append)
    timer = tprof.StepTimer()
    out = torch.ones(2)
    with timer.step(3, sync=out):
        pass
    with timer.step(3):
        pass
    assert fenced == [out] and timer.items == [3, 3]


def test_fence_waits_only_for_a_card(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls.append(d))
    for x in (torch.ones(1), {"a": [torch.ones(1)]}, (None, 3), [], {}):
        tprof.fence(x)
    assert calls == []
    assert tprof._first_tensor({"a": {}, "b": ([1], torch.zeros(2))}).shape == (2,)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path / "logs")):
        x = torch.randn(64, 64)
        (x @ x).sum()
    files = glob.glob(str(tmp_path / "logs" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_profile_pipeline_runs_on_the_cpu(tmp_path, monkeypatch):
    """The runbook over a pretrained encoder directory, on the CPU, at a
    short decode (the config's decoder cut to one layer and 8 tokens)."""
    from mit_tpu_torch.config import Config
    from mit_tpu_torch.models.vision import (VisionConfig,
                                             hf_vision_state_dict_from_params,
                                             init_vision_params)
    from mit_tpu_torch.tools import profile_pipeline
    from mit_tpu_torch.train.checkpoint import save_file

    vcfg = VisionConfig(family="clip", image_size=28, patch_size=14,
                        hidden_size=64, num_layers=2, num_heads=1,
                        intermediate_size=96, hidden_act="quick_gelu",
                        layer_norm_eps=1e-5, patch_bias=False, ln_pre=True,
                        ln_post=False)
    enc = tmp_path / "clip"
    enc.mkdir()
    params = init_vision_params(torch.Generator().manual_seed(0), vcfg)
    save_file(hf_vision_state_dict_from_params(params, vcfg, "vision_model."),
              str(enc / "model.safetensors"))
    fields = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                  intermediate_size=96, image_size=28, patch_size=14)
    (enc / "config.json").write_text(json.dumps(
        {"model_type": "clip", "vision_config": fields}))
    monkeypatch.setattr(profile_pipeline, "Config", lambda: Config(
        DECODER_LAYERS=1, MAX_SEQ_LEN=8))
    logdir = tmp_path / "prof"
    rc = profile_pipeline.main([str(logdir), "--batch", "2", "--device", "cpu",
                                "--encoder", str(enc)])
    assert rc == 0 and glob.glob(str(logdir / "*.pt.trace.json"))
    if not torch.cuda.is_available():
        assert profile_pipeline.main([str(logdir), "--batch", "2"]) == 1
