"""Port parity: ``mit_tpu_torch.utils.profiling`` against
``mit_tpu.utils.profiling`` (StepTimer's arithmetic on a patched clock),
the CPU trace, ``fence``, and the profiling runbook
``python -m mit_tpu_torch.tools.profile_pipeline`` on the CPU. Then the
port's own spans (``span``, no JAX counterpart): free with no profiler,
where the decode loops and the train step say, and without effect on
tokens, losses or parameters; and the kernel library's build record.
"""

import glob
import json

import numpy as np
import pytest
import torch

import jax

from mit_tpu.utils import profiling as jprof
from mit_tpu_torch.decode.beam import beam_generate
from mit_tpu_torch.decode.greedy import greedy_generate
from mit_tpu_torch.decode.step import decoder_step
from mit_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
from mit_tpu_torch.train.steps import tree_leaves
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


# ----------------------------------------------------------------------
# the program's spans (``span``): free with no profiler, one of each where
# the work is, and the same numbers with a profiler on
# ----------------------------------------------------------------------
SPAN_DEC = DecoderConfig(vocab_size=40, embed_dim=32, num_heads=2,
                         num_layers=2, ff_dim=48, max_seq_len=20, dropout=0.1)
# no token is -1: every decode runs to max_len, 19 steps over two buckets
NEVER_END = -1
STEPS = SPAN_DEC.max_seq_len - 1


def _decoder():
    return init_decoder_params(torch.Generator().manual_seed(0), SPAN_DEC)


def _memory(b=2):
    return torch.randn(b, 1, SPAN_DEC.embed_dim,
                       generator=torch.Generator().manual_seed(1))


def _greedy(params):
    return greedy_generate(params, SPAN_DEC, _memory(), 1, NEVER_END, 0,
                           SPAN_DEC.max_seq_len)


def _beam(params):
    return beam_generate(params, SPAN_DEC, _memory(), 1, NEVER_END, 0,
                         SPAN_DEC.max_seq_len, beam_size=3)


def _train_step():
    """(step, state, batch): one tiny decoder step from CLS features, with
    dropout and the clip."""
    from mit_tpu_torch.config import Config
    from mit_tpu_torch.models.model import ModelConfig, _init_trainable
    from mit_tpu_torch.models.vision import VisionConfig
    from mit_tpu_torch.train import steps

    vis = VisionConfig(family="vit", image_size=32, patch_size=16,
                       hidden_size=48, num_layers=1, num_heads=2,
                       intermediate_size=64, hidden_act="gelu",
                       layer_norm_eps=1e-12, patch_bias=True, ln_pre=False,
                       ln_post=True)
    mcfg = ModelConfig("tiny", vis, SPAN_DEC._replace(max_seq_len=12))
    opt, _ = steps.make_optimizer(Config(GRAD_CLIP_VALUE=1.0,
                                         LEARNING_RATE=3e-3))
    state = steps.init_train_state(
        _init_trainable(torch.Generator().manual_seed(2), mcfg), opt)
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(4, 40, (4, 12), generator=g)
    toks[0, 6:] = 0
    batch = {"features": torch.randn(4, 1, 48, generator=g),
             "decoder_input_tokens": toks[:, :-1],
             "target_tokens": toks[:, 1:]}
    return steps.make_train_step(mcfg, opt, 0, torch.float32,
                                 from_features=True), state, batch


def _profiled(fn):
    """fn() under ``torch.profiler`` on the CPU → (its result, the mit.*
    spans as (name, start µs, end µs) in start order)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.time_range.start, -e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("mit."))
    return out, [(n, a, -b) for a, b, n in spans]


def _counts(spans):
    out = {}
    for name, _, _ in spans:
        out[name] = out.get(name, 0) + 1
    return out


def test_span_with_no_profiler_is_one_shared_object(monkeypatch):
    """No profiler: ``span`` hands back the same object each time and never
    enters ``record_function``, here nor anywhere in a decode or a train
    step."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tprof.span("mit.a") is tprof.span("mit.b") is tprof._OFF
    with tprof.span("mit.a"):
        pass
    params = _decoder()
    _greedy(params)
    _beam(params)
    step, state, batch = _train_step()
    step(state, {}, batch, 7)
    from mit_tpu_torch.data.dataset import to_device
    from mit_tpu_torch.data.preprocess import device_preprocess

    to_device({"a": np.zeros(3, np.int32)}, "cpu")
    device_preprocess(torch.zeros(1, 8, 8, 3, dtype=torch.uint8), "vit", 4)


def test_greedy_decode_spans_one_step_and_sync_a_step():
    before = decoder_step.routes["unfused"]
    _, spans = _profiled(lambda: _greedy(_decoder()))
    assert decoder_step.routes["unfused"] - before == STEPS
    assert _counts(spans) == {"mit.decode.prepare": 1, "mit.decode.loop": 1,
                              "mit.decode.step": STEPS,
                              "mit.decode.select": STEPS,
                              "mit.decode.sync": STEPS,
                              "mit.decode.grow": 1}
    (_, lo, hi), = [s for s in spans if s[0] == "mit.decode.loop"]
    inner = [s for s in spans if s[0] not in ("mit.decode.loop",
                                              "mit.decode.prepare")]
    assert all(lo <= a and b <= hi for _, a, b in inner)


def test_beam_decode_spans_one_reorder_a_step():
    _, spans = _profiled(lambda: _beam(_decoder()))
    counts = _counts(spans)
    assert counts["mit.decode.reorder"] == counts["mit.decode.step"] == STEPS
    assert counts["mit.decode.sync"] == STEPS
    assert counts["mit.decode.loop"] == counts["mit.decode.prepare"] == 1
    # per step: select, reorder, then select again (the finished flags)
    steps = [n for n, _, _ in spans if n in ("mit.decode.step",
                                             "mit.decode.select",
                                             "mit.decode.reorder")]
    assert steps[:4] == ["mit.decode.step", "mit.decode.select",
                         "mit.decode.reorder", "mit.decode.select"]


def test_train_step_spans_forward_backward_optimizer_in_order():
    step, state, batch = _train_step()

    def run():
        with torch.profiler.record_function("mit.test.step"):
            return step(state, {}, batch, 7)

    _, spans = _profiled(run)
    (_, lo, hi), = [s for s in spans if s[0] == "mit.test.step"]
    phases = [s for s in spans if s[0].startswith("mit.train.")]
    assert [n for n, _, _ in phases] == ["mit.train.forward",
                                         "mit.train.backward",
                                         "mit.train.optimizer"]
    assert lo <= phases[0][1] and phases[-1][2] <= hi
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))


def test_a_profiler_changes_no_token_loss_or_parameter():
    params = _decoder()
    step, state, batch = _train_step()
    plain = (_greedy(params), _beam(params), step(state, {}, batch, 7))
    traced, spans = _profiled(
        lambda: (_greedy(params), _beam(params), step(state, {}, batch, 7)))
    assert spans
    for a, b in zip(plain[:2], traced[:2]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    (s0, l0), (s1, l1) = plain[2], traced[2]
    assert torch.equal(l0, l1) and s0.step == s1.step
    for t0, t1 in ((s0.params, s1.params), (s0.opt_state.mu, s1.opt_state.mu),
                   (s0.opt_state.nu, s1.opt_state.nu)):
        assert all(torch.equal(a, b)
                   for a, b in zip(tree_leaves(t0), tree_leaves(t1)))


def test_kernel_library_records_its_build(monkeypatch, tmp_path):
    """``kernels.lib()`` records whether it ran nvcc and how long loading
    took: here the library is found built, so nvcc did not run."""
    import ctypes

    from mit_tpu_torch import kernels

    found = tmp_path / "libmit_kernels_test.so"
    found.write_bytes(b"")

    class Library:
        def __getattr__(self, name):
            return type("Entry", (), {})()

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "library_path", lambda: found)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: Library())
    monkeypatch.setattr(kernels.lib, "built", None)
    monkeypatch.setattr(kernels.lib, "load_seconds", None)
    kernels.lib()
    assert kernels.lib.built == {"nvcc": False, "seconds": 0.0}
    assert kernels.lib.load_seconds >= 0.0
