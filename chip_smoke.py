#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Imports torch, numpy and mit_tpu_torch only: no JAX and no module of the
JAX package. Every phase prints its own lines; a failed phase raises, and
the script exits non-zero without printing the result line.

1. device   Requires CUDA (else exits 1) and prints nvidia-smi's card name
            and power limit.
2. build    Builds every kernel from mit_tpu_torch/csrc with nvcc for
            sm_90a; prints the build seconds and ptxas' register report.
3. kernels  flash_attention_btd against its plain PyTorch version on the
            card, in f32 (limit 1e-4) and bf16 (limit 2e-2), TF32 off, at
            the encoder shape (64, 197, 768), the decoder shape
            (64, 100, 512, causal, a pad that masks every key of batch row
            0) and the 577-token shape (8, 577, 768); then both timed at the
            encoder shape (CUDA events, turns plain, kernel, kernel, plain).
4. slice    The default captioning path at full width: ViT-B/16 encoder in
            CLS-memory mode, projection 768 -> 512, 6-layer 512-wide
            decoder, vocab 10000, max_len 100, random weights from a seeded
            torch.Generator, pixels from a numpy seed, through
            Captioner.memory_from_pixels / generate_from_memory.
            f32 batch 8: the kernel path's memory and greedy tokens equal
            the plain attention path's. Then the launch counter is reset,
            the bf16 batch-64 path runs REPS times, and it must have
            launched the kernel 11 times per encode call (layers 1-11; the
            CLS-only last layer needs no kernel); prints captions/s.
5. result   One JSON line describing each kernel, then the last line,
            {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

SEED = 0
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (name, B, T = S, D, causal and padded)
SHAPES = [("encoder", 64, 197, 768, False), ("decoder", 64, 100, 512, True),
          ("blip384", 8, 577, 768, False)]
TIMED_ITERS = 20
REPS = 3


class SpecialIds(NamedTuple):
    """The ids Captioner decodes with (the mit_tpu.config defaults). The
    smoke decodes no text, so it needs no tokenizer files."""

    pad_id: int = 0
    start_id: int = 2
    end_id: int = 3


def attention_inputs(torch, b, t, d, padded, dtype, seed=SEED):
    """q, k ~ N(0, 1) (score std 1: a peaked softmax); v ~ U(-1, 1)."""
    r = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
    q, k = to(r.normal(size=(b, t, d))), to(r.normal(size=(b, t, d)))
    v = to(r.uniform(-1, 1, size=(b, t, d)))
    pad = None
    if padded:
        p = np.where(r.random((b, t)) > 0.8, -1e9, 0.0).astype(np.float32)
        p[0] = -1e9
        pad = torch.from_numpy(p).cuda()
    return q, k, v, pad


def cuda_ms(torch, fn, iters=TIMED_ITERS):
    """Mean device milliseconds per call over `iters` calls, after warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernels(torch):
    from mit_tpu_torch.ops.flash_attention import (
        flash_attention_btd,
        flash_attention_btd_reference,
    )

    errors = {}
    for name, b, t, d, padded in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, pad = attention_inputs(torch, b, t, d, padded, dtype)
            out = flash_attention_btd(q, k, v, pad, padded, 64)
            ref = flash_attention_btd_reference(q, k, v, pad, padded, 64)
            torch.cuda.synchronize()
            dname = str(dtype).split(".")[1]
            err = (out.float() - ref.float()).abs().max().item()
            nan = bool(torch.isnan(out).any())
            print(f"kernel vs plain  {name:8s} B={b} T=S={t} D={d} "
                  f"causal+pad={padded} {dname:8s} max_abs_err={err:.3e} "
                  f"limit={TOL[dname]:.0e} nan={nan}")
            if nan or not err <= TOL[dname]:
                raise AssertionError(f"flash_attention_btd disagrees: {name} {dname}")
            errors[(name, dname)] = err

    times = {}
    _, b, t, d, padded = SHAPES[0]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, pad = attention_inputs(torch, b, t, d, padded, dtype)
        kern = lambda: flash_attention_btd(q, k, v, pad, padded, 64)
        plain = lambda: flash_attention_btd_reference(q, k, v, pad, padded, 64)
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            runs[which].append(cuda_ms(torch, kern if which == "kernel" else plain))
        dname = str(dtype).split(".")[1]
        times[dname] = {w: statistics.mean(r) for w, r in runs.items()}
        print(f"time at encoder shape {dname:8s} kernel {runs['kernel']} ms, "
              f"plain {runs['plain']} ms (mean of {TIMED_ITERS} calls each)")
    return errors, times


def check_slice(torch):
    from mit_tpu_torch.decode.api import Captioner
    from mit_tpu_torch.models.decoder import DecoderConfig
    from mit_tpu_torch.models.model import ModelConfig, init_model_params
    from mit_tpu_torch.models.vision import PRESETS
    from mit_tpu_torch.ops.flash_attention import flash_attention_btd

    name = "google/vit-base-patch16-224-in21k"
    mcfg = ModelConfig(name, PRESETS[name], DecoderConfig(vocab_size=10000),
                       "cls")
    ids = SpecialIds()
    params = init_model_params(torch.Generator().manual_seed(SEED), mcfg, "cuda")
    size = mcfg.vision.image_size
    pixels = torch.from_numpy(
        np.random.default_rng(SEED).uniform(-1, 1, (64, 3, size, size))
        .astype(np.float32)
    )

    def check_tokens(tokens, n):
        assert len(tokens) == n
        for row in tokens:
            assert row[0] == ids.start_id and 2 <= len(row) <= 100, row[:5]
            assert all(0 <= x < mcfg.decoder.vocab_size for x in row)

    # f32, batch 8: kernel path against the plain attention path
    kern = Captioner(params, mcfg, ids, torch.float32)
    plain = Captioner(params, mcfg, ids, torch.float32, use_kernel=False)
    before = flash_attention_btd.launches
    mem_k = kern.memory_from_pixels(pixels[:8])
    torch.cuda.synchronize()
    per_encode = flash_attention_btd.launches - before
    mem_p = plain.memory_from_pixels(pixels[:8])
    assert flash_attention_btd.launches - before == per_encode
    err = (mem_k - mem_p).abs().max().item()
    assert mem_k.shape == (8, 1, 512) and bool(torch.isfinite(mem_k).all())
    tok_k = kern.generate_from_memory(mem_k)
    tok_p = plain.generate_from_memory(mem_p)
    check_tokens(tok_k, 8)
    same = tok_k == tok_p
    print(f"slice f32 B=8: kernel launches per encode call {per_encode} "
          f"(want 11); memory kernel vs plain max_abs_err={err:.3e} "
          f"(limit 1e-4); greedy tokens identical={same}; "
          f"caption lengths {[len(t) for t in tok_k]}")
    if per_encode != 11 or not err <= 1e-4 or not same:
        raise AssertionError("f32 slice: kernel path disagrees with plain path")

    # bf16, batch 64: the counted and timed main path
    cap = Captioner(params, mcfg, ids, torch.bfloat16)
    px = pixels.to("cuda")
    cap.generate_from_memory(cap.memory_from_pixels(px))      # warm-up
    torch.cuda.synchronize()
    flash_attention_btd.launches = 0
    seconds, enc_s, steps = [], [], 0
    for _ in range(REPS):
        t0 = time.perf_counter()
        mem = cap.memory_from_pixels(px)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tokens = cap.generate_from_memory(mem)
        t2 = time.perf_counter()
        seconds.append(t2 - t0)
        enc_s.append(t1 - t0)
        steps = max(len(t) for t in tokens) - 1
    launches = flash_attention_btd.launches
    assert bool(torch.isfinite(mem).all()) and mem.shape == (64, 1, 512)
    check_tokens(tokens, 64)
    rate = 64 / statistics.median(seconds)
    print(f"slice bf16 B=64: {rate:.1f} captions/s (median of {REPS} runs "
          f"{[round(s, 4) for s in seconds]} s; encode {[round(s, 4) for s in enc_s]} s; "
          f"{steps} decode steps); kernel launches {launches} "
          f"(want {11 * REPS} = 11 x {REPS} encode calls)")
    if launches != 11 * REPS:
        raise AssertionError("main path did not launch flash_attention_btd "
                             "11 times per encode call")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    print("== 1 device", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== 2 build", flush=True)
    from mit_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.lib()
    print(f"build {time.perf_counter() - t0:.2f} s: {kernels.library_path().name}")
    log = kernels.library_path().with_name(kernels.library_path().name + ".log")
    if log.exists():
        print(log.read_text().strip())

    print("== 3 kernels", flush=True)
    errors, times = check_kernels(torch)

    print("== 4 slice", flush=True)
    launches = check_slice(torch)

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "mit_tpu"))
    if loaded:
        raise AssertionError(f"the smoke imported JAX-side modules: {loaded}")

    print("== 5 result", flush=True)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_btd",
        "route": "cuda",
        "source": "mit_tpu_torch/csrc/flash_attention_btd.cu",
        "replaces": "mit_tpu/ops/pallas_attention.py:160",
        "launches": launches,
        "max_abs_err": errors[("encoder", "bfloat16")],
        "ms": times["bfloat16"]["kernel"],
        "plain_ms": times["bfloat16"]["plain"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
