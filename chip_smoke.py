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
3. kernels  Every kernel against its plain PyTorch version on the card,
            TF32 off, each timed at its ViT-B batch-64 shape (CUDA events,
            turns plain, kernel, kernel, plain):
            - flash_attention_btd in f32 (limit 1e-4) and bf16 (limit 2e-2)
              at the encoder shape (64, 197, 768), the decoder shape
              (64, 100, 512, causal, a pad that masks every key of batch
              row 0) and the 577-token shape (8, 577, 768);
            - quantize_rows, without and with its LayerNorm, on (12608, 768)
              and (12608, 3072) f32 and bf16 rows with an all-zero row:
              codes and scales bitwise equal without the LayerNorm, codes
              within one step (at most 1e-3 of them) with it;
            - int8_gemm at K x N = 768 x 2304, 768 x 768, 768 x 3072 and
              3072 x 768, M = 12608 and 197: int32 accumulators bitwise
              equal, and each shape's epilogue of the fused layer (plus
              gelu, quick_gelu and the bf16 residual) within rtol 2e-6 (f32
              out) or one bf16 rounding;
            - flash_attention_btd_fusedqkv at (64, 197, 3 x 768), f32 (1e-4),
              bf16 (2e-2) and the fused layer's numerics (bf16 in, f32 out,
              2e-2);
            - int8_linear (the patch embedding) and fused_int8_mlp at 12608
              rows, relative L2 <= 1e-3;
            - fused_int8_vit_layer at ViT-B (64, 197, 768), F 3072, 12 heads,
              and fused_int8_vit_layer_split at ViT-L (8, 257, 1024), F 4096,
              16 heads, bf16: relative L2 <= 5e-3 (the JAX package's bound
              between its layer kernel and its composition).
4. slice    The default captioning path at full width: ViT-B/16 encoder in
            CLS-memory mode, projection 768 -> 512, 6-layer 512-wide
            decoder, vocab 10000, max_len 100, random weights from a seeded
            torch.Generator, pixels from a numpy seed, through
            Captioner.memory_from_pixels / generate_from_memory.
            Float arm, f32 batch 8: the kernel path's memory and greedy
            tokens equal the plain attention path's.
            int8 arm (Captioner(..., encoder_quant="int8"), quantized at
            load), f32 batch 8: the kernel path's memory within 3 times the
            plain int8 path's own move under a one-ulp change of the pixels
            (relative L2; quantization makes the arm discontinuous), cosine
            to the float arm's memory > 0.999; greedy-token agreement
            printed, not gated.
            bf16 batch 64: every launch counter is set to 0 before each
            path and read after it. The float arm and the int8 arm (fused
            layers) run REPS times each, the int8 per-op form once; each
            must launch exactly its kernels per encode call (float:
            flash_attention_btd 11; int8 fused: fused_int8_vit_layer 11,
            int8_linear 3, fused_int8_mlp 1; int8 per-op: int8_linear 25,
            fused_int8_mlp 12, flash_attention_btd_fusedqkv 11). Prints
            captions/s of both arms and their median encoder ms.
            Phase 3 also holds the dropout-attention kernels (training's
            decoder self-attention) to their plain versions at (32, 8, 99,
            99, 64), causal with padded keys (every key of batch row 0), and
            at a ragged (3, 2, 7, 9), f32 and bf16: the dump kernel's
            keep-mask bitwise equal to keep_mask; the forward within 1e-5
            (f32) or 2e-2 (bf16) absolute; dq, dk and dv within 1e-5 (f32)
            or 1e-2 (bf16) of their largest value. It times forward and
            backward, kernel against plain, at the bf16 training shape,
            and the dump kernel against keep_mask at (32, 8, 99, 99).
5. train    Training at the default model's full width: a random ViT-B/16
            builds the CLS feature cache of 64 pixel images made in the run
            (FeatureCache.build, through flash_attention_btd); decoder 6 x
            512, 8 heads, FF 2048, vocab 10000, T 99, batch 32, the config's
            AdamW, clip 5.0 and dropout 0.1, token ids from a numpy seed.
            (a) f32, 5 steps, the kernel path against the plain path
            (flash_attention_dropout_plain; the same seeds, so the same
            hash masks and the same other masks): losses within 1e-4
            relative. (b) launches: 6 dropout forward and 6 backward per
            step with fused dropout; 6 flash_attention_btd and no dropout
            launch per step at dropout 0. (c) bf16, 30 steps on one batch:
            the loss falls. (d) an eval step, then safetensors and train
            state saved, restored, and one step from the restore equal to
            one step without it. (e) steps/s and images/s at bf16 batch 32,
            fused dropout on and off (the plain dropout path), median and
            quartiles of RUNS runs in alternating turns. Every counter is
            set to 0 before the cache build and (c), and read after them.
            Phase 3 also holds fused_decode_layer to its plain version at
            (B, T) = (64, 16), (64, 100), (192, 100) and a ragged (3, 7),
            D 512, F 2048, with a scalar and with per-row positions, a madd
            that masks PAD keys and one fully masked row, with and without
            the in-kernel cache write: f32 within 1e-5 on x' and on the
            fresh rows, bf16 within 0.05 (then a table of its times at 1, 2
            and 4 batch rows per block, with and without the staggered walk
            over the weights); and flash_attention (the
            (B, H, T, hd) kernel) at (8, 12, 577, 64), f32 (1e-5) and bf16
            (2e-2), and at the causal padded decoder shape (64, 8, 100, 64).
            Yardsticks, timed and used nowhere in the port: one
            F.scaled_dot_product_attention call at each attention kernel's
            shape and torch._int_mm at each int8_gemm shape.
            Phase 4 also drives the decode routes on the ViT-B model. f32
            batch 8: greedy tokens of the fused route (fused_decode_layer
            in every layer of every step) equal the unfused route's, and
            the kernel's equal its plain version's run through the same
            step; beam K = 3 tokens equal between the routes, scores within
            rtol = atol = 1e-5; beam_size 1 and temperature 0 equal greedy; a sampled
            batch (temperature 1, top-k 50, top-p 0.9) repeats under the
            same seed. bf16 batch 64: one fused step under torch.profiler
            runs one matrix product (the logits) and no softmax, einsum or
            LayerNorm op; the fused greedy run launches exactly num_layers
            kernels a step; captions/s and ms per step of greedy fused
            against unfused in alternating turns, and of beam K = 3; a
            32-step trace of each greedy route (device kernels and
            device-busy time per step). Then
            the BLIP-384 encoder (577 tokens) at full depth, f32 batch 8:
            11 flash_attention launches per encode call and no
            flash_attention_btd, memory within 1e-4 of the plain path's.
6. result   One JSON line describing each kernel (its error, its time, its
            plain version's time, its bound and, where one PyTorch call
            computes the same function, that call's time), then the last
            line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
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
ENC_REPS = 10            # encoder-only timings per arm, in alternating turns
FLOOR_FACTOR = 3         # int8 slice bound, in units of its own noise floor
M_FULL = 64 * 197        # the encoder's rows at batch 64
# K x N of the fused layer's GEMMs, with the epilogue each has on the path
GEMMS = [("qkv", 768, 2304, "none", None, "bfloat16"),
         ("out_proj", 768, 768, "none", "bfloat16", "float32"),
         ("fc1", 768, 3072, "gelu", None, "float32"),
         ("fc2", 3072, 768, "none", "float32", "bfloat16")]
# launches per encode call of each path (bf16, batch 64)
PER_ENCODE = {
    "float": {"flash_attention_btd": 11},
    "int8": {"fused_int8_vit_layer": 11, "int8_linear": 3,
             "fused_int8_mlp": 1, "flash_attention_btd_fusedqkv": 11,
             "quantize_rows": 49, "int8_gemm": 49},
    "int8_per_op": {"int8_linear": 25, "fused_int8_mlp": 12,
                    "flash_attention_btd_fusedqkv": 11, "quantize_rows": 49,
                    "int8_gemm": 49},
}


# peak rates of one H100 SXM (NVIDIA's data sheet, dense) for the bounds
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
# fused decode layer: (B, T) at D 512, F 2048, 8 heads
DECODE_SHAPES = [(64, 16), (64, 100), (192, 100), (3, 7)]
# max abs error of x' and of the fresh rows. f32: summation order over 512
# or 2048 terms at values of order 1 (the fresh rows reach 3e-6 to 4e-6
# against cuBLAS; the JAX package's 1e-6 is at its test's width of 64)
DECODE_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (0.05, 0.05)}
BHTD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DECODE_REPS = 4          # timed greedy runs per route, in alternating turns
BLIP = "Salesforce/blip-image-captioning-base"


# training phase
TRAIN_BATCH = 32
TRAIN_IMAGES = 64
TRAIN_SEED = 1234
BF16_STEPS = 30
RUNS = 5                 # throughput runs per configuration
RUN_STEPS = 10           # steps per throughput run
DROPOUT_SHAPES = [("decoder", 32, 8, 99, 99, True), ("ragged", 3, 2, 7, 9, False)]
DROPOUT_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}


class TrainConfig(NamedTuple):
    """The training knobs of mit_tpu.config.Config, at its defaults (the
    smoke imports nothing of the JAX package)."""

    LEARNING_RATE: float = 1e-4
    WEIGHT_DECAY: float = 1e-5
    GRAD_CLIP_VALUE: float = 5.0
    ADAM_BETA1: float = 0.9
    ADAM_BETA2: float = 0.98
    ADAM_EPS: float = 1e-9
    WARMUP_STEPS: int = 0
    NUM_EPOCHS: int = 20
    DECODER_DROPOUT: float = 0.1

    def to_json(self) -> str:
        """The train-state sidecar's config entry."""
        return json.dumps(self._asdict())


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
        times[dname].update(attention_bound(b, d // 64, t, t, dtype))
        times[dname]["library_ms"] = sdpa_ms(
            torch, heads_view(q), heads_view(k), heads_view(v))
        print(f"time at encoder shape {dname:8s} kernel {runs['kernel']} ms, "
              f"plain {runs['plain']} ms (mean of {TIMED_ITERS} calls each); "
              f"bound {times[dname]['bound_ms']:.5f} ms by "
              f"{times[dname]['bound_by']}, library call "
              f"{times[dname]['library_ms']:.4f} ms")
    return errors, times


def wrappers():
    """Every kernel wrapper with a launch counter, by name."""
    from mit_tpu_torch.ops import (
        decode_layer,
        dropout_attention,
        flash_attention,
        int8_layer,
        int8_mlp,
    )

    return {
        "fused_decode_layer": decode_layer.fused_decode_layer,
        "flash_attention": flash_attention.flash_attention,
        "flash_attention_dropout": dropout_attention.flash_attention_dropout_fwd,
        "flash_attention_dropout_bwd":
            dropout_attention.flash_attention_dropout_bwd,
        "dump_dropout_mask": dropout_attention.dump_dropout_mask,
        "flash_attention_btd": flash_attention.flash_attention_btd,
        "flash_attention_btd_fusedqkv":
            flash_attention.flash_attention_btd_fusedqkv,
        "quantize_rows": int8_mlp.quantize_rows,
        "int8_gemm": int8_mlp.int8_gemm,
        "int8_linear": int8_mlp.int8_linear,
        "fused_int8_mlp": int8_mlp.fused_int8_mlp,
        "fused_int8_vit_layer": int8_layer.fused_int8_vit_layer,
        "fused_int8_vit_layer_split": int8_layer.fused_int8_vit_layer_split,
    }


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in wrappers().items()}


def timed_turns(torch, kern, plain):
    """Mean ms of kernel and plain, in turns plain, kernel, kernel, plain."""
    runs = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        runs[which].append(cuda_ms(torch, kern if which == "kernel" else plain))
    return runs


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def random_qlinear(torch, k, n, seed):
    """A quantized (K, N) weight from N(0, 0.02) and a N(0, 0.02) bias."""
    from mit_tpu_torch.ops.quant import QuantizedLinear, quantize_weight

    g = torch.Generator().manual_seed(seed)
    q = quantize_weight(torch.randn(k, n, generator=g) * 0.02,
                        torch.randn(n, generator=g) * 0.02)
    return QuantizedLinear(*(a.cuda() for a in q))


def random_rows(torch, m, k, dtype, seed, zero_row=True):
    x = np.random.default_rng(seed).normal(size=(m, k)).astype(np.float32)
    if zero_row:
        x[1] = 0.0
    return torch.from_numpy(x).to("cuda", dtype)


def random_ln(torch, d, seed):
    r = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    return {"scale": to(1 + 0.1 * r.normal(size=d)),
            "bias": to(0.1 * r.normal(size=d))}


def bound(nbytes, ops, kind):
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once) over
    the memory rate and its operations over the peak rate for their type."""
    by_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def attention_bound(b, h, t, s, dtype, n_products=2, extra_bytes=0):
    """q, k, v read and the output written once; two (T, S, 64) products."""
    size = 2 if "bfloat16" in str(dtype) else 4
    nbytes = (2 * b * h * t * 64 + 2 * b * h * s * 64) * size + extra_bytes
    ops = n_products * 2 * b * h * t * s * 64
    return bound(nbytes, ops, "bf16" if size == 2 else "f32")


def sdpa_ms(torch, q, k, v, causal=False, pad=None, dropout_p=0.0):
    """One F.scaled_dot_product_attention call over (B, H, T, hd) views: the
    library's time for the same function, a yardstick only."""
    mask = None
    if pad is not None or causal:
        t, s = q.shape[2], k.shape[2]
        mask = torch.zeros((q.shape[0], 1, t, s), dtype=q.dtype, device="cuda")
        if causal:
            mask = mask + torch.full((t, s), -1e9, dtype=q.dtype,
                                     device="cuda").triu(1)
        if pad is not None:
            mask = mask + pad[:, None, None, :].to(q.dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return cuda_ms(torch, lambda: sdpa(q, k, v, attn_mask=mask,
                                       dropout_p=dropout_p))


def heads_view(x, hd=64):
    """(B, T, D) → the (B, H, T, hd) view the library call takes."""
    b, t, d = x.shape
    return x.view(b, t, d // hd, hd).transpose(1, 2)


def report(results, name, err, runs, what, bound_, library_ms=None):
    ms = statistics.mean(runs["kernel"])
    plain_ms = statistics.mean(runs["plain"])
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"time {name:28s} {what}: kernel {runs['kernel']} ms, plain "
          f"{runs['plain']} ms, bound {bound_['bound_ms']:.5f} ms by "
          f"{bound_['bound_by']}, library call {lib}")
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **bound_, "library_ms": library_ms}


def check_int8_kernels(torch):
    """The int8 arm's kernels against their plain versions; returns, per
    wrapper, the max abs error and both times at its ViT-B shape."""
    from mit_tpu_torch.ops import int8_layer, int8_mlp
    from mit_tpu_torch.ops.flash_attention import (
        flash_attention_btd_fusedqkv,
        flash_attention_btd_fusedqkv_reference,
    )

    results = {}

    # quantize_rows: bitwise without the LayerNorm, one step with it
    for k in (768, 3072):
        for dtype in (torch.float32, torch.bfloat16):
            x = random_rows(torch, M_FULL, k, dtype, seed=k)
            ln = random_ln(torch, k, seed=k + 1)
            for with_ln in (False, True):
                args = (x, ln if with_ln else None, 1e-12)
                x8, sx = int8_mlp.quantize_rows(*args)
                r8, rsx = int8_mlp.quantize_rows_reference(*args)
                torch.cuda.synchronize()
                diff = (x8.int() - r8.int()).abs()
                flips = (diff > 0).float().mean().item()
                srel = ((sx - rsx).abs() / rsx).max().item()
                print(f"quantize_rows ({M_FULL}, {k}) {str(dtype)[6:]:8s} "
                      f"ln={with_ln}: max code diff {diff.max().item()}, "
                      f"share of codes differing {flips:.2e}, max scale "
                      f"rel diff {srel:.2e}, all-zero row's max code "
                      f"{x8[1].abs().max().item()}")
                ok = (diff.max().item() <= 1 and flips <= 1e-3
                      and srel <= 1e-5) if with_ln else (
                    torch.equal(x8, r8) and torch.equal(sx, rsx)
                    and not x8[1].any())
                if not ok:
                    raise AssertionError(f"quantize_rows disagrees: K={k} "
                                         f"{dtype} ln={with_ln}")
    x = random_rows(torch, M_FULL, 3072, torch.float32, seed=3)
    (x8, sx), (r8, rsx) = (int8_mlp.quantize_rows(x),
                           int8_mlp.quantize_rows_reference(x))
    err = max((x8.int() - r8.int()).abs().max().item(),
              (sx - rsx).abs().max().item())
    runs = timed_turns(torch, lambda: int8_mlp.quantize_rows(x),
                       lambda: int8_mlp.quantize_rows_reference(x))
    report(results, "quantize_rows", err, runs,
           f"({M_FULL}, 3072) f32, the fc2 input (error: codes and scales)",
           bound(M_FULL * 3072 * 5 + M_FULL * 4, 3 * M_FULL * 3072, "f32"))

    # int8_gemm: exact accumulators, then each epilogue of the path
    gemm_ms = {"kernel": [0.0, 0.0], "plain": [0.0, 0.0]}
    gemm_err = 0.0
    gemm_bound = {"bytes": 0.0, "operations": 0.0}
    gemm_lib = 0.0
    for i, (name, k, n, act, res, out) in enumerate(GEMMS):
        q = random_qlinear(torch, k, n, seed=10 + i)
        out_dtype = getattr(torch, out)
        for m in (M_FULL, 197):
            a8, sx = int8_mlp.quantize_rows(
                random_rows(torch, m, k, torch.float32, seed=20 + i))
            a8[0] = 127                      # 127² · K: past f32's 2²⁴
            acc = int8_mlp.int8_gemm(a8, sx, q, out_dtype=torch.int32)
            exact = torch.equal(
                acc, int8_mlp.int8_gemm_reference(a8, sx, q,
                                                  out_dtype=torch.int32))
            epilogues = [(act, res, out_dtype)]
            if name == "fc1":
                epilogues.append(("quick_gelu", None, torch.float32))
            if name == "out_proj":
                epilogues.append(("none", "float32", torch.bfloat16))
            for e_act, e_res, e_out in epilogues:
                residual = None if e_res is None else random_rows(
                    torch, m, n, getattr(torch, e_res), seed=30 + i)
                y = int8_mlp.int8_gemm(a8, sx, q, e_act, residual, e_out)
                ref = int8_mlp.int8_gemm_reference(a8, sx, q, e_act,
                                                   residual, e_out)
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs().max().item()
                tol = ({"rtol": 2e-6, "atol": 1e-6} if e_out == torch.float32
                       else {"rtol": 8e-3, "atol": 1e-5})
                close = torch.allclose(y.float(), ref.float(), **tol)
                print(f"int8_gemm {name:8s} M={m:5d} K={k} N={n} act={e_act} "
                      f"residual={e_res} out={str(e_out)[6:]}: int32 exact="
                      f"{exact}, max_abs_err={err:.3e} ({tol})")
                if not (exact and close):
                    raise AssertionError(f"int8_gemm disagrees: {name} M={m}")
                if m == M_FULL and e_act == act and e_res == res:
                    gemm_err = max(gemm_err, err)
            if m == M_FULL:
                residual = None if res is None else random_rows(
                    torch, m, n, getattr(torch, res), seed=30 + i)
                runs = timed_turns(
                    torch,
                    lambda: int8_mlp.int8_gemm(a8, sx, q, act, residual,
                                               out_dtype),
                    lambda: int8_mlp.int8_gemm_reference(a8, sx, q, act,
                                                         residual, out_dtype))
                tops = 2 * m * k * n / (statistics.mean(runs["kernel"]) * 1e9)
                print(f"time int8_gemm {name:8s} M={m} K={k} N={n}: kernel "
                      f"{runs['kernel']} ms ({tops:.1f} TOP/s), plain "
                      f"{runs['plain']} ms")
                for w in ("kernel", "plain"):
                    for j in range(2):
                        gemm_ms[w][j] += runs[w][j]
                size = lambda name: 0 if name is None else (
                    2 if name == "bfloat16" else 4)
                one = bound(m * k + k * n + 4 * m + 8 * n
                            + m * n * (size(res) + size(out)),
                            2 * m * k * n, "int8")
                gemm_bound[one["bound_by"]] += one["bound_ms"]
                lib = cuda_ms(torch, lambda: torch._int_mm(a8, q.w8))
                gemm_lib += lib
                print(f"     int8_gemm {name:8s} bound {one['bound_ms']:.5f} "
                      f"ms by {one['bound_by']}; torch._int_mm (no scales, "
                      f"bias or epilogue) {lib:.4f} ms")
    report(results, "int8_gemm", gemm_err, gemm_ms,
           "the four GEMMs of one layer, summed",
           {"bound_ms": sum(gemm_bound.values()),
            "bound_by": max(gemm_bound, key=gemm_bound.get)}, gemm_lib)

    # fused-QKV attention, both output modes
    qkv32 = random_rows(torch, M_FULL, 3 * 768, torch.float32, seed=40,
                        zero_row=False).reshape(64, 197, 3 * 768)
    for dtype, layer in ((torch.float32, False), (torch.bfloat16, False),
                         (torch.bfloat16, True)):
        qkv = qkv32.to(dtype)
        out = flash_attention_btd_fusedqkv(qkv, 64, layer)
        ref = flash_attention_btd_fusedqkv_reference(qkv, 64, layer)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        limit = TOL[str(dtype)[6:]]
        print(f"flash_attention_btd_fusedqkv (64, 197, 2304) "
              f"{str(dtype)[6:]:8s} layer_numerics={layer}: max_abs_err="
              f"{err:.3e} limit={limit:.0e} out={str(out.dtype)[6:]}")
        if not err <= limit or torch.isnan(out).any():
            raise AssertionError("flash_attention_btd_fusedqkv disagrees")
        if dtype == torch.bfloat16 and not layer:
            runs = timed_turns(
                torch, lambda: flash_attention_btd_fusedqkv(qkv, 64),
                lambda: flash_attention_btd_fusedqkv_reference(qkv, 64))
            report(results, "flash_attention_btd_fusedqkv", err, runs,
                   "(64, 197, 2304) bf16",
                   attention_bound(64, 12, 197, 197, dtype),
                   sdpa_ms(torch, *(heads_view(x)
                                    for x in qkv.split(768, dim=-1))))
        if layer:
            runs = timed_turns(
                torch, lambda: flash_attention_btd_fusedqkv(qkv, 64, True),
                lambda: flash_attention_btd_fusedqkv_reference(qkv, 64, True))
            print(f"time attention stage of the fused layer: kernel "
                  f"{runs['kernel']} ms, plain {runs['plain']} ms")

    # int8_linear (the patch embedding) and fused_int8_mlp
    patches = random_rows(torch, 64 * 196, 768, torch.bfloat16, seed=50
                          ).reshape(64, 196, 768)
    q = random_qlinear(torch, 768, 768, seed=51)
    x = random_rows(torch, M_FULL, 768, torch.bfloat16, seed=52
                    ).reshape(64, 197, 768)
    q1 = random_qlinear(torch, 768, 3072, seed=53)
    q2 = random_qlinear(torch, 3072, 768, seed=54)
    mp = 64 * 196
    for name, kern, plain, what, bound_ in (
        ("int8_linear", lambda: int8_mlp.int8_linear(patches, q),
         lambda: int8_mlp.int8_linear_reference(patches, q),
         "(64, 196, 768) bf16, the patch embedding",
         bound(mp * 768 * 4 + 768 * 768 + 8 * 768, 2 * mp * 768 * 768,
               "int8")),
        ("fused_int8_mlp", lambda: int8_mlp.fused_int8_mlp(x, q1, q2),
         lambda: int8_mlp.fused_int8_mlp_reference(x, q1, q2),
         "(64, 197, 768) bf16, F 3072, gelu",
         bound(M_FULL * 768 * 4 + 2 * 768 * 3072 + 8 * 3840,
               4 * M_FULL * 768 * 3072, "int8")),
    ):
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel = rel_l2(out, ref)
        print(f"{name} {what}: relative L2 {rel:.3e} (limit 1e-3), "
              f"max_abs_err={err:.3e}")
        if not rel <= 1e-3:
            raise AssertionError(f"{name} disagrees")
        report(results, name, err, timed_turns(torch, kern, plain), what,
               bound_)

    # the whole layer: ViT-B (one pass) and ViT-L (the split form)
    for name, b, t, d, f, heads in (
        ("fused_int8_vit_layer", 64, 197, 768, 3072, 12),
        ("fused_int8_vit_layer_split", 8, 257, 1024, 4096, 16),
    ):
        x = random_rows(torch, b * t, d, torch.bfloat16, seed=60,
                        zero_row=False).reshape(b, t, d)
        args = (random_ln(torch, d, 61), random_qlinear(torch, d, 3 * d, 62),
                random_qlinear(torch, d, d, 63), random_ln(torch, d, 64),
                random_qlinear(torch, d, f, 65),
                random_qlinear(torch, f, d, 66), heads, 1e-12)
        kern_fn = getattr(int8_layer, name)
        plain_fn = getattr(int8_layer, name + "_reference")
        out, ref = kern_fn(x, *args), plain_fn(x, *args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel = rel_l2(out, ref)
        what = f"({b}, {t}, {d}) F {f} {heads} heads bf16"
        print(f"{name} {what}: relative L2 {rel:.3e} (limit 5e-3), "
              f"max_abs_err={err:.3e}")
        if not rel <= 5e-3 or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name} disagrees")
        # x read and written in bf16, int8 weights read once; four int8
        # products and the attention's two bf16 products
        by_bytes = (b * t * d * 4 + 4 * d * d + 2 * d * f) / MEM_BYTES_PER_S
        by_ops = (2 * b * t * (4 * d * d + 2 * d * f) / PEAK_OPS["int8"]
                  + 4 * b * t * t * d / PEAK_OPS["bf16"])
        report(results, name, err,
               timed_turns(torch, lambda: kern_fn(x, *args),
                           lambda: plain_fn(x, *args)), what,
               {"bound_ms": max(by_bytes, by_ops) * 1e3,
                "bound_by": "bytes" if by_bytes >= by_ops else "operations"})
    return results


def decode_layer_inputs(torch, b, t, dtype, per_row, seed=SEED):
    """One layer call at D 512, F 2048, 8 heads: x, pos, madd, caches, cross
    and a one-layer stack of weights. madd hides the keys past pos and about
    a tenth of the others (generated PADs); batch row 1 is fully masked."""
    from mit_tpu_torch.ops.decode_layer import pack_decode_layers

    d, f = 512, 2048
    r = np.random.default_rng(seed)
    to = lambda a, dt=dtype: torch.from_numpy(
        np.asarray(a, np.float32)).to("cuda", dt)
    x = to(r.normal(size=(b, d)))
    kc, vc = to(r.normal(size=(b, t, d))), to(r.normal(size=(b, t, d)))
    cross = to(r.normal(size=(b, d)), torch.float32)
    pos = r.integers(0, t, b).astype(np.int32) if per_row else t // 2
    visible = np.arange(t)[None, :] <= np.broadcast_to(pos, (b,))[:, None]
    visible &= r.random((b, t)) > 0.1
    madd = np.where(visible, 0.0, -1e9)
    madd[1] = -1e9
    w = lambda k, n: to(r.normal(size=(1, k, n)) / np.sqrt(k))
    vec = lambda n, dt=dtype: to(0.1 * r.normal(size=(1, n)), dt)
    ln = lambda: {"scale": 1 + vec(d, torch.float32),
                  "bias": vec(d, torch.float32)}
    lay = pack_decode_layers({
        "wqkv": w(d, 3 * d), "bqkv": vec(3 * d), "wo": w(d, d), "bo": vec(d),
        "w1": w(d, f), "b1": vec(f), "w2": w(f, d), "b2": vec(d),
        "ln1": ln(), "ln2": ln(), "ln3": ln()})
    if per_row:
        pos = torch.from_numpy(pos).cuda()
    return x, pos, to(madd, torch.float32), kc, vc, cross, lay


def decode_layer_bound(b, t, dtype, d=512, f=2048):
    """Weights, both caches, x, madd and cross read once, three (B, D) rows
    written; four products and the two attention contractions."""
    size = 2 if "bfloat16" in str(dtype) else 4
    weights = (4 * d * d + 2 * d * f) * size + (9 * d + 3 * d + f) * 4
    rows = b * (d * size + 4 + t * 4 + 2 * t * d * size + d * 4 + 3 * d * size)
    ops = 2 * b * (4 * d * d + 2 * d * f) + 4 * b * t * d
    return bound(weights + rows, ops, "bf16" if size == 2 else "f32")


def check_decode_layer_kernel(torch):
    """fused_decode_layer against fused_decode_layer_plain; returns its
    error and times at the main path's largest shape, bf16 (64, 100)."""
    from mit_tpu_torch.ops.decode_layer import (
        fused_decode_layer,
        fused_decode_layer_plain,
    )

    results = {}
    for b, t in DECODE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            xtol, rtol = DECODE_TOL[dname]
            for per_row in (False, True):
                x, pos, madd, kc, vc, cross, lay = decode_layer_inputs(
                    torch, b, t, dtype, per_row)
                args = (x, pos, madd, kc, vc, cross, lay, 0, 8)
                out = fused_decode_layer(*args)
                ref = fused_decode_layer_plain(*args)
                k2, v2 = kc.clone(), vc.clone()
                wrote = fused_decode_layer(x, pos, madd, k2, v2, cross, lay,
                                           0, 8, write_cache=True)
                k3, v3 = kc.clone(), vc.clone()
                fused_decode_layer_plain(x, pos, madd, k3, v3, cross, lay, 0,
                                         8, write_cache=True)
                torch.cuda.synchronize()
                errs = [(o.float() - r.float()).abs().max().item()
                        for o, r in zip(out, ref)]
                same = all(torch.equal(a, c) for a, c in zip(out, wrote))
                cache_ok = (
                    (k2.float() - k3.float()).abs().max().item() <= rtol
                    and (v2.float() - v3.float()).abs().max().item() <= rtol
                    and (k2 != kc).any(-1).sum().item() <= b)
                finite = all(bool(torch.isfinite(o).all()) for o in out)
                print(f"fused_decode_layer B={b} T={t} {dname:8s} "
                      f"per_row_pos={per_row}: max_abs_err x' {errs[0]:.3e} "
                      f"(limit {xtol:.0e}), k_new {errs[1]:.3e}, v_new "
                      f"{errs[2]:.3e} (limit {rtol:.0e}); write_cache: same "
                      f"outputs={same}, rows in place={cache_ok}; "
                      f"finite={finite}")
                if not (finite and same and cache_ok and errs[0] <= xtol
                        and max(errs[1:]) <= rtol):
                    raise AssertionError(
                        f"fused_decode_layer disagrees: B={b} T={t} {dname}")
            if b == 3:
                continue
            runs = timed_turns(torch, lambda: fused_decode_layer(*args),
                               lambda: fused_decode_layer_plain(*args))
            shape = f"({b}, {t}) {dname}"
            main = (b, t, dtype) == (64, 100, torch.bfloat16)
            report(results,
                   "fused_decode_layer" if main else
                   f"fused_decode_layer {shape}", errs[0], runs,
                   f"{shape}, D 512, F 2048" if main else "D 512, F 2048",
                   decode_layer_bound(b, t, dtype))
    # the kernel's two design choices against their alternatives
    for b, t, dtype in ((64, 100, torch.bfloat16), (192, 100, torch.bfloat16),
                        (64, 100, torch.float32)):
        args = (*decode_layer_inputs(torch, b, t, dtype, True), 0, 8)
        cells = []
        for rows in (None, 1, 2, 4):
            for stagger in (True, False):
                ms = cuda_ms(torch, lambda: fused_decode_layer(
                    *args, rows_per_block=rows, stagger=stagger))
                cells.append(f"rows {rows or 'by B'} stagger "
                             f"{'on' if stagger else 'off'} {ms:.4f}")
        print(f"design fused_decode_layer ({b}, {t}) {str(dtype)[6:]}, ms: "
              + "; ".join(cells))
    return {"fused_decode_layer": results["fused_decode_layer"]}


def bhtd_inputs(torch, b, h, t, padded, dtype, seed=SEED):
    q, k, v, pad = attention_inputs(torch, b, t, h * 64, padded, dtype, seed)
    split = lambda x: heads_view(x).contiguous()
    return split(q), split(k), split(v), pad


def check_bhtd_kernel(torch):
    """flash_attention, the (B, H, T, hd) kernel, against its plain version;
    returns its error and times at the BLIP-384 f32 encoder's shape."""
    from mit_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    results = {}
    for name, b, h, t, padded in (("blip384", 8, 12, 577, False),
                                  ("decoder", 64, 8, 100, True)):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            q, k, v, pad = bhtd_inputs(torch, b, h, t, padded, dtype)
            out = flash_attention(q, k, v, pad, padded)
            ref = flash_attention_reference(q, k, v, pad, padded)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            finite = bool(torch.isfinite(out).all())
            print(f"flash_attention {name:8s} ({b}, {h}, {t}, 64) "
                  f"causal+pad={padded} {dname:8s} max_abs_err={err:.3e} "
                  f"limit={BHTD_TOL[dname]:.0e} finite={finite}")
            if not (finite and err <= BHTD_TOL[dname]):
                raise AssertionError(f"flash_attention disagrees: {name} {dname}")
            if name != "blip384":
                continue
            runs = timed_turns(
                torch, lambda: flash_attention(q, k, v, pad, padded),
                lambda: flash_attention_reference(q, k, v, pad, padded))
            what = f"({b}, {h}, {t}, 64) {dname}"
            report(results,
                   "flash_attention" if dtype == torch.float32 else
                   "flash_attention bf16", err, runs, what,
                   attention_bound(b, h, t, t, dtype),
                   sdpa_ms(torch, q, k, v))
    return {"flash_attention": results["flash_attention"]}



def drive(torch, name, cap, px, reps):
    """The main path of one arm: every counter set to 0, `reps` encode and
    decode calls, the counters read and held to PER_ENCODE. Returns
    captions/s (median), the counts and the last batch's memory."""
    reset_counts()
    seconds, enc_s = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        mem = cap.memory_from_pixels(px)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tokens = cap.generate_from_memory(mem)
        t2 = time.perf_counter()
        seconds.append(t2 - t0)
        enc_s.append(t1 - t0)
    counts = read_counts()
    want = {k: PER_ENCODE[name].get(k, 0) * reps for k in counts}
    b = px.shape[0]
    rate = b / statistics.median(seconds)
    steps = max(len(t) for t in tokens) - 1
    per_encode = {k: v / reps for k, v in counts.items() if v}
    print(f"slice bf16 B={b} {name}: {rate:.1f} captions/s (median of {reps} "
          f"runs {[round(s, 4) for s in seconds]} s; encode "
          f"{[round(s, 4) for s in enc_s]} s; {steps} decode steps); "
          f"launches per encode call {per_encode}, every other counter 0")
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, want {want} "
                             f"({reps} encode calls)")
    if not (bool(torch.isfinite(mem).all()) and mem.shape == (b, 1, 512)):
        raise AssertionError(f"{name}: bad memory {tuple(mem.shape)}")
    return rate, counts, tokens


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

    # int8 arm, f32, batch 8: kernel path against the plain int8 path and
    # against the float arm. The int8 encoder is discontinuous where a
    # value crosses a rounding boundary of its code: a change of the input
    # in its last bit flips a code, and twelve layers of requantization
    # spread that flip (the float arm moves by about 1e-6 where the int8
    # arm moves by about 2e-2). So the bound is measured in the run: the
    # kernel path may differ from the plain path by at most FLOOR_FACTOR
    # times what a one-ulp change of the pixels (x (1 + 1e-7)) moves the
    # plain path itself. Phase 3 holds each kernel to its own rounding.
    q8 = Captioner(params, mcfg, ids, torch.float32, encoder_quant="int8")
    q8_plain = Captioner(params, mcfg, ids, torch.float32, use_kernel=False,
                         encoder_quant="int8")
    px8 = pixels[:8]
    mem_q = q8.memory_from_pixels(px8)
    mem_qp = q8_plain.memory_from_pixels(px8)
    floor = rel_l2(q8_plain.memory_from_pixels(px8 * (1 + 1e-7)), mem_qp)
    torch.cuda.synchronize()
    rel = rel_l2(mem_q, mem_qp)
    cos = lambda a: torch.nn.functional.cosine_similarity(
        a.flatten(), mem_k.flatten(), dim=0).item()
    tok_q = q8.generate_from_memory(mem_q)
    tok_qp = q8_plain.generate_from_memory(mem_qp)
    check_tokens(tok_q, 8)
    agree = np.mean([a == b for ta, tb in zip(tok_q, tok_qp)
                     for a, b in zip(ta, tb)])
    agree_float = np.mean([a == b for ta, tb in zip(tok_q, tok_k)
                           for a, b in zip(ta, tb)])
    print(f"slice int8 f32 B=8: memory kernel vs plain int8 relative L2 "
          f"{rel:.3e} (limit {FLOOR_FACTOR} x {floor:.3e}, the plain int8 "
          f"path's move under pixels x (1 + 1e-7)), max_abs_err="
          f"{(mem_q - mem_qp).abs().max().item():.3e}; cosine to the float "
          f"arm: kernel {cos(mem_q):.6f}, plain {cos(mem_qp):.6f} (limit "
          f"> 0.999); greedy-token agreement kernel vs plain int8 "
          f"{agree:.4f}, int8 vs float {agree_float:.4f} (not gated)")
    if not (0 < floor and rel <= FLOOR_FACTOR * floor and cos(mem_q) > 0.999
            and bool(torch.isfinite(mem_q).all())):
        raise AssertionError("int8 f32 slice: kernel path disagrees")
    del kern, plain, q8, q8_plain

    # bf16, batch 64: the counted and timed main paths of both arms
    arms = {
        "float": Captioner(params, mcfg, ids, torch.bfloat16),
        "int8": Captioner(params, mcfg, ids, torch.bfloat16,
                          encoder_quant="int8"),
    }
    px = pixels.to("cuda")
    for cap in arms.values():                                  # warm-up
        cap.generate_from_memory(cap.memory_from_pixels(px))
    torch.cuda.synchronize()
    enc_ms = {arm: [] for arm in arms}
    for turn in range(ENC_REPS):
        for arm in (("float", "int8") if turn % 2 == 0 else ("int8", "float")):
            t0 = time.perf_counter()
            arms[arm].memory_from_pixels(px)
            torch.cuda.synchronize()
            enc_ms[arm].append((time.perf_counter() - t0) * 1e3)
    for arm, ms in enc_ms.items():
        q1, q2, q3 = statistics.quantiles(ms, n=4)
        print(f"encoder bf16 B=64 {arm}: median {q2:.3f} ms (quartiles "
              f"{q1:.3f}-{q3:.3f}, {ENC_REPS} runs in alternating turns)")

    rates, counts = {}, {}
    for arm in ("float", "int8"):
        rates[arm], counts[arm], tokens = drive(torch, arm, arms[arm], px, REPS)
        check_tokens(tokens, 64)
    per_op = Captioner(params, mcfg, ids, torch.bfloat16, encoder_quant="int8",
                       fused_layers=False)
    per_op.memory_from_pixels(px[:2])                          # warm-up
    torch.cuda.synchronize()
    _, counts["int8_per_op"], tokens = drive(torch, "int8_per_op", per_op, px, 1)
    check_tokens(tokens, 64)
    return {"rates": rates, "enc_ms": {a: statistics.median(m)
                                       for a, m in enc_ms.items()},
            "counts": counts}


def trace_decode(torch, cap, mem, label, max_len=33):
    """One greedy generation of max_len - 1 steps under torch.profiler:
    device kernels per step, device-busy time per step and its share of the
    traced wall time, and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cap.generate_from_memory(mem, max_len=max_len)             # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cap.generate_from_memory(mem, max_len=max_len)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = max_len - 1
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = lambda e: getattr(e, "self_device_time_total", 0)
    total = sum(busy_us(e) for e in dev)
    if not dev or total <= 0:
        print(f"trace {label}: the profiler recorded no device time")
        return None
    top = sorted(dev, key=busy_us, reverse=True)[:6]
    print(f"trace {label} bf16 B={mem.shape[0]}, {steps} steps: "
          f"{sum(e.count for e in dev) / steps:.1f} device kernels and copies "
          f"per step, device busy {total / steps / 1e3:.3f} ms per step, "
          f"traced wall {wall_ms / steps:.3f} ms per step (busy share "
          f"{total / 1e3 / wall_ms:.3f}); most device time: "
          + "; ".join(f"{e.key[:48]} {busy_us(e) / steps / 1e3:.3f} ms x "
                      f"{e.count / steps:.1f}" for e in top))
    return {"kernels_per_step": sum(e.count for e in dev) / steps,
            "busy_ms_per_step": total / steps / 1e3}


def check_decode_routes(torch):
    """Phase 4, the decode routes on the ViT-B model (see the module
    docstring). Returns the fused greedy run's counts and the rates."""
    from mit_tpu_torch.decode import step as step_mod
    from mit_tpu_torch.decode.api import Captioner
    from mit_tpu_torch.decode.beam import beam_generate
    from mit_tpu_torch.models.decoder import DecoderConfig
    from mit_tpu_torch.models.model import ModelConfig, init_model_params
    from mit_tpu_torch.models.vision import PRESETS
    from mit_tpu_torch.ops.decode_layer import fused_decode_layer_plain

    name = "google/vit-base-patch16-224-in21k"
    mcfg = ModelConfig(name, PRESETS[name], DecoderConfig(vocab_size=10000),
                       "cls")
    dcfg, ids = mcfg.decoder, SpecialIds()
    params = init_model_params(torch.Generator().manual_seed(SEED), mcfg, "cuda")
    size = mcfg.vision.image_size
    pixels = torch.from_numpy(
        np.random.default_rng(SEED).uniform(-1, 1, (64, 3, size, size))
        .astype(np.float32))

    # f32, batch 8
    unfused = Captioner(params, mcfg, ids, torch.float32)
    fused = Captioner(params, mcfg, ids, torch.float32, fused_decode=True)
    mem = unfused.memory_from_pixels(pixels[:8])
    tok_u = unfused.generate_from_memory(mem)
    reset_counts()
    tok_f = fused.generate_from_memory(mem)
    steps = max(len(t) for t in tok_f) - 1
    launches = read_counts()["fused_decode_layer"]
    kernel_fn = step_mod.fused_decode_layer
    step_mod.fused_decode_layer = fused_decode_layer_plain
    try:                                  # the same route on the plain version
        tok_p = fused.generate_from_memory(mem)
    finally:
        step_mod.fused_decode_layer = kernel_fn
    print(f"decode f32 B=8 greedy: fused == unfused tokens {tok_f == tok_u}, "
          f"kernel == plain version tokens {tok_f == tok_p}; {steps} steps, "
          f"{launches} fused_decode_layer launches (want "
          f"{dcfg.num_layers * steps}); lengths {[len(t) for t in tok_f]}")
    if not (tok_f == tok_u and tok_f == tok_p
            and launches == dcfg.num_layers * steps):
        raise AssertionError("f32 greedy: the fused route disagrees")

    beams = {}
    for route in (False, True):
        beams[route] = beam_generate(
            params["decoder"], dcfg, mem, ids.start_id, ids.end_id, ids.pad_id,
            dcfg.max_seq_len, 3, compute_dtype=torch.float32, fused=route)
    same = torch.equal(beams[True][0], beams[False][0])
    score_err = (beams[True][1] - beams[False][1]).abs().max().item()
    # the JAX package's bound between its two routes; a sum of 99
    # log-probabilities near -800 has an f32 spacing of 6e-5
    close = torch.allclose(beams[True][1], beams[False][1], rtol=1e-5,
                           atol=1e-5)
    finite = bool(torch.isfinite(beams[True][1]).all())
    one = fused.generate_from_memory(mem, method="beam", beam_size=1)
    cold = fused.generate_from_memory(mem, method="sample", temperature=0.0)
    gen = lambda: torch.Generator(device="cuda").manual_seed(SEED + 1)
    draw = dict(method="sample", temperature=1.0, top_k=50, top_p=0.9)
    s1 = fused.generate_from_memory(mem, generator=gen(), **draw)
    s2 = fused.generate_from_memory(mem, generator=gen(), **draw)
    print(f"decode f32 B=8 beam K=3: fused == unfused tokens {same}, scores "
          f"max_abs_diff {score_err:.3e} (rtol = atol = 1e-5: {close}), best scores "
          f"{[round(x, 3) for x in beams[True][1].tolist()]}; beam_size 1 == "
          f"greedy {one == tok_f}; temperature 0 == greedy {cold == tok_f}; "
          f"sampled batch repeats under one seed {s1 == s2}, differs from "
          f"greedy {s1 != tok_f}")
    if not (same and finite and close and one == tok_f
            and cold == tok_f and s1 == s2 and s1 != tok_f):
        raise AssertionError("f32 beam or sampling: the fused route disagrees")
    del unfused, fused

    # bf16, batch 64
    caps = {False: Captioner(params, mcfg, ids, torch.bfloat16),
            True: Captioner(params, mcfg, ids, torch.bfloat16,
                            fused_decode=True)}
    mem = caps[True].memory_from_pixels(pixels.to("cuda"))
    for cap in caps.values():                                  # warm-up
        cap.generate_from_memory(mem, max_len=20)
    torch.cuda.synchronize()

    # one fused step: which ops run between the embedding and the logits
    prep = step_mod.prepare_decode_params(params["decoder"], torch.bfloat16,
                                          fused=True)
    cache = step_mod.init_cache(params["decoder"], dcfg, mem, None, 16,
                                torch.bfloat16)
    toks = torch.full((64,), ids.start_id, dtype=torch.long, device="cuda")
    reset_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step_mod.decoder_step(prep, dcfg, toks, 0, cache, torch.bfloat16,
                              fused=True)
    torch.cuda.synchronize()
    ops = {e.key: e.count for e in prof.key_averages()}
    products = sum(n for k, n in ops.items() if k in (
        "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm"))
    banned = {k: n for k, n in ops.items() if any(w in k for w in (
        "softmax", "einsum", "layer_norm", "scaled_dot_product"))}
    one_step = read_counts()["fused_decode_layer"]
    print(f"decode bf16 B=64, one fused step: {one_step} fused_decode_layer "
          f"launches (want {dcfg.num_layers}), {products} matrix product "
          f"op (want 1, the logits), softmax/einsum/LayerNorm ops {banned} "
          f"(want none); {sum(ops.values())} ops in all")
    if one_step != dcfg.num_layers or products != 1 or banned:
        raise AssertionError("the fused step runs unfused layer ops")

    # the counted and timed main path: greedy, fused against unfused
    seconds = {False: [], True: []}
    reset_counts()
    for turn in range(DECODE_REPS):
        for route in ((True, False) if turn % 2 == 0 else (False, True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens = caps[route].generate_from_memory(mem)
            seconds[route].append(time.perf_counter() - t0)
            steps = max(len(t) for t in tokens) - 1
            assert len(tokens) == 64 and all(
                t[0] == ids.start_id and 2 <= len(t) <= 100
                and all(0 <= x < dcfg.vocab_size for x in t) for t in tokens)
    counts = read_counts()
    want = {k: 0 for k in counts}
    want["fused_decode_layer"] = dcfg.num_layers * steps * DECODE_REPS
    rates = {}
    for route, secs in seconds.items():
        label = "fused" if route else "unfused"
        rates[label] = 64 / statistics.median(secs)
        print(f"decode bf16 B=64 greedy {label}: {rates[label]:.1f} captions/s, "
              f"{statistics.median(secs) / steps * 1e3:.3f} ms per step "
              f"(median of {DECODE_REPS} runs {[round(x, 4) for x in secs]} s, "
              f"{steps} steps, encoder not included)")
    print(f"decode bf16 B=64 greedy fused: {counts['fused_decode_layer']} "
          f"launches in {DECODE_REPS} runs = {dcfg.num_layers} per step, "
          f"every other counter 0")
    if counts != want:
        raise AssertionError(f"fused greedy launches {counts}, want {want}")

    for route in (True, False):
        trace_decode(torch, caps[route], mem,
                     "greedy fused" if route else "greedy unfused")
    for route in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = caps[route].generate_from_memory(mem, method="beam",
                                                  beam_size=3)
        dt = time.perf_counter() - t0
        steps = max(len(t) for t in tokens) - 1
        label = "fused" if route else "unfused"
        rates[f"beam_{label}"] = 64 / dt
        print(f"decode bf16 B=64 beam K=3 {label}: {64 / dt:.1f} captions/s, "
              f"{dt / steps * 1e3:.3f} ms per step (one run of {dt:.4f} s, "
              f"{steps} steps, 192 rows)")
    return {"counts": counts, "rates": rates}


def check_blip(torch):
    """Phase 4, the BLIP-384 encoder (577 tokens, D 768) at full depth, f32
    batch 8: its self-attention takes flash_attention, the (B, H, T, hd)
    kernel. Returns the counts of one encode call."""
    from mit_tpu_torch.decode.api import Captioner
    from mit_tpu_torch.models.decoder import DecoderConfig
    from mit_tpu_torch.models.model import ModelConfig, init_model_params
    from mit_tpu_torch.models.vision import PRESETS

    mcfg = ModelConfig(BLIP, PRESETS[BLIP], DecoderConfig(vocab_size=10000),
                       "cls")
    params = init_model_params(torch.Generator().manual_seed(SEED), mcfg, "cuda")
    size = mcfg.vision.image_size
    pixels = torch.from_numpy(
        np.random.default_rng(SEED).uniform(-1, 1, (8, 3, size, size))
        .astype(np.float32))
    kern = Captioner(params, mcfg, SpecialIds(), torch.float32)
    plain = Captioner(params, mcfg, SpecialIds(), torch.float32,
                      use_kernel=False)
    kern.memory_from_pixels(pixels[:2])                        # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mem_k = kern.memory_from_pixels(pixels)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    mem_p = plain.memory_from_pixels(pixels)
    err = (mem_k - mem_p).abs().max().item()
    ok = mem_k.shape == (8, 1, 512) and bool(torch.isfinite(mem_k).all())
    print(f"blip384 f32 B=8 ({mcfg.vision.seq_len} tokens, "
          f"{mcfg.vision.num_layers} layers): launches per encode call "
          f"{ {k: v for k, v in counts.items() if v} } (want flash_attention "
          f"11 and nothing else); memory kernel vs plain max_abs_err="
          f"{err:.3e} (limit 1e-4); encode {ms:.3f} ms (one call)")
    want = {k: 0 for k in counts}
    want["flash_attention"] = 11
    if counts != want or not ok or not err <= 1e-4:
        raise AssertionError("BLIP-384 f32: the kernel path disagrees")
    return counts


def dropout_inputs(torch, b, h, t, s, dtype, seed=SEED):
    """q, k ~ N(0, 1), v ~ U(-1, 1) in (B, H, T|S, 64), do ~ N(0, 1); pads
    mask about a fifth of the keys and every key of batch row 0."""
    r = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
    q, k = to(r.normal(size=(b, h, t, 64))), to(r.normal(size=(b, h, s, 64)))
    v = to(r.uniform(-1, 1, size=(b, h, s, 64)))
    do = to(r.normal(size=(b, h, t, 64)))
    pad = np.where(r.random((b, s)) > 0.8, -1e9, 0.0).astype(np.float32)
    pad[0] = -1e9
    return q, k, v, torch.from_numpy(pad).cuda(), do


def check_dropout_kernels(torch):
    """The dropout-attention kernels against their plain versions; returns,
    per wrapper, the max abs error and both times at the bf16 training
    shape (32, 8, 99, 99, 64)."""
    from mit_tpu_torch.ops import dropout_attention as da

    seed, rate = 20261016, 0.1
    results, errs = {}, {"fwd": 0.0, "bwd": 0.0}
    for name, b, h, t, s, causal in DROPOUT_SHAPES:
        for r_seed, r_rate in ((seed, rate), (2**31 - 2, 0.5)):
            got = da.dump_dropout_mask(b, h, t, s, r_seed, r_rate, "cuda")
            want = da.keep_mask(t, s, r_rate, r_seed,
                                torch.arange(b * h, device="cuda"))
            torch.cuda.synchronize()
            same = torch.equal(got, want.reshape(b, h, t, s))
            print(f"dump_dropout_mask {name} ({b}, {h}, {t}, {s}) seed "
                  f"{r_seed} rate {r_rate}: bitwise equal to keep_mask={same}, "
                  f"kept {got.float().mean().item():.4f}")
            if not same:
                raise AssertionError("dump_dropout_mask disagrees")
        if name == "decoder":
            cells = torch.arange(b * h, device="cuda")
            dump_runs = timed_turns(
                torch, lambda: da.dump_dropout_mask(b, h, t, s, seed, rate,
                                                    "cuda"),
                lambda: da.keep_mask(t, s, rate, seed, cells))
            print(f"time dump_dropout_mask          ({b}, {h}, {t}, {s}): "
                  f"kernel {dump_runs['kernel']} ms, plain "
                  f"{dump_runs['plain']} ms (not on the training path)")
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            fwd_tol, bwd_tol = DROPOUT_TOL[dname]
            q, k, v, pad, do = dropout_inputs(torch, b, h, t, s, dtype)
            out = da.flash_attention_dropout_fwd(q, k, v, pad, seed, causal, rate)
            ref = da.flash_attention_dropout_reference(q, k, v, pad, seed,
                                                       causal, rate)
            grads = da.flash_attention_dropout_bwd(q, k, v, pad, do, seed,
                                                   causal, rate)
            ref_grads = da.flash_attention_dropout_reference_backward(
                q, k, v, pad, do, seed, causal, rate)
            torch.cuda.synchronize()
            fwd_err = (out.float() - ref.float()).abs().max().item()
            bwd_abs = [(g.float() - r.float()).abs().max().item()
                       for g, r in zip(grads, ref_grads)]
            bwd_rel = [e / r.float().abs().max().item()
                       for e, r in zip(bwd_abs, ref_grads)]
            finite = all(bool(torch.isfinite(x).all()) for x in (out, *grads))
            print(f"flash_attention_dropout {name} ({b}, {h}, {t}, {s}) "
                  f"causal={causal} {dname:8s}: forward max_abs_err "
                  f"{fwd_err:.3e} (limit {fwd_tol:.0e}); dq, dk, dv max_abs_err "
                  f"{[f'{e:.3e}' for e in bwd_abs]}, over their largest value "
                  f"{[f'{e:.3e}' for e in bwd_rel]} (limit {bwd_tol:.0e}); "
                  f"finite={finite}")
            if not (finite and fwd_err <= fwd_tol
                    and max(bwd_rel) <= bwd_tol):
                raise AssertionError(f"dropout attention disagrees: {name} "
                                     f"{dname}")
            if name == "decoder" and dtype == torch.bfloat16:
                errs = {"fwd": fwd_err, "bwd": max(bwd_abs)}
                fwd_runs = timed_turns(
                    torch,
                    lambda: da.flash_attention_dropout_fwd(q, k, v, pad, seed,
                                                           causal, rate),
                    lambda: da.flash_attention_dropout_reference(
                        q, k, v, pad, seed, causal, rate))
                bwd_runs = timed_turns(
                    torch,
                    lambda: da.flash_attention_dropout_bwd(q, k, v, pad, do,
                                                           seed, causal, rate),
                    lambda: da.flash_attention_dropout_reference_backward(
                        q, k, v, pad, do, seed, causal, rate))
    what = "(32, 8, 99, 99, 64) bf16 causal+pad"
    _, b, h, t, s, _ = DROPOUT_SHAPES[0]
    q, k, v, pad, _ = dropout_inputs(torch, b, h, t, s, torch.bfloat16)
    report(results, "flash_attention_dropout", errs["fwd"], fwd_runs,
           what + ", forward",
           attention_bound(b, h, t, s, torch.bfloat16, extra_bytes=b * s * 4),
           sdpa_ms(torch, q, k, v, True, pad, dropout_p=rate))
    # q, k, v and do read, dq, dk and dv written; five (T, S, 64) products
    report(results, "flash_attention_dropout_bwd", errs["bwd"], bwd_runs,
           what + ", backward",
           bound((3 * t + 4 * s) * b * h * 64 * 2 + b * s * 4,
                 5 * 2 * b * h * t * s * 64, "bf16"))
    return results


class PixelSet:
    """Stands in for ImageTextDataset in FeatureCache.build: image names and
    seeded pixels, no files and no Pillow."""

    def __init__(self, n, size, seed):
        self.image_paths = [f"image{i:04d}" for i in range(n)]
        self._pixels = np.random.default_rng(seed).uniform(
            -1, 1, (n, 3, size, size)).astype(np.float32)

    def load_image(self, path):
        return self._pixels[int(path[5:])]


def token_batch(rng, b, t, vocab, ids):
    """(B, t + 1) caption ids: START, random tokens, END, then PAD, with
    lengths from 8 to t + 1."""
    toks = np.full((b, t + 1), ids.pad_id, np.int64)
    for row, n in zip(toks, rng.integers(8, t + 2, b)):
        row[0] = ids.start_id
        row[1:n - 1] = rng.integers(4, vocab, n - 2)
        row[n - 1] = ids.end_id
    return toks


def check_training(torch):
    """Phase 5: the training path at full width (see the module docstring).
    Returns the counts of the counted run and the throughput."""
    import tempfile

    from mit_tpu_torch.data.dataset import to_device
    from mit_tpu_torch.models.decoder import DecoderConfig
    from mit_tpu_torch.models.model import (
        ModelConfig,
        init_model_params,
        split_trainable,
    )
    from mit_tpu_torch.models.vision import PRESETS
    from mit_tpu_torch.train import checkpoint as ckpt
    from mit_tpu_torch.train.features import FeatureCache, attach_features
    from mit_tpu_torch.train.steps import (
        init_train_state,
        make_eval_step,
        make_optimizer,
        make_train_step,
        tree_leaves,
        tree_map,
    )

    tcfg = TrainConfig()
    ids = SpecialIds()
    name = "google/vit-base-patch16-224-in21k"
    mcfg = ModelConfig(name, PRESETS[name],
                       DecoderConfig(vocab_size=10000,
                                     dropout=tcfg.DECODER_DROPOUT), "cls")
    params = init_model_params(torch.Generator().manual_seed(TRAIN_SEED), mcfg,
                               "cuda")
    trainable, frozen = split_trainable(params)
    rng = np.random.default_rng(TRAIN_SEED)
    t = mcfg.decoder.max_seq_len - 1
    pixels = PixelSet(TRAIN_IMAGES, mcfg.vision.image_size, TRAIN_SEED)
    toks = token_batch(rng, TRAIN_IMAGES, t, mcfg.decoder.vocab_size, ids)

    def batch(i):
        rows = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        b = attach_features({
            "image_paths": pixels.image_paths[rows],
            "decoder_input_tokens": toks[rows, :-1],
            "target_tokens": toks[rows, 1:]}, cache)
        del b["image_paths"]
        return to_device(b, "cuda")

    optimizer, _ = make_optimizer(tcfg)

    def steps(dtype, fused, use_kernel=True, cfg=mcfg):
        return make_train_step(cfg, optimizer, ids.pad_id, dtype,
                               from_features=True, fused_dropout=fused,
                               use_kernel=use_kernel)

    # the counted main path: the cache build, then (c)
    reset_counts()
    t0 = time.perf_counter()
    cache = FeatureCache.build(pixels, frozen["encoder"], mcfg, "cuda",
                               batch_size=TRAIN_BATCH, verbose=False,
                               compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batches = [batch(0), batch(1)]
    fixed = batches[0]
    step = steps(torch.bfloat16, True)
    state = init_train_state(trainable, optimizer)
    losses = []
    for _ in range(BF16_STEPS):
        state, loss = step(state, {}, fixed, TRAIN_SEED)
        losses.append(loss)
    losses = [x.item() for x in losses]
    counts = read_counts()
    per_step = {k: counts[k] / BF16_STEPS for k in
                ("flash_attention_dropout", "flash_attention_dropout_bwd")}
    print(f"train cache: {tuple(cache.features.shape)} {cache.features.dtype} "
          f"from {TRAIN_IMAGES} images in {build_s:.3f} s, "
          f"flash_attention_btd launches {counts['flash_attention_btd']} "
          f"(want {11 * TRAIN_IMAGES // TRAIN_BATCH})")
    print(f"train (c) bf16 B={TRAIN_BATCH} T={t}, {BF16_STEPS} steps on one "
          f"batch: loss first {losses[0]:.6f}, last {losses[-1]:.6f}, min "
          f"{min(losses):.6f}; (b) launches per step {per_step}, every "
          f"other counter 0: {counts}")
    want = {k: 0 for k in counts}
    want.update(flash_attention_btd=11 * TRAIN_IMAGES // TRAIN_BATCH,
                flash_attention_dropout=6 * BF16_STEPS,
                flash_attention_dropout_bwd=6 * BF16_STEPS)
    if counts != want:
        raise AssertionError(f"training launches {counts}, want {want}")
    if not (all(np.isfinite(losses)) and losses[-1] < 0.9 * losses[0]):
        raise AssertionError(f"bf16 loss did not fall: {losses}")

    # (b) at dropout 0: flash_attention_btd in the forward, no dropout kernel
    no_drop = mcfg._replace(decoder=mcfg.decoder._replace(dropout=0.0))
    reset_counts()
    steps(torch.bfloat16, True, cfg=no_drop)(
        init_train_state(trainable, optimizer), {}, fixed, TRAIN_SEED)
    torch.cuda.synchronize()
    counts0 = {k: v for k, v in read_counts().items() if v}
    print(f"train (b) dropout 0, one step: launches {counts0}")
    if counts0 != {"flash_attention_btd": 6}:
        raise AssertionError(f"dropout-0 launches {counts0}")

    # (a) f32: kernel path against plain path, same seeds
    traj = {}
    for use_kernel in (True, False):
        st = init_train_state(trainable, optimizer)
        run = steps(torch.float32, True, use_kernel)
        out = []
        for i in range(5):
            st, loss = run(st, {}, batches[i % 2], TRAIN_SEED)
            out.append(loss.item())
        traj[use_kernel] = out
    rel = max(abs(a - b) / abs(b) for a, b in zip(traj[True], traj[False]))
    print(f"train (a) f32 5 steps: kernel losses {traj[True]}, plain losses "
          f"{traj[False]}; max relative difference {rel:.3e} (limit 1e-4)")
    if not rel <= 1e-4:
        raise AssertionError("f32 kernel and plain training disagree")

    # (d) eval, save, restore, one step each way
    ev = make_eval_step(mcfg, ids.pad_id, torch.bfloat16, from_features=True)
    nll, count = ev(state.params, batches[1])
    val = nll.item() / count.item()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.safetensors")
        ckpt.save_safetensors(path, {**state.params, **frozen}, mcfg)
        ckpt.save_train_state(os.path.join(tmp, "latest"), state, 0, val,
                              tcfg)
        loaded = ckpt.load_safetensors(path, mcfg, "cuda")
        restored, epoch, best = ckpt.restore_train_state(
            os.path.join(tmp, "latest"), init_train_state(trainable, optimizer))
        size = os.path.getsize(path)
    weights_same = all(tree_leaves(tree_map(
        torch.equal, {**state.params, **frozen}, loaded)))
    a_state, a_loss = step(state, {}, batches[1], TRAIN_SEED)
    b_state, b_loss = step(restored, {}, batches[1], TRAIN_SEED)
    resume_same = torch.equal(a_loss, b_loss) and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a_state.params),
                                          tree_leaves(b_state.params)))
    print(f"train (d) eval loss {val:.6f} over {count.item():.0f} tokens; "
          f"safetensors {size} bytes, reloaded equal={weights_same}; resume "
          f"(step {restored.step}, epoch {epoch}, best {best:.6f}): one step "
          f"equal to the uninterrupted one={resume_same} (loss "
          f"{a_loss.item():.6f})")
    if not (weights_same and resume_same and restored.step == BF16_STEPS
            and np.isfinite(val)):
        raise AssertionError("save, restore and resume disagree")

    # (e) throughput, fused dropout on and off, in alternating turns
    runs = {True: [], False: []}
    st0 = init_train_state(trainable, optimizer)
    for fused in (True, False):                               # warm-up
        steps(torch.bfloat16, fused)(st0, {}, fixed, TRAIN_SEED)
    for turn in range(RUNS):
        for fused in ((True, False) if turn % 2 == 0 else (False, True)):
            run, st = steps(torch.bfloat16, fused), st0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(RUN_STEPS):
                st, loss = run(st, {}, batches[i % 2], TRAIN_SEED)
            torch.cuda.synchronize()
            runs[fused].append(RUN_STEPS / (time.perf_counter() - t0))
    rates = {}
    for fused, sps in runs.items():
        q1, q2, q3 = statistics.quantiles(sps, n=4)
        rates["fused" if fused else "plain"] = q2
        print(f"train (e) bf16 B={TRAIN_BATCH} fused_dropout={fused}: "
              f"{q2:.3f} steps/s median (quartiles {q1:.3f}-{q3:.3f}, "
              f"{RUNS} runs of {RUN_STEPS} steps), {q2 * TRAIN_BATCH:.1f} "
              f"images/s; runs {[round(x, 3) for x in sps]}")
    return {"counts": counts, "rates": rates}


# kernel name -> (source, the TPU kernel it replaces, the path whose run
# gives its launch count)
KERNELS = {
    "flash_attention_btd": ("flash_attention_btd.cu",
                            "mit_tpu/ops/pallas_attention.py:160", "float"),
    "flash_attention_btd_fusedqkv": ("flash_attention_btd.cu",
                                     "mit_tpu/ops/pallas_attention.py:196",
                                     "int8_per_op"),
    "quantize_rows": ("quantize_rows.cu",
                      "mit_tpu/ops/pallas_int8_mlp.py:72", "int8"),
    "int8_gemm": ("int8_gemm.cu", "mit_tpu/ops/pallas_int8_mlp.py:212",
                  "int8"),
    "int8_linear": ("int8_gemm.cu", "mit_tpu/ops/pallas_int8_mlp.py:212",
                    "int8"),
    "fused_int8_mlp": ("int8_gemm.cu", "mit_tpu/ops/pallas_int8_mlp.py:88",
                       "int8"),
    "fused_int8_vit_layer": ("int8_gemm.cu",
                             "mit_tpu/ops/pallas_int8_layer.py:263", "int8"),
    "flash_attention_dropout": ("flash_attention_dropout.cu",
                                "mit_tpu/ops/pallas_dropout_attention.py:77",
                                "train"),
    "flash_attention_dropout_bwd": ("flash_attention_dropout.cu",
                                    "mit_tpu/ops/pallas_dropout_attention.py:91",
                                    "train"),
    "fused_decode_layer": ("decode_layer.cu",
                           "mit_tpu/ops/pallas_decode_layer.py:60",
                           "decode_fused"),
    "flash_attention": ("flash_attention_btd.cu",
                        "mit_tpu/ops/pallas_attention.py:86", "blip384"),
}


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
    int8 = check_int8_kernels(torch)
    dropout = check_dropout_kernels(torch)
    decode_layer = check_decode_layer_kernel(torch)
    bhtd = check_bhtd_kernel(torch)

    print("== 4 slice", flush=True)
    slice_ = check_slice(torch)
    rates, enc_ms = slice_["rates"], slice_["enc_ms"]
    print(f"captions/s bf16 B=64: float {rates['float']:.2f}, int8 "
          f"{rates['int8']:.2f}; median encoder ms: float "
          f"{enc_ms['float']:.3f}, int8 {enc_ms['int8']:.3f}")
    routes = check_decode_routes(torch)
    slice_["counts"]["decode_fused"] = routes["counts"]
    print("decode captions/s bf16 B=64 (decoding only): " + ", ".join(
        f"{k} {v:.2f}" for k, v in routes["rates"].items()))
    slice_["counts"]["blip384"] = check_blip(torch)

    print("== 5 train", flush=True)
    train = check_training(torch)
    slice_["counts"]["train"] = train["counts"]
    print(f"training bf16 B={TRAIN_BATCH}: fused dropout "
          f"{train['rates']['fused']:.3f} steps/s, plain dropout "
          f"{train['rates']['plain']:.3f} steps/s (medians)")

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "mit_tpu"))
    if loaded:
        raise AssertionError(f"the smoke imported JAX-side modules: {loaded}")

    print("== 6 result", flush=True)
    btd = times["bfloat16"]
    results = dict(int8, **dropout, **decode_layer, **bhtd, flash_attention_btd={
        "max_abs_err": errors[("encoder", "bfloat16")],
        "ms": btd["kernel"], "plain_ms": btd["plain"],
        "bound_ms": btd["bound_ms"], "bound_by": btd["bound_by"],
        "library_ms": btd["library_ms"],
    })
    lines = []
    for name, (source, replaces, path) in KERNELS.items():
        launches = slice_["counts"][path][name]
        if launches == 0:
            raise AssertionError(f"{name} was not launched on its path")
        lines.append({"name": name, "route": "cuda",
                      "source": f"mit_tpu_torch/csrc/{source}",
                      "replaces": replaces, "launches": launches,
                      **results[name]})
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
