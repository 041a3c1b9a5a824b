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
            - the bf16 tensor-core kernel of flash_attention_btd against the
              plain version at those shapes and at CLIP ViT-L's (8, 257,
              1024), limit 2e-2, the fully masked batch row uniform; its
              time, the profiler's device time, the bound and the library
              call; then a table of its tilings (one warpgroup of 64 query
              rows a block, or two) at the encoder shape;
            - moe_experts (csrc/moe_experts.cu), the grouped SwiGLU experts
              of Kimi-VL-A3B (D 2048, F 1408, 64 experts, 6 a token),
              against their plain composition at a decode step's 384 routes
              and a prefill's 30,720, and with half the experts given no
              rows (limit 2e-2 of the largest output); timed beside the
              composition and torch._grouped_mm (check_moe_kernel); then
              on the Kimi-VL path at the published widths, one batch of 64
              replayed under the profiler: 1,664 expert kernels, the
              counters' calls and rows alike (check_kimi_vl_path; `python3
              chip_smoke.py --moe` runs phases 1, 2 and these alone, then
              one JSON line);
            - quantize_rows, without and with its LayerNorm, on (12608, 768)
              and (12608, 3072) f32 and bf16 rows with an all-zero row:
              codes and scales bitwise equal without the LayerNorm, codes
              within one step (at most 1e-3 of them) with it;
            - int8_gemm at K x N = 768 x 2304, 768 x 768, 768 x 3072 and
              3072 x 768, M = 12608 and 197: int32 accumulators bitwise
              equal, and each shape's epilogue of the fused layer (plus
              gelu, quick_gelu and the bf16 residual) within rtol 2e-6 (f32
              out) or one bf16 rounding; the four summed beside
              torch._int_mm on the same shapes; then the path's other
              shapes (GEMM_SHAPES: the patch embedding, the last layer's 64
              CLS rows, CLIP ViT-L/14's K = 592, ViT-L's four), each with
              raw accumulators bitwise equal to int8_accumulate, its
              epilogue, its time, bound and torch._int_mm;
            - flash_attention_btd_fusedqkv at (64, 197, 3 x 768), f32 (1e-4),
              bf16 (2e-2) and the fused layer's numerics (bf16 in, f32 out,
              2e-2);
            - int8_linear (the patch embedding) and fused_int8_mlp at 12608
              rows, relative L2 <= 1e-3;
            - fused_int8_vit_layer at ViT-B (64, 197, 768), F 3072, 12 heads,
              and fused_int8_vit_layer_split at ViT-L (8, 257, 1024), F 4096,
              16 heads, bf16: relative L2 <= 5e-3 (the JAX package's bound
              between its layer kernel and its composition); the ViT-B
              layer also at head widths 128 and 32 (6 and 24 heads), whose
              attention runs the wide tiled kernel and the any-shape
              kernel; rows 2, 3 and the layers beside their library
              yardsticks (torch._int_mm at their GEMM shapes, plus one
              SDPA call for a layer);
            - int8_mlp_fused (csrc/int8_mlp_fused.cu, check_int8_mlp_fused)
              at ViT-B's, CLIP-L's and ViT-H's widths, batch 64: its shared
              memory and cudaOccupancyMaxActiveClusters; in the layer's,
              the split layer's and fused_int8_mlp's forms one launch,
              bitwise the composition's for gelu (quick_gelu: at most 1e-3
              of the rows differ, one ulp of expf), within 5e-3 (layer) or
              1e-3 (MLP) relative L2 of the plain version; the layer form
              timed against the plain version and in turns against the
              composition, with its bound, device time and torch._int_mm at
              fc1 and fc2; then row 4 in turns (check_row4_turns): the
              split form at (8, 257, 1024) and fused_int8_vit_layer at
              (64, 257, 1024), each with either MLP route.
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
            must launch exactly its kernels per encode call
            (slice_per_encode; float: flash_attention_btd 11; int8 fused:
            fused_int8_vit_layer 11, int8_linear 3, fused_int8_mlp 1, and
            where the port's rule sends the MLP halves to int8_mlp_fused,
            12 of those with 25 quantize_rows and 25 int8_gemm, else 49
            and 49; int8 per-op: int8_linear 25, fused_int8_mlp 12,
            flash_attention_btd_fusedqkv 11). Prints captions/s of both
            arms and their median encoder ms.
            Phase 3 also holds the dropout-attention kernels (training's
            decoder self-attention) to their plain versions at (32, 8, 99,
            99, 64), causal with padded keys (every key of batch row 0), and
            at a ragged (3, 2, 7, 9), f32 and bf16: the dump kernel's
            keep-mask bitwise equal to keep_mask; the forward within 1e-5
            (f32) or 2e-2 (bf16) absolute; dq, dk and dv within 1e-5 (f32)
            or 1e-2 (bf16) of their largest value. It times forward and
            backward, kernel against plain, at the bf16 training shape
            (the backward also beside the backward of the library call with
            dropout, and both device times), and the dump kernel against
            keep_mask at (32, 8, 99, 99). The
            bf16 forward (tensor cores) also has its keep-mask recovered
            from its output (q = k = 0, v one-hot) and compared bit for bit
            with keep_mask at those shapes and (2, 2, 128, 128), then its
            time beside the library call with dropout (CUDA events and the
            profiler's device time).
5. train    Training at the default model's full width: a random ViT-B/16
            builds the CLS feature cache of 64 pixel images made in the run
            (FeatureCache.build, through flash_attention_btd); decoder 6 x
            512, 8 heads, FF 2048, vocab 10000, T 99, batch 32, the config's
            AdamW, clip 5.0 and dropout 0.1, token ids from a numpy seed.
            (a) f32, 5 steps, the kernel path against the plain path
            (flash_attention_dropout_plain; the same seeds, so the same
            hash masks and the same other masks): losses within 1e-4
            relative. (b) launches: the graphed step runs the dropout
            wrappers 6 times each way in its warm-up and 6 in its capture,
            and its replays run 6 dropout forward and 6 backward kernels a
            step in the device trace of (f), the launches of the kernels
            line; 6 flash_attention_btd and no dropout launch in an eager
            step at dropout 0. (c) bf16, 30 graphed steps on one batch (one
            capture, then replays, no eager step): the loss falls. (d) an eval step, then safetensors and train
            state saved, restored, and one step from the restore equal to
            one step without it. (e) steps/s and images/s at bf16 batch 32,
            fused dropout on and off (the plain dropout path), median and
            quartiles of RUNS runs in alternating turns. (f) TRACE_STEPS
            fused-dropout steps under torch.profiler: device kernels and
            device-busy ms per step, busy share, the dropout kernels' ms per
            step. Every counter is set to 0 before the cache build and (c),
            and read after them; every bf16 backward of (c)'s warm-up and
            capture ran the tensor-core kernel. Then remat (check_remat): (a) f32, 8 rows,
            dropout 0.1, fused dropout on and off: loss and every gradient
            with remat against without, and one train step each way, within
            1e-6 relative (bitwise is printed); (b) one bf16 fused-dropout
            step each way, counters set to 0 before it and read after it:
            6 dropout forward launches without remat and 12 with it (the
            recompute), 6 backward either way; (c) steps/s (median and
            quartiles, alternating turns) and max_memory_allocated over a
            step, bf16 batch 32, with and without remat, not held; (d) one
            line a host library of native/ (the JPEG loader, the BPE core):
            built, or why not (the smoke needs neither).
            `python3 chip_smoke.py --trace-train` runs
            phases 1, 2 and (f) alone, on seeded tokens and features.
            Phase 3 also holds fused_decode_layer to its plain version at
            (B, T) = (64, 16), (64, 100), (192, 100) and a ragged (3, 7),
            D 512, F 2048, with a scalar and with per-row positions, a madd
            that masks PAD keys and one fully masked row, with and without
            the in-kernel cache write: f32 within 1e-5 on x' and on the
            fresh rows, bf16 within 0.05, each timed with its device time
            (then a table of its grids and slices of K against the plan,
            and one launch captured in a CUDA graph and replayed: the same
            outputs); and flash_attention (the
            (B, H, T, hd) kernel) at (8, 12, 577, 64), f32 (1e-5) and bf16
            (2e-2), and at the causal padded decoder shape (64, 8, 100, 64);
            at the 577-token shape the profiler's device time, and
            flash_attention_btd on the same numbers in (B, T, D).
            Phase 3 then holds the kernels of csrc/attention_any_shape.cu,
            which take the shapes the tiled kernels do not: every attention
            wrapper at head widths 136, 100 and 32 (causal, padded, a fully
            padded batch row), f32 and bf16, at the tiled kernels' limits;
            the dropout wrappers, forward and backward, at 160 tokens and
            at head widths 128 and 32; the dropout forward's keep-mask
            recovered from its output bit for bit; then multihead_attention
            on the card, 544 wide in 4 heads over 160 tokens, without and
            with fused dropout, which must launch a kernel at every call
            and agree with the plain path in output and input gradient.
            Phase 3 ends with the tiled kernels at heads of 72 to 128
            columns (check_wide_heads): flash_attention_btd (bf16, f32)
            and fused QKV (bf16, f32, the int8 layer's numerics) at
            ViT-H/14's (64, 257, 1280) in 16 heads of 80, the (B, T, D)
            entry also causal and padded; flash_attention at (8, 16, 257,
            hd) for hd 72, 80, 96, 112 and 128, causal and padded (a fully
            padded batch row, a row whose only visible key is padded), bf16
            and f32; the int8 layer at ViT-H/14's width (relative L2 5e-3).
            Each against its plain version at the limits above, each launch
            counted as "tiled" in its wrapper's .kernels, and each beside
            the any-shape kernel through its C entry at the same shape
            (which ran these widths before; the int8 layer with that
            attention): its error, and times of the kernel (events and the
            profiler's device time), the plain version, the bound, SDPA
            (events and device) and the any-shape kernel; then a table of
            the wide bf16 kernel's two tilings at ViT-H/14's shape.
            Yardsticks, timed and used nowhere in the port: one
            F.scaled_dot_product_attention call at each attention kernel's
            shape and torch._int_mm at each int8_gemm shape.
            Phase 4 also drives the decode routes on the ViT-B model. f32
            batch 8: greedy tokens of the fused route (fused_decode_layer
            in every layer of every step) equal the unfused route's, and
            the kernel's equal its plain version's run through the same
            step; beam K = 3 tokens equal between the routes and between
            the kernel and its plain version, scores within
            rtol = atol = 1e-5; beam_size 1 and temperature 0 equal greedy; a sampled
            batch (temperature 1, top-k 50, top-p 0.9) repeats under the
            same seed. bf16 batch 64: one fused step under torch.profiler
            runs one matrix product (the logits) and no softmax, einsum or
            LayerNorm op; the fused greedy run launches exactly num_layers
            kernels a step; captions/s and ms per step of greedy fused
            against unfused in alternating turns, and of beam K = 3; a
            32-step trace of each greedy route (device kernels and
            device-busy time per step).
            Then the continuously batched CaptionService on the same model
            with the END logit's bias raised by END_MARGIN, so that captions
            end at several lengths; every request goes through run_stream
            (chunks of seeded pixels through memory_from_pixels) or
            submit_memory_batch. f32, 6 slots, 24 requests: the fused CLS
            service's tokens on the kernel equal them with
            fused_decode_layer_plain swapped in and greedy_generate(fused=
            True)'s; the unfused CLS service equals unfused batch greedy;
            the full-memory service (unfused, per-row positions) equals
            full-memory batch greedy; beam K = 3 equals beam_generate(fused=
            True); a cache_len 16 run with overflow equals the unbucketed
            run; slots were reused while others decoded. bf16, 64 slots, 256
            requests in 4 chunks: captions/s (encoder included), window ms
            and caption lengths of greedy fused (windows of 8 and 1 tokens),
            greedy unfused, beam K = 3 fused, sampling and greedy over full
            memory (S_mem 197), each with its launches and routes held (every
            CLS step fused, every full-memory step unfused, 11 or 12
            flash_attention_btd launches a chunk); the share of tokens equal
            to batch greedy (reported: the service's CLS constant is f32);
            a 32-window trace of the greedy service, fused, unfused and over
            full memory. Then
            the BLIP-384 encoder (577 tokens) at full depth, f32 batch 8:
            11 flash_attention launches per encode call and no
            flash_attention_btd, memory within 1e-4 of the plain path's.
            Every path of phases 4, 4b and 5 also reads the route counters
            of multihead_attention and decoder_step (set to 0 with the
            launch counters): every attention call went to a kernel wrapper,
            none to the plain path, and every step asked to fuse ran the
            fused layers.
4b. pretrained
            Pretrained encoders booted from local HF files written in the
            run from seeded weights, and the uint8 image path. A composite
            CLIP ViT-L/14 checkpoint (model.safetensors through the port's
            codec, the tower under vision_model. beside one text tensor,
            config.json with a nested vision_config; its bytes and seconds
            printed) goes through init_model_params_pretrained onto the card
            with the 6 x 512 decoder: the VisionConfig equals the written
            one and every tensor the seeded one, bit for bit. Seeded uint8
            images, 64 x 480 x 640, through device_preprocess on the card:
            within PREPROCESS_TOL of the same call on the CPU, its ms
            printed. f32 batch 8: the kernel encoder's memory within 1e-4 of
            the plain path's, greedy tokens identical from the kernel path,
            the plain path and the fused decode step, 23 flash_attention_btd
            launches an encode and no plain route; the int8 arm within 3
            times its own noise floor and at cosine > 0.999 to the float
            arm. bf16 batch 64, both arms: launches per encode held to
            per_encode(23); each arm's memory against its plain version on
            the same pixels, within FLOOR_FACTOR times what one bf16 ulp of
            the pixels moves that plain version, and the int8 arm at cosine
            > 0.999 to the float arm; encode ms (median of ENC_REPS in alternating
            turns) and captions/s from uint8 on the host through upload,
            device_preprocess, encode and fused greedy (StepTimer and fence
            of the port), with the fused steps' launches held; the int8
            encode with each MLP route (int8_mlp_turns: launches per encode
            and the layers' MLP routes held, encode ms in alternating
            turns, device ms by kernel name under torch.profiler). Then a
            BLIP-base checkpoint (self_attn.qkv under vision_model.), f32
            batch 8, 11 flash_attention launches, memory within 1e-4 of
            plain; and a bare ViT-B/16 pytorch_model.bin without config.json
            (geometry inferred): f32 batch 8 within 1e-4 of plain, bf16
            batch 64 with 11 flash_attention_btd launches. The smoke prints
            its wall time before the result.
4c. vit-h   ViT-H/14 at its published widths (VIT_H: 32 layers of 1280 in
            16 heads of 80, MLP 5120, patch 14 at 224, 257 tokens; no
            PRESETS entry) from a model.safetensors (2.5 GB f32, seeded)
            and config.json (model_type "vit") written in the run to a
            temporary directory, deleted at the end: booted through
            init_model_params_pretrained(..., local_files_only=True), its
            VisionConfig equal to the written one and every tensor bit
            for bit the seeded one; seeded uint8 64 x 480 x 640 through
            device_preprocess, card against CPU. f32 batch 8: memory from
            the kernel (the f32 kernel at head width 80) within 1e-4 of the
            plain path, greedy tokens equal on the kernel, plain and fused
            step routes; the int8 arm within FLOOR_FACTOR times its own
            noise floor and at cosine > 0.999 to the float arm. bf16 batch
            64, both arms, fused greedy: launches per encode held to
            per_encode(31), the routes held, and 31 "tiled" and 0
            "any_shape" launches an encode in flash_attention_btd.kernels
            (float) and flash_attention_btd_fusedqkv.kernels (int8); encode
            ms in alternating turns, and captions/s from uint8 split into
            upload, preprocess + encode and the 99 fused steps; the int8
            encode with each MLP route, as in 4b. Prints its seconds.
            `python3 chip_smoke.py --wide-heads` runs phases 1, 2,
            check_wide_heads and this phase alone, then one JSON line of
            the wide-head kernels. `python3 chip_smoke.py --int8-mlp` runs
            phases 1, 2, the int8 lines of phase 3 (check_int8_kernels)
            and the int8 arms of 4b and 4c alone (check_int8_paths: each
            held to its plain version and int8_mlp_turns), then one JSON
            line of the fused MLP's kernel lines.
5b. mesh    The device mesh (parallel/mesh.py). Rows 9 and 10 under the
            cell map: at (32, 8, 99, 99, 64) bf16 split as the (2, 1) and
            (1, 2) meshes split it, each rank's dump-kernel mask and its
            forward kernel's mask (recovered from the output) bitwise equal
            to the plain mask at its map and to its slice of the global
            launch's; its forward and backward within DROPOUT_TOL of the
            plain version's (bitwise against the global launch's slice is
            printed); forward, backward and dump times at the global shape
            (no map, the identity map: the same launches) and the ranks'
            shapes, each the median of CELL_MAP_ROUNDS bursts taken in
            turns, a burst CELL_MAP_ITERS launches queued behind a sleep
            kernel and timed with CUDA events (the card's time, not the
            host's issue time); the times are marked trusted where no map
            and the identity map agree within CELL_MAP_AGREE and every
            burst was queued before the sleep ended.
            `python3 chip_smoke.py --cell-map` runs phases 1, 2 and this
            part alone. Then two
            ranks on the one card over gloo (this script run twice with
            --mesh-rank, joined within MESH_TIMEOUT, every process stopped):
            at (2, 1) and (1, 2), the training phase's model from seeded
            CLS features, batch 32, dropout 0.1, fused dropout, MESH_STEPS
            f32 steps with losses within 1e-5 relative of one rank's, then
            MESH_STEPS bf16 steps whose loss falls; each rank, counted from
            0 before each run: 6 dropout forward and 6 backward launches a
            step at its local shape (16, 8 or 32, 4), the bf16 backward on
            the tensor cores; steps/s printed as "2 ranks sharing one card,
            not a multi-GPU rate". One rank under nccl (--mesh-nccl): the
            mesh at (1, 1) built through init_distributed_mesh, an
            all-reduce, two steps equal to two without the mesh. The
            CaptionService over a single-process mesh of two "data" shards
            on cuda:0: 64 slots, 256 requests, bf16, greedy fused and beam
            K = 3, tokens equal to one shard's, fused_decode_layer launches
            counted from 0 before each sharded run, captions/s and window
            ms beside one shard's.
5c. tp encoder
            The frozen encoder in the train step, split over "model"
            (TP_SHAPE (1, 2)). Rows 7 and 8 first, at the local shapes a
            rank gives them: flash_attention_btd at (32, 197, 384) f32
            (limit 1e-4) and bf16 (2e-2), flash_attention at (4, 6, 577,
            64) f32 (1e-5), each against its plain version, timed against
            it, with its bound and the library call. Then two ranks on the
            one card over gloo (this script run twice with
            --tp-encoder-rank, joined within MESH_TIMEOUT): ViT-B/16 at
            full width with the training phase's decoder, batch 32 of
            seeded pixel images, dropout 0.1, fused dropout, the encoder
            this rank's piece (shard_encoder), MESH_STEPS f32 steps with
            losses within 1e-5 relative of one rank's, then MESH_STEPS bf16
            steps whose loss falls; counted from 0 before each run, 11
            flash_attention_btd launches a step a rank, all at (32, 197,
            384), 6 dropout forward and 6 backward, no other kernel and no
            plain attention route. One BLIP-384 f32 step at batch 4: 11
            flash_attention launches at (4, 6, 577, 64) and no
            flash_attention_btd, its loss within 1e-5 of one rank's. The
            int8 arm, TP_INT8_STEPS f32 steps: the int8 encoder whole on
            each rank, launch counts equal to one rank's, losses within
            1e-5. steps/s printed as "2 ranks sharing one card, not a
            multi-GPU rate". `python3 chip_smoke.py --tp-encoder` runs
            phases 1, 2 and this phase alone.
6. result   The smoke's wall time, then one JSON line describing each
            kernel (its error, its time, its plain version's time, its
            bound and, where one PyTorch call
            computes the same function, that call's time; for the kernels
            near the host's issue floor also the profiler's device time of
            the kernel and of the library call; rows 7 and 8 also under
            "tp": their local shape in phase 5c, launches a rank there, and
            their error, times and bound at that shape; the wide heads'
            instantiations that phase 4c's path runs, with its launches),
            before it the same for every wide-head line of phase 3
            ("wide_head_kernels", each with "any_shape_ms") and for the
            any-shape kernels, then the last line,
            {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
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
# the path's other int8 GEMM shapes, (name, M, K, N, epilogue as in GEMMS):
# the patch embedding, the last layer on the CLS rows, CLIP ViT-L/14's patch
# embedding (K 588 padded to 592) and ViT-L's layer at batch 8
GEMM_SHAPES = [
    ("patch", 64 * 196, 768, 768, "none", None, "bfloat16"),
    ("cls qkv", 64, 768, 2304, "none", None, "bfloat16"),
    ("cls fc2", 64, 3072, 768, "none", "float32", "bfloat16"),
    ("clip patch", 8 * 256, 592, 1024, "none", None, "float32"),
    ("vit-l qkv", 8 * 257, 1024, 3072, "none", None, "bfloat16"),
    ("vit-l out", 8 * 257, 1024, 1024, "none", "bfloat16", "bfloat16"),
    ("vit-l fc1", 8 * 257, 1024, 4096, "gelu", None, "float32"),
    ("vit-l fc2", 8 * 257, 4096, 1024, "none", "bfloat16", "bfloat16"),
]
# head widths other than 64 of the int8 layer at ViT-B's width (the wide
# tiled kernel runs its attention at 128, the any-shape kernel at 32)
INT8_HEADS = [("hd128", 6), ("hd32", 24)]


def per_encode(full_layers, mlp_layers=True, mlp_cls=True):
    """Launches of one CLS-memory encode call with `full_layers` full
    layers (the last layer runs on the CLS rows): the float arm's attention
    in each full layer; the int8 arm's fused layer of two quantize_rows and
    two int8_gemm launches (LN1 + QKV, the context + out-projection), its
    attention and its MLP half, plus the patch embedding and the last
    layer's QKV and out-projection (int8_linear) and MLP (fused_int8_mlp).
    An MLP half is one int8_mlp_fused launch where the port's rule fuses it
    (`mlp_layers` for the full layers', `mlp_cls` for the CLS rows'), else
    the composition: two more quantize_rows and int8_gemm launches."""
    mlps = (full_layers if mlp_layers else 0) + (1 if mlp_cls else 0)
    per_op = 2 * full_layers + 3 + 2 * (full_layers + 1 - mlps)
    return {
        "float": {"flash_attention_btd": full_layers},
        "int8": {"fused_int8_vit_layer": full_layers, "int8_linear": 3,
                 "fused_int8_mlp": 1,
                 "flash_attention_btd_fusedqkv": full_layers,
                 "quantize_rows": per_op, "int8_gemm": per_op,
                 "int8_mlp_fused": mlps},
    }


def mlp_fused_on(vcfg, rows):
    """Whether the port's rule (int8_mlp.mlp_kernel_for) sends an MLP half
    of this encoder over `rows` rows to the fused kernel."""
    from mit_tpu_torch.ops import int8_mlp

    act = "quick_gelu" if vcfg.hidden_act == "quick_gelu" else "gelu"
    return int8_mlp.mlp_kernel_for(vcfg.hidden_size, vcfg.intermediate_size,
                                   act, rows) == "fused"


def encode_launches(vcfg, batch, tokens):
    """per_encode for this encoder at `batch` images of `tokens` tokens,
    its MLP halves routed as the port's rule routes them."""
    return per_encode(vcfg.num_layers - 1, mlp_fused_on(vcfg, batch * tokens),
                      mlp_fused_on(vcfg, batch))


def slice_per_encode(vcfg, batch):
    """Launches per encode call of each path of the slice (ViT-B/16, 197
    tokens): encode_launches and the int8 per-op form, whose 12 MLPs run
    fused_int8_mlp (11 over every token, 1 over the CLS rows)."""
    mlp = (11 * mlp_fused_on(vcfg, batch * 197)
           + mlp_fused_on(vcfg, batch))
    per_op = 25 + 2 * (12 - mlp)
    return dict(encode_launches(vcfg, batch, 197), int8_per_op={
        "int8_linear": 25, "fused_int8_mlp": 12,
        "flash_attention_btd_fusedqkv": 11, "quantize_rows": per_op,
        "int8_gemm": per_op, "int8_mlp_fused": mlp})


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
# the pretrained phase: checkpoints written in the run, seeded uint8 images
CLIP_L = "openai/clip-vit-large-patch14"
VIT_B = "google/vit-base-patch16-224-in21k"
PRETRAINED_BATCH = 64
F32_BATCH = 8
UINT8_HW = (480, 640)
# card against CPU on the normalized output: about 7e-3 on the 0..255 scale
PREPROCESS_TOL = 1e-4


# training phase
TRAIN_BATCH = 32
TRAIN_IMAGES = 64
TRAIN_SEED = 1234
BF16_STEPS = 30
RUNS = 5                 # throughput runs per configuration
RUN_STEPS = 10           # steps per throughput run
TRACE_STEPS = 8          # traced bf16 train steps (fused dropout)
REMAT_BATCH = 8          # rows of the f32 remat identity
REMAT_TOL = 1e-6         # remat against no remat: relative, per gradient
DROPOUT_SHAPES = [("decoder", 32, 8, 99, 99, True), ("ragged", 3, 2, 7, 9, False)]
DROPOUT_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}
# the service phase: the END logit's bias raised by END_MARGIN (chosen on a
# CPU rehearsal of the phase so that captions end at many lengths; the phase
# prints them), f32 identity checks on F32_SLOTS slots, rates at bf16 on
# SERVICE_SLOTS slots with SERVICE_REQUESTS requests in chunks of
# SERVICE_CHUNK images, windows of SERVICE_WINDOW tokens
END_MARGIN = 1.1
F32_SLOTS, F32_REQUESTS, F32_CHUNK = 6, 24, 8
SERVICE_SLOTS, SERVICE_REQUESTS, SERVICE_CHUNK = 64, 256, 64
SERVICE_WINDOW = 8
SERVICE_TRACE_STEPS = 32
DEVICE_LINE = []         # nvidia-smi's name and power limit, set by main()


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


def tiled_bf16(torch, q, k, v, pad, causal, tiling, hd=64):
    """The tensor-core kernel at a tiling other than the wrapper's."""
    from mit_tpu_torch import kernels

    b, t, d = q.shape
    out = torch.empty_like(q)
    rc = kernels.lib().mit_flash_attention_btd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if pad is None else pad.data_ptr(), out.data_ptr(), b, t,
        k.shape[1], d, hd, int(causal), int(pad is not None), *tiling,
        torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "mit_flash_attention_btd_bf16")
    return out


def device_ms(torch, fn, iters=TIMED_ITERS):
    """Mean device milliseconds per call by torch.profiler's kernel times:
    what the card spends, where cuda_ms is bounded below by the host's time
    to enqueue a call. None if the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0)
                for e in prof.key_averages())
    return total / iters / 1e3 if total > 0 else None


# the grouped expert kernel's shapes: Kimi-VL-A3B's experts (D 2048,
# F 1408, 64 experts, 6 a token) at a decode step of 64 rows and at the
# prefill of 64 x 80 tokens
MOE_SHAPES = (("decode", 64), ("prefill", 5120))
MOE_D, MOE_F, MOE_E, MOE_K = 2048, 1408, 64, 6


def moe_bound(hit, routes, d=MOE_D, f=MOE_F):
    """The hit experts' three matrices and the routed rows in and out read
    or written once; 2 x 3 x D x F operations a route."""
    return bound(hit * 3 * d * f * 2 + routes * d * 2 * 2,
                 2 * 3 * d * f * routes, "bf16")


def grouped_mm_call(torch, x, token, offsets, wg, wu, wd):
    """The yardstick: the same SwiGLU through ``torch._grouped_mm`` on the
    gathered rows (three grouped products), or None where this torch lacks
    it or refuses the shapes."""
    gm = getattr(torch, "_grouped_mm", None)
    if gm is None:
        return None
    offs = offsets[1:].contiguous()
    rows = x[token.long()]

    def call():
        g = gm(rows, wg, offs=offs)
        u = gm(rows, wu, offs=offs)
        return gm(torch.nn.functional.silu(g) * u, wd, offs=offs)
    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:
        print(f"torch._grouped_mm refused: {str(e).splitlines()[0]}")
        return None
    return call


def check_moe_kernel(torch):
    """The grouped SwiGLU expert kernel (``csrc/moe_experts.cu``) against
    its plain composition at the decode and prefill shapes, with half the
    experts given no rows in a second case; times against the composition
    and ``torch._grouped_mm``."""
    from mit_tpu_torch.ops import moe

    g = torch.Generator(device="cuda").manual_seed(SEED)
    d, f, e, k = MOE_D, MOE_F, MOE_E, MOE_K
    w = lambda *shape: (torch.randn(shape, generator=g, device="cuda")
                        * 0.02).to(torch.bfloat16)
    wg, wu, wd = w(e, d, f), w(e, d, f), w(e, f, d)
    results = {}
    for label, t in MOE_SHAPES:
        x = torch.randn((t, d), generator=g, device="cuda").to(torch.bfloat16)
        for experts in (e, e // 2):
            idx = torch.rand((t, experts), generator=g,
                             device="cuda").topk(k, -1).indices
            _, token, offsets = moe.group_routes(idx, e)
            kern = lambda: moe.grouped_swiglu(x, token, offsets, wg, wu, wd)
            plain = lambda: moe.grouped_swiglu_plain(x, token, offsets, wg,
                                                     wu, wd)
            want = plain().float()
            before = moe.moe_experts.launches
            got = kern().float()
            launches = moe.moe_experts.launches - before
            err = float((got - want).abs().max() / want.abs().max())
            name = f"moe_experts_{label}" + ("" if experts == e
                                             else "_half_idle")
            print(f"check {name}: routes {t * k} over {experts} experts, "
                  f"max |kernel - plain| / max |plain| {err:.3e}, "
                  f"{launches} launches")
            if not err <= 2e-2:
                raise AssertionError(f"{name}: error {err}")
            if experts != e:
                continue
            runs = timed_turns(torch, kern, plain)
            lib = grouped_mm_call(torch, x, token, offsets, wg, wu, wd)
            report(results, name, err, runs, f"({t} x {k} routes, E {e})",
                   moe_bound(int((offsets[1:] > offsets[:-1]).sum()), t * k),
                   None if lib is None else cuda_ms(torch, lib),
                   device_ms(torch, kern),
                   None if lib is None else device_ms(torch, lib))
    return results


# the Kimi-VL path as the benchmark's cell runs it: 64 photos' image tokens
# (64 each after the 2 x 2 merge), a 16-id prompt, 32 greedy tokens
KIMI_BATCH, KIMI_IMAGE_TOKENS, KIMI_PROMPT, KIMI_NEW = 64, 64, 16, 32


def check_kimi_vl_path(torch):
    """The grouped expert kernel on the Kimi-VL path: ``Captioner`` at the
    published widths (``KIMI_VL_A3B``, its 33 GB of bf16 weights drawn on
    the card with the cell's scales), one batch of ``KIMI_BATCH`` rows of
    random image tokens through ``generate_from_memory``. The first batch
    captures the decode step; the second replays it under the profiler,
    which must see two expert kernels a call: the prefill's and every
    step's, one call a MoE layer, 2 x 26 x 32 = 1,664 a batch. The expert
    layer's device-side counters must count the same calls and rows, the
    host launch the prefill's kernels alone and the step replay 31 times.
    → the launches and counters of the profiled batch."""
    from torch.profiler import ProfilerActivity, profile

    from mit_tpu_torch.decode.api import Captioner
    from mit_tpu_torch.models import kimi_vl as kv
    from mit_tpu_torch.models.model import ModelConfig
    from mit_tpu_torch.models.vision import config_for_encoder
    from mit_tpu_torch.ops import moe

    cfg = kv.KIMI_VL_A3B
    g = torch.Generator(device="cuda").manual_seed(SEED)
    tree: dict = {}
    for path, shape in kv.param_shapes(cfg).items():
        if kv.is_norm_scale(path):
            leaf = torch.ones(shape, device="cuda", dtype=torch.bfloat16)
        else:
            std = {"lm/embed": 1.0, "lm/layers/wo": 0.006,
                   "lm/dense/w_down": 0.002, "lm/moe/w_down": 0.002,
                   "lm/moe/shared_down": 0.002}.get(path, 0.02)
            leaf = torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.bfloat16).mul_(std)
        kv.put(tree, path, leaf)
    name = "openai/clip-vit-large-patch14"
    mcfg = ModelConfig(name, config_for_encoder(name), cfg, "full",
                       "kimi_vl")
    cap = Captioner({"encoder": {}, **tree}, mcfg, None)
    memory = torch.randn((KIMI_BATCH, KIMI_IMAGE_TOKENS, cfg.hidden_size),
                         generator=g, device="cuda", dtype=torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (KIMI_PROMPT,), generator=g,
                           device="cuda").cpu()
    run = lambda: cap.generate_from_memory(
        memory, prompt_ids=prompt, max_new_tokens=KIMI_NEW, end_token_id=-1)
    first = run()
    torch.cuda.synchronize()
    moe.reset_counters()
    replays = cap.steps.graph_replays
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = run()
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if "moe_gate_up_kernel" in e.key or "moe_down_kernel" in e.key}
    n_moe, steps = cfg.n_moe_layers, KIMI_NEW - 1
    calls = {"prefill": n_moe, "decode": n_moe * steps}
    k = cfg.num_experts_per_tok
    rows = {"prefill": n_moe * KIMI_BATCH * (KIMI_IMAGE_TOKENS + KIMI_PROMPT)
            * k, "decode": n_moe * steps * KIMI_BATCH * k}
    out = {"launches": sum(kernels.values()), "kernels": kernels,
           "moe_experts.calls": dict(moe.moe_experts.calls),
           "moe_experts.rows": dict(moe.moe_experts.rows),
           "moe_experts.experts_hit": dict(moe.moe_experts.experts_hit),
           "moe_experts.launches": moe.moe_experts.launches,
           "graph_replays": cap.steps.graph_replays - replays,
           "graph_captures": cap.steps.graph_captures,
           "same_tokens": first == again,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"check kimi_vl_path: {out}")
    want = 2 * (calls["prefill"] + calls["decode"])
    if not (out["launches"] == want and out["moe_experts.calls"] == calls
            and out["moe_experts.rows"] == rows
            and out["moe_experts.launches"] == 2 * n_moe
            and out["graph_replays"] == steps and out["graph_captures"] == 1
            and out["same_tokens"]):
        raise AssertionError(f"kimi_vl_path: {want} expert kernels, calls "
                             f"{calls} and rows {rows} wanted")
    del cap, tree
    torch.cuda.empty_cache()
    return out


def check_bf16_design(torch):
    """The tensor-core kernel against the plain version at every bf16 shape
    of SHAPES and at CLIP ViT-L's (8, 257, 1024), with its time, device
    time, bound and library call; then the table of tilings at the encoder
    shape."""
    from mit_tpu_torch.ops.flash_attention import (
        BF16_WARPS,
        bf16_tiling,
        flash_attention_btd,
        flash_attention_btd_reference,
    )

    dtype = torch.bfloat16
    for name, b, t, d, padded in SHAPES + [("vit-l", 8, 257, 1024, False)]:
        q, k, v, pad = attention_inputs(torch, b, t, d, padded, dtype)
        kern = lambda: flash_attention_btd(q, k, v, pad, padded, 64)
        out = kern()
        ref = flash_attention_btd_reference(q, k, v, pad, padded, 64)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        uniform = True
        if padded:      # batch row 0: every key padded, so uniform over them
            want = torch.stack([v[0, :i + 1].float().mean(0)
                                for i in range(t)])
            uniform = bool((out[0].float() - want).abs().max()
                           <= TOL["bfloat16"])
        bound_ = attention_bound(b, d // 64, t, t, dtype,
                                 extra_bytes=b * t * 4 if padded else 0)
        lib = sdpa_ms(torch, heads_view(q), heads_view(k), heads_view(v),
                      padded, pad)
        dev = device_ms(torch, kern)
        print(f"bf16 tensor-core {name:8s} B={b} T=S={t} D={d} "
              f"causal+pad={padded} tiling {bf16_tiling(t)}: max_abs_err vs "
              f"plain {err:.3e}, limit 2e-02; fully masked row "
              f"uniform={uniform}; {cuda_ms(torch, kern):.4f} ms (device "
              f"time {'not measured' if dev is None else f'{dev:.4f} ms'}), "
              f"bound {bound_['bound_ms']:.5f} ms by {bound_['bound_by']}, "
              f"library call {lib:.4f} ms")
        if not (err <= TOL["bfloat16"] and uniform
                and bool(torch.isfinite(out).all())):
            raise AssertionError(f"bf16 tensor-core kernel disagrees: {name}")

    _, b, t, d, _ = SHAPES[0]
    q, k, v, _ = attention_inputs(torch, b, t, d, False, dtype)
    ref = flash_attention_btd_reference(q, k, v, None, False, 64)
    cells = []
    for tiling in [bf16_tiling(t, w) for w in BF16_WARPS]:
        out = tiled_bf16(torch, q, k, v, None, False, tiling)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= TOL["bfloat16"]:
            raise AssertionError(f"tiling {tiling} disagrees: {err}")
        ms = cuda_ms(torch, lambda: tiled_bf16(torch, q, k, v, None, False,
                                               tiling))
        warps, rows = tiling
        cells.append(f"{warps} warps, {rows} rows a block "
                     f"({-(-t // rows)} blocks a head) {ms:.4f}")
    print(f"design flash_attention_btd ({b}, {t}, {d}) bf16, ms (the "
          f"wrapper takes {bf16_tiling(t)}): " + "; ".join(cells))


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
        lib = sdpa_call(torch, heads_view(q), heads_view(k), heads_view(v))
        times[dname]["library_ms"] = cuda_ms(torch, lib)
        times[dname]["device_ms"] = device_ms(torch, kern)
        times[dname]["library_device_ms"] = device_ms(torch, lib)
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
        "int8_mlp_fused": int8_mlp.int8_mlp_fused,
        "fused_int8_mlp": int8_mlp.fused_int8_mlp,
        "fused_int8_vit_layer": int8_layer.fused_int8_vit_layer,
        "fused_int8_vit_layer_split": int8_layer.fused_int8_vit_layer_split,
    }


def dispatchers():
    """The functions that pick a route by shape, with their counters."""
    from mit_tpu_torch.decode.step import decoder_step
    from mit_tpu_torch.ops.attention import multihead_attention

    return {"attention": multihead_attention, "decode": decoder_step}


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0
        if hasattr(fn, "kernels"):
            fn.kernels = {k: 0 for k in fn.kernels}
    for fn in dispatchers().values():
        fn.routes = {k: 0 for k in fn.routes}


def hold_routes(label, attention=None, decode=None):
    """The route counters since reset_counts: every multihead_attention call
    went to a kernel wrapper (`attention` of them) and none to the plain
    path, and the decode steps took the fused and unfused routes `decode`
    times. A rule that is wrong at the model's geometry fails here."""
    got = {name: dict(fn.routes) for name, fn in dispatchers().items()}
    print(f"routes {label}: multihead_attention {got['attention']}, "
          f"decoder_step {got['decode']}")
    if got["attention"]["plain"] or (
            attention is not None and got["attention"]["kernel"] != attention):
        raise AssertionError(f"{label}: attention routes {got['attention']}, "
                             f"want {attention} kernel and no plain")
    if decode is not None and got["decode"] != decode:
        raise AssertionError(f"{label}: decode routes {got['decode']}, "
                             f"want {decode}")


def read_counts():
    return {name: fn.launches for name, fn in wrappers().items()}


def graph_counts(cap):
    """(captures, replays, eager steps) of a captioner's decode graphs."""
    g = cap.decode_graphs
    return g.graph_captures, g.graph_replays, g.eager_steps


def hold_graphs(label, cap, before, steps):
    """A fused captioner's decode loops since ``before`` (its graph_counts
    then) took ``steps`` steps, each replayed from its graphs or run
    eagerly. → the steps Python ran through ``decoder_step``: the eager
    ones and a warm-up and a capture a graph (a replay counts no route and
    no launch)."""
    captures, replays, eager = (a - b for a, b in
                                zip(graph_counts(cap), before))
    print(f"decode graphs {label}: {captures} captured, {replays} steps "
          f"replayed, {eager} eager (want {steps} steps)")
    if replays + eager != steps:
        raise AssertionError(f"{label}: {replays} replayed + {eager} eager "
                             f"steps, want {steps}")
    return eager + 2 * captures


def layer_kernels(prof):
    """The decode-layer kernel's launches in a profile's device events."""
    from torch.autograd import DeviceType

    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "decode_layer_kernel" in e.key)


def hold_layer_kernels(label, cap, before, launches, layers):
    """A fused captioner's decode under the profiler, since ``before`` (its
    graph_counts then): every step replayed from graphs it already held,
    and the device trace holds ``launches`` decode-layer kernels, ``layers``
    a replayed step. → the steps replayed."""
    captures, replays, eager = (a - b for a, b in
                                zip(graph_counts(cap), before))
    print(f"decode graphs {label}, traced: {replays} steps replayed, "
          f"{eager} eager, {captures} captured; {launches} decode_layer_kernel "
          f"launches on the device (want {layers} x {replays})")
    if captures or eager or not replays or launches != layers * replays:
        raise AssertionError(f"{label}: the replayed steps did not launch "
                             f"{layers} decode-layer kernels each")
    return replays


def traced_decode(torch, cap, mem, label, layers, **kw):
    """One decode of ``cap`` over ``mem`` (``generate_from_memory``'s
    keywords ``kw``) replayed under the profiler and held by
    hold_layer_kernels. → its token lists."""
    from torch.profiler import ProfilerActivity, profile

    before = graph_counts(cap)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tokens = cap.generate_from_memory(mem, **kw)
        torch.cuda.synchronize()
    hold_layer_kernels(label, cap, before, layer_kernels(prof), layers)
    return tokens


def timed_turns(torch, kern, plain):
    """Mean ms of kernel and plain, in turns plain, kernel, kernel, plain."""
    runs = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        runs[which].append(cuda_ms(torch, kern if which == "kernel" else plain))
    return runs


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def bf16_ulp_up(torch, x):
    """x rounded to bf16 and moved one bf16 ulp away from zero, as f32: the
    smallest change of the pixels that a bf16 encoder, which casts them to
    bf16 first, still sees (x * (1 + 1e-7) rounds back to the same value)."""
    bits = x.to(torch.bfloat16).view(torch.int16) + 1
    return bits.view(torch.bfloat16).float()


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


def attention_bound(b, h, t, s, dtype, n_products=2, extra_bytes=0, hd=64):
    """q, k, v read and the output written once; two (T, S, hd) products."""
    size = 2 if "bfloat16" in str(dtype) else 4
    nbytes = (2 * b * h * t * hd + 2 * b * h * s * hd) * size + extra_bytes
    ops = n_products * 2 * b * h * t * s * hd
    return bound(nbytes, ops, "bf16" if size == 2 else "f32")


def sdpa_call(torch, q, k, v, causal=False, pad=None, dropout_p=0.0):
    """One F.scaled_dot_product_attention call over (B, H, T, hd) views, as
    a function of no arguments: the library's way to the same function, a
    yardstick only."""
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
    return lambda: sdpa(q, k, v, attn_mask=mask, dropout_p=dropout_p)


def sdpa_backward_call(torch, q, k, v, do, causal=False, pad=None,
                       dropout_p=0.0):
    """The backward of one F.scaled_dot_product_attention call over the
    same inputs, as a function of no arguments: torch.autograd.grad of one
    forward kept with retain_graph, so that only the backward is timed. With
    dropout it draws another mask than the kernels: the same function, a
    yardstick only."""
    qkv = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = sdpa_call(torch, *qkv, causal, pad, dropout_p)()
    return lambda: torch.autograd.grad(out, qkv, do, retain_graph=True)


def sdpa_ms(torch, q, k, v, causal=False, pad=None, dropout_p=0.0):
    """The library call's time by CUDA events."""
    return cuda_ms(torch, sdpa_call(torch, q, k, v, causal, pad, dropout_p))


def heads_view(x, hd=64):
    """(B, T, D) → the (B, H, T, hd) view the library call takes."""
    b, t, d = x.shape
    return x.view(b, t, d // hd, hd).transpose(1, 2)


def report(results, name, err, runs, what, bound_, library_ms=None,
           device=None, library_device=None):
    """`device` and `library_device`, where given, are the profiler's device
    times of the kernel and of the library call: below about 0.05 ms the
    events (`ms`, `library_ms`) read the host's time to issue a call, and
    only the device times compare the two."""
    ms = statistics.mean(runs["kernel"])
    plain_ms = statistics.mean(runs["plain"])
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    if library_device is not None:
        lib += f" (device time {library_device:.4f} ms)"
    dev = "" if device is None else f" (device time {device:.4f} ms)"
    print(f"time {name:28s} {what}: kernel {runs['kernel']} ms{dev}, plain "
          f"{runs['plain']} ms, bound {bound_['bound_ms']:.5f} ms by "
          f"{bound_['bound_by']}, library call {lib}")
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **bound_, "library_ms": library_ms}
    if device is not None:
        results[name]["device_ms"] = device
    if library_device is not None:
        results[name]["library_device_ms"] = library_device


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
    gemm_bounds = {"bytes": 0.0, "operations": 0.0}
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
                kern = lambda: int8_mlp.int8_gemm(a8, sx, q, act, residual,
                                                  out_dtype)
                runs = timed_turns(
                    torch, kern,
                    lambda: int8_mlp.int8_gemm_reference(a8, sx, q, act,
                                                         residual, out_dtype))
                # the kernel against torch._int_mm in turns (kernel, library,
                # library, kernel): the comparison the redesign is held to
                vs_lib = timed_turns(torch, kern,
                                     lambda: torch._int_mm(a8, q.w8))
                ms = statistics.mean(vs_lib["kernel"])
                lib = statistics.mean(vs_lib["plain"])
                print(f"time int8_gemm {name:8s} M={m} K={k} N={n}: kernel "
                      f"{runs['kernel']} ms, then {vs_lib['kernel']} ms in "
                      f"turns with torch._int_mm {vs_lib['plain']} ms "
                      f"({2 * m * k * n / (ms * 1e9):.1f} TOP/s); plain "
                      f"{runs['plain']} ms")
                gemm_ms["kernel"][0] += ms
                gemm_ms["kernel"][1] += ms
                for j in range(2):
                    gemm_ms["plain"][j] += runs["plain"][j]
                one = gemm_bound(m, k, n, res, out)
                gemm_bounds[one["bound_by"]] += one["bound_ms"]
                gemm_lib += lib
                print(f"     int8_gemm {name:8s} bound {one['bound_ms']:.5f} "
                      f"ms by {one['bound_by']}; torch._int_mm (no scales, "
                      f"bias or epilogue) {lib:.4f} ms")
    report(results, "int8_gemm", gemm_err, gemm_ms,
           "the four GEMMs of one layer, summed",
           {"bound_ms": sum(gemm_bounds.values()),
            "bound_by": max(gemm_bounds, key=gemm_bounds.get)}, gemm_lib)
    print(f"int8_gemm ViT-B layer (M={M_FULL}): four GEMMs "
          f"{statistics.mean(gemm_ms['kernel']):.4f} ms against torch._int_mm "
          f"{gemm_lib:.4f} ms on the same four shapes (each in turns with "
          f"the kernel), bound {sum(gemm_bounds.values()):.4f} ms")
    check_int8_gemm_shapes(torch)

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
            lib = sdpa_call(torch, *(heads_view(x)
                                     for x in qkv.split(768, dim=-1)))
            report(results, "flash_attention_btd_fusedqkv", err, runs,
                   "(64, 197, 2304) bf16",
                   attention_bound(64, 12, 197, 197, dtype),
                   cuda_ms(torch, lib),
                   device_ms(torch, lambda: flash_attention_btd_fusedqkv(
                       qkv, 64)),
                   device_ms(torch, lib))
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
    for name, kern, plain, what, bound_, lib in (
        ("int8_linear", lambda: int8_mlp.int8_linear(patches, q),
         lambda: int8_mlp.int8_linear_reference(patches, q),
         "(64, 196, 768) bf16, the patch embedding",
         bound(mp * 768 * 4 + 768 * 768 + 8 * 768, 2 * mp * 768 * 768,
               "int8"), int_mm_call(torch, [(768, 768)], mp)),
        ("fused_int8_mlp", lambda: int8_mlp.fused_int8_mlp(x, q1, q2),
         lambda: int8_mlp.fused_int8_mlp_reference(x, q1, q2),
         "(64, 197, 768) bf16, F 3072, gelu",
         bound(M_FULL * 768 * 4 + 2 * 768 * 3072 + 8 * 3840,
               4 * M_FULL * 768 * 3072, "int8"),
         int_mm_call(torch, [(768, 3072), (3072, 768)], M_FULL)),
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
               bound_, cuda_ms(torch, lib), device_ms(torch, kern),
               device_ms(torch, lib))

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
        lib = layer_yardstick(torch, b, t, d, f, heads)
        report(results, name, err,
               timed_turns(torch, lambda: kern_fn(x, *args),
                           lambda: plain_fn(x, *args)), what,
               {"bound_ms": max(by_bytes, by_ops) * 1e3,
                "bound_by": "bytes" if by_bytes >= by_ops else "operations"},
               cuda_ms(torch, lib), device_ms(torch, lambda: kern_fn(x, *args)),
               device_ms(torch, lib))
        if name == "fused_int8_vit_layer":
            for label, h in INT8_HEADS:
                before = dict(flash_attention_btd_fusedqkv.kernels)
                out, ref = kern_fn(x, *args[:-2], h, 1e-12), plain_fn(
                    x, *args[:-2], h, 1e-12)
                torch.cuda.synchronize()
                rel = rel_l2(out, ref)
                launched = {k: n - before[k] for k, n in
                            flash_attention_btd_fusedqkv.kernels.items()}
                ms = cuda_ms(torch, lambda: kern_fn(x, *args[:-2], h, 1e-12))
                print(f"{name} {label} ({b}, {t}, {d}) {h} heads bf16: "
                      f"relative L2 {rel:.3e} (limit 5e-3), attention "
                      f"launches by kernel {launched}; kernel {ms:.4f} ms")
                if not (rel <= 5e-3 and bool(torch.isfinite(out).all())):
                    raise AssertionError(f"{name} disagrees at {label}")
    results.update(check_int8_mlp_fused(torch))
    results["fused_int8_vit_layer_split"]["turns_ms"] = {
        str(b): times for b, times in check_row4_turns(torch).items()}
    return results


def gemm_bound(m, k, n, res, out):
    """a8, w8 and the scales read, the residual read and the output written
    once; 2 M K N int8 operations."""
    size = lambda name: 0 if name is None else (2 if name == "bfloat16" else 4)
    return bound(m * k + k * n + 4 * m + 8 * n + m * n * (size(res) + size(out)),
                 2 * m * k * n, "int8")


def check_int8_gemm_shapes(torch):
    """int8_gemm at the path's other shapes: raw accumulators bitwise equal
    to int8_accumulate, the path's epilogue against the plain version, the
    time beside the bound and torch._int_mm. Returns _int_mm's summed time
    over ViT-L's four shapes (the library yardstick of the split layer)."""
    from mit_tpu_torch.ops import int8_mlp
    from mit_tpu_torch.ops.quant import int8_accumulate

    vit_l_lib = 0.0
    for i, (name, m, k, n, act, res, out) in enumerate(GEMM_SHAPES):
        q = random_qlinear(torch, k, n, seed=70 + i)
        a8, sx = int8_mlp.quantize_rows(
            random_rows(torch, m, k, torch.float32, seed=80 + i))
        a8[0] = 127
        acc = int8_mlp.int8_gemm(a8, sx, q, out_dtype=torch.int32)
        exact = torch.equal(acc, int8_accumulate(a8, q.w8))
        out_dtype = getattr(torch, out)
        residual = None if res is None else random_rows(
            torch, m, n, getattr(torch, res), seed=90 + i)
        run = lambda: int8_mlp.int8_gemm(a8, sx, q, act, residual, out_dtype)
        y, ref = run(), int8_mlp.int8_gemm_reference(a8, sx, q, act, residual,
                                                     out_dtype)
        torch.cuda.synchronize()
        tol = ({"rtol": 2e-6, "atol": 1e-6} if out_dtype == torch.float32
               else {"rtol": 8e-3, "atol": 1e-5})
        close = torch.allclose(y.float(), ref.float(), **tol)
        turns = timed_turns(torch, run, lambda: torch._int_mm(a8, q.w8))
        ms, lib = (statistics.mean(turns[w]) for w in ("kernel", "plain"))
        dev = device_ms(torch, run)
        one = gemm_bound(m, k, n, res, out)
        if name.startswith("vit-l"):
            vit_l_lib += lib
        print(f"int8_gemm {name:10s} M={m:5d} K={k} N={n} act={act} "
              f"residual={res} out={out}: int32 exact={exact}, epilogue "
              f"close={close}; kernel {ms:.4f} ms (device time "
              f"{'not measured' if dev is None else f'{dev:.4f} ms'}; "
              f"{2 * m * k * n / (ms * 1e9):.1f} TOP/s), bound "
              f"{one['bound_ms']:.5f} ms by {one['bound_by']}, torch._int_mm "
              f"{lib:.4f} ms")
        if not (exact and close):
            raise AssertionError(f"int8_gemm disagrees: {name}")
    print(f"int8_gemm ViT-L layer (M={8 * 257}): torch._int_mm on its four "
          f"shapes {vit_l_lib:.4f} ms")
    return vit_l_lib


# the fused MLP half (csrc/int8_mlp_fused.cu) at the three geometries it is
# built for, batch 64: (label, B, T, D, F), and the phase 4b/4c counts that
# give each line's launches on its path
MLP_WIDTHS = [("vit-b", 64, 197, 768, 3072), ("clip-l", 64, 257, 1024, 4096),
              ("vit-h", 64, 257, 1280, 5120)]
MLP_PATH = {"clip-l": "clip_l_int8", "vit-h": "vit_h_int8"}
PROFILE_ENCODES = 3      # encodes under torch.profiler per MLP route


@contextlib.contextmanager
def mlp_route(route):
    """Inside, every MLP half on a (D, F) the fused kernel is built for takes
    `route`, at any number of rows: "fused" (one int8_mlp_fused launch) or
    "composition" (quantize_rows, int8_gemm, quantize_rows, int8_gemm),
    whatever the port's rule (int8_mlp.MLP_KERNEL_MAX_ROWS) picks. For
    measurements: the two routes in turns."""
    from mit_tpu_torch.ops import int8_mlp

    rule = int8_mlp.MLP_KERNEL_MAX_ROWS
    int8_mlp.MLP_KERNEL_MAX_ROWS = (
        {shape: 1 << 62 for shape in int8_mlp.FUSED_MLP_SHAPES}
        if route == "fused" else {})
    try:
        yield
    finally:
        int8_mlp.MLP_KERNEL_MAX_ROWS = rule


def int_mm_call(torch, shapes, m, extra=None):
    """torch._int_mm at each (K, N) of `shapes` over M rows of int8, then
    `extra`, as one function of no arguments: the library's way to the same
    int8 products, a yardstick only."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    draw = lambda r, c: torch.randint(-127, 128, (r, c), dtype=torch.int8,
                                      device="cuda", generator=g)
    ops = [(draw(m, k), draw(n, k).t()) for k, n in shapes]

    def run():
        for a, w in ops:
            torch._int_mm(a, w)
        if extra is not None:
            extra()
    return run


def layer_yardstick(torch, b, t, d, f, heads):
    """An int8 layer's library yardstick: torch._int_mm at its four GEMM
    shapes and one SDPA call at its attention shape (bf16)."""
    qkv = random_rows(torch, b * t, 3 * d, torch.bfloat16, seed=95,
                      zero_row=False).reshape(b, t, 3 * d)
    views = [heads_view(x, d // heads) for x in qkv.split(d, dim=-1)]
    return int_mm_call(torch, [(d, 3 * d), (d, d), (d, f), (f, d)], b * t,
                       sdpa_call(torch, *views))


def check_int8_mlp_fused(torch):
    """Phase 3, the fused MLP half at ViT-B's, CLIP-L's and ViT-H's widths:
    its shared memory and the clusters the card holds; at batch 64, in four
    forms (the layer's f32 stream with LN2 and the residual, gelu and
    quick_gelu; the split layer's bf16 stream; fused_int8_mlp's bf16 rows,
    no LayerNorm or residual) one launch, bitwise the composition's for gelu
    (for quick_gelu, rows that differ at most 1e-3 of them: one ulp of expf
    may flip a code), within 5e-3 (the layer's forms) or 1e-3 (the MLP's)
    relative L2 of the plain version; and over the 64 CLS rows of the last
    layer (fused_int8_mlp's form, the act of the width's preset), bitwise
    the composition's. Two timed lines a width: the layer form at batch 64
    and the CLS rows, each against the plain version and in turns against
    the composition, with its bound, device time and torch._int_mm at fc1
    and fc2. A line carries the path whose counts give its launches where
    the port's rule sends that shape to the kernel. Returns the timed lines
    by label."""
    import ctypes

    from mit_tpu_torch import kernels
    from mit_tpu_torch.models.vision import PRESETS
    from mit_tpu_torch.ops import int8_mlp

    comp = lambda *args: int8_mlp._mlp_half(
        *args, int8_mlp.quantize_rows, int8_mlp._gemm_any_k)
    vcfgs = {"vit-b": PRESETS[VIT_B], "clip-l": PRESETS[CLIP_L],
             "vit-h": vit_h_config()}
    paths = {"vit-b": "int8", **MLP_PATH}
    lines = {}

    def timed(label, args, m, d, f, what):
        kern = lambda: int8_mlp.int8_mlp_fused(*args)
        plain = lambda: int8_mlp.int8_mlp_fused_reference(*args)
        err = (kern().float() - plain().float()).abs().max().item()
        runs = timed_turns(torch, kern, plain)
        vs = timed_turns(torch, kern, lambda: comp(*args))
        lib = int_mm_call(torch, [(d, f), (f, d)], m)
        report(lines, label, err, runs, what,
               bound(m * d * (args[0].element_size() + 2) + 2 * d * f
                     + 8 * (2 * d + f),
                     4 * m * d * f, "int8"),
               cuda_ms(torch, lib), device_ms(torch, kern),
               device_ms(torch, lib))
        comp_dev = device_ms(torch, lambda: comp(*args))
        lines[label].update(
            composition_ms=statistics.mean(vs["plain"]),
            composition_device_ms=comp_dev,
            ms_in_turns_with_composition=statistics.mean(vs["kernel"]))
        print(f"     {label}: kernel {vs['kernel']} ms in turns with the "
              f"composition {vs['plain']} ms (device "
              f"{comp_dev if comp_dev is None else round(comp_dev, 4)} ms); "
              f"{DEVICE_LINE[0] if DEVICE_LINE else ''}")

    for i, (name, b, t, d, f) in enumerate(MLP_WIDTHS):
        smem, clusters = ctypes.c_int(), ctypes.c_int()
        kernels.check(kernels.lib().mit_int8_mlp_fused_info(
            d, f, ctypes.byref(smem), ctypes.byref(clusters)),
            "mit_int8_mlp_fused_info")
        print(f"int8_mlp_fused D={d} F={f}: {smem.value} bytes of shared "
              f"memory a block, clusters of 8 blocks, "
              f"cudaOccupancyMaxActiveClusters {clusters.value}")
        m = b * t
        q1 = random_qlinear(torch, d, f, 100 + 4 * i)
        q2 = random_qlinear(torch, f, d, 101 + 4 * i)
        ln = random_ln(torch, d, 102 + 4 * i)
        x1 = random_rows(torch, m, d, torch.float32, seed=103 + 4 * i)
        cls_act = ("quick_gelu" if vcfgs[name].hidden_act == "quick_gelu"
                   else "gelu")
        forms = {"layer": (x1, "gelu", ln, True, 5e-3),
                 "layer quick_gelu": (x1, "quick_gelu", ln, True, 5e-3),
                 "split": (x1.to(torch.bfloat16), "gelu", ln, True, 5e-3),
                 "mlp": (x1.to(torch.bfloat16), "gelu", None, False, 1e-3),
                 "cls rows": (x1[:b].to(torch.bfloat16), cls_act, None,
                              False, 1e-3)}
        for form, (x, act, ln_, res, limit) in forms.items():
            args = (x, q1, q2, act, ln_, 1e-6, res, torch.bfloat16)
            before = int8_mlp.int8_mlp_fused.launches
            y = int8_mlp.int8_mlp_fused(*args)
            launched = int8_mlp.int8_mlp_fused.launches - before
            z, ref = comp(*args), int8_mlp.int8_mlp_fused_reference(*args)
            torch.cuda.synchronize()
            same = torch.equal(y, z)
            rows = (y != z).any(dim=1).float().mean().item()
            rel = rel_l2(y, ref)
            print(f"int8_mlp_fused {name} {tuple(x.shape)} F {f} {form} "
                  f"{act} x={str(x.dtype)[6:]}: {launched} launch, bitwise "
                  f"the composition's {same} (rows that differ "
                  f"{rows:.2e}), relative L2 to plain {rel:.3e} (limit "
                  f"{limit:.0e})")
            if not (launched == 1 and bool(torch.isfinite(y).all())
                    and rel <= limit
                    and (same if act == "gelu" else rows <= 1e-3)):
                raise AssertionError(f"int8_mlp_fused disagrees: {name} "
                                     f"{form}")
        label = f"int8_mlp_fused ({b}, {t}, {d}) F {f}"
        timed(label, (x1, q1, q2, "gelu", ln, 1e-6, True, torch.bfloat16),
              m, d, f, f"{name}: f32 stream, LN2, residual, bf16 out")
        lines[label].update(smem_bytes=smem.value,
                            max_active_clusters=clusters.value)
        if mlp_fused_on(vcfgs[name], m):
            lines[label]["path"] = paths[name]
        label = ("int8_mlp_fused" if name == "vit-b"
                 else f"int8_mlp_fused ({b}, {d}) F {f} cls rows")
        timed(label, (x1[:b].to(torch.bfloat16), q1, q2, cls_act, None, 0.0,
                      False, torch.bfloat16), b, d, f,
              f"{name}: the last layer's {b} CLS rows, bf16, {cls_act}")
        if name != "vit-b" and mlp_fused_on(vcfgs[name], b):
            lines[label]["path"] = paths[name]
    return lines


def check_row4_turns(torch):
    """Phase 3, row 4 (the int8 layer at ViT-L's width, F 4096, 16 heads,
    bf16) in turns: the split form at (8, 257, 1024), as phase 3 has timed
    it, and fused_int8_vit_layer at (64, 257, 1024), as CLIP ViT-L/14's int8
    encode calls it, each with the fused MLP half and with the composition
    (turns fused, composition, composition, fused, twice). Prints the times
    and returns them by shape and route."""
    from mit_tpu_torch.ops import int8_layer

    d, f, heads, t = 1024, 4096, 16, 257
    args = (random_ln(torch, d, 61), random_qlinear(torch, d, 3 * d, 62),
            random_qlinear(torch, d, d, 63), random_ln(torch, d, 64),
            random_qlinear(torch, d, f, 65), random_qlinear(torch, f, d, 66),
            heads, 1e-12)
    out = {}
    for b, fn in ((8, int8_layer.fused_int8_vit_layer_split),
                  (64, int8_layer.fused_int8_vit_layer)):
        x = random_rows(torch, b * t, d, torch.bfloat16, seed=60,
                        zero_row=False).reshape(b, t, d)
        times = {"fused": [], "composition": []}
        for turn in range(2):
            for route in ("fused", "composition", "composition", "fused"):
                with mlp_route(route):
                    times[route].append(cuda_ms(torch, lambda: fn(x, *args)))
        out[b] = times
        print(f"row 4 {fn.__name__} ({b}, {t}, {d}) bf16 in turns: fused MLP "
              f"{[round(v, 4) for v in times['fused']]} ms, composition "
              f"{[round(v, 4) for v in times['composition']]} ms; "
              f"{DEVICE_LINE[0] if DEVICE_LINE else ''}")
    return out


def int8_mlp_turns(torch, label, cap, px, full):
    """An int8 encode (bf16) with the fused MLP half against the
    composition: each route's launches per encode held (per_encode) and its
    layers' MLP routes (fused_int8_vit_layer.kernels); encode ms in
    alternating turns, ENC_REPS each; then device ms by kernel name under
    torch.profiler over PROFILE_ENCODES encodes each. Returns
    {route: {"ms": median, "by_kernel": {name: ms an encode}}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mit_tpu_torch.ops import int8_layer

    routes = ("fused", "composition")
    for route in routes:
        with mlp_route(route):
            cap.memory_from_pixels(px)
            torch.cuda.synchronize()
            reset_counts()
            cap.memory_from_pixels(px)
            torch.cuda.synchronize()
            hold_launches(f"{label} int8 encode, MLP {route}", read_counts(),
                          per_encode(full, route == "fused",
                                     route == "fused")["int8"])
            hold_kernels(f"{label} int8 encode, MLP {route}",
                         int8_layer.fused_int8_vit_layer,
                         {"fused": full if route == "fused" else 0,
                          "composition": 0 if route == "fused" else full})
    times = {route: [] for route in routes}
    for turn in range(ENC_REPS):
        for route in (routes if turn % 2 == 0 else routes[::-1]):
            with mlp_route(route):
                t0 = time.perf_counter()
                cap.memory_from_pixels(px)
                torch.cuda.synchronize()
                times[route].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for route in routes:
        with mlp_route(route), profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_ENCODES):
                cap.memory_from_pixels(px)
            torch.cuda.synchronize()
        by = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                ms = getattr(e, "self_device_time_total", 0) / 1e3
                if ms > 0:
                    by[e.key[:60]] = ms / PROFILE_ENCODES
        total = sum(by.values())
        q1, q2, q3 = statistics.quantiles(times[route], n=4)
        out[route] = {"ms": q2, "by_kernel": by}
        print(f"{label} int8 bf16 B={PRETRAINED_BATCH} MLP {route}: encode "
              f"median {q2:.3f} ms (quartiles {q1:.3f}-{q3:.3f}, {ENC_REPS} "
              f"in alternating turns); device {total:.3f} ms an encode "
              f"({PROFILE_ENCODES} traced), by kernel: " + "; ".join(
                  f"{k} {v:.3f}" for k, v in sorted(
                      by.items(), key=lambda kv: -kv[1])[:8])
              + f"; {DEVICE_LINE[0] if DEVICE_LINE else ''}")
    return out


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
                   decode_layer_bound(b, t, dtype),
                   device=device_ms(torch, lambda: fused_decode_layer(*args)))
    # the kernel's plan (grid, slices of K) against its alternatives, and one
    # launch captured in a CUDA graph
    from mit_tpu_torch.ops import decode_layer as dl

    sms = dl._sms(torch.device("cuda", torch.cuda.current_device()))
    for b, t, dtype in ((64, 100, torch.bfloat16), (192, 100, torch.bfloat16),
                        (64, 100, torch.float32)):
        x, pos, madd, kc, vc, cross, lay = decode_layer_inputs(
            torch, b, t, dtype, True)
        plan = dl.decode_layer_plan(dtype, sms)
        cells = []
        for grid in (sms, dl.GRID_PER_SM * sms):
            for ks in (1, 2, 4):
                ms = cuda_ms(torch, lambda: dl._launch(
                    x, pos, madd, kc, vc, cross, lay, 0, 1e-5, False, grid,
                    ks))
                mark = " (the plan)" if (grid, ks) == plan else ""
                cells.append(f"grid {grid} ks {ks}{mark} {ms:.4f}")
        args = (x, pos, madd, kc, vc, cross, lay, 0, 8)
        want = fused_decode_layer(*args)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = fused_decode_layer(*args)
        graph.replay()
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(want, got))
        replay_ms = cuda_ms(torch, graph.replay)
        print(f"design fused_decode_layer ({b}, {t}) {str(dtype)[6:]}, ms: "
              + "; ".join(cells) + f"; one launch captured in a CUDA graph: "
              f"replay equal={same}, {replay_ms:.4f} ms a replay")
        if not same:
            raise AssertionError("fused_decode_layer: the graph replay differs")
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
        flash_attention_btd,
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
            dev = device_ms(torch,
                            lambda: flash_attention(q, k, v, pad, padded))
            report(results,
                   "flash_attention" if dtype == torch.float32 else
                   "flash_attention bf16", err, runs, what,
                   attention_bound(b, h, t, t, dtype),
                   sdpa_ms(torch, q, k, v), dev,
                   device_ms(torch, sdpa_call(torch, q, k, v)))
            # beside it: the card's own time, and flash_attention_btd on the
            # same numbers in (B, T, D), the kernel takes_bhtd passes over at
            # this shape
            merged = [x.transpose(1, 2).reshape(b, t, h * 64).contiguous()
                      for x in (q, k, v)]
            btd = lambda: flash_attention_btd(*merged, pad, padded, 64)
            btd_err = (btd().view(b, t, h, 64).transpose(1, 2).float()
                       - ref.float()).abs().max().item()
            btd_ms, btd_dev = cuda_ms(torch, btd), device_ms(torch, btd)
            lib_dev = device_ms(torch, sdpa_call(torch, q, k, v))
            fmt = lambda x: "not measured" if x is None else f"{x:.4f}"
            print(f"design flash_attention {what}: "
                  f"{statistics.mean(runs['kernel']):.4f} ms, device "
                  f"time {fmt(dev)} ms; flash_attention_btd at ({b}, {t}, "
                  f"{h * 64}) {btd_ms:.4f} ms, device time {fmt(btd_dev)} "
                  f"ms, max_abs_err against this reference {btd_err:.3e}; "
                  f"the library call's device time {fmt(lib_dev)} ms")
    return {"flash_attention": results["flash_attention"]}


# the any-shape kernels: (name, B, H, T = S, hd), all causal and padded, at
# widths the tiled kernels do not take (past 128, not a multiple of 8)
ANY_SHAPES = [("decoder 544 wide in 4 heads", 64, 4, 100, 136),
              ("heads of 100 columns", 8, 8, 197, 100),
              ("narrow heads", 3, 2, 33, 32)]
DROPOUT_ANY_SHAPES = [("160 tokens", 32, 8, 160, 64),
                      ("decoder 512 wide in 4 heads", 32, 4, 99, 128),
                      ("narrow heads", 3, 2, 33, 32)]


def any_shape_inputs(torch, b, h, t, hd, dtype, seed=SEED):
    """q, k ~ N(0, 1), v ~ U(-1, 1), do ~ N(0, 1) in (B, H, T, hd); the pad
    masks about a fifth of the keys, every key of batch row 0 and key 0 of
    batch row 1 (whose query row 0 then sees a pad only)."""
    r = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
    q, k = to(r.normal(size=(b, h, t, hd))), to(r.normal(size=(b, h, t, hd)))
    v = to(r.uniform(-1, 1, size=(b, h, t, hd)))
    do = to(r.normal(size=(b, h, t, hd)))
    pad = np.where(r.random((b, t)) > 0.8, -1e9, 0.0).astype(np.float32)
    pad[0] = -1e9
    pad[1, 0] = -1e9
    return q, k, v, torch.from_numpy(pad).cuda(), do


def check_any_shape_kernels(torch):
    """Phase 3, the kernels of csrc/attention_any_shape.cu: every attention
    wrapper at head widths other than 64, and the dropout wrappers there and
    past 128 tokens, against their plain versions at the tiled kernels'
    limits; the dropout forward's keep-mask recovered bit for bit; then
    multihead_attention on the card at such shapes, which must launch a
    kernel at every call. Returns the timed lines."""
    from mit_tpu_torch.ops import attention as attn
    from mit_tpu_torch.ops import dropout_attention as da
    from mit_tpu_torch.ops import flash_attention as fa

    lines = {}
    for name, b, h, t, hd in ANY_SHAPES:
        if fa.attention_kernel_for(hd) != "any_shape":
            raise AssertionError(f"head_dim {hd} does not get the any-shape kernel")
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            q, k, v, pad, _ = any_shape_inputs(torch, b, h, t, hd, dtype)
            merged = [x.transpose(1, 2).reshape(b, t, h * hd).contiguous()
                      for x in (q, k, v)]
            qkv = torch.cat(merged, -1).contiguous()
            cases = {
                "flash_attention": (
                    lambda: fa.flash_attention(q, k, v, pad, True),
                    lambda: fa.flash_attention_reference(q, k, v, pad, True),
                    BHTD_TOL[dname]),
                "flash_attention_btd": (
                    lambda: fa.flash_attention_btd(*merged, pad, True, hd),
                    lambda: fa.flash_attention_btd_reference(*merged, pad,
                                                             True, hd),
                    TOL[dname]),
                "flash_attention_btd_fusedqkv": (
                    lambda: fa.flash_attention_btd_fusedqkv(qkv, hd),
                    lambda: fa.flash_attention_btd_fusedqkv_reference(qkv, hd),
                    TOL[dname]),
            }
            for wrapper, (kern, plain, limit) in cases.items():
                out, ref = kern(), plain()
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                finite = bool(torch.isfinite(out).all())
                print(f"any-shape {wrapper} {name} ({b}, {h}, {t}, {hd}) "
                      f"causal+pad {dname:8s} max_abs_err={err:.3e} "
                      f"limit={limit:.0e} finite={finite}")
                if not (finite and err <= limit):
                    raise AssertionError(
                        f"any-shape {wrapper} disagrees: {name} {dname}")
                if (name, wrapper) == (ANY_SHAPES[0][0], "flash_attention"):
                    size = 2 if dtype == torch.bfloat16 else 4
                    lib = sdpa_call(torch, q, k, v, True, pad)
                    report(lines, f"any-shape flash_attention {dname}", err,
                           timed_turns(torch, kern, plain),
                           f"({b}, {h}, {t}, {hd}) causal+pad",
                           bound(4 * b * h * t * hd * size + b * t * 4,
                                 4 * b * h * t * t * hd,
                                 "bf16" if size == 2 else "f32"),
                           cuda_ms(torch, lib), device_ms(torch, kern),
                           device_ms(torch, lib))

    seed, rate = 20261016, 0.1
    for name, b, h, t, hd in DROPOUT_ANY_SHAPES:
        if da.dropout_kernel_for(hd, t, t) != "any_shape":
            raise AssertionError(f"{name} does not get the any-shape kernels")
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            fwd_tol, bwd_tol = DROPOUT_TOL[dname]
            q, k, v, pad, do = any_shape_inputs(torch, b, h, t, hd, dtype)
            args = (q, k, v, pad)
            fwd = lambda: da.flash_attention_dropout_fwd(*args, seed, True, rate)
            bwd = lambda: da.flash_attention_dropout_bwd(*args, do, seed, True,
                                                         rate)
            fwd_plain = lambda: da.flash_attention_dropout_reference(
                *args, seed, True, rate)
            bwd_plain = lambda: da.flash_attention_dropout_reference_backward(
                *args, do, seed, True, rate)
            out, ref, grads, want = fwd(), fwd_plain(), bwd(), bwd_plain()
            torch.cuda.synchronize()
            fwd_err = (out.float() - ref.float()).abs().max().item()
            bwd_abs = [(g.float() - r.float()).abs().max().item()
                       for g, r in zip(grads, want)]
            bwd_rel = [e / r.float().abs().max().item()
                       for e, r in zip(bwd_abs, want)]
            finite = all(bool(torch.isfinite(x).all()) for x in (out, *grads))
            print(f"any-shape flash_attention_dropout {name} ({b}, {h}, {t}, "
                  f"{t}, {hd}) causal+pad {dname:8s}: forward max_abs_err "
                  f"{fwd_err:.3e} (limit {fwd_tol:.0e}); dq, dk, dv over their "
                  f"largest value {[f'{e:.3e}' for e in bwd_rel]} (limit "
                  f"{bwd_tol:.0e}); finite={finite}")
            if not (finite and fwd_err <= fwd_tol and max(bwd_rel) <= bwd_tol):
                raise AssertionError(
                    f"any-shape dropout attention disagrees: {name} {dname}")
            if name == DROPOUT_ANY_SHAPES[0][0] and dtype == torch.bfloat16:
                what = f"({b}, {h}, {t}, {t}, {hd}) bf16 causal+pad"
                lib = sdpa_call(torch, q, k, v, True, pad, dropout_p=rate)
                report(lines, "any-shape flash_attention_dropout", fwd_err,
                       timed_turns(torch, fwd, fwd_plain), what + ", forward",
                       bound(4 * b * h * t * hd * 2 + b * t * 4,
                             4 * b * h * t * t * hd, "bf16"),
                       cuda_ms(torch, lib), device_ms(torch, fwd),
                       device_ms(torch, lib))
                report(lines, "any-shape flash_attention_dropout_bwd",
                       max(bwd_abs), timed_turns(torch, bwd, bwd_plain),
                       what + ", backward",
                       bound(7 * b * h * t * hd * 2 + b * t * 4,
                             5 * 2 * b * h * t * t * hd, "bf16"),
                       device=device_ms(torch, bwd))

    # the forward's keep-mask, read off its output as for the tiled kernel
    for b, h, t, hd in ((2, 2, 160, 64), (3, 2, 70, 128)):
        want = da.keep_mask(t, t, rate, seed, torch.arange(b * h, device="cuda")
                            ).reshape(b, h, t, t).tril()
        zeros = lambda: torch.zeros(b, h, t, hd, device="cuda")
        got = torch.zeros(b, h, t, t, dtype=torch.bool, device="cuda")
        for c0 in range(0, t, hd):
            n = min(hd, t - c0)
            v = zeros()
            v[:, :, c0 + torch.arange(n), torch.arange(n)] = 1.0
            out = da.flash_attention_dropout_fwd(
                zeros(), zeros(), v, torch.zeros(b, t, device="cuda"), seed,
                True, rate)
            got[..., c0:c0 + n] = out[..., :n] > 0
        same = torch.equal(got, want)
        print(f"any-shape flash_attention_dropout forward, keep-mask "
              f"recovered from the output, ({b}, {h}, {t}, {t}, {hd}): "
              f"bitwise equal to keep_mask={same}")
        if not same:
            raise AssertionError("the any-shape forward draws another mask")

    # multihead_attention on the card at these shapes: a kernel at every call
    heads, b, t, d = 4, 8, 160, 544
    g = torch.Generator().manual_seed(SEED)
    params = {w: (torch.randn(d, d, generator=g) * 0.05).cuda()
              for w in ("wq", "wk", "wv", "wo")}
    params.update({"b" + w[1]: torch.zeros(d, device="cuda")
                   for w in list(params)})
    x = torch.randn(b, t, d, generator=g).cuda()
    pad = torch.zeros(b, t, device="cuda")
    pad[:, -7:] = -1e9
    outs = {}
    for use_kernel in (True, False):
        reset_counts()
        xg = x.clone().requires_grad_()
        gens = attn.DropoutGenerators.for_step(SEED, 1, "cuda")
        plain = attn.multihead_attention(params, xg, xg, heads, None,
                                         torch.float32, use_kernel, True, pad)
        dropped = attn.multihead_attention(
            params, xg, xg, heads, None, torch.float32, use_kernel, True, pad,
            rate, gens, False, True)
        (grad,) = torch.autograd.grad(dropped.square().sum(), xg)
        outs[use_kernel] = (plain.detach(), dropped.detach(), grad)
        if use_kernel:
            counts = {k: n for k, n in read_counts().items() if n}
            hold_routes(f"multihead_attention {d} wide in {heads} heads, T {t}",
                        attention=2)
    errs = [((a - r).abs().max() / r.abs().max()).item()
            for a, r in zip(outs[True], outs[False])]
    print(f"any-shape multihead_attention ({b}, {t}, {d}) f32 in {heads} heads "
          f"of {d // heads}, causal+pad, without and with fused dropout "
          f"{rate}: launches {counts}; output, dropped output and input "
          f"gradient against the plain path, over their largest value "
          f"{[f'{e:.3e}' for e in errs]} (limit 1e-4)")
    want = {"flash_attention_btd": 1, "flash_attention_dropout": 1,
            "flash_attention_dropout_bwd": 1}
    if counts != want or not max(errs) <= 1e-4:
        raise AssertionError("multihead_attention at an any-shape geometry")
    return lines


# heads wider than 64 on the tiled kernels: ViT-H/14's attention (B, T, D,
# head width) and the (B, H, T, hd) entry's widths at (8, 16, 257, hd)
VIT_H = "google/vit-huge-patch14-224-in21k"
VIT_H_LAYERS = 32        # its depth (the phase's CPU rehearsal cuts it)
WIDE_BTD = (64, 257, 1280, 80)
WIDE_BHTD = (8, 16, 257)
WIDE_HDS = (72, 80, 96, 112, 128)


def kernels_delta(fn, before):
    """Launches of `fn` by kernel since `before` (a copy of fn.kernels)."""
    return {k: n - before[k] for k, n in fn.kernels.items()}


def any_shape_call(torch, fa, kind, q, k, v, pad, causal, hd, layer=False):
    """The any-shape kernel through its C entry at a tiled kernel's shape,
    as a function of no arguments: the kernel that ran these widths before
    (old against new), reached only from here. kind "btd": q, k, v (B, T|S,
    D); "fused": q is the (B, T, 3D) qkv; "bhtd": (B, H, T|S, hd)."""
    bf16 = q.dtype == torch.bfloat16
    if kind == "bhtd":
        b, h, t, _ = q.shape
        out = torch.empty_like(q)
        return lambda: (fa._any_shape(q, k, v, pad, out, b, h, t, k.shape[2],
                                      hd, hd, hd, hd, True, causal,
                                      fa.ANY_NORM_FIRST, bf16), out)[1]
    if kind == "btd":
        b, t, d = q.shape
        out = torch.empty_like(q)
        return lambda: (fa._any_shape(q, k, v, pad, out, b, d // hd, t,
                                      k.shape[1], hd, d, d, d, False, causal,
                                      fa.ANY_DIVIDE_AFTER, bf16), out)[1]
    b, t, d3 = q.shape
    d = d3 // 3
    out = torch.empty((b, t, d), device=q.device,
                      dtype=torch.float32 if layer else q.dtype)
    at = lambda i: q.data_ptr() + i * d * q.element_size()
    mode = fa.ANY_LAYER if layer else fa.ANY_DIVIDE_AFTER
    return lambda: (fa._any_shape(at(0), at(1), at(2), None, out, b, d // hd,
                                  t, t, hd, d3, d3, d, False, False, mode,
                                  bf16), out)[1]


def check_wide_heads(torch):
    """Phase 3, heads of 72 to 128 columns on the tiled kernels: each entry
    at ViT-H/14's attention and flash_attention at every wide width, against
    its plain version, with its time, device time, bound, SDPA's device time
    and the any-shape kernel's time at the same shape (old against new);
    then the int8 layer at ViT-H/14's width. Returns the timed lines."""
    from mit_tpu_torch.ops import flash_attention as fa
    from mit_tpu_torch.ops import int8_layer, int8_mlp

    t_phase = time.perf_counter()
    lines = {}
    fmt = lambda x: "not measured" if x is None else f"{x:.4f}"

    def hold(label, kern, plain, old, limit, wrapper, time_it, bound_,
             lib=None, rel=False):
        before = dict(wrapper.kernels)
        out = kern()
        launched = kernels_delta(wrapper, before)
        ref, was = plain(), old()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        err_old = (was.float() - ref.float()).abs().max().item()
        if rel:                  # the int8 layer's numerics: relative L2
            err, err_old = rel_l2(out, ref), rel_l2(was, ref)
        finite = bool(torch.isfinite(out).all())
        print(f"wide {label}: {'relative L2' if rel else 'max_abs_err'} vs "
              f"plain {err:.3e} (any-shape kernel {err_old:.3e}), limit "
              f"{limit:.0e}, finite={finite}, launches {launched}")
        if not (finite and err <= limit and err_old <= limit
                and launched == {"tiled": 1, "any_shape": 0}):
            raise AssertionError(f"wide heads: {label} disagrees")
        if not time_it:
            return
        runs = timed_turns(torch, kern, plain)
        old_ms = cuda_ms(torch, old)
        report(lines, label, err, runs, f"tiled, any-shape {old_ms:.4f} ms",
               bound_, None if lib is None else cuda_ms(torch, lib),
               device_ms(torch, kern),
               None if lib is None else device_ms(torch, lib))
        lines[label]["any_shape_ms"] = old_ms

    # ViT-H/14's attention in (B, T, D) and fused qkv: the path's calls
    # (bidirectional, unpadded), then causal and padded
    b, t, d, hd = WIDE_BTD
    h = d // hd
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        q4, k4, v4, pad, _ = any_shape_inputs(torch, b, h, t, hd, dtype)
        q, k, v = (x.transpose(1, 2).reshape(b, t, d).contiguous()
                   for x in (q4, k4, v4))
        for causal in (False, True):
            p = pad if causal else None
            hold(f"flash_attention_btd ({b}, {t}, {d}) hd {hd} {dname}"
                 + (" causal+pad" if causal else ""),
                 lambda: fa.flash_attention_btd(q, k, v, p, causal, hd),
                 lambda: fa.flash_attention_btd_reference(q, k, v, p, causal,
                                                          hd),
                 any_shape_call(torch, fa, "btd", q, k, v, p, causal, hd),
                 TOL[dname], fa.flash_attention_btd, not causal,
                 attention_bound(b, h, t, t, dtype, hd=hd),
                 sdpa_call(torch, q4, k4, v4))
        if dtype == torch.bfloat16:
            # the wide kernel's tilings at ViT-H/14's shape (the wrapper's
            # rule picks by T alone)
            ref = fa.flash_attention_btd_reference(q, k, v, None, False, hd)
            cells = []
            for tiling in [fa.bf16_tiling(t, w) for w in fa.BF16_WARPS]:
                run = lambda: tiled_bf16(torch, q, k, v, None, False, tiling,
                                         hd)
                err = (run().float() - ref.float()).abs().max().item()
                if not err <= TOL[dname]:
                    raise AssertionError(f"tiling {tiling} disagrees: {err}")
                cells.append(f"{tiling[0]} warps, {tiling[1]} rows a block "
                             f"{fmt(device_ms(torch, run))}")
            print(f"design flash_attention_btd ({b}, {t}, {d}) hd {hd} bf16, "
                  f"device ms (the wrapper takes {fa.bf16_tiling(t)}): "
                  + "; ".join(cells))
        qkv = torch.cat([q, k, v], -1).contiguous()
        layers = (False, True) if dtype == torch.bfloat16 else (False,)
        for layer in layers:
            hold(f"flash_attention_btd_fusedqkv ({b}, {t}, {3 * d}) hd {hd} "
                 f"{dname}" + (" layer numerics" if layer else ""),
                 lambda: fa.flash_attention_btd_fusedqkv(qkv, hd, layer),
                 lambda: fa.flash_attention_btd_fusedqkv_reference(qkv, hd,
                                                                   layer),
                 any_shape_call(torch, fa, "fused", qkv, None, None, None,
                                False, hd, layer),
                 TOL[dname], fa.flash_attention_btd_fusedqkv,
                 dtype == torch.bfloat16,
                 attention_bound(b, h, t, t, dtype, hd=hd,
                                 extra_bytes=2 * b * t * d if layer else 0),
                 sdpa_call(torch, q4, k4, v4))
        del q4, k4, v4, q, k, v, qkv

    # flash_attention (B, H, T, hd) at every wide width, causal and padded
    b, h, t = WIDE_BHTD
    for hd in WIDE_HDS:
        if fa.attention_kernel_for(hd) != "tiled":
            raise AssertionError(f"head_dim {hd} does not get the tiled kernels")
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype)[6:]
            q, k, v, pad, _ = any_shape_inputs(torch, b, h, t, hd, dtype)
            hold(f"flash_attention ({b}, {h}, {t}, {hd}) {dname} causal+pad",
                 lambda: fa.flash_attention(q, k, v, pad, True),
                 lambda: fa.flash_attention_reference(q, k, v, pad, True),
                 any_shape_call(torch, fa, "bhtd", q, k, v, pad, True, hd),
                 BHTD_TOL[dname], fa.flash_attention, True,
                 attention_bound(b, h, t, t, dtype, hd=hd,
                                 extra_bytes=b * t * 4),
                 sdpa_call(torch, q, k, v, True, pad))

    # the int8 layer at ViT-H/14's width: its attention in LAYER mode at hd 80
    b, t, d, hd = WIDE_BTD
    f = 4 * d
    x = random_rows(torch, b * t, d, torch.bfloat16, seed=60,
                    zero_row=False).reshape(b, t, d)
    args = (random_ln(torch, d, 61), random_qlinear(torch, d, 3 * d, 62),
            random_qlinear(torch, d, d, 63), random_ln(torch, d, 64),
            random_qlinear(torch, d, f, 65), random_qlinear(torch, f, d, 66),
            d // hd, 1e-12)
    by_bytes = (b * t * d * 4 + 4 * d * d + 2 * d * f) / MEM_BYTES_PER_S
    by_ops = (2 * b * t * (4 * d * d + 2 * d * f) / PEAK_OPS["int8"]
              + 4 * b * t * t * d / PEAK_OPS["bf16"])
    # the layer as it ran before: the same kernels, the any-shape attention
    old_attention = lambda qkv, hd, layer_numerics: any_shape_call(
        torch, fa, "fused", qkv, None, None, None, False, hd, True)()
    hold(f"fused_int8_vit_layer ({b}, {t}, {d}) F {f} {d // hd} heads bf16",
         lambda: int8_layer.fused_int8_vit_layer(x, *args),
         lambda: int8_layer.fused_int8_vit_layer_reference(x, *args),
         lambda: int8_layer._layer(x, *args, "gelu", False,
                                   int8_mlp.quantize_rows, int8_mlp.int8_gemm,
                                   old_attention),
         5e-3, fa.flash_attention_btd_fusedqkv, True,
         {"bound_ms": max(by_bytes, by_ops) * 1e3,
          "bound_by": "bytes" if by_bytes >= by_ops else "operations"},
         layer_yardstick(torch, b, t, d, f, d // hd), rel=True)
    print(f"wide heads: {time.perf_counter() - t_phase:.1f} s")
    return lines


def hold_launches(label, counts, want, calls=1):
    """The launch counters since reset_counts equal `want` per call, every
    other counter 0."""
    want = {k: want.get(k, 0) * calls for k in counts}
    shown = {k: v / calls for k, v in counts.items() if v}
    print(f"launches {label}: per call {shown}, every other counter 0")
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, want {want}")


def hold_kernels(label, wrapper, want):
    """The launches of an attention wrapper by kernel since reset_counts
    equal `want` ({"tiled": n, "any_shape": m})."""
    got = dict(wrapper.kernels)
    print(f"kernels {label}: {wrapper.__name__} {got}")
    if got != want:
        raise AssertionError(f"{label}: {wrapper.__name__} launched {got}, "
                             f"want {want}")


def drive(torch, name, cap, px, reps):
    """The main path of one arm: every counter set to 0, `reps` encode and
    decode calls, the counters read and held to slice_per_encode. Returns
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
    # the float arm's attention goes through multihead_attention, the int8
    # arm's does not; the decode steps were not asked to fuse
    steps_taken = dispatchers()["decode"].routes["unfused"]
    hold_routes(f"slice {name}",
                attention=counts["flash_attention_btd"],
                decode={"fused": 0, "unfused": steps_taken})
    b = px.shape[0]
    rate = b / statistics.median(seconds)
    steps = max(len(t) for t in tokens) - 1
    print(f"slice bf16 B={b} {name}: {rate:.1f} captions/s (median of {reps} "
          f"runs {[round(s, 4) for s in seconds]} s; encode "
          f"{[round(s, 4) for s in enc_s]} s; {steps} decode steps)")
    hold_launches(f"slice bf16 B={b} {name} encode", counts,
                  slice_per_encode(cap.mcfg.vision, b)[name], reps)
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
    launched = flash_attention_btd.launches - before
    mem_p = plain.memory_from_pixels(pixels[:8])
    assert flash_attention_btd.launches - before == launched
    err = (mem_k - mem_p).abs().max().item()
    assert mem_k.shape == (8, 1, 512) and bool(torch.isfinite(mem_k).all())
    tok_k = kern.generate_from_memory(mem_k)
    tok_p = plain.generate_from_memory(mem_p)
    check_tokens(tok_k, 8)
    same = tok_k == tok_p
    print(f"slice f32 B=8: kernel launches per encode call {launched} "
          f"(want 11); memory kernel vs plain max_abs_err={err:.3e} "
          f"(limit 1e-4); greedy tokens identical={same}; "
          f"caption lengths {[len(t) for t in tok_k]}")
    if launched != 11 or not err <= 1e-4 or not same:
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


def trace_decode(torch, cap, mem, label, layers, **kw):
    """One generation at the served max_len (``generate_from_memory``'s
    keywords ``kw``) under torch.profiler, after a warm-up that captures a
    fused captioner's graphs: device kernels per step, device-busy time per
    step and its share of the traced wall time, and the kernels that take
    most of it. A fused captioner's steps all replay, with ``layers``
    decode-layer kernels each on the device (hold_layer_kernels); an
    unfused one launches none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cap.generate_from_memory(mem, **kw)                         # warm-up
    torch.cuda.synchronize()
    before = graph_counts(cap)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cap.generate_from_memory(mem, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _, replays, eager = (a - b for a, b in zip(graph_counts(cap), before))
    steps = replays + eager
    launches = layer_kernels(prof)
    if cap.fused_decode:
        hold_layer_kernels(label, cap, before, launches, layers)
    elif launches:
        raise AssertionError(f"{label}: {launches} decode-layer kernels on "
                             "the unfused route")
    # the program's spans ("mit.*") reach the device events as ranges
    # that overlap the kernels they hold: left out, as the kernels count
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and not e.key.startswith("mit.")]
    busy_us = lambda e: getattr(e, "self_device_time_total", 0)
    total = sum(busy_us(e) for e in dev)
    if not dev or total <= 0:
        print(f"trace {label}: the profiler recorded no device time")
        return None
    top = sorted(dev, key=busy_us, reverse=True)[:6]
    layer = [e for e in dev if "decode_layer" in e.key]
    on_path = ""
    if layer:
        n = sum(e.count for e in layer)
        on_path = (f"; fused_decode_layer on the path {n / steps:.1f} launches "
                   f"a step, {sum(busy_us(e) for e in layer) / n / 1e3:.4f} "
                   f"ms of device time a launch")
    print(f"trace {label} bf16 B={mem.shape[0]}, {steps} steps ({replays} "
          f"replayed): {sum(e.count for e in dev) / steps:.1f} device kernels "
          f"and copies per step, device busy {total / steps / 1e3:.3f} ms per "
          f"step, traced wall {wall_ms / steps:.3f} ms per step (busy share "
          f"{total / 1e3 / wall_ms:.3f}); most device time: "
          + "; ".join(f"{e.key[:48]} {busy_us(e) / steps / 1e3:.3f} ms x "
                      f"{e.count / steps:.1f}" for e in top) + on_path)
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
    before = graph_counts(fused)
    reset_counts()
    tok_f = fused.generate_from_memory(mem)         # captures, then replays
    steps = max(len(t) for t in tok_f) - 1
    launches = read_counts()["fused_decode_layer"]
    ran = hold_graphs("f32 greedy fused", fused, before, steps)
    hold_routes("decode f32 greedy fused", attention=0,
                decode={"fused": ran, "unfused": 0})
    kernel_fn = step_mod.fused_decode_layer
    step_mod.fused_decode_layer = fused_decode_layer_plain
    try:                                  # the same route on the plain version
        tok_p = Captioner(params, mcfg, ids, torch.float32,
                          fused_decode=True).generate_from_memory(mem)
    finally:
        step_mod.fused_decode_layer = kernel_fn
    print(f"decode f32 B=8 greedy: fused == unfused tokens {tok_f == tok_u}, "
          f"kernel == plain version tokens {tok_f == tok_p}; {steps} steps, "
          f"{launches} fused_decode_layer launches (want "
          f"{dcfg.num_layers * ran}); lengths {[len(t) for t in tok_f]}")
    if not (tok_f == tok_u and tok_f == tok_p
            and launches == dcfg.num_layers * ran):
        raise AssertionError("f32 greedy: the fused route disagrees")

    beams = {}
    for route in (False, True, "plain"):
        if route == "plain":              # the fused route on the plain version
            step_mod.fused_decode_layer = fused_decode_layer_plain
        try:
            beams[route] = beam_generate(
                params["decoder"], dcfg, mem, ids.start_id, ids.end_id,
                ids.pad_id, dcfg.max_seq_len, 3, compute_dtype=torch.float32,
                fused=route is not False)
        finally:
            step_mod.fused_decode_layer = kernel_fn
    same = torch.equal(beams[True][0], beams[False][0])
    same_plain = torch.equal(beams[True][0], beams["plain"][0])
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
    print(f"decode f32 B=8 beam K=3: fused == unfused tokens {same}, kernel "
          f"== plain version tokens {same_plain}, scores "
          f"max_abs_diff {score_err:.3e} (rtol = atol = 1e-5: {close}), best scores "
          f"{[round(x, 3) for x in beams[True][1].tolist()]}; beam_size 1 == "
          f"greedy {one == tok_f}; temperature 0 == greedy {cold == tok_f}; "
          f"sampled batch repeats under one seed {s1 == s2}, differs from "
          f"greedy {s1 != tok_f}")
    if not (same and same_plain and finite and close and one == tok_f
            and cold == tok_f and s1 == s2 and s1 != tok_f):
        raise AssertionError("f32 beam or sampling: the fused route disagrees")
    check_graphed_beam(torch, params, mcfg, ids, fused.memory_from_pixels(
        pixels.to("cuda")), torch.float32)
    del unfused, fused

    # bf16, batch 64; each captioner warmed up at the served max_len, so
    # the fused one has captured its greedy graphs and replays from here on
    caps = {False: Captioner(params, mcfg, ids, torch.bfloat16),
            True: Captioner(params, mcfg, ids, torch.bfloat16,
                            fused_decode=True)}
    mem = caps[True].memory_from_pixels(pixels.to("cuda"))
    for cap in caps.values():                                  # warm-up
        cap.generate_from_memory(mem)
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

    # the counted and timed main path: greedy, fused (replayed) against
    # unfused (eager)
    seconds = {False: [], True: []}
    steps = {}
    before = graph_counts(caps[True])
    reset_counts()
    for turn in range(DECODE_REPS):
        for route in ((True, False) if turn % 2 == 0 else (False, True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens = caps[route].generate_from_memory(mem)
            seconds[route].append(time.perf_counter() - t0)
            steps[route] = max(len(t) for t in tokens) - 1
            assert len(tokens) == 64 and all(
                t[0] == ids.start_id and 2 <= len(t) <= 100
                and all(0 <= x < dcfg.vocab_size for x in t) for t in tokens)
    counts = read_counts()
    # the replays run no Python: the fused route counts no step and no
    # host launch here; trace_decode counts its kernels on the device
    ran = hold_graphs("bf16 greedy fused, replayed", caps[True], before,
                      steps[True] * DECODE_REPS)
    hold_routes("decode bf16 greedy, fused and unfused in turns", attention=0,
                decode={"fused": ran, "unfused": steps[False] * DECODE_REPS})
    want = {k: 0 for k in counts}
    want["fused_decode_layer"] = dcfg.num_layers * ran
    rates = {}
    for route, secs in seconds.items():
        label = "fused" if route else "unfused"
        rates[label] = 64 / statistics.median(secs)
        print(f"decode bf16 B=64 greedy {label}: {rates[label]:.1f} captions/s, "
              f"{statistics.median(secs) / steps[route] * 1e3:.3f} ms per step "
              f"(median of {DECODE_REPS} runs {[round(x, 4) for x in secs]} s, "
              f"{steps[route]} steps, encoder not included)")
    print(f"decode bf16 B=64 greedy fused: {counts['fused_decode_layer']} "
          f"host launches in {DECODE_REPS} replayed runs (want "
          f"{want['fused_decode_layer']}), every other counter 0")
    if counts != want:
        raise AssertionError(f"fused greedy launches {counts}, want {want}")

    for route in (True, False):
        trace_decode(torch, caps[route], mem,
                     "greedy fused" if route else "greedy unfused",
                     dcfg.num_layers)
    # beam K=3, 192 rows: the fused captioner of the beam cell's shape,
    # whose warm-up captures the beam graphs; the unfused one steps eagerly
    beam_caps = {True: Captioner(params, mcfg, ids, torch.bfloat16,
                                 fused_decode=True), False: caps[False]}
    beam_kw = dict(method="beam", beam_size=3)
    for route in (True, False):
        beam_caps[route].generate_from_memory(mem, **beam_kw)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = beam_caps[route].generate_from_memory(mem, **beam_kw)
        dt = time.perf_counter() - t0
        n = max(len(t) for t in tokens) - 1
        label = "fused" if route else "unfused"
        rates[f"beam_{label}"] = 64 / dt
        print(f"decode bf16 B=64 beam K=3 {label}: {64 / dt:.1f} captions/s, "
              f"{dt / n * 1e3:.3f} ms per step (one run of {dt:.4f} s, "
              f"{n} steps, 192 rows)")
    trace_decode(torch, beam_caps[True], mem, "beam K=3 fused",
                 dcfg.num_layers, **beam_kw)
    check_graphed_beam(torch, params, mcfg, ids, mem, torch.bfloat16)
    return {"counts": counts, "rates": rates}


def check_graphed_beam(torch, params, mcfg, ids, mem, dtype):
    """The beam loop at the beam cell's shape, B 64 and K 3 (192 rows), on
    the fused route: replayed from a holder's graphs, it equals the eager
    kernel loop bit for bit in tokens and scores, and (f32) the eager loop
    on the kernel's plain version in tokens, its scores within 1e-5."""
    from mit_tpu_torch.decode import step as step_mod
    from mit_tpu_torch.decode.beam import beam_generate
    from mit_tpu_torch.decode.graphs import DecodeGraphs
    from mit_tpu_torch.decode.greedy import _bucket_schedule
    from mit_tpu_torch.ops.decode_layer import fused_decode_layer_plain

    dcfg = mcfg.decoder
    holder = DecodeGraphs()
    run = lambda steps=None: beam_generate(
        params["decoder"], dcfg, mem, ids.start_id, ids.end_id, ids.pad_id,
        dcfg.max_seq_len, 3, compute_dtype=dtype, fused=True, steps=steps)
    run(holder)                                                # captures
    graphed = run(holder)
    eager = run()
    same = torch.equal(graphed[0], eager[0]) and torch.equal(graphed[1],
                                                             eager[1])
    plain_ok = True
    line = ""
    if dtype == torch.float32:
        kernel_fn = step_mod.fused_decode_layer
        step_mod.fused_decode_layer = fused_decode_layer_plain
        try:
            plain = run()
        finally:
            step_mod.fused_decode_layer = kernel_fn
        rows = (graphed[0] == plain[0]).all(dim=1)
        err = (graphed[1] - plain[1]).abs().max().item()
        plain_ok = bool(rows.all()) and torch.allclose(
            graphed[1], plain[1], rtol=1e-5, atol=1e-5)
        line = (f"; graphed == plain version tokens in {int(rows.sum())} of "
                f"{rows.numel()} items, scores max_abs_diff {err:.3e} "
                f"(rtol = atol = 1e-5)")
    name = str(dtype).replace("torch.", "")
    print(f"decode {name} B={mem.shape[0]} beam K=3 graphed: "
          f"{holder.graph_captures} graphs, {holder.graph_replays} steps "
          f"replayed, {holder.eager_steps} eager; graphed == eager kernel "
          f"tokens and "
          f"scores bit for bit {same}" + line)
    if not (same and plain_ok and holder.eager_steps == 0
            and holder.graph_captures == 2 * len(
                _bucket_schedule(dcfg.max_seq_len))):
        raise AssertionError(f"{name} graphed beam: disagrees")


def service_setup(torch, device="cuda"):
    """The service's model: the slice's ViT-B/16 float encoder and 6 x 512
    decoder (8 heads, FF 2048, vocab 10000, max_len 100) from SEED, the END
    logit's bias raised by END_MARGIN, and SERVICE_REQUESTS seeded pixel
    images on ``device`` (the card; a rehearsal takes the CPU)."""
    from mit_tpu_torch.models.decoder import DecoderConfig
    from mit_tpu_torch.models.model import ModelConfig, init_model_params
    from mit_tpu_torch.models.vision import PRESETS

    name = "google/vit-base-patch16-224-in21k"
    mcfg = ModelConfig(name, PRESETS[name], DecoderConfig(vocab_size=10000),
                       "cls")
    params = init_model_params(torch.Generator().manual_seed(SEED), mcfg, device)
    params["decoder"]["fc_out_b"][SpecialIds().end_id] += END_MARGIN
    size = mcfg.vision.image_size
    pixels = torch.from_numpy(
        np.random.default_rng(SEED + 7).uniform(
            -1, 1, (SERVICE_REQUESTS, 3, size, size)).astype(np.float32)
    ).to(device)
    return mcfg, params, pixels


def chunked(cap, pixels, size):
    """The encoder chunks of ``pixels`` as run_stream takes them: (memory
    of up to ``size`` images, its rows), each encoded when pulled."""
    for i in range(0, pixels.shape[0], size):
        px = pixels[i:i + size]
        yield cap.memory_from_pixels(px), px.shape[0]


def encoded(torch, cap, pixels, size):
    """The memories run_stream sees, chunk by chunk, concatenated."""
    return torch.cat([m for m, _ in chunked(cap, pixels, size)])


def padded_rows(results, max_len=100, pad=0):
    """Service results → whole rows, PAD after the caption (a greedy row of
    the batch loops)."""
    return [list(r) + [pad] * (max_len - len(r)) for r in results]


def batch_rows(tokens, method):
    """Batch-loop tokens → rows comparable with the service's: whole rows
    for greedy, beam rows cut at their count of tokens that are not PAD (as
    both packages' beam results are)."""
    rows = tokens.tolist()
    if method == "beam":
        return [r[:sum(t != SpecialIds().pad_id for t in r)] for r in rows]
    return rows


def caption_lengths(results, end_id=3):
    """Tokens a caption, START and END included."""
    return [r.index(end_id) + 1 if end_id in r else len(r) for r in results]


def serve(torch, cap, requests, chunk=None, **kw):
    """One CaptionService run over ``requests`` (pixels through run_stream in
    chunks of ``chunk``, or a memory tensor through submit_memory_batch) →
    (results in request order, the service, wall seconds, window ms)."""
    from mit_tpu_torch.decode.service import CaptionService

    svc = CaptionService(cap, **kw)
    windows = []
    for name in ("_step_flat", "_step_beam"):
        fn = getattr(svc, name)

        def timed(fn=fn):
            t0 = time.perf_counter()
            fn()                              # ends in the window's read-back
            windows.append((time.perf_counter() - t0) * 1e3)
        setattr(svc, name, timed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if chunk is None:
        ids = svc.submit_memory_batch(requests)
        res = svc.run_to_completion()
        out = [res[i] for i in ids]
    else:
        ids = svc.run_stream(chunked(cap, requests, chunk))
        out = [svc.result(i) for i in ids]
    torch.cuda.synchronize()
    return out, svc, time.perf_counter() - t0, windows


def trace_service(torch, cap, mem, label, steps=SERVICE_TRACE_STEPS):
    """``steps`` windows of one token of a greedy service under
    torch.profiler, its slots full: device kernels and copies a step,
    device-busy ms a step and its share of the traced wall time, and the
    copies to the host a step (the window's one read-back)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mit_tpu_torch.decode.service import CaptionService

    svc = CaptionService(cap, num_slots=SERVICE_SLOTS)
    svc.submit_memory_batch(mem)
    for _ in range(4):                                        # warm-up
        svc.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            svc.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = lambda e: getattr(e, "self_device_time_total", 0)
    total = sum(busy_us(e) for e in dev)
    if not dev or total <= 0:
        print(f"trace service {label}: the profiler recorded no device time")
        return None
    d2h = sum(e.count for e in dev if "DtoH" in e.key or "Device -> Pinned"
              in e.key or "Device -> Pageable" in e.key)
    layer = [e for e in dev if "decode_layer" in e.key]
    top = sorted(dev, key=busy_us, reverse=True)[:5]
    out = {"kernels_per_step": sum(e.count for e in dev) / steps,
           "busy_ms_per_step": total / steps / 1e3,
           "wall_ms_per_step": wall_ms / steps,
           "busy_share": total / 1e3 / wall_ms,
           "d2h_per_step": d2h / steps}
    print(f"trace service {label} bf16 {SERVICE_SLOTS} slots, {steps} "
          f"windows of 1 token: {out['kernels_per_step']:.1f} device kernels "
          f"and copies a step, device busy {out['busy_ms_per_step']:.3f} ms a "
          f"step, traced wall {out['wall_ms_per_step']:.3f} ms a step (busy "
          f"share {out['busy_share']:.3f}); copies to the host "
          f"{out['d2h_per_step']:.2f} a step; fused_decode_layer "
          f"{sum(e.count for e in layer) / steps:.1f} launches a step; most "
          "device time: " + "; ".join(
              f"{e.key[:40]} {busy_us(e) / steps / 1e3:.3f} ms x "
              f"{e.count / steps:.1f}" for e in top) + f"; {DEVICE_LINE[0]}")
    return out


def check_service(torch, device="cuda"):
    """Phase 4, the continuously batched CaptionService on the ViT-B model
    (see the module docstring). Returns the bf16 fused greedy run's counts
    and the rates."""
    from mit_tpu_torch.decode import step as step_mod
    from mit_tpu_torch.decode.api import Captioner
    from mit_tpu_torch.decode.beam import beam_generate
    from mit_tpu_torch.decode.greedy import greedy_generate
    from mit_tpu_torch.ops.decode_layer import fused_decode_layer_plain

    t_phase = time.perf_counter()
    mcfg, params, pixels = service_setup(torch, device)
    dcfg, ids, dec = mcfg.decoder, SpecialIds(), params["decoder"]
    full_mcfg = mcfg._replace(memory_mode="full")
    greedy = lambda mem, fused, dtype=torch.float32: batch_rows(greedy_generate(
        dec, dcfg, mem, ids.start_id, ids.end_id, ids.pad_id, 100,
        compute_dtype=dtype, fused=fused)[0], "greedy")
    spread = lambda res: (f"caption length mean "
                          f"{statistics.mean(caption_lengths(res)):.1f}, min "
                          f"{min(caption_lengths(res))}, max "
                          f"{max(caption_lengths(res))}")

    # f32, F32_SLOTS slots, F32_REQUESTS requests: token identity
    px = pixels[:F32_REQUESTS]
    caps = {route: Captioner(params, mcfg, ids, torch.float32,
                             fused_decode=route) for route in (True, False)}
    full = Captioner(params, full_mcfg, ids, torch.float32, fused_decode=True)
    mem = encoded(torch, caps[True], px, F32_CHUNK)
    reset_counts()
    res, svc, _, _ = serve(torch, caps[True], px, F32_CHUNK,
                           num_slots=F32_SLOTS)
    steps = svc.windows
    counts = read_counts()
    chunks = -(-F32_REQUESTS // F32_CHUNK)
    hold_routes("service f32 greedy fused", attention=11 * chunks,
                decode={"fused": steps, "unfused": 0})
    if (counts["fused_decode_layer"] != dcfg.num_layers * steps
            or counts["flash_attention_btd"] != 11 * chunks):
        raise AssertionError(f"service f32 greedy fused: launches {counts}")
    kernel_fn = step_mod.fused_decode_layer
    step_mod.fused_decode_layer = fused_decode_layer_plain
    try:                                # the same route on the plain version
        plain, _, _, _ = serve(torch, caps[True], mem, num_slots=F32_SLOTS)
    finally:
        step_mod.fused_decode_layer = kernel_fn
    rows = padded_rows(res)
    checks = {
        "fused kernel == plain fused layer": rows == padded_rows(plain),
        "fused == batch greedy fused": rows == greedy(mem, True),
        "slots reused while others decode": svc.reused > 0,
    }
    reset_counts()
    unfused, usvc, _, _ = serve(torch, caps[False], mem, num_slots=F32_SLOTS)
    hold_routes("service f32 greedy unfused", attention=0,
                decode={"fused": 0, "unfused": usvc.windows})
    checks["unfused == batch greedy unfused"] = \
        padded_rows(unfused) == greedy(mem, False)
    fmem = encoded(torch, full, px, F32_CHUNK)
    reset_counts()
    fres, fsvc, _, _ = serve(torch, full, px, F32_CHUNK, num_slots=F32_SLOTS)
    # full memory: the last layer attends over every token, not the CLS row
    hold_routes("service f32 greedy full memory", attention=12 * chunks,
                decode={"fused": 0, "unfused": fsvc.windows})
    checks["full memory == batch full memory"] = \
        padded_rows(fres) == greedy(fmem, True)
    beam, _, _, _ = serve(torch, caps[True], mem, num_slots=F32_SLOTS,
                          method="beam", beam_size=3)
    checks["beam K=3 fused == beam_generate fused"] = beam == batch_rows(
        beam_generate(dec, dcfg, mem, ids.start_id, ids.end_id, ids.pad_id,
                      100, 3, compute_dtype=torch.float32, fused=True)[0],
        "beam")
    bucketed, bsvc, _, _ = serve(torch, caps[True], mem, num_slots=F32_SLOTS,
                                 cache_len=16)
    checks["cache_len 16 == unbucketed"] = \
        padded_rows(bucketed) == rows and bsvc.overflowed > 0
    print(f"service f32 {F32_SLOTS} slots, {F32_REQUESTS} requests: "
          + ", ".join(f"{k} {v}" for k, v in checks.items())
          + f"; greedy {spread(res)}; {svc.reused} admissions into a reused "
          f"slot while others decoded; full memory {spread(fres)}; "
          f"{bsvc.overflowed} overflowed at cache_len 16")
    if not all(checks.values()):
        raise AssertionError(f"service f32: {checks}")
    del caps, full, svc, usvc, fsvc, bsvc

    # bf16, SERVICE_SLOTS slots, SERVICE_REQUESTS requests in chunks
    caps = {"fused": Captioner(params, mcfg, ids, torch.bfloat16,
                               fused_decode=True),
            "unfused": Captioner(params, mcfg, ids, torch.bfloat16),
            "full": Captioner(params, full_mcfg, ids, torch.bfloat16,
                              fused_decode=True)}
    serve(torch, caps["fused"], pixels[:SERVICE_CHUNK], SERVICE_CHUNK,
          num_slots=SERVICE_SLOTS, steps_per_sync=SERVICE_WINDOW)  # warm-up
    chunks = SERVICE_REQUESTS // SERVICE_CHUNK
    runs = [("greedy fused", "fused", {}, SERVICE_WINDOW),
            ("greedy fused", "fused", {}, 1),
            ("greedy unfused", "unfused", {}, SERVICE_WINDOW),
            ("beam K=3 fused", "fused", dict(method="beam", beam_size=3),
             SERVICE_WINDOW),
            ("sample fused", "fused", dict(method="sample", top_k=50,
                                           top_p=0.9, seed=SEED),
             SERVICE_WINDOW),
            ("greedy full memory", "full", {}, SERVICE_WINDOW)]
    rates, main_counts, greedy_res = {}, None, None
    for label, which, kw, window in runs:
        reset_counts()
        res, svc, secs, win = serve(
            torch, caps[which], pixels, SERVICE_CHUNK, num_slots=SERVICE_SLOTS,
            steps_per_sync=window, **kw)
        counts = read_counts()
        steps = svc.windows * window
        fused = which == "fused"
        attn_calls = 12 if which == "full" else 11
        hold_routes(f"service bf16 {label}, window {window}",
                    attention=attn_calls * chunks,
                    decode={"fused": steps if fused else 0,
                            "unfused": 0 if fused else steps})
        want_layer = dcfg.num_layers * steps if fused else 0
        if (counts["fused_decode_layer"] != want_layer
                or counts["flash_attention_btd"] != attn_calls * chunks
                or len(res) != SERVICE_REQUESTS or svc.reused == 0):
            raise AssertionError(f"service bf16 {label}: launches {counts}, "
                                 f"{len(res)} results, {svc.reused} reuses")
        for r in res:
            assert r[0] == ids.start_id and 2 <= len(r) <= 100
            assert all(0 <= x < dcfg.vocab_size for x in r)
        key = f"{label}, window {window}"
        rates[key] = SERVICE_REQUESTS / secs
        print(f"service bf16 {SERVICE_SLOTS} slots, {key}: "
              f"{rates[key]:.1f} captions/s ({SERVICE_REQUESTS} requests in "
              f"{chunks} chunks, encoder included, {secs:.4f} s), window "
              f"median {statistics.median(win):.3f} ms (quartiles "
              f"{' - '.join(f'{q:.3f}' for q in statistics.quantiles(win, n=4)[::2])}"
              f", {len(win)} windows, {svc.steps_run} steps), "
              f"{spread(res)}; {svc.reused} admissions into a reused slot; "
              f"{counts['fused_decode_layer']} fused_decode_layer launches; "
              f"{DEVICE_LINE[0]}")
        if (label, window) == ("greedy fused", SERVICE_WINDOW):
            main_counts, greedy_res = counts, res
    # bf16 tokens against batch greedy: the service's CLS constant is f32,
    # the batch init_cache's bf16 (both packages), so a share, not a check
    mem = encoded(torch, caps["fused"], pixels, SERVICE_CHUNK)
    batch = greedy(mem, True, torch.bfloat16)
    rows = padded_rows(greedy_res)
    same_tok = np.mean([a == b for ra, rb in zip(rows, batch)
                        for a, b in zip(ra, rb)])
    same_cap = np.mean([ra == rb for ra, rb in zip(rows, batch)])
    print(f"service bf16 greedy fused against batch greedy fused: "
          f"{same_tok:.4f} of tokens equal, {same_cap:.4f} of captions "
          f"(reported, not checked: the CLS constant is f32 in the service, "
          f"bf16 in the batch)")
    fmem = encoded(torch, caps["full"], pixels, SERVICE_CHUNK)
    for label, which, m in (("greedy fused", "fused", mem),
                            ("greedy unfused", "unfused", mem),
                            ("greedy full memory", "full", fmem)):
        trace_service(torch, caps[which], m, label)
    print(f"service phase {time.perf_counter() - t_phase:.1f} s")
    return {"counts": main_counts, "rates": rates}


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
    hold_routes("blip384 f32", attention=11,
                decode={"fused": 0, "unfused": 0})
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


def write_tower(torch, root, name, vcfg, prefix, weights, config,
                extra=None):
    """A seeded vision tower of geometry `vcfg` (a VisionConfig) written in
    the HF layout: `weights` is "model.safetensors" (the port's codec) or
    "pytorch_model.bin" (torch.save of the state dict), `config` the
    config.json dict or None. Returns the directory, the seeded parameters
    (on the CPU), the file's bytes and the seconds to draw and to write."""
    from mit_tpu_torch.models.vision import (
        hf_vision_state_dict_from_params,
        init_vision_params,
    )
    from mit_tpu_torch.train.checkpoint import save_file

    t0 = time.perf_counter()
    params = init_vision_params(torch.Generator().manual_seed(SEED), vcfg)
    sd = dict(hf_vision_state_dict_from_params(params, vcfg, prefix),
              **(extra or {}))
    t1 = time.perf_counter()
    path = os.path.join(root, name)
    os.makedirs(path)
    if weights.endswith(".safetensors"):
        save_file(sd, os.path.join(path, weights))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   os.path.join(path, weights))
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f)
    return (path, params, os.path.getsize(os.path.join(path, weights)),
            t1 - t0, time.perf_counter() - t1)


def hf_vision_config(vcfg, model_type):
    """The config.json fields of a vision tower, as transformers writes
    them."""
    return {"model_type": model_type, "hidden_size": vcfg.hidden_size,
            "num_hidden_layers": vcfg.num_layers,
            "num_attention_heads": vcfg.num_heads,
            "intermediate_size": vcfg.intermediate_size,
            "image_size": vcfg.image_size, "patch_size": vcfg.patch_size,
            "hidden_act": vcfg.hidden_act,
            "layer_norm_eps": vcfg.layer_norm_eps}


def boot(torch, path, preset, seeded, written, device):
    """init_model_params_pretrained from `path` onto `device` (the 6 x 512
    decoder, vocab 10000): the loaded VisionConfig must equal the preset it
    was written from and every loaded tensor the seeded one, bit for bit.
    Returns (mcfg, params, seconds to load)."""
    from mit_tpu_torch.config import Config
    from mit_tpu_torch.models.model import init_model_params_pretrained

    t0 = time.perf_counter()
    mcfg, params = init_model_params_pretrained(
        torch.Generator().manual_seed(SEED), Config(ENCODER_MODEL_NAME=preset),
        vocab_size=10000, name_or_path=path, local_files_only=True,
        device=device)
    seconds = time.perf_counter() - t0
    flat = lambda tree, pre="": (
        [x for k, v in tree.items() for x in flat(v, f"{pre}{k}.")]
        if isinstance(tree, dict) else [(pre[:-1], tree)])
    loaded, want = dict(flat(params["encoder"])), dict(flat(seeded))
    differ = [k for k in want if k not in loaded
              or not torch.equal(loaded[k].cpu(), want[k])]
    same_cfg = mcfg.vision == written
    print(f"pretrained {preset}: loaded in {seconds:.2f} s onto {device}; "
          f"VisionConfig equal to the written one: {same_cfg}; "
          f"{len(want) - len(differ)} of {len(want)} tensors bit-equal to "
          f"the seeded ones, {len(loaded)} loaded")
    if not same_cfg or differ or len(loaded) != len(want):
        raise AssertionError(f"{preset}: loaded {mcfg.vision}, tensors that "
                             f"differ {differ[:4]}")
    return mcfg, params, seconds


def check_pretrained(torch, device="cuda"):
    """Phase 4b, pretrained encoders from local HF files and the uint8 image
    path (see the module docstring). Returns the counts of the CLIP ViT-L/14
    paths."""
    import tempfile

    from mit_tpu_torch.data.preprocess import device_preprocess
    from mit_tpu_torch.decode.api import Captioner
    from mit_tpu_torch.models.vision import PRESETS, FAMILY_BASE
    from mit_tpu_torch.utils.profiling import StepTimer, fence

    t_phase = time.perf_counter()
    ids = SpecialIds()
    counts = {}
    with tempfile.TemporaryDirectory() as root:
        # a composite CLIP checkpoint: the tower under vision_model., one
        # text tensor to skip, the nested vision_config
        clip = PRESETS[CLIP_L]
        stray = {"text_model.encoder.layers.0.self_attn.q_proj.weight":
                 np.zeros((8, 8), np.float32)}
        path, seeded, nbytes, draw_s, write_s = write_tower(
            torch, root, "clip", clip, "vision_model.", "model.safetensors",
            {"model_type": "clip", "projection_dim": 768,
             "vision_config": hf_vision_config(clip, "clip_vision_model")},
            stray)
        print(f"pretrained checkpoint {CLIP_L}: {nbytes} bytes of "
              f"safetensors, drawn in {draw_s:.2f} s, written in "
              f"{write_s:.2f} s")
        mcfg, params, _ = boot(torch, path, CLIP_L, seeded, clip, device)
        del seeded

        # uint8 -> normalized pixels on the card, held to the same call on
        # the CPU
        u8 = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, 256, (PRETRAINED_BATCH, *UINT8_HW, 3), dtype=np.uint8))
        u8_dev = u8.to(device)
        px = device_preprocess(u8_dev, CLIP_L)
        px_cpu = device_preprocess(u8, CLIP_L)
        err = (px.cpu() - px_cpu).abs().max().item()
        pre_ms = cuda_ms(torch, lambda: device_preprocess(u8_dev, CLIP_L))
        print(f"device_preprocess uint8 {tuple(u8.shape)} -> "
              f"{tuple(px.shape)} (bicubic, antialias): card vs CPU "
              f"max_abs_err={err:.3e} (limit {PREPROCESS_TOL:g}); "
              f"{pre_ms:.4f} ms a batch (CUDA events, {TIMED_ITERS} calls); "
              f"{DEVICE_LINE[0] if DEVICE_LINE else ''}")
        if not err <= PREPROCESS_TOL:
            raise AssertionError("device_preprocess: the card disagrees with "
                                 "the CPU")

        # f32, batch 8: kernel against plain memory; greedy tokens of the
        # kernel path, the plain path and the fused decode step identical;
        # the int8 arm within its own noise floor and near the float arm
        full = mcfg.vision.num_layers - 1
        px8 = px[:F32_BATCH]
        kern = Captioner(params, mcfg, ids, torch.float32)
        plain = Captioner(params, mcfg, ids, torch.float32, use_kernel=False)
        fused = Captioner(params, mcfg, ids, torch.float32, fused_decode=True)
        reset_counts()
        mem_k = kern.memory_from_pixels(px8)
        torch.cuda.synchronize()
        hold_launches("clip-l f32 encode", read_counts(),
                      per_encode(full)["float"])
        hold_routes("clip-l f32", attention=full,
                    decode={"fused": 0, "unfused": 0})
        mem_p = plain.memory_from_pixels(px8)
        err = (mem_k - mem_p).abs().max().item()
        tok_k = kern.generate_from_memory(mem_k)
        tok_p = plain.generate_from_memory(mem_p)
        before = graph_counts(fused)
        reset_counts()
        tok_f = fused.generate_from_memory(mem_k)
        steps = max(len(t) for t in tok_f) - 1
        hold_routes("clip-l f32 fused greedy", decode={
            "fused": hold_graphs("clip-l f32 fused greedy", fused, before,
                                 steps), "unfused": 0})
        same = tok_k == tok_p == tok_f
        print(f"pretrained clip-l f32 B={F32_BATCH}: memory kernel vs plain "
              f"max_abs_err={err:.3e} (limit 1e-4); greedy tokens kernel == "
              f"plain == fused step: {same} ({steps} steps, lengths "
              f"{[len(t) for t in tok_k]})")
        if not (err <= 1e-4 and same and mem_k.shape == (F32_BATCH, 1, 512)
                and bool(torch.isfinite(mem_k).all())):
            raise AssertionError("CLIP-L f32: the kernel path disagrees")
        q8 = Captioner(params, mcfg, ids, torch.float32, encoder_quant="int8")
        q8_plain = Captioner(params, mcfg, ids, torch.float32,
                             use_kernel=False, encoder_quant="int8")
        mem_q = q8.memory_from_pixels(px8)
        mem_qp = q8_plain.memory_from_pixels(px8)
        floor = rel_l2(q8_plain.memory_from_pixels(px8 * (1 + 1e-7)), mem_qp)
        rel = rel_l2(mem_q, mem_qp)
        cos = torch.nn.functional.cosine_similarity(
            mem_q.flatten(), mem_k.flatten(), dim=0).item()
        print(f"pretrained clip-l int8 f32 B={F32_BATCH}: memory kernel vs "
              f"plain int8 relative L2 {rel:.3e} (limit {FLOOR_FACTOR} x "
              f"{floor:.3e}, the plain int8 path's move under pixels x "
              f"(1 + 1e-7)); cosine to the float arm {cos:.6f} (limit > 0.999)")
        if not (0 < floor and rel <= FLOOR_FACTOR * floor and cos > 0.999):
            raise AssertionError("CLIP-L int8 f32: the kernel path disagrees")
        del kern, plain, fused, q8, q8_plain

        # bf16, batch 64, both arms: launches per encode, encode ms in
        # alternating turns, captions/s from uint8 through the fused step
        arms = {
            "float": Captioner(params, mcfg, ids, torch.bfloat16,
                               fused_decode=True),
            "int8": Captioner(params, mcfg, ids, torch.bfloat16,
                              encoder_quant="int8", fused_decode=True),
        }
        want = encode_launches(mcfg.vision, PRETRAINED_BATCH, 257)
        for arm, cap in arms.items():
            cap.memory_from_pixels(px)                          # warm-up
            torch.cuda.synchronize()
            reset_counts()
            cap.memory_from_pixels(px)
            torch.cuda.synchronize()
            counts[f"clip_l_{arm}"] = read_counts()
            hold_launches(f"clip-l bf16 B={PRETRAINED_BATCH} {arm} encode",
                          counts[f"clip_l_{arm}"], want[arm])
            hold_routes(f"clip-l bf16 {arm}",
                        attention=full if arm == "float" else 0,
                        decode={"fused": 0, "unfused": 0})
        # each arm against its plain version on the same pixels, within
        # FLOOR_FACTOR times the plain version's own move under one bf16 ulp
        # of the pixels; the int8 arm near the float arm
        plains = {
            "float": Captioner(params, mcfg, ids, torch.bfloat16,
                               use_kernel=False),
            "int8": Captioner(params, mcfg, ids, torch.bfloat16,
                              use_kernel=False, encoder_quant="int8"),
        }
        px_ulp = bf16_ulp_up(torch, px)
        mems, held = {}, True
        for arm, cap in arms.items():
            mems[arm] = cap.memory_from_pixels(px)
            mem_p = plains[arm].memory_from_pixels(px)
            floor = rel_l2(plains[arm].memory_from_pixels(px_ulp), mem_p)
            rel = rel_l2(mems[arm], mem_p)
            err = (mems[arm].float() - mem_p.float()).abs().max().item()
            print(f"pretrained clip-l bf16 B={PRETRAINED_BATCH} {arm}: memory "
                  f"kernel vs plain relative L2 {rel:.3e} (limit "
                  f"{FLOOR_FACTOR} x {floor:.3e}, the plain path's move under "
                  f"one bf16 ulp of the pixels), max_abs_err={err:.3e}")
            held &= (0 < floor and rel <= FLOOR_FACTOR * floor
                     and mems[arm].shape == (PRETRAINED_BATCH, 1, 512)
                     and bool(torch.isfinite(mems[arm]).all()))
        cos = torch.nn.functional.cosine_similarity(
            mems["int8"].float().flatten(), mems["float"].float().flatten(),
            dim=0).item()
        print(f"pretrained clip-l bf16 B={PRETRAINED_BATCH}: int8 arm's cosine "
              f"to the float arm {cos:.6f} (limit > 0.999)")
        if not (held and cos > 0.999):
            raise AssertionError("CLIP-L bf16: a kernel path disagrees")
        del plains, mems, mem_p
        mlp_turns = int8_mlp_turns(torch, "clip-l", arms["int8"], px, full)
        enc_ms = {arm: [] for arm in arms}
        for turn in range(ENC_REPS):
            for arm in (("float", "int8") if turn % 2 == 0
                        else ("int8", "float")):
                t0 = time.perf_counter()
                arms[arm].memory_from_pixels(px)
                torch.cuda.synchronize()
                enc_ms[arm].append((time.perf_counter() - t0) * 1e3)
        rates = {}
        for arm, cap in arms.items():
            q1, q2, q3 = statistics.quantiles(enc_ms[arm], n=4)
            timer = StepTimer()
            cap.generate_from_memory(cap.memory_from_pixels(                # warm-up
                device_preprocess(u8.to(device), CLIP_L)))
            before = graph_counts(cap)
            reset_counts()
            split = {"upload": [], "preprocess+encode": [], "decode": []}
            for _ in range(REPS):
                with timer.step(PRETRAINED_BATCH, sync=cap.params["decoder"]):
                    t0 = time.perf_counter()
                    batch = u8.to(device)
                    fence(batch)
                    t1 = time.perf_counter()
                    mem = cap.memory_from_pixels(device_preprocess(batch,
                                                                   CLIP_L))
                    fence(mem)
                    t2 = time.perf_counter()
                    tokens = cap.generate_from_memory(mem)
                    t3 = time.perf_counter()
                for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
                    split[key].append(dt * 1e3)
            steps = max(len(t) for t in tokens) - 1
            got = read_counts()
            # the warm-up captured the loop's graphs: the timed steps replay,
            # with no host launch of the decode layer; one more batch
            # under the profiler counts its kernels on the device
            ran = hold_graphs(f"clip-l bf16 {arm} uint8 to caption", cap,
                              before, steps * REPS)
            hold_routes(f"clip-l bf16 {arm} uint8 to caption",
                        decode={"fused": ran, "unfused": 0})
            hold_launches(f"clip-l bf16 {arm} uint8 to caption", got,
                          dict(want[arm], fused_decode_layer=(
                              mcfg.decoder.num_layers * ran // REPS)), REPS)
            traced_decode(torch, cap, mem,
                          f"clip-l bf16 {arm} uint8 to caption",
                          mcfg.decoder.num_layers)
            rates[arm] = timer.items_per_sec
            print(f"pretrained clip-l bf16 B={PRETRAINED_BATCH} {arm}: encode "
                  f"median {q2:.3f} ms (quartiles {q1:.3f}-{q3:.3f}, "
                  f"{ENC_REPS} runs in alternating turns); uint8 (host) -> "
                  f"caption {timer.items_per_sec:.2f} captions/s "
                  f"(StepTimer over {REPS} runs, mean "
                  f"{timer.mean_step_seconds * 1e3:.1f} ms a batch: "
                  + ", ".join(f"{k} {statistics.mean(v):.2f} ms"
                              for k, v in split.items())
                  + f", {steps} fused greedy steps); "
                  f"{DEVICE_LINE[0] if DEVICE_LINE else ''}")
        del arms, params

        # BLIP-base (self_attn.qkv under vision_model.) in f32 and a bare
        # ViT-B/16 pytorch_model.bin without config.json (geometry inferred)
        blip = FAMILY_BASE["blip"]
        path, seeded, nbytes, _, write_s = write_tower(
            torch, root, "blip", blip, "vision_model.", "model.safetensors",
            {"model_type": "blip",
             "vision_config": hf_vision_config(blip, "blip_vision_model")})
        print(f"pretrained checkpoint {BLIP}: {nbytes} bytes, written in "
              f"{write_s:.2f} s")
        mcfg, params, _ = boot(torch, path, BLIP, seeded, blip, device)
        pixels = torch.from_numpy(np.random.default_rng(SEED).uniform(
            -1, 1, (F32_BATCH, 3, 384, 384)).astype(np.float32)).to(device)
        kern = Captioner(params, mcfg, ids, torch.float32)
        plain = Captioner(params, mcfg, ids, torch.float32, use_kernel=False)
        reset_counts()
        mem_k = kern.memory_from_pixels(pixels)
        torch.cuda.synchronize()
        hold_launches(f"blip-base f32 B={F32_BATCH} encode", read_counts(),
                      {"flash_attention": blip.num_layers - 1})
        hold_routes("blip-base f32", attention=blip.num_layers - 1,
                    decode={"fused": 0, "unfused": 0})
        err = (mem_k - plain.memory_from_pixels(pixels)).abs().max().item()
        print(f"pretrained blip-base f32 B={F32_BATCH}: memory kernel vs "
              f"plain max_abs_err={err:.3e} (limit 1e-4)")
        if not (err <= 1e-4 and bool(torch.isfinite(mem_k).all())):
            raise AssertionError("BLIP-base f32: the kernel path disagrees")
        del kern, plain, params

        vit = PRESETS[VIT_B]
        path, seeded, nbytes, _, write_s = write_tower(
            torch, root, "vit", vit, "", "pytorch_model.bin", None)
        print(f"pretrained checkpoint {VIT_B}: {nbytes} bytes of "
              f"pytorch_model.bin, no config.json, written in {write_s:.2f} s")
        mcfg, params, _ = boot(torch, path, VIT_B, seeded, vit, device)
        px = device_preprocess(u8_dev, VIT_B)
        f32 = Captioner(params, mcfg, ids, torch.float32)
        f32_plain = Captioner(params, mcfg, ids, torch.float32,
                              use_kernel=False)
        err = (f32.memory_from_pixels(px[:F32_BATCH]) - f32_plain
               .memory_from_pixels(px[:F32_BATCH])).abs().max().item()
        bf16 = Captioner(params, mcfg, ids, torch.bfloat16)
        bf16.memory_from_pixels(px)                              # warm-up
        reset_counts()
        mem = bf16.memory_from_pixels(px)
        torch.cuda.synchronize()
        hold_launches(f"vit-b bf16 B={PRETRAINED_BATCH} encode", read_counts(),
                      per_encode(vit.num_layers - 1)["float"])
        hold_routes("vit-b bf16", attention=vit.num_layers - 1,
                    decode={"fused": 0, "unfused": 0})
        print(f"pretrained vit-b: f32 B={F32_BATCH} memory kernel vs plain "
              f"max_abs_err={err:.3e} (limit 1e-4); bf16 B="
              f"{PRETRAINED_BATCH} memory finite")
        if not (err <= 1e-4 and bool(torch.isfinite(mem).all())
                and mem.shape == (PRETRAINED_BATCH, 1, 512)):
            raise AssertionError("ViT-B: the kernel path disagrees")
    print(f"phase pretrained: {time.perf_counter() - t_phase:.1f} s")
    return {"counts": counts, "rates": rates,
            "enc_ms": {a: statistics.median(m) for a, m in enc_ms.items()},
            "preprocess_ms": pre_ms, "mlp_turns": mlp_turns}


def vit_h_config():
    """ViT-H/14 at its published widths (google/vit-huge-patch14-224-in21k's
    config.json): 32 layers of 1280 in 16 heads of 80, MLP 5120, patch 14 at
    224 (257 tokens), LayerNorm eps 1e-12, GELU. No PRESETS entry: the
    loaders read the widths from config.json."""
    from mit_tpu_torch.models.vision import FAMILY_BASE

    return FAMILY_BASE["vit"]._replace(
        image_size=224, patch_size=14, hidden_size=1280,
        num_layers=VIT_H_LAYERS, num_heads=16, intermediate_size=5120,
        hidden_act="gelu", layer_norm_eps=1e-12)


def check_vit_h(torch, device="cuda"):
    """Phase 4c, ViT-H/14 from local HF files (see the module docstring):
    its attention at head width 80 on the tiled kernels, float and int8
    arms, uint8 to caption. Returns its counts, rates and encode ms."""
    import tempfile

    from mit_tpu_torch.data.preprocess import device_preprocess
    from mit_tpu_torch.decode.api import Captioner
    from mit_tpu_torch.ops import flash_attention as fa
    from mit_tpu_torch.utils.profiling import StepTimer, fence

    t_phase = time.perf_counter()
    ids = SpecialIds()
    vcfg = vit_h_config()
    full = vcfg.num_layers - 1
    hd = vcfg.hidden_size // vcfg.num_heads
    tiled = {"tiled": full, "any_shape": 0}
    counts, rates, enc_ms = {}, {}, {}
    with tempfile.TemporaryDirectory() as root:
        path, seeded, nbytes, draw_s, write_s = write_tower(
            torch, root, "vit-h", vcfg, "", "model.safetensors",
            hf_vision_config(vcfg, "vit"))
        print(f"pretrained checkpoint {VIT_H}: {nbytes} bytes of safetensors "
              f"(config.json: {vcfg.num_layers} layers of "
              f"{vcfg.hidden_size}, {vcfg.num_heads} heads of {hd}), drawn "
              f"in {draw_s:.2f} s, written in {write_s:.2f} s")
        mcfg, params, _ = boot(torch, path, VIT_H, seeded, vcfg, device)
        del seeded
    u8 = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (PRETRAINED_BATCH, *UINT8_HW, 3), dtype=np.uint8))
    u8_dev = u8.to(device)
    px = device_preprocess(u8_dev, VIT_H)
    err = (px.cpu() - device_preprocess(u8, VIT_H)).abs().max().item()
    print(f"device_preprocess uint8 {tuple(u8.shape)} -> {tuple(px.shape)} "
          f"(bilinear, antialias): card vs CPU max_abs_err={err:.3e} (limit "
          f"{PREPROCESS_TOL:g})")
    if not err <= PREPROCESS_TOL:
        raise AssertionError("device_preprocess: the card disagrees with the "
                             "CPU")

    # f32, batch 8: the f32 kernel at head width 80 against the plain path;
    # greedy tokens of the kernel path, the plain path and the fused step
    px8 = px[:F32_BATCH]
    kern = Captioner(params, mcfg, ids, torch.float32)
    plain = Captioner(params, mcfg, ids, torch.float32, use_kernel=False)
    fused = Captioner(params, mcfg, ids, torch.float32, fused_decode=True)
    reset_counts()
    mem_k = kern.memory_from_pixels(px8)
    torch.cuda.synchronize()
    hold_launches("vit-h f32 encode", read_counts(), per_encode(full)["float"])
    hold_routes("vit-h f32", attention=full, decode={"fused": 0, "unfused": 0})
    hold_kernels("vit-h f32 encode", fa.flash_attention_btd, tiled)
    mem_p = plain.memory_from_pixels(px8)
    err = (mem_k - mem_p).abs().max().item()
    tok_k = kern.generate_from_memory(mem_k)
    tok_p = plain.generate_from_memory(mem_p)
    before = graph_counts(fused)
    reset_counts()
    tok_f = fused.generate_from_memory(mem_k)
    steps = max(len(t) for t in tok_f) - 1
    hold_routes("vit-h f32 fused greedy", decode={
        "fused": hold_graphs("vit-h f32 fused greedy", fused, before, steps),
        "unfused": 0})
    same = tok_k == tok_p == tok_f
    print(f"pretrained vit-h f32 B={F32_BATCH}: memory kernel vs plain "
          f"max_abs_err={err:.3e} (limit 1e-4); greedy tokens kernel == plain "
          f"== fused step: {same} ({steps} steps)")
    if not (err <= 1e-4 and same and mem_k.shape == (F32_BATCH, 1, 512)
            and bool(torch.isfinite(mem_k).all())):
        raise AssertionError("ViT-H f32: the kernel path disagrees")
    q8 = Captioner(params, mcfg, ids, torch.float32, encoder_quant="int8")
    q8_plain = Captioner(params, mcfg, ids, torch.float32, use_kernel=False,
                         encoder_quant="int8")
    mem_q = q8.memory_from_pixels(px8)
    mem_qp = q8_plain.memory_from_pixels(px8)
    floor = rel_l2(q8_plain.memory_from_pixels(px8 * (1 + 1e-7)), mem_qp)
    rel = rel_l2(mem_q, mem_qp)
    cos = torch.nn.functional.cosine_similarity(
        mem_q.flatten(), mem_k.flatten(), dim=0).item()
    print(f"pretrained vit-h int8 f32 B={F32_BATCH}: memory kernel vs plain "
          f"int8 relative L2 {rel:.3e} (limit {FLOOR_FACTOR} x {floor:.3e}, "
          f"the plain int8 path's move under pixels x (1 + 1e-7)); cosine to "
          f"the float arm {cos:.6f} (limit > 0.999)")
    if not (0 < floor and rel <= FLOOR_FACTOR * floor and cos > 0.999):
        raise AssertionError("ViT-H int8 f32: the kernel path disagrees")
    del kern, plain, fused, q8, q8_plain

    # bf16, batch 64, both arms, fused greedy: launches per encode, the
    # attention's kernel, encode ms in alternating turns, uint8 to caption
    arms = {
        "float": Captioner(params, mcfg, ids, torch.bfloat16,
                           fused_decode=True),
        "int8": Captioner(params, mcfg, ids, torch.bfloat16,
                          encoder_quant="int8", fused_decode=True),
    }
    wrapper = {"float": fa.flash_attention_btd,
               "int8": fa.flash_attention_btd_fusedqkv}
    want = encode_launches(mcfg.vision, PRETRAINED_BATCH, 257)
    mems = {}
    for arm, cap in arms.items():
        cap.memory_from_pixels(px)                              # warm-up
        torch.cuda.synchronize()
        reset_counts()
        mems[arm] = cap.memory_from_pixels(px)
        torch.cuda.synchronize()
        counts[f"vit_h_{arm}"] = read_counts()
        hold_launches(f"vit-h bf16 B={PRETRAINED_BATCH} {arm} encode",
                      counts[f"vit_h_{arm}"], want[arm])
        hold_routes(f"vit-h bf16 {arm}",
                    attention=full if arm == "float" else 0,
                    decode={"fused": 0, "unfused": 0})
        hold_kernels(f"vit-h bf16 {arm} encode", wrapper[arm], tiled)
        if not (mems[arm].shape == (PRETRAINED_BATCH, 1, 512)
                and bool(torch.isfinite(mems[arm]).all())):
            raise AssertionError(f"ViT-H bf16 {arm}: bad memory")
    cos = torch.nn.functional.cosine_similarity(
        mems["int8"].float().flatten(), mems["float"].float().flatten(),
        dim=0).item()
    print(f"pretrained vit-h bf16 B={PRETRAINED_BATCH}: int8 arm's cosine to "
          f"the float arm {cos:.6f} (printed, not held)")
    del mems
    mlp_turns = int8_mlp_turns(torch, "vit-h", arms["int8"], px, full)
    times = {arm: [] for arm in arms}
    for turn in range(ENC_REPS):
        for arm in (("float", "int8") if turn % 2 == 0 else ("int8", "float")):
            t0 = time.perf_counter()
            arms[arm].memory_from_pixels(px)
            torch.cuda.synchronize()
            times[arm].append((time.perf_counter() - t0) * 1e3)
    for arm, cap in arms.items():
        q1, q2, q3 = statistics.quantiles(times[arm], n=4)
        enc_ms[arm] = q2
        timer = StepTimer()
        cap.generate_from_memory(cap.memory_from_pixels(                # warm-up
            device_preprocess(u8_dev, VIT_H)))
        before = graph_counts(cap)
        reset_counts()
        split = {"upload": [], "preprocess+encode": [], "decode": []}
        for _ in range(REPS):
            with timer.step(PRETRAINED_BATCH, sync=cap.params["decoder"]):
                t0 = time.perf_counter()
                batch = u8.to(device)
                fence(batch)
                t1 = time.perf_counter()
                mem = cap.memory_from_pixels(device_preprocess(batch, VIT_H))
                fence(mem)
                t2 = time.perf_counter()
                tokens = cap.generate_from_memory(mem)
                t3 = time.perf_counter()
            for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
                split[key].append(dt * 1e3)
        steps = max(len(t) for t in tokens) - 1
        got = read_counts()
        # the warm-up captured the loop's graphs: the timed steps replay,
        # with no host launch of the decode layer; one more batch
        # under the profiler counts its kernels on the device
        ran = hold_graphs(f"vit-h bf16 {arm} uint8 to caption", cap, before,
                          steps * REPS)
        hold_routes(f"vit-h bf16 {arm} uint8 to caption",
                    decode={"fused": ran, "unfused": 0})
        hold_launches(f"vit-h bf16 {arm} uint8 to caption", got,
                      dict(want[arm], fused_decode_layer=(
                          mcfg.decoder.num_layers * ran // REPS)), REPS)
        traced_decode(torch, cap, mem, f"vit-h bf16 {arm} uint8 to caption",
                      mcfg.decoder.num_layers)
        rates[arm] = timer.items_per_sec
        print(f"pretrained vit-h bf16 B={PRETRAINED_BATCH} {arm}: encode "
              f"median {q2:.3f} ms (quartiles {q1:.3f}-{q3:.3f}, {ENC_REPS} "
              f"runs in alternating turns); uint8 (host) -> caption "
              f"{timer.items_per_sec:.2f} captions/s (StepTimer over {REPS} "
              f"runs, mean {timer.mean_step_seconds * 1e3:.1f} ms a batch: "
              + ", ".join(f"{k} {statistics.mean(v):.2f} ms"
                          for k, v in split.items())
              + f", {steps} fused greedy steps); "
              f"{DEVICE_LINE[0] if DEVICE_LINE else ''}")
    print(f"phase vit-h: {time.perf_counter() - t_phase:.1f} s")
    return {"counts": counts, "rates": rates, "enc_ms": enc_ms,
            "mlp_turns": mlp_turns}


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


def recovered_keep_mask(torch, da, b, h, t, s, seed, rate, causal,
                        cells=None):
    """The bf16 forward kernel's keep-mask at the cell map ``cells``, read
    off its output: q = k = 0 makes p uniform over the visible keys, and v
    one-hot over 64 keys at a time makes out[r, c] = pd[r, key c], positive
    iff the key is kept."""
    dt = torch.bfloat16
    q = torch.zeros(b, h, t, 64, device="cuda", dtype=dt)
    k = torch.zeros(b, h, s, 64, device="cuda", dtype=dt)
    pad = torch.zeros(b, s, device="cuda")
    got = torch.zeros(b, h, t, s, dtype=torch.bool, device="cuda")
    for c0 in range(0, s, 64):
        n = min(64, s - c0)
        v = torch.zeros(b, h, s, 64, device="cuda", dtype=dt)
        v[:, :, c0 + torch.arange(n), torch.arange(n)] = 1.0
        out = da.flash_attention_dropout_fwd(q, k, v, pad, seed, causal, rate,
                                             cells)
        got[..., c0:c0 + n] = out[..., :n] > 0
    return got


def check_dropout_forward_design(torch, da, seed, rate):
    """The bf16 forward on the tensor cores: its keep-mask recovered bit for
    bit, then its time beside the library call with dropout, at the
    training shape."""
    for name, b, h, t, s, causal in DROPOUT_SHAPES + [
            ("full", 2, 2, 128, 128, True)]:
        for r_seed, r_rate in ((seed, rate), (2**31 - 2, 0.5)):
            want = da.keep_mask(t, s, r_rate, r_seed,
                                torch.arange(b * h, device="cuda")
                                ).reshape(b, h, t, s)
            if causal:
                want = want & torch.ones(t, s, dtype=torch.bool,
                                         device="cuda").tril()
            same = torch.equal(recovered_keep_mask(
                torch, da, b, h, t, s, r_seed, r_rate, causal), want)
            torch.cuda.synchronize()
            print(f"flash_attention_dropout forward, keep-mask recovered from "
                  f"the output, {name} ({b}, {h}, {t}, {s}) causal={causal} "
                  f"seed {r_seed} rate {r_rate}: bitwise equal to keep_mask "
                  f"{same}")
            if not same:
                raise AssertionError("the forward kernel draws another mask")

    _, b, h, t, s, causal = DROPOUT_SHAPES[0]
    q, k, v, pad, _ = dropout_inputs(torch, b, h, t, s, torch.bfloat16)
    ref = da.flash_attention_dropout_reference(q, k, v, pad, seed, causal, rate)
    fmt = lambda x: "not measured" if x is None else f"{x:.4f}"
    fn = lambda: da.flash_attention_dropout_fwd(q, k, v, pad, seed, causal,
                                                rate)
    err = (fn().float() - ref.float()).abs().max().item()
    if not err <= DROPOUT_TOL["bfloat16"][0]:
        raise AssertionError(f"dropout forward: {err}")
    lib = sdpa_call(torch, q, k, v, True, pad, dropout_p=rate)
    print(f"design flash_attention_dropout forward ({b}, {h}, {t}, {s}, 64) "
          f"bf16, ms: 4 warps, 64 rows a block ({-(-t // 64)} blocks a cell) "
          f"{cuda_ms(torch, fn):.4f} (device time {fmt(device_ms(torch, fn))}"
          f", max_abs_err {err:.3e}); the library call with dropout "
          f"{cuda_ms(torch, lib):.4f} (device time "
          f"{fmt(device_ms(torch, lib))})")


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
            # nothing read; one byte written per (row, key)
            dump_bound = bound(b * h * t * s, 0, "f32")
            print(f"time dump_dropout_mask          ({b}, {h}, {t}, {s}): "
                  f"kernel {dump_runs['kernel']} ms, plain "
                  f"{dump_runs['plain']} ms, bound "
                  f"{dump_bound['bound_ms']:.5f} ms by "
                  f"{dump_bound['bound_by']}, library call none (not on the "
                  f"training path)")
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
    check_dropout_forward_design(torch, da, seed, rate)
    what = "(32, 8, 99, 99, 64) bf16 causal+pad"
    _, b, h, t, s, _ = DROPOUT_SHAPES[0]
    q, k, v, pad, do = dropout_inputs(torch, b, h, t, s, torch.bfloat16)
    report(results, "flash_attention_dropout", errs["fwd"], fwd_runs,
           what + ", forward",
           attention_bound(b, h, t, s, torch.bfloat16, extra_bytes=b * s * 4),
           sdpa_ms(torch, q, k, v, True, pad, dropout_p=rate),
           device_ms(torch, lambda: da.flash_attention_dropout_fwd(
               q, k, v, pad, seed, True, rate)),
           device_ms(torch, sdpa_call(torch, q, k, v, True, pad,
                                      dropout_p=rate)))
    # q, k, v and do read, dq, dk and dv written; five (T, S, 64) products
    lib_bwd = sdpa_backward_call(torch, q, k, v, do, True, pad,
                                 dropout_p=rate)
    report(results, "flash_attention_dropout_bwd", errs["bwd"], bwd_runs,
           what + ", backward",
           bound((3 * t + 4 * s) * b * h * 64 * 2 + b * s * 4,
                 5 * 2 * b * h * t * s * 64, "bf16"),
           cuda_ms(torch, lib_bwd),
           device_ms(torch, lambda: da.flash_attention_dropout_bwd(
               q, k, v, pad, do, seed, True, rate)),
           device_ms(torch, lib_bwd))
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


def train_setup(torch):
    """The training phase's model (ViT-B/16 encoder, decoder 6 x 512, vocab
    10000, the config's dropout) with weights from TRAIN_SEED, its trainable
    and frozen parts, and the optimizer."""
    from mit_tpu_torch.models.decoder import DecoderConfig
    from mit_tpu_torch.models.model import (
        ModelConfig,
        init_model_params,
        split_trainable,
    )
    from mit_tpu_torch.models.vision import PRESETS
    from mit_tpu_torch.train.steps import make_optimizer

    tcfg = TrainConfig()
    name = "google/vit-base-patch16-224-in21k"
    mcfg = ModelConfig(name, PRESETS[name],
                       DecoderConfig(vocab_size=10000,
                                     dropout=tcfg.DECODER_DROPOUT), "cls")
    params = init_model_params(torch.Generator().manual_seed(TRAIN_SEED), mcfg,
                               "cuda")
    trainable, frozen = split_trainable(params)
    return tcfg, mcfg, trainable, frozen, make_optimizer(tcfg)[0]


def trace_train(torch, mcfg, trainable, optimizer, batch, steps=TRACE_STEPS):
    """`steps` bf16 train steps with fused dropout under torch.profiler,
    after one warm-up (which captures the step's graph): device-busy ms per
    step (the union of the device events' intervals, so that no time is
    counted twice), its share of the traced wall time (the profiler's own
    host cost included), and the dropout-attention kernels' device ms per
    step. Steps/s moves with the host between calls; this shows a kernel's
    gain."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mit_tpu_torch.train.steps import init_train_state, make_train_step

    step = make_train_step(mcfg, optimizer, SpecialIds().pad_id,
                           torch.bfloat16, from_features=True,
                           fused_dropout=True)
    state, _ = step(init_train_state(trainable, optimizer), {}, batch,
                    TRAIN_SEED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, {}, batch, TRAIN_SEED)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = lambda e: getattr(e, "self_device_time_total", 0)
    total, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA):
        if b > end:
            total, end = total + b - max(a, end), b
    if not dev or total <= 0:
        print("trace train: the profiler recorded no device time (not "
              "measured)")
        return None
    per = lambda part: {
        "ms": sum(busy_us(e) for e in dev if part in e.key) / steps / 1e3,
        "launches": sum(e.count for e in dev if part in e.key) / steps}
    out = {"busy_ms_per_step": total / steps / 1e3,
           "wall_ms_per_step": wall_ms / steps,
           "busy_share": total / 1e3 / wall_ms,
           "kernels_per_step": sum(e.count for e in dev) / steps,
           "dropout_bwd": per("dropout_bwd"), "dropout_fwd": per("dropout_fwd")}
    print(f"trace train bf16 B={TRAIN_BATCH} fused dropout, {steps} steps: "
          f"{out['kernels_per_step']:.1f} device kernels and copies per step, "
          f"device busy {out['busy_ms_per_step']:.3f} ms per step, traced wall "
          f"{out['wall_ms_per_step']:.3f} ms per step (busy share "
          f"{out['busy_share']:.3f}); dropout backward "
          f"{out['dropout_bwd']['ms']:.4f} ms per step in "
          f"{out['dropout_bwd']['launches']:.1f} launches, forward "
          f"{out['dropout_fwd']['ms']:.4f} ms in "
          f"{out['dropout_fwd']['launches']:.1f}")
    return out


def trace_only(torch):
    """`chip_smoke.py --trace-train`: the train step's trace alone, on a
    batch of seeded tokens and CLS features, for comparing trees in one
    call."""
    from mit_tpu_torch.data.dataset import to_device

    _, mcfg, trainable, _, optimizer = train_setup(torch)
    ids = SpecialIds()
    rng = np.random.default_rng(TRAIN_SEED)
    toks = token_batch(rng, TRAIN_BATCH, mcfg.decoder.max_seq_len - 1,
                       mcfg.decoder.vocab_size, ids)
    feats = rng.normal(size=(TRAIN_BATCH, 1, mcfg.vision.hidden_size))
    batch = to_device({"decoder_input_tokens": toks[:, :-1],
                       "target_tokens": toks[:, 1:],
                       "features": feats.astype(np.float32)}, "cuda")
    if trace_train(torch, mcfg, trainable, optimizer, batch) is None:
        raise AssertionError("the train trace recorded no device time")


def check_training(torch):
    """Phase 5: the training path at full width (see the module docstring).
    Returns the counts of the counted run and the throughput."""
    import tempfile

    from mit_tpu_torch.data.dataset import to_device
    from mit_tpu_torch.ops.dropout_attention import flash_attention_dropout_bwd
    from mit_tpu_torch.train import checkpoint as ckpt
    from mit_tpu_torch.train.features import FeatureCache, attach_features
    from mit_tpu_torch.train.steps import (
        init_train_state,
        make_eval_step,
        make_train_step,
        tree_leaves,
        tree_map,
    )

    tcfg, mcfg, trainable, frozen, optimizer = train_setup(torch)
    ids = SpecialIds()
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
    # the graphed step: its first call runs the wrappers twice (the warm-up
    # and the capture), and the replays run none
    for _ in range(BF16_STEPS):
        state, loss = step(state, {}, fixed, TRAIN_SEED)
        losses.append(loss)
    losses = [x.item() for x in losses]
    counts = read_counts()
    bwd_kernels = dict(flash_attention_dropout_bwd.kernels)
    graph_calls = {"graph_captures": step.graph_captures,
                   "graph_replays": step.graph_replays,
                   "eager_steps": step.eager_steps}
    hold_routes("train cache build + bf16 steps",
                attention=counts["flash_attention_btd"]
                + counts["flash_attention_dropout"],
                decode={"fused": 0, "unfused": 0})
    print(f"train cache: {tuple(cache.features.shape)} {cache.features.dtype} "
          f"from {TRAIN_IMAGES} images in {build_s:.3f} s, "
          f"flash_attention_btd launches {counts['flash_attention_btd']} "
          f"(want {11 * TRAIN_IMAGES // TRAIN_BATCH})")
    print(f"train (c) bf16 B={TRAIN_BATCH} T={t}, {BF16_STEPS} graphed steps "
          f"on one batch: loss first {losses[0]:.6f}, last {losses[-1]:.6f}, "
          f"min {min(losses):.6f}; {graph_calls}; launches in the warm-up and "
          f"the capture, every other counter 0: {counts}; backward launches "
          f"by kernel {bwd_kernels}")
    want = {k: 0 for k in counts}
    want.update(flash_attention_btd=11 * TRAIN_IMAGES // TRAIN_BATCH,
                flash_attention_dropout=2 * 6,
                flash_attention_dropout_bwd=2 * 6)
    if counts != want:
        raise AssertionError(f"training launches {counts}, want {want}")
    if bwd_kernels != {"tensor_cores": 2 * 6, "cuda_cores": 0,
                       "any_shape": 0}:
        raise AssertionError(f"the bf16 backward ran {bwd_kernels}, want the "
                             f"tensor-core kernel only")
    if graph_calls != {"graph_captures": 1, "graph_replays": BF16_STEPS,
                       "eager_steps": 0}:
        raise AssertionError(f"the train step ran {graph_calls}, want one "
                             f"capture and replays")
    if not (all(np.isfinite(losses)) and losses[-1] < 0.9 * losses[0]):
        raise AssertionError(f"bf16 loss did not fall: {losses}")

    # (b) at dropout 0: flash_attention_btd in the forward, no dropout kernel
    no_drop = mcfg._replace(decoder=mcfg.decoder._replace(dropout=0.0))
    reset_counts()
    steps(torch.bfloat16, True, cfg=no_drop).eager(
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

    # (e) throughput, fused dropout on and off, in alternating turns; the
    # warm-up captures each step's graph
    runs = {True: [], False: []}
    st0 = init_train_state(trainable, optimizer)
    step_of = {fused: steps(torch.bfloat16, fused) for fused in runs}
    for fused in (True, False):                               # warm-up
        step_of[fused](st0, {}, fixed, TRAIN_SEED)
    for turn in range(RUNS):
        for fused in ((True, False) if turn % 2 == 0 else (False, True)):
            run, st = step_of[fused], st0
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
    # the replayed step's own launches, which only the device trace sees
    trace = trace_train(torch, mcfg, trainable, optimizer, fixed)
    if trace is None:
        raise AssertionError("the train trace recorded no device time")
    replayed = {"flash_attention_dropout": trace["dropout_fwd"]["launches"],
                "flash_attention_dropout_bwd": trace["dropout_bwd"]["launches"]}
    if replayed != {"flash_attention_dropout": 6,
                    "flash_attention_dropout_bwd": 6}:
        raise AssertionError(f"the replayed step launched {replayed} dropout "
                             f"kernels a step, want 6 each way")
    counts = dict(counts, **{k: round(v * TRACE_STEPS)
                             for k, v in replayed.items()})
    remat = check_remat(torch, mcfg, trainable, optimizer, batches)
    return {"counts": counts, "rates": rates, "remat": remat}


def host_libraries():
    """Whether each host library of native/ (the JPEG loader, the BPE
    core) built here, and if not, why. Nothing in the smoke needs
    them: without one the dataset decodes with PIL and the tokenizer runs
    the Python BPE."""
    from mit_tpu_torch.kernels import host

    for name, state in host.status().items():
        print(f"host library {name}: {state.splitlines()[0]}")


def remat_grads(torch, mcfg, params, batch, fused, remat):
    """The loss and every gradient of one training forward at f32 from
    the step's (TRAIN_SEED, step 0) dropout streams, as the train step
    computes them."""
    from mit_tpu_torch.models.model import forward_from_features
    from mit_tpu_torch.ops.attention import DropoutGenerators
    from mit_tpu_torch.train.steps import (
        masked_cross_entropy,
        tree_leaves,
        tree_unflatten,
    )

    gens = DropoutGenerators.for_step(TRAIN_SEED, 0, batch["features"].device)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    logits = forward_from_features(
        tree_unflatten(params, leaves), mcfg, batch["features"],
        batch["decoder_input_tokens"], False, gens, torch.float32, True,
        fused, remat)
    loss = masked_cross_entropy(logits, batch["target_tokens"],
                                SpecialIds().pad_id)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


def check_remat(torch, mcfg, trainable, optimizer, batches):
    """Remat in training, after the rest of phase 5:
    (a) f32, REMAT_BATCH rows, dropout 0.1, fused dropout on and off: the
    loss and every gradient with remat=True against remat=False from the
    same state and (seed, step), and one train step each way: bitwise is
    the aim, REMAT_TOL relative (largest |difference| over the largest
    |gradient| of each leaf) the bound. (b) bf16 batch 32, fused dropout,
    one step each way with the counters set to 0 before it and read after
    it: without remat 6 dropout forward and 6 backward launches, with remat
    12 forward (each layer's forward runs again in the recompute) and 6
    backward, every attention call on a kernel route. (c) bf16 batch 32, T
    99, fused dropout: steps/s (median and quartiles of RUNS runs of
    RUN_STEPS steps in alternating turns) and torch.cuda.max_memory_allocated
    over one step, with and without remat; printed, not held. (d) the host
    libraries' build state."""
    from mit_tpu_torch.train.steps import (
        init_train_state,
        make_train_step,
        tree_leaves,
    )

    ids = SpecialIds()
    small = {k: v[:REMAT_BATCH] for k, v in batches[0].items()}
    worst, bitwise = 0.0, True
    for fused in (True, False):
        (l0, g0), (l1, g1) = (remat_grads(torch, mcfg, trainable, small,
                                          fused, remat)
                              for remat in (False, True))
        rel = max((a - b).abs().max().item() / max(a.abs().max().item(),
                                                   1e-30)
                  for a, b in zip(g0, g1))
        states = [make_train_step(mcfg, optimizer, ids.pad_id, torch.float32,
                                  from_features=True, fused_dropout=fused,
                                  remat=remat)(
            init_train_state(trainable, optimizer), {}, small, TRAIN_SEED)
            for remat in (False, True)]
        same = (torch.equal(l0, l1) and all(map(torch.equal, g0, g1))
                and torch.equal(states[0][1], states[1][1])
                and all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(states[0][0].params),
                    tree_leaves(states[1][0].params))))
        loss_rel = abs(l1.item() - l0.item()) / abs(l0.item())
        print(f"remat (a) f32 B={REMAT_BATCH} dropout "
              f"{mcfg.decoder.dropout} fused_dropout={fused}: loss "
              f"{l0.item():.8f} vs {l1.item():.8f} (relative {loss_rel:.3e}), "
              f"largest gradient difference {rel:.3e} relative over "
              f"{len(g0)} gradients (limit {REMAT_TOL:g}); loss, gradients "
              f"and one train step bitwise equal={same}")
        worst, bitwise = max(worst, rel, loss_rel), bitwise and same
        if not max(rel, loss_rel) <= REMAT_TOL:
            raise AssertionError("remat changes the loss or the gradients")

    fixed = batches[0]
    st0 = init_train_state(trainable, optimizer)
    # eager both ways: the counters count each launch, and remat's cost is
    # not mixed with the graph's
    step = {remat: make_train_step(mcfg, optimizer, ids.pad_id,
                                   torch.bfloat16, from_features=True,
                                   fused_dropout=True, remat=remat).eager
            for remat in (False, True)}
    for remat in (False, True):
        reset_counts()
        step[remat](st0, {}, fixed, TRAIN_SEED)
        torch.cuda.synchronize()
        counts = read_counts()
        fwd = 12 if remat else 6
        hold_launches(f"remat (b) bf16 one step remat={remat}", counts,
                      {"flash_attention_dropout": fwd,
                       "flash_attention_dropout_bwd": 6})
        hold_routes(f"remat (b) remat={remat}", attention=fwd,
                    decode={"fused": 0, "unfused": 0})

    peak = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        step[remat](st0, {}, fixed, TRAIN_SEED)
        torch.cuda.synchronize()
        peak[remat] = (torch.cuda.max_memory_allocated(), before)
    runs = {False: [], True: []}
    for turn in range(RUNS):
        for remat in ((False, True) if turn % 2 == 0 else (True, False)):
            st = st0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(RUN_STEPS):
                st, _ = step[remat](st, {}, batches[i % 2], TRAIN_SEED)
            torch.cuda.synchronize()
            runs[remat].append(RUN_STEPS / (time.perf_counter() - t0))
    out = {"max_rel": worst, "bitwise": bitwise}
    for remat, sps in runs.items():
        q1, q2, q3 = statistics.quantiles(sps, n=4)
        top, before = peak[remat]
        key = "remat" if remat else "no_remat"
        out[key] = {"steps_per_s": q2, "peak_bytes": top,
                    "step_bytes": top - before}
        print(f"remat (c) bf16 B={TRAIN_BATCH} fused dropout remat={remat}: "
              f"{q2:.3f} steps/s median (quartiles {q1:.3f}-{q3:.3f}, {RUNS} "
              f"runs of {RUN_STEPS} steps), runs "
              f"{[round(x, 3) for x in sps]}; max_memory_allocated over one "
              f"step {top / 2**20:.1f} MiB, {(top - before) / 2**20:.1f} MiB "
              f"above the {before / 2**20:.1f} MiB held before it; "
              f"{DEVICE_LINE[0] if DEVICE_LINE else ''}")
    host_libraries()
    return out


# kernel name -> (source, the TPU kernel it replaces, the path whose run
# gives its launch count)
# ----------------------------------------------------------------------
# phase 5b: the device mesh
# ----------------------------------------------------------------------
MESH_STEPS = 5                  # train steps of each mesh run
MESH_SHAPES = ((2, 1), (1, 2))  # two ranks: data-parallel, tensor-parallel
MESH_TOL = 1e-5                 # f32 mesh losses against one rank, relative
MESH_TIMEOUT = 600              # seconds the ranks of one spawn may take
MESH_LABEL = "2 ranks sharing one card, not a multi-GPU rate"
CELL_SEED, CELL_RATE = 20261017, 0.1
CELL_MAP_ITERS = 50             # launches in one timed burst
CELL_MAP_ROUNDS = 5             # bursts of each case and kernel, in turns
CELL_MAP_HOLD = 50_000_000      # cycles the stream sleeps while a burst queues
CELL_MAP_AGREE = 0.05           # no map against the identity map, relative


def mesh_train_inputs(torch):
    """(mcfg, trainable, optimizer, batch) of the mesh runs: the training
    phase's model from TRAIN_SEED and one batch of TRAIN_BATCH seeded CLS
    features (what the cache holds) and token ids, on the card."""
    from mit_tpu_torch.data.dataset import to_device

    _, mcfg, trainable, _, optimizer = train_setup(torch)
    rng = np.random.default_rng(TRAIN_SEED + 1)
    t = mcfg.decoder.max_seq_len - 1
    toks = token_batch(rng, TRAIN_BATCH, t, mcfg.decoder.vocab_size,
                       SpecialIds())
    feats = rng.normal(size=(TRAIN_BATCH, 1, mcfg.vision.hidden_size))
    return mcfg, trainable, optimizer, to_device({
        "features": feats.astype(np.float32),
        "decoder_input_tokens": toks[:, :-1], "target_tokens": toks[:, 1:]},
        "cuda")


def mesh_train(torch, mcfg, trainable, optimizer, batch, mesh, dtype,
               steps=MESH_STEPS, frozen=None):
    """``steps`` fused-dropout train steps on ``batch`` at ``mesh`` (None:
    one device) → (losses, seconds of the steps after the first, or of the
    one step). With
    ``frozen`` (the whole frozen subtree) the steps run from the batch's
    images with the encoder in the step, this rank's as ``train()`` gives
    it (``shard_encoder``: a float encoder split over "model", an int8 one
    whole); without, from its features."""
    from mit_tpu_torch.parallel import mesh as pmesh
    from mit_tpu_torch.train.steps import init_train_state, make_train_step

    step = make_train_step(mcfg, optimizer, SpecialIds().pad_id, dtype,
                           from_features=frozen is None, fused_dropout=True,
                           mesh=mesh)
    state = init_train_state(trainable, optimizer)
    frozen = frozen or {}
    if mesh is not None:
        state = pmesh.shard_train_state(state, mesh,
                                        tp=mesh.shape["model"] > 1)
        batch = pmesh.shard_batch(batch, mesh)
        if frozen:
            frozen = {"encoder": pmesh.shard_encoder(
                frozen["encoder"], mcfg.vision, mesh)}
    losses, t0 = [], time.perf_counter()
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, loss = step(state, frozen, batch, TRAIN_SEED)
        losses.append(loss)
    torch.cuda.synchronize()
    return [x.item() for x in losses], time.perf_counter() - t0


def mesh_rank(argv) -> int:
    """One rank of the gloo spawn (``--mesh-rank RANK WORLD INIT OUT``): at
    each of MESH_SHAPES, MESH_STEPS f32 and MESH_STEPS bf16 steps on
    ``cuda:0``, with the dropout kernels' launches, the forward's local
    shapes and the backward's kernels counted from 0 before each run; a
    JSON file of it all at OUT."""
    rank, world, init, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    import torch
    import torch.distributed as dist

    from mit_tpu_torch.ops import dropout_attention as da
    from mit_tpu_torch.parallel.mesh import init_distributed_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    launch, bwd = da.flash_attention_dropout_fwd, da.flash_attention_dropout_bwd
    shapes = []

    def recording(q, *args, **kw):
        shapes.append(tuple(q.shape))
        return launch(q, *args, **kw)

    # the wrapper counts its launches under its module name: this one now
    da.flash_attention_dropout_fwd = fwd = recording
    result = {}
    try:
        inputs = mesh_train_inputs(torch)
        for shape in MESH_SHAPES:
            mesh = init_distributed_mesh(shape, "cuda:0")
            runs = {"coords": list(mesh.coords)}
            for dtype in (torch.float32, torch.bfloat16):
                fwd.launches = bwd.launches = 0
                bwd.kernels = {k: 0 for k in bwd.kernels}
                shapes.clear()
                losses, secs = mesh_train(torch, *inputs, mesh, dtype)
                runs[str(dtype)[6:]] = {
                    "losses": losses, "seconds": secs, "fwd": fwd.launches,
                    "bwd": bwd.launches, "bwd_kernels": dict(bwd.kernels),
                    "shapes": sorted(set(shapes))}
            result[f"{shape[0]},{shape[1]}"] = runs
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


def mesh_nccl(argv) -> int:
    """One rank under nccl (``--mesh-nccl INIT OUT``): the mesh at (1, 1)
    built explicitly through ``init_distributed_mesh``, an all-reduce over
    its "data" group, and two f32 train steps through the mesh's step
    against two without it."""
    init, out = argv
    import torch
    import torch.distributed as dist

    from mit_tpu_torch.parallel.collectives import all_reduce_sum
    from mit_tpu_torch.parallel.mesh import init_distributed_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = init_distributed_mesh((1, 1), "cuda:0", backend="nccl",
                                 init_method=f"file://{init}", rank=0,
                                 world_size=1)
    try:
        x = all_reduce_sum(torch.arange(4.0, device="cuda"),
                           mesh.group("data"))
        inputs = mesh_train_inputs(torch)
        got, _ = mesh_train(torch, *inputs, mesh, torch.float32, steps=2)
        want, _ = mesh_train(torch, *inputs, None, torch.float32, steps=2)
        result = {"backend": dist.get_backend(), "world": dist.get_world_size(),
                  "all_reduce": x.tolist(), "losses": got, "single": want}
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


def spawn_ranks(argvs, label):
    """Run ``chip_smoke.py <argv>`` once for each of ``argvs`` at once, and
    join them all within MESH_TIMEOUT; every process is stopped before this
    returns. Raises unless all exit 0."""
    import tempfile

    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for i, argv in enumerate(argvs):
                log = open(os.path.join(tmp, f"rank{i}.log"), "w")
                procs.append((subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), *argv],
                    stdout=log, stderr=subprocess.STDOUT), log))
            deadline = time.monotonic() + MESH_TIMEOUT
            for p, _ in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        for i, (p, _) in enumerate(procs):
            text = open(os.path.join(tmp, f"rank{i}.log")).read()
            if p.returncode != 0:
                raise AssertionError(f"{label} rank {i} exited {p.returncode}:"
                                     f"\n{text[-3000:]}")


def check_cell_map(torch):
    """Rows 9 and 10 under the cell map, at the bf16 training shape (32, 8,
    99, 99, 64) split as (2, 1) and (1, 2) meshes split it: each rank's
    dump-kernel mask and forward-kernel mask (recovered from its output)
    bitwise equal to the plain mask at its map and to its slice of the
    global launch's; its forward and its dq, dk, dv against its slice of
    the global launch's (bitwise printed) and the plain version's (the
    DROPOUT_TOL bounds). Then the forward, backward and dump times at the
    global shape, with no map and with the identity map, and at the ranks'
    shapes (``time_cell_map``), which it returns for the kernels line."""
    from mit_tpu_torch.ops import dropout_attention as da

    seed, rate = CELL_SEED, CELL_RATE
    _, b, h, t, s, causal = DROPOUT_SHAPES[0]
    fwd_tol, bwd_tol = DROPOUT_TOL["bfloat16"]
    q, k, v, pad, do = dropout_inputs(torch, b, h, t, s, torch.bfloat16)
    whole = da.dump_dropout_mask(b, h, t, s, seed, rate, "cuda")
    recovered = recovered_keep_mask(torch, da, b, h, t, s, seed, rate, causal)
    out = da.flash_attention_dropout_fwd(q, k, v, pad, seed, causal, rate)
    grads = da.flash_attention_dropout_bwd(q, k, v, pad, do, seed, causal,
                                           rate)
    local = {}
    for d, m in MESH_SHAPES:
        for i in range(d):
            for j in range(m):
                rows = slice(i * b // d, (i + 1) * b // d)
                heads = slice(j * h // m, (j + 1) * h // m)
                cells = (rows.start, h, heads.start)
                part = lambda x: x[rows, heads].contiguous()
                lb, lh = b // d, h // m
                mask = da.dump_dropout_mask(lb, lh, t, s, seed, rate, "cuda",
                                            cells)
                plain = da.dump_dropout_mask(lb, lh, t, s, seed, rate, "cpu",
                                             cells).cuda()
                fmask = recovered_keep_mask(torch, da, lb, lh, t, s, seed,
                                            rate, causal, cells)
                args = (part(q), part(k), part(v), pad[rows].contiguous())
                got = da.flash_attention_dropout_fwd(*args, seed, causal, rate,
                                                     cells)
                ref = da.flash_attention_dropout_reference(*args, seed, causal,
                                                           rate, cells)
                g = da.flash_attention_dropout_bwd(*args, part(do), seed,
                                                   causal, rate, cells)
                rg = da.flash_attention_dropout_reference_backward(
                    *args, part(do), seed, causal, rate, cells)
                torch.cuda.synchronize()
                same = {"dump vs plain": torch.equal(mask, plain),
                        "dump vs global": torch.equal(mask, part(whole)),
                        "forward's mask vs global": torch.equal(
                            fmask, part(recovered)),
                        "forward vs global": torch.equal(got, part(out)),
                        "backward vs global": all(torch.equal(x, part(y))
                                                  for x, y in zip(g, grads))}
                fwd_err = (got.float() - ref.float()).abs().max().item()
                bwd_rel = max(((x.float() - y.float()).abs().max()
                               / y.float().abs().max()).item()
                              for x, y in zip(g, rg))
                print(f"cell map mesh ({d}, {m}) rank ({i}, {j}): local "
                      f"({lb}, {lh}, {t}, {s}) at cells {cells}: bitwise "
                      f"{same}; forward max_abs_err {fwd_err:.3e} (limit "
                      f"{fwd_tol:.0e}), dq, dk, dv over their largest value "
                      f"{bwd_rel:.3e} (limit {bwd_tol:.0e})")
                if not (all(list(same.values())[:3]) and fwd_err <= fwd_tol
                        and bwd_rel <= bwd_tol):
                    raise AssertionError(f"cell map ({d}, {m}) rank ({i}, {j})")
                local.setdefault((lb, lh), (args, part(do), cells))
    cases = [(f"({b}, {h}) no map", ((q, k, v, pad), do, None)),
             (f"({b}, {h}) map (0, {h}, 0)", ((q, k, v, pad), do, (0, h, 0)))]
    cases += [(f"({lb}, {lh}) map {c[2]}", c) for (lb, lh), c in local.items()]
    return time_cell_map(torch, da, cases, seed, causal, rate, t, s)


def queued_ms(torch, fn, iters=CELL_MAP_ITERS):
    """(device ms a call, queued) of ``iters`` calls of ``fn`` that the host
    enqueues while the stream sleeps: the events then time the card's
    back-to-back work, not the host's issue time. ``queued`` is False where
    the host was still enqueueing when the sleep ended."""
    fn()
    torch.cuda.synchronize()
    held, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    held.record()
    torch.cuda._sleep(CELL_MAP_HOLD)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms < held.elapsed_time(start)


def time_cell_map(torch, da, cases, seed, causal, rate, t, s):
    """Forward, backward and dump device times of each (label, (args, do,
    cells)) case: the median of CELL_MAP_ROUNDS bursts (``queued_ms``),
    the cases in turns, every other round reversed, with the spread (max −
    min) / median. The first two cases are the same launches (no map, the
    identity map): the times are trusted where those agree within
    CELL_MAP_AGREE and every burst queued."""
    calls = {}
    for label, (args, dout, cells) in cases:
        lb, lh = args[0].shape[:2]
        calls[label] = {
            "fwd": lambda a=args, c=cells: da.flash_attention_dropout_fwd(
                *a, seed, causal, rate, c),
            "bwd": lambda a=args, o=dout, c=cells:
                da.flash_attention_dropout_bwd(*a, o, seed, causal, rate, c),
            "dump": lambda lb=lb, lh=lh, c=cells: da.dump_dropout_mask(
                lb, lh, t, s, seed, rate, "cuda", c)}
    runs = {label: {kind: [] for kind in ("fwd", "bwd", "dump")}
            for label in calls}
    queued = True
    for r in range(CELL_MAP_ROUNDS):
        for label in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            for kind, fn in calls[label].items():
                ms, ok = queued_ms(torch, fn)
                runs[label][kind].append(ms)
                queued &= ok
    times = {}
    for label, (args, _, _) in cases:
        lb, lh = args[0].shape[:2]
        fb = attention_bound(lb, lh, t, s, torch.bfloat16,
                             extra_bytes=lb * s * 4)
        row = {"fwd_bound_ms": fb["bound_ms"]}
        for kind, xs in runs[label].items():
            med = statistics.median(xs)
            row[f"{kind}_ms"] = med
            row[f"{kind}_spread"] = (max(xs) - min(xs)) / med
        times[label] = row
        print(f"time cell map {label} ({t}, {s}, 64) bf16, device ms, median "
              f"of {CELL_MAP_ROUNDS} bursts of {CELL_MAP_ITERS} (spread): "
              + ", ".join(f"{kind} {row[kind + '_ms']:.5f} "
                          f"({row[kind + '_spread']:.3f})"
                          for kind in ("fwd", "bwd", "dump"))
              + f"; forward bound {fb['bound_ms']:.5f} by {fb['bound_by']}; "
              f"{DEVICE_LINE[0] if DEVICE_LINE else ''}")
    none, ident = (times[label] for label, _ in cases[:2])
    agree = {kind: abs(none[f"{kind}_ms"] - ident[f"{kind}_ms"])
             / none[f"{kind}_ms"] for kind in ("fwd", "bwd", "dump")}
    trusted = queued and all(x <= CELL_MAP_AGREE for x in agree.values())
    print(f"time cell map: no map against the identity map (the same "
          f"launches), relative difference "
          + ", ".join(f"{k} {x:.3f}" for k, x in agree.items())
          + f" (limit {CELL_MAP_AGREE}); every burst queued behind the sleep="
          f"{queued}; trusted={trusted}")
    return {"trusted": trusted, "cases": times}


def check_mesh_service(torch):
    """The CaptionService with its 64 slots split over two "data" shards on
    the one card (a single-process mesh of cuda:0 twice), 256 requests in
    bf16, greedy through the fused decode layer and beam K = 3: tokens equal
    to the one-shard service's; the counts set to 0 before each sharded run
    and read after it; captions/s and window ms of both."""
    from mit_tpu_torch.decode.api import Captioner
    from mit_tpu_torch.parallel.mesh import create_mesh

    mcfg, params, pixels = service_setup(torch)
    cap = Captioner(params, mcfg, SpecialIds(), torch.bfloat16,
                    fused_decode=True)
    mem = encoded(torch, cap, pixels, SERVICE_CHUNK)
    mesh = create_mesh((2, 1), ["cuda:0", "cuda:0"])
    L = mcfg.decoder.num_layers
    counts, rates = {}, {}
    for method, extra in (("greedy", {}), ("beam", {"beam_size": 3})):
        kw = dict(num_slots=SERVICE_SLOTS, steps_per_sync=SERVICE_WINDOW,
                  method=method, **extra)
        one, _, s1, w1 = serve(torch, cap, mem, **kw)
        reset_counts()
        two, svc, s2, w2 = serve(torch, cap, mem, mesh=mesh, **kw)
        counts[method] = read_counts()
        micro = counts[method]["fused_decode_layer"]
        hold_routes(f"mesh service {method}", attention=0,
                    decode={"fused": micro // L, "unfused": 0})
        same = one == two
        n = len(one)
        rates[method] = {"one": n / s1, "two": n / s2}
        print(f"mesh service bf16 {method} fused {SERVICE_SLOTS} slots over "
              f"2 shards, {n} requests: tokens equal to one shard={same}; "
              f"captions/s {n / s2:.2f} against {n / s1:.2f} on one shard "
              f"({MESH_LABEL}); median window ms "
              f"{statistics.median(w2):.3f} against "
              f"{statistics.median(w1):.3f}: the host issues both shards' "
              f"windows; fused_decode_layer launches {micro} "
              f"({svc.windows} windows)")
        if not same:
            raise AssertionError(f"mesh service {method}: tokens differ")
        if micro == 0 or micro % (2 * L):
            raise AssertionError(f"mesh service {method}: launches {micro}")
    return {"counts": counts["greedy"], "rates": rates}


def check_mesh(torch):
    """Phase 5b, the device mesh (see the module docstring)."""
    import tempfile

    t_phase = time.perf_counter()
    times = check_cell_map(torch)
    with tempfile.TemporaryDirectory() as tmp:
        init, outs = os.path.join(tmp, "pg"), [os.path.join(tmp, f"r{r}.json")
                                               for r in range(2)]
        t0 = time.perf_counter()
        spawn_ranks([["--mesh-rank", str(r), "2", init, outs[r]]
                     for r in range(2)], "gloo mesh")
        spawn_s = time.perf_counter() - t0
        ranks = [json.load(open(o)) for o in outs]
        nccl_out = os.path.join(tmp, "nccl.json")
        spawn_ranks([["--mesh-nccl", os.path.join(tmp, "pg_nccl"),
                      nccl_out]], "nccl mesh")
        nccl = json.load(open(nccl_out))
    inputs = mesh_train_inputs(torch)
    single = {str(dt)[6:]: mesh_train(torch, *inputs, None, dt)
              for dt in (torch.float32, torch.bfloat16)}
    counts = {}
    for shape in MESH_SHAPES:
        key = f"{shape[0]},{shape[1]}"
        b, h = TRAIN_BATCH // shape[0], 8 // shape[1]
        for r, res in enumerate(ranks):
            run = res[key]
            f32, bf16 = run["float32"], run["bfloat16"]
            rel = max(abs(a - w) / abs(w) for a, w in
                      zip(f32["losses"], single["float32"][0]))
            falls = bf16["losses"][-1] < bf16["losses"][0]
            want = [[b, h, 99, 64]]
            sps = (MESH_STEPS - 1) / bf16["seconds"]
            print(f"mesh {shape} rank {r} at {tuple(run['coords'])}: f32 "
                  f"losses {f32['losses']} against one rank "
                  f"{single['float32'][0]}, largest relative difference "
                  f"{rel:.3e} (limit {MESH_TOL:.0e}); bf16 losses "
                  f"{bf16['losses']} (falls={falls}); dropout launches per "
                  f"step forward {bf16['fwd'] / MESH_STEPS}, backward "
                  f"{bf16['bwd'] / MESH_STEPS} at local shapes "
                  f"{bf16['shapes']}, backward kernels {bf16['bwd_kernels']}; "
                  f"bf16 {sps:.3f} steps/s ({MESH_LABEL})")
            for run_ in (f32, bf16):
                if (run_["fwd"], run_["bwd"]) != (6 * MESH_STEPS,
                                                  6 * MESH_STEPS) \
                        or run_["shapes"] != want:
                    raise AssertionError(f"mesh {shape} rank {r}: launches "
                                         f"{run_}")
            if not (rel <= MESH_TOL and falls
                    and bf16["bwd_kernels"]["tensor_cores"] == 6 * MESH_STEPS):
                raise AssertionError(f"mesh {shape} rank {r} disagrees")
            counts.setdefault("flash_attention_dropout", bf16["fwd"])
            counts.setdefault("flash_attention_dropout_bwd", bf16["bwd"])
    one_sps = (MESH_STEPS - 1) / single["bfloat16"][1]
    print(f"mesh: one rank bf16 {one_sps:.3f} steps/s in this process; the "
          f"gloo spawn of two ranks took {spawn_s:.1f} s")
    ok = (nccl["backend"] == "nccl" and nccl["all_reduce"] == [0, 1, 2, 3]
          and nccl["losses"] == nccl["single"])
    print(f"mesh nccl (1, 1): backend {nccl['backend']}, world "
          f"{nccl['world']}, all_reduce {nccl['all_reduce']}, two f32 steps "
          f"through the mesh {nccl['losses']} against without "
          f"{nccl['single']}: ok={ok}. NCCL across real cards is not "
          "measured: this machine has one card.")
    if not ok:
        raise AssertionError("the nccl mesh disagrees")
    service = check_mesh_service(torch)
    print(f"mesh phase {time.perf_counter() - t_phase:.1f} s")
    return {"times": times, "counts": counts, "service": service}


# ----------------------------------------------------------------------
# phase 5c: the frozen encoder split over "model" in the train step
# ----------------------------------------------------------------------
TP_SHAPE = (1, 2)               # two ranks, the encoder's heads split
TP_BLIP_BATCH = 4               # rows of the BLIP-384 step
TP_INT8_STEPS = 2               # steps of the int8 arm, each way


def tp_inputs(torch, name, rows, device="cuda"):
    """(mcfg, trainable, frozen, optimizer, batch) of a step with the
    encoder in it: encoder preset ``name`` at full width with the training
    phase's decoder, weights from TRAIN_SEED, ``rows`` seeded pixel images
    and token ids on ``device``."""
    from mit_tpu_torch.data.dataset import to_device
    from mit_tpu_torch.models.decoder import DecoderConfig
    from mit_tpu_torch.models.model import (
        ModelConfig,
        init_model_params,
        split_trainable,
    )
    from mit_tpu_torch.models.vision import PRESETS
    from mit_tpu_torch.train.steps import make_optimizer

    tcfg = TrainConfig()
    mcfg = ModelConfig(name, PRESETS[name],
                       DecoderConfig(vocab_size=10000,
                                     dropout=tcfg.DECODER_DROPOUT), "cls")
    params = init_model_params(torch.Generator().manual_seed(TRAIN_SEED),
                               mcfg, device)
    trainable, frozen = split_trainable(params)
    rng = np.random.default_rng(TRAIN_SEED + 2)
    size = mcfg.vision.image_size
    toks = token_batch(rng, rows, mcfg.decoder.max_seq_len - 1,
                       mcfg.decoder.vocab_size, SpecialIds())
    batch = to_device({
        "images": rng.uniform(-1, 1, (rows, 3, size, size)).astype(np.float32),
        "decoder_input_tokens": toks[:, :-1], "target_tokens": toks[:, 1:]},
        device)
    return mcfg, trainable, frozen, make_optimizer(tcfg)[0], batch


def tp_int8(inputs):
    """``tp_inputs`` with the frozen encoder quantized to int8."""
    from mit_tpu_torch.models.vision import quantize_vision_params

    mcfg, trainable, frozen, optimizer, batch = inputs
    enc = quantize_vision_params(frozen["encoder"], mcfg.vision)
    return mcfg, trainable, {"encoder": enc}, optimizer, batch


def tp_run(torch, inputs, mesh, dtype, steps=MESH_STEPS):
    """``mesh_train`` from pixels on ``tp_inputs``, the counts set to 0
    just before it and read just after → (losses, seconds, counts, routes
    of multihead_attention)."""
    mcfg, trainable, frozen, optimizer, batch = inputs
    reset_counts()
    losses, secs = mesh_train(torch, mcfg, trainable, optimizer, batch,
                              mesh, dtype, steps, frozen=frozen)
    return losses, secs, read_counts(), dict(dispatchers()["attention"].routes)


def tp_encoder_rank(argv) -> int:
    """One rank of phase 5c (``--tp-encoder-rank RANK WORLD INIT OUT
    DEVICE``, every rank on DEVICE) at TP_SHAPE over gloo: the ViT-B
    model MESH_STEPS f32 and MESH_STEPS bf16 steps, one BLIP-384 f32 step
    and TP_INT8_STEPS f32 steps of the int8 arm, each with its counts from
    0 and the local shapes its attention kernels were called at; a JSON
    file of it all at OUT."""
    rank, world, init, out, device = (int(argv[0]), int(argv[1]), argv[2],
                                      argv[3], argv[4])
    import torch
    import torch.distributed as dist

    from mit_tpu_torch.ops import flash_attention as fa
    from mit_tpu_torch.parallel.mesh import init_distributed_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    shapes = {"btd": set(), "bhtd": set()}

    def recording(kind, forward):
        def call(q, *args, **kw):
            shapes[kind].add(tuple(q.shape))
            return forward(q, *args, **kw)
        return call

    # the wrappers look their forwards up by name at each call
    fa._flash_forward_btd = recording("btd", fa._flash_forward_btd)
    fa._flash_forward = recording("bhtd", fa._flash_forward)
    result = {}

    def run(key, inputs, dtype, steps=MESH_STEPS):
        for kind in shapes:
            shapes[kind].clear()
        losses, secs, counts, routes = tp_run(torch, inputs, mesh, dtype,
                                              steps)
        result[key] = {"losses": losses, "seconds": secs, "counts": counts,
                       "routes": routes,
                       **{k: sorted(v) for k, v in shapes.items()}}

    try:
        mesh = init_distributed_mesh(TP_SHAPE, device)
        result["coords"] = list(mesh.coords)
        vit = tp_inputs(torch, VIT_B, TRAIN_BATCH, device)
        run("float32", vit, torch.float32)
        run("bfloat16", vit, torch.bfloat16)
        run("int8", tp_int8(vit), torch.float32, TP_INT8_STEPS)
        del vit
        run("blip", tp_inputs(torch, BLIP, TP_BLIP_BATCH, device),
            torch.float32, 1)
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


def hold_tp_kernels(torch):
    """Rows 7 and 8 at the local shapes a rank of TP_SHAPE gives them:
    flash_attention_btd at (TRAIN_BATCH, 197, 768 / m), f32 and bf16, and
    flash_attention at (TP_BLIP_BATCH, 12 / m, 577, 64) f32, each against
    its plain version (TOL, BHTD_TOL), timed against it, with its bound and
    the library call → the results by row, with the local shapes."""
    from mit_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_btd,
        flash_attention_btd_reference,
        flash_attention_reference,
    )

    m = TP_SHAPE[1]
    out = {}
    b, t, d = TRAIN_BATCH // TP_SHAPE[0], 197, 768 // m
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype)[6:]
        q, k, v, _ = attention_inputs(torch, b, t, d, False, dtype)
        got = flash_attention_btd(q, k, v, None, False, 64)
        want = flash_attention_btd_reference(q, k, v, None, False, 64)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        print(f"tp kernel vs plain flash_attention_btd ({b}, {t}, {d}) "
              f"{dname} max_abs_err={err:.3e} limit={TOL[dname]:.0e}")
        if not (bool(torch.isfinite(got).all()) and err <= TOL[dname]):
            raise AssertionError(f"flash_attention_btd at the TP shape "
                                 f"disagrees: {dname}")
        runs = timed_turns(
            torch, lambda: flash_attention_btd(q, k, v, None, False, 64),
            lambda: flash_attention_btd_reference(q, k, v, None, False, 64))
        res = {}
        report(res, f"flash_attention_btd tp {dname}", err, runs,
               f"({b}, {t}, {d})", attention_bound(b, d // 64, t, t, dtype),
               sdpa_ms(torch, heads_view(q), heads_view(k), heads_view(v)),
               device_ms(torch,
                         lambda: flash_attention_btd(q, k, v, None, False,
                                                     64)))
        out[("flash_attention_btd", dname)] = {
            "local_shape": [b, t, d], **next(iter(res.values()))}
    b, h, t = TP_BLIP_BATCH // TP_SHAPE[0], 12 // m, 577
    q, k, v, _ = bhtd_inputs(torch, b, h, t, False, torch.float32)
    got = flash_attention(q, k, v, None, False)
    want = flash_attention_reference(q, k, v, None, False)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    print(f"tp kernel vs plain flash_attention ({b}, {h}, {t}, 64) float32 "
          f"max_abs_err={err:.3e} limit={BHTD_TOL['float32']:.0e}")
    if not (bool(torch.isfinite(got).all()) and err <= BHTD_TOL["float32"]):
        raise AssertionError("flash_attention at the TP shape disagrees")
    runs = timed_turns(torch, lambda: flash_attention(q, k, v, None, False),
                       lambda: flash_attention_reference(q, k, v, None, False))
    res = {}
    report(res, "flash_attention tp float32", err, runs,
           f"({b}, {h}, {t}, 64)", attention_bound(b, h, t, t, torch.float32),
           sdpa_ms(torch, q, k, v),
           device_ms(torch, lambda: flash_attention(q, k, v, None, False)))
    out[("flash_attention", "float32")] = {"local_shape": [b, h, t, 64],
                                           **res["flash_attention tp float32"]}
    return out


def check_tp_encoder(torch):
    """Phase 5c, the frozen encoder split over "model" in the train step
    (see the module docstring)."""
    import tempfile

    t_phase = time.perf_counter()
    kernels = hold_tp_kernels(torch)
    world = TP_SHAPE[0] * TP_SHAPE[1]
    with tempfile.TemporaryDirectory() as tmp:
        init, outs = os.path.join(tmp, "pg"), [os.path.join(tmp, f"r{r}.json")
                                               for r in range(world)]
        t0 = time.perf_counter()
        spawn_ranks([["--tp-encoder-rank", str(r), str(world), init, outs[r],
                      "cuda:0"] for r in range(world)], "tp encoder")
        spawn_s = time.perf_counter() - t0
        ranks = [json.load(open(o)) for o in outs]
    vit = tp_inputs(torch, VIT_B, TRAIN_BATCH)
    single = {str(dt)[6:]: tp_run(torch, vit, None, dt)
              for dt in (torch.float32, torch.bfloat16)}
    single["int8"] = tp_run(torch, tp_int8(vit), None, torch.float32,
                            TP_INT8_STEPS)
    del vit
    single["blip"] = tp_run(torch, tp_inputs(torch, BLIP, TP_BLIP_BATCH),
                            None, torch.float32, 1)
    m, steps = TP_SHAPE[1], MESH_STEPS
    btd_shape = [TRAIN_BATCH // TP_SHAPE[0], 197, 768 // m]
    bhtd_shape = [TP_BLIP_BATCH // TP_SHAPE[0], 12 // m, 577, 64]

    def want(counts, **launches):
        w = {k: 0 for k in counts}
        w.update(launches)
        return w

    def rel(got, ref):
        return max(abs(a - w) / abs(w) for a, w in zip(got, ref))

    for r, res in enumerate(ranks):
        where = f"tp encoder {TP_SHAPE} rank {r} at {tuple(res['coords'])}"
        f32, bf16 = res["float32"], res["bfloat16"]
        diff = rel(f32["losses"], single["float32"][0])
        falls = bf16["losses"][-1] < bf16["losses"][0]
        sps = (steps - 1) / bf16["seconds"]
        one_sps = (steps - 1) / single["bfloat16"][1]
        print(f"{where}: vit-b f32 losses {f32['losses']} against one rank "
              f"{single['float32'][0]}, largest relative difference "
              f"{diff:.3e} (limit {MESH_TOL:.0e}); bf16 losses "
              f"{bf16['losses']} (falls={falls}); launches per step "
              f"flash_attention_btd {bf16['counts']['flash_attention_btd'] / steps}"
              f" at local shapes {bf16['btd']}, dropout forward "
              f"{bf16['counts']['flash_attention_dropout'] / steps}, backward "
              f"{bf16['counts']['flash_attention_dropout_bwd'] / steps}; "
              f"attention routes {bf16['routes']}; bf16 {sps:.3f} steps/s "
              f"against one rank {one_sps:.3f} in this process ({MESH_LABEL}"
              f"; {DEVICE_LINE[0] if DEVICE_LINE else ''})")
        for run_ in (f32, bf16):
            expect = want(run_["counts"], flash_attention_btd=11 * steps,
                          flash_attention_dropout=6 * steps,
                          flash_attention_dropout_bwd=6 * steps)
            if run_["counts"] != expect or run_["btd"] != [btd_shape] \
                    or run_["bhtd"] or run_["routes"]["plain"]:
                raise AssertionError(f"{where}: launches {run_}")
        if not (diff <= MESH_TOL and falls):
            raise AssertionError(f"{where}: the split encoder's step "
                                 f"disagrees")
        blip = res["blip"]
        diff = rel(blip["losses"], single["blip"][0])
        print(f"{where}: blip-384 f32 B={TP_BLIP_BATCH} one step, loss "
              f"{blip['losses']} against one rank {single['blip'][0]} "
              f"(relative {diff:.3e}), flash_attention launches "
              f"{blip['counts']['flash_attention']} at local shapes "
              f"{blip['bhtd']}, flash_attention_btd "
              f"{blip['counts']['flash_attention_btd']}")
        expect = want(blip["counts"], flash_attention=11,
                      flash_attention_dropout=6,
                      flash_attention_dropout_bwd=6)
        if blip["counts"] != expect or blip["bhtd"] != [bhtd_shape] \
                or blip["btd"] or not diff <= MESH_TOL:
            raise AssertionError(f"{where}: BLIP-384 {blip}")
        int8 = res["int8"]
        diff = rel(int8["losses"], single["int8"][0])
        same = int8["counts"] == single["int8"][2]
        print(f"{where}: int8 arm f32 {TP_INT8_STEPS} steps, the encoder "
              f"whole on the rank: losses {int8['losses']} against one rank "
              f"{single['int8'][0]} (relative {diff:.3e}); launches "
              f"{ {k: v for k, v in int8['counts'].items() if v} } equal to "
              f"one rank's: {same}")
        if not (same and diff <= MESH_TOL and int8["btd"] == []
                and int8["counts"]["fused_int8_vit_layer"]
                == 11 * TP_INT8_STEPS):
            raise AssertionError(f"{where}: the int8 arm {int8}")
    print(f"tp encoder: the gloo spawn of {world} ranks took {spawn_s:.1f} s;"
          f" phase {time.perf_counter() - t_phase:.1f} s")
    launches = ranks[0]["bfloat16"]["counts"]["flash_attention_btd"]
    kernels[("flash_attention_btd", "bfloat16")]["launches_per_rank"] = \
        launches
    kernels[("flash_attention", "float32")]["launches_per_rank"] = \
        ranks[0]["blip"]["counts"]["flash_attention"]
    return {"kernels": kernels}


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
    "int8_mlp_fused": ("int8_mlp_fused.cu",
                       "mit_tpu/ops/pallas_int8_layer.py:297", "int8"),
    "fused_int8_mlp": ("int8_mlp_fused.cu",
                       "mit_tpu/ops/pallas_int8_mlp.py:88", "int8"),
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
                           "service"),
    "flash_attention": ("flash_attention_btd.cu",
                        "mit_tpu/ops/pallas_attention.py:86", "blip384"),
}


# the wide-head lines of phase 3 that phase 4c's path runs: line label ->
# (phase 4c's counts, the counter)
WIDE_PATH = {
    "flash_attention_btd (64, 257, 1280) hd 80 bfloat16": (
        "vit_h_float", "flash_attention_btd"),
    "flash_attention_btd_fusedqkv (64, 257, 3840) hd 80 bfloat16 layer "
    "numerics": ("vit_h_int8", "flash_attention_btd_fusedqkv"),
    "fused_int8_vit_layer (64, 257, 1280) F 5120 16 heads bf16": (
        "vit_h_int8", "fused_int8_vit_layer"),
}


def wide_lines(wide, counts):
    """Phase 3's wide-head lines as kernel entries (source and TPU kernel
    as KERNELS has them for the wrapper); those that phase 4c's path runs
    carry its launches and "path", the rest 0 launches."""
    out = []
    for label, line in wide.items():
        source, replaces, _ = KERNELS[label.split(" ")[0]]
        path, counter = WIDE_PATH.get(label, (None, None))
        out.append({"name": label, "route": "cuda",
                    "source": f"mit_tpu_torch/csrc/{source}",
                    "replaces": replaces, "path": path,
                    "launches": counts[path][counter] if path else 0,
                    **line})
    return out


def check_int8_paths(torch, device="cuda"):
    """Phases 4b and 4c's int8 arms alone (`--int8-mlp`): CLIP ViT-L/14 and
    ViT-H/14 at their published widths from checkpoints written in the run
    (seeded weights), seeded uint8 64 x 480 x 640 through
    device_preprocess, the int8 arm at bf16 batch 64: launches per encode
    held, its memory within FLOOR_FACTOR times the plain int8 path's own
    move under one bf16 ulp of the pixels, then int8_mlp_turns. Returns the
    counts of each path."""
    import tempfile

    from mit_tpu_torch.data.preprocess import device_preprocess
    from mit_tpu_torch.decode.api import Captioner
    from mit_tpu_torch.models.vision import PRESETS

    ids, counts = SpecialIds(), {}
    u8 = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (PRETRAINED_BATCH, *UINT8_HW, 3), dtype=np.uint8)).to(device)
    clip, vit_h = PRESETS[CLIP_L], vit_h_config()
    towers = [
        ("clip_l", CLIP_L, clip, "vision_model.",
         {"model_type": "clip", "projection_dim": 768,
          "vision_config": hf_vision_config(clip, "clip_vision_model")}),
        ("vit_h", VIT_H, vit_h, "", hf_vision_config(vit_h, "vit")),
    ]
    for key, name, vcfg, prefix, config in towers:
        with tempfile.TemporaryDirectory() as root:
            path, seeded, *_ = write_tower(torch, root, key, vcfg, prefix,
                                           "model.safetensors", config)
            mcfg, params, _ = boot(torch, path, name, seeded, vcfg, device)
            del seeded
        px = device_preprocess(u8, name)
        full = vcfg.num_layers - 1
        cap = Captioner(params, mcfg, ids, torch.bfloat16,
                        encoder_quant="int8")
        plain = Captioner(params, mcfg, ids, torch.bfloat16,
                          use_kernel=False, encoder_quant="int8")
        cap.memory_from_pixels(px)                              # warm-up
        torch.cuda.synchronize()
        reset_counts()
        mem = cap.memory_from_pixels(px)
        torch.cuda.synchronize()
        counts[f"{key}_int8"] = read_counts()
        hold_launches(f"{key} bf16 B={PRETRAINED_BATCH} int8 encode",
                      counts[f"{key}_int8"],
                      encode_launches(vcfg, PRETRAINED_BATCH, 257)["int8"])
        hold_routes(f"{key} bf16 int8", attention=0,
                    decode={"fused": 0, "unfused": 0})
        mem_p = plain.memory_from_pixels(px)
        floor = rel_l2(plain.memory_from_pixels(bf16_ulp_up(torch, px)), mem_p)
        rel = rel_l2(mem, mem_p)
        print(f"{key} int8 bf16 B={PRETRAINED_BATCH}: memory kernel vs plain "
              f"relative L2 {rel:.3e} (limit {FLOOR_FACTOR} x {floor:.3e}, "
              f"the plain path's move under one bf16 ulp of the pixels)")
        if not (0 < floor and rel <= FLOOR_FACTOR * floor
                and bool(torch.isfinite(mem).all())):
            raise AssertionError(f"{key} int8 bf16: the kernel path disagrees")
        del plain, mem_p
        int8_mlp_turns(torch, key.replace("_", "-"), cap, px, full)
        del cap, params
    return counts


def mlp_lines(int8, counts):
    """Phase 3's fused-MLP lines other than the ViT-B path's as kernel
    entries: (those whose shape a path runs on the kernel, with that path's
    launches; those the port's rule keeps off every path, with 0). A line
    whose path launched no fused MLP fails."""
    source, replaces, _ = KERNELS["int8_mlp_fused"]
    on, off = [], []
    for label, line in int8.items():
        if not label.startswith("int8_mlp_fused ("):
            continue
        path = line.get("path")
        launches = counts[path]["int8_mlp_fused"] if path else 0
        entry = {"name": label, "route": "cuda",
                 "source": f"mit_tpu_torch/csrc/{source}",
                 "replaces": replaces, "launches": launches,
                 **{k: v for k, v in line.items() if k != "path"}}
        if path is None:
            off.append(entry)
        elif launches == 0:
            raise AssertionError(f"{label} was not launched on its path")
        else:
            on.append(entry)
    return on, off


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(sys.argv[2:])
    if sys.argv[1:2] == ["--mesh-nccl"]:
        return mesh_nccl(sys.argv[2:])
    if sys.argv[1:2] == ["--tp-encoder-rank"]:
        return tp_encoder_rank(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    print("== 1 device", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    DEVICE_LINE.append(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== 2 build", flush=True)
    from mit_tpu_torch import kernels

    kernels.lib()
    built = kernels.lib.built
    print(f"build {built['seconds']:.2f} s (nvcc {built['nvcc']}), "
          f"loaded in {kernels.lib.load_seconds:.2f} s: "
          f"{kernels.library_path().name}")
    log = kernels.library_path().with_name(kernels.library_path().name + ".log")
    if log.exists():
        print(log.read_text().strip())
    if sys.argv[1:] == ["--trace-train"]:
        trace_only(torch)
        return 0
    if sys.argv[1:] == ["--cell-map"]:
        check_cell_map(torch)
        return 0
    if sys.argv[1:] == ["--tp-encoder"]:
        check_tp_encoder(torch)
        return 0
    if sys.argv[1:] == ["--int8-mlp"]:
        int8 = check_int8_kernels(torch)
        on, off = mlp_lines(int8, check_int8_paths(torch))
        print(json.dumps({"int8_mlp_kernels": on, "off_path": off}))
        return 0
    if sys.argv[1:] == ["--moe"]:
        moe_kernels = check_moe_kernel(torch)
        moe_kernels["kimi_vl_path"] = check_kimi_vl_path(torch)
        print(json.dumps({"moe_kernels": moe_kernels}))
        return 0
    if sys.argv[1:] == ["--wide-heads"]:
        print(json.dumps({"wide_head_kernels": wide_lines(
            check_wide_heads(torch), check_vit_h(torch)["counts"])}))
        return 0

    print("== 3 kernels", flush=True)
    errors, times = check_kernels(torch)
    check_bf16_design(torch)
    int8 = check_int8_kernels(torch)
    dropout = check_dropout_kernels(torch)
    decode_layer = check_decode_layer_kernel(torch)
    bhtd = check_bhtd_kernel(torch)
    any_shape = check_any_shape_kernels(torch)
    wide = check_wide_heads(torch)
    moe_kernels = check_moe_kernel(torch)
    moe_kernels["kimi_vl_path"] = check_kimi_vl_path(torch)

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
    service = check_service(torch)
    slice_["counts"]["service"] = service["counts"]
    print(f"service captions/s bf16 {SERVICE_SLOTS} slots (encoder "
          "included): " + ", ".join(f"{k} {v:.2f}"
                                    for k, v in service["rates"].items())
          + f"; {smi}")
    slice_["counts"]["blip384"] = check_blip(torch)

    print("== 4b pretrained", flush=True)
    pretrained = check_pretrained(torch)
    slice_["counts"].update(pretrained["counts"])
    print(f"pretrained clip-l bf16 B={PRETRAINED_BATCH}: median encoder ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in pretrained["enc_ms"].items())
          + "; uint8 to caption captions/s "
          + ", ".join(f"{k} {v:.2f}" for k, v in pretrained["rates"].items())
          + f"; device_preprocess {pretrained['preprocess_ms']:.4f} ms; {smi}")

    print("== 4c vit-h", flush=True)
    vit_h = check_vit_h(torch)
    slice_["counts"].update(vit_h["counts"])
    print(f"pretrained vit-h bf16 B={PRETRAINED_BATCH}: median encoder ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in vit_h["enc_ms"].items())
          + "; uint8 to caption captions/s "
          + ", ".join(f"{k} {v:.2f}" for k, v in vit_h["rates"].items())
          + f"; {smi}")

    print("== 5 train", flush=True)
    train = check_training(torch)
    slice_["counts"]["train"] = train["counts"]
    print(f"training bf16 B={TRAIN_BATCH}: fused dropout "
          f"{train['rates']['fused']:.3f} steps/s, plain dropout "
          f"{train['rates']['plain']:.3f} steps/s (medians)")
    remat = train["remat"]
    print(f"training remat bf16 B={TRAIN_BATCH} fused dropout: "
          f"{remat['remat']['steps_per_s']:.3f} steps/s and "
          f"{remat['remat']['peak_bytes'] / 2**20:.1f} MiB peak, without "
          f"remat {remat['no_remat']['steps_per_s']:.3f} steps/s and "
          f"{remat['no_remat']['peak_bytes'] / 2**20:.1f} MiB; f32 identity "
          f"bitwise={remat['bitwise']}, largest relative difference "
          f"{remat['max_rel']:.3e}; {smi}")

    print("== 5b mesh", flush=True)
    mesh = check_mesh(torch)
    slice_["counts"]["service_mesh"] = mesh["service"]["counts"]
    for name in ("flash_attention_dropout", "flash_attention_dropout_bwd"):
        dropout[name]["mesh_launches_per_rank"] = mesh["counts"][name]
    cell_map = mesh["times"]
    for name, kind in (("flash_attention_dropout", "fwd"),
                       ("flash_attention_dropout_bwd", "bwd")):
        dropout[name]["cell_map_ms"] = {
            "trusted": cell_map["trusted"],
            **{label: {key: v[f"{kind}_{key}"] for key in ("ms", "spread")}
               for label, v in cell_map["cases"].items()}}

    print("== 5c tp encoder", flush=True)
    tp = check_tp_encoder(torch)
    results_tp = {}
    for (name, dname), line in tp["kernels"].items():
        if name == "flash_attention_btd" and dname != "bfloat16":
            continue
        tp_line = {k: line[k] for k in (
            "local_shape", "launches_per_rank", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}
        tp_line["dtype"] = dname
        results_tp[name] = tp_line

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "mit_tpu"))
    if loaded:
        raise AssertionError(f"the smoke imported JAX-side modules: {loaded}")

    print(f"smoke wall time before the result: "
          f"{time.perf_counter() - t_start:.1f} s")
    print("== 6 result", flush=True)
    btd = times["bfloat16"]
    results = dict(int8, **dropout, **decode_layer, **bhtd, flash_attention_btd={
        "max_abs_err": errors[("encoder", "bfloat16")],
        "ms": btd["kernel"], "plain_ms": btd["plain"],
        "bound_ms": btd["bound_ms"], "bound_by": btd["bound_by"],
        "library_ms": btd["library_ms"],
        **{key: btd[key] for key in ("device_ms", "library_device_ms")
           if btd[key] is not None},
    })
    lines, off_path = [], []
    for name, (source, replaces, path) in KERNELS.items():
        launches = slice_["counts"][path][name]
        line = {"name": name, "route": "cuda",
                "source": f"mit_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                **results[name],
                **({"tp": results_tp[name]} if name in results_tp else {})}
        if launches == 0:
            raise AssertionError(f"{name} was not launched on its path")
        lines.append(line)
    # the fused MLP half at CLIP-L's and ViT-H's widths (phases 4b, 4c)
    on, off = mlp_lines(int8, slice_["counts"])
    lines += on
    off_path += off
    # the wide heads' instantiations on the ViT-H/14 path (phase 4c)
    wide_path = wide_lines(wide, vit_h["counts"])
    for line in wide_path:
        if line.get("path") is None:
            continue
        if line["launches"] == 0:
            raise AssertionError(f"{line['name']} was not launched on its path")
        lines.append({k: v for k, v in line.items() if k != "path"})
    # beside the kernels of the paths: the any-shape kernels, which the
    # default models' geometries never reach, and every wide-head line
    print(json.dumps({"wide_head_kernels": wide_path}))
    print(json.dumps({"off_path_kernels": off_path}))
    # the grouped expert kernel runs on the kimi_vl path, which the slice
    # does not drive: its lines stand apart
    print(json.dumps({"moe_kernels": moe_kernels}))
    print(json.dumps({"any_shape_kernels": [
        {"name": name, "route": "cuda",
         "source": "mit_tpu_torch/csrc/attention_any_shape.cu", **line}
        for name, line in any_shape.items()]}))
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
