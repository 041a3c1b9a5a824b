"""Where a block of the fused int8 MLP kernel spends its time, phase by
phase (``csrc/int8_mlp_fused.cu`` built with ``-DMIT_MLP_PROFILE``).

    python -m mit_tpu_torch.tools.mlp_phases [--batch 64]
    python -m mit_tpu_torch.tools.mlp_phases --sweep 1 2 4 8 16 32 64

Needs a CUDA card and nvcc. Builds the kernel's source alone, with its
phase stamps compiled in, into ``mit_tpu_torch/_build/``, and runs it at
each (D, F) it is built for on seeded weights and rows: the layer's form
(an f32 stream, LN2, the residual, f32 out) at ``batch`` x 197 rows for
ViT-B's width and ``batch`` x 257 for CLIP-L's and ViT-H's. After three
warm-up launches it times one launch with CUDA events and prints, for that
launch, the mean over blocks of each phase boundary's time since the
block's start (and its 10th and 90th percentiles), the ns a block spent
in some waits of fc2, and the card's name and power limit. The stamps
cost a few global stores a phase, so the launch is a little slower than
the default build's.

``--sweep B ...`` instead times the MLP half of the default library at each
width and each batch B (rows B x T): the fused kernel against the
composition (quantize_rows, int8_gemm, quantize_rows, int8_gemm) in turns
(fused, composition, composition, fused; CUDA events, 20 calls each).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from mit_tpu_torch import kernels
from mit_tpu_torch.ops.quant import QuantizedLinear, quantize_weight

WIDTHS = ((768, 3072, 197), (1024, 4096, 257), (1280, 5120, 257))
SLOTS = 16                    # int8_mlp_fused.cu PROF_SLOTS
# slot -> what its stamp marks (times since slot 0, the block's start)
PHASES = {1: "cluster barrier passed", 2: "own rows pushed",
          3: "every row in H8", 4: "fc1 done", 5: "row maxima pushed",
          6: "every block's maxima in", 7: "HID written",
          8: "fc2 done, sums pushed", 9: "y written",
          13: "producer: fc1 tiles issued", 14: "producer: all tiles issued"}
# slot -> the wait whose ns it sums
WAITS = {11: "fc2 waits for weight tiles", 10: "fc2 staging writes",
         15: "fc2 waits for the last push's read", 12: "fc2 final drain"}


def build() -> ctypes.CDLL:
    out = kernels.BUILD_DIR / "libmit_int8_mlp_phases.so"
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-DMIT_MLP_PROFILE",
           "-shared", "-o", str(out),
           str(kernels.CSRC / "int8_mlp_fused.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.mit_int8_mlp_fused.argtypes = kernels.ENTRY_POINTS["mit_int8_mlp_fused"]
    lib.mit_int8_mlp_fused_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def qlinear(k, n, seed) -> QuantizedLinear:
    g = torch.Generator().manual_seed(seed)
    q = quantize_weight(torch.randn(k, n, generator=g) * 0.02,
                        torch.randn(n, generator=g) * 0.02)
    return QuantizedLinear(*(a.cuda() for a in q))


def run(lib, d, f, m) -> None:
    q1, q2 = qlinear(d, f, 1), qlinear(f, d, 2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(m, d, device="cuda", generator=gen)
    ln_s, ln_b = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.mit_int8_mlp_fused(
            x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), q1.w8.data_ptr(),
            q1.scale.data_ptr(), q1.bias.data_ptr(), q2.w8.data_ptr(),
            q2.scale.data_ptr(), q2.bias.data_ptr(), y.data_ptr(), m, d, f,
            0, 1, 1, 0, 1e-6, stream)
        kernels.check(rc, "mit_int8_mlp_fused")

    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    kernels.check(lib.mit_int8_mlp_fused_profile_clear(),
                  "mit_int8_mlp_fused_profile_clear")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    blocks = (m + 63) // 64 * 8
    buf = np.zeros(blocks * SLOTS, np.uint64)
    kernels.check(lib.mit_int8_mlp_fused_profile(buf.ctypes.data, buf.size),
                  "mit_int8_mlp_fused_profile")
    t = buf.reshape(blocks, SLOTS).astype(np.int64)
    print(f"D={d} F={f} M={m}: one launch {start.elapsed_time(end):.4f} ms, "
          f"{blocks} blocks")
    for slot, what in PHASES.items():
        us = (t[:, slot] - t[:, 0]) / 1e3
        print(f"  {what:30s} {us.mean():8.2f} us after the block's start "
              f"(p10 {np.quantile(us, 0.1):.2f}, p90 "
              f"{np.quantile(us, 0.9):.2f})")
    print("  a block's waits: " + ", ".join(
        f"{what} {t[:, slot].mean() / 1e3:.2f} us"
        for slot, what in WAITS.items()))


def ms(fn, iters=20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sweep(batches) -> None:
    from mit_tpu_torch.ops import int8_mlp

    for d, f, t in WIDTHS:
        q1, q2 = qlinear(d, f, 1), qlinear(f, d, 2)
        ln = {"scale": torch.ones(d, device="cuda"),
              "bias": torch.zeros(d, device="cuda")}
        for b in batches:
            gen = torch.Generator(device="cuda").manual_seed(b)
            x = torch.randn(b * t, d, device="cuda", generator=gen)
            args = (x, q1, q2, "gelu", ln, 1e-6, True, torch.bfloat16)
            runs = {"fused": [], "composition": []}
            for route in ("fused", "composition", "composition", "fused"):
                fn = (lambda: int8_mlp.int8_mlp_fused(*args)) \
                    if route == "fused" else (lambda: int8_mlp._mlp_half(
                        *args, int8_mlp.quantize_rows, int8_mlp._gemm_any_k))
                runs[route].append(ms(fn))
            print(f"D={d} F={f} batch {b} ({b * t} rows): fused "
                  f"{[round(v, 4) for v in runs['fused']]} ms, composition "
                  f"{[round(v, 4) for v in runs['composition']]} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--sweep", type=int, nargs="+", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mlp_phases: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(smi)
    if args.sweep:
        sweep(args.sweep)
        return 0
    lib = build()
    for d, f, t in WIDTHS:
        run(lib, d, f, args.batch * t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
