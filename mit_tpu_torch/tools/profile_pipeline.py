"""Trace the int8 serving pipeline once, uint8 images to greedy tokens (port
of the JAX package's ``scripts/profile_pipeline.py``).

    python -m mit_tpu_torch.tools.profile_pipeline [logdir] [--batch N]
        [--encoder DIR_OR_FILE] [--device cuda|cpu]

Builds the default model (the config's encoder and 6 x 512 decoder, vocab
10000) with seeded random weights, or over the pretrained encoder that
``--encoder`` names (a local HF-layout directory or weights file; nothing is
downloaded), quantizes the encoder to int8, and runs in bf16
``device_preprocess`` → the encoder → the projection → ``greedy_generate``
on seeded 224 x 224 uint8 images: once to warm up, once under
``torch.profiler``. Prints the traced pass's ``StepTimer`` summary and
where the Chrome trace landed (open it in Perfetto): the card's kernels
under the program's own ``mit.*`` spans (``utils.profiling.span``:
``mit.preprocess``, ``mit.decode.loop``, ``mit.decode.step``, ...). Runs
on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile

import numpy as np
import torch

from mit_tpu_torch.config import Config
from mit_tpu_torch.data.preprocess import device_preprocess
from mit_tpu_torch.decode.greedy import greedy_generate
from mit_tpu_torch.models.model import (
    ModelConfig,
    encode_images,
    init_model_params,
    init_model_params_pretrained,
    project_features,
)
from mit_tpu_torch.models.vision import quantize_vision_params
from mit_tpu_torch.utils.profiling import StepTimer, fence, trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("logdir", nargs="?",
                    default=os.path.join(tempfile.gettempdir(), "mit_profile"))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--encoder", default=None,
                    help="a local pretrained encoder (directory or file)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_pipeline: CUDA is not available (--device cpu runs "
              "on the CPU)", file=sys.stderr)
        return 1
    dev = torch.device(args.device)

    cfg = Config()
    gen = torch.Generator().manual_seed(0)
    if args.encoder:
        mcfg, params = init_model_params_pretrained(
            gen, cfg, vocab_size=10000, name_or_path=args.encoder,
            local_files_only=True, device=dev)
    else:
        mcfg = ModelConfig.build(cfg, vocab_size=10000)
        params = init_model_params(gen, mcfg, dev)
    params["encoder"] = quantize_vision_params(params["encoder"], mcfg.vision)
    cd = torch.bfloat16
    vis = mcfg.vision

    @torch.inference_mode()
    def pipeline(u8):
        # the family picks the resize recipe, the tower its input size
        px = device_preprocess(u8, vis.family, vis.image_size)
        mem = project_features(params, mcfg, encode_images(params, mcfg, px, cd),
                               cd)
        tokens, _ = greedy_generate(params["decoder"], mcfg.decoder, mem, 2, 3,
                                    0, mcfg.decoder.max_seq_len,
                                    compute_dtype=cd)
        return tokens

    rng = np.random.default_rng(0)
    u8 = torch.from_numpy(
        rng.integers(0, 255, (args.batch, 224, 224, 3), dtype=np.uint8)).to(dev)
    fence(pipeline(u8))                  # first calls outside the trace

    timer = StepTimer()
    with trace(args.logdir):
        with timer.step(args.batch):
            fence(pipeline(u8))

    files = sorted(glob.glob(os.path.join(args.logdir, "*.pt.trace.json")),
                   key=os.path.getmtime)
    print(f"traced pass on {args.device}: {timer.summary()}")
    if files:
        print(f"trace written: {files[-1]}")
        return 0
    print(f"ERROR: no trace under {args.logdir}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
