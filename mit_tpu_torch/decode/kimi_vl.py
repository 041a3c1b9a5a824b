"""The captioner over Kimi-VL-A3B's language model (``language_model``
"kimi_vl"): what ``Captioner`` becomes when its ``ModelConfig`` names the
family. The vision tower runs as for the other family, in "full" memory;
:func:`~mit_tpu_torch.models.kimi_vl.project_patches` turns its patches
into image tokens, and
:func:`~mit_tpu_torch.models.kimi_vl.greedy_generate_vlm` prefills
``[image tokens; prompt]`` and decodes greedily through the latent cache
(on the card the steps of the first shape replay from one CUDA graph,
:class:`~mit_tpu_torch.models.kimi_vl.DecodeSteps`). Beam search,
sampling, the service, the int8 encoder and training are not implemented
for this family and raise.

Parameters: ``{"encoder": vision tree, "projector": ..., "lm": ...}``
(:func:`~mit_tpu_torch.models.kimi_vl.param_shapes`), the language side in
its compute dtype on the card.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from mit_tpu_torch.data.preprocess import HostPreprocessor
from mit_tpu_torch.decode.api import Captioner
from mit_tpu_torch.models.kimi_vl import (
    DecodeSteps,
    greedy_generate_vlm,
    prepare,
    project_patches,
)
from mit_tpu_torch.models.vision import vision_forward
from mit_tpu_torch.ops import moe
from mit_tpu_torch.utils.profiling import span

UNSUPPORTED = ("the kimi_vl language model decodes greedily only: beam "
               "search, sampling, the caption service, the int8 encoder and "
               "training are not implemented for it")


class KimiVLCaptioner(Captioner):
    """``Captioner`` for ``language_model="kimi_vl"``, built with
    ``Captioner``'s arguments. ``compute_dtype`` is the encoder's; the
    language side runs in its weights' dtype. ``fused_layers``,
    ``fused_decode`` and ``beam_size`` serve the other family's paths and
    are not read here."""

    def __init__(self, params: dict, mcfg, tokenizer,
                 compute_dtype=torch.bfloat16, use_kernel: bool = True,
                 encoder_quant: str = "none", fused_layers: bool = True,
                 fused_decode: bool = False, beam_size: int = 3):
        if encoder_quant != "none":
            raise NotImplementedError(UNSUPPORTED)
        if mcfg.memory_mode != "full":
            raise ValueError("the kimi_vl language model reads the full "
                             "patch memory (memory_mode='full')")
        self.params = params
        self.mcfg = mcfg
        self.tokenizer = tokenizer
        self.compute_dtype = compute_dtype
        self.use_kernel = use_kernel
        self.device = params["lm"]["embed"].device
        self.prepared = prepare(params["lm"], mcfg.decoder)
        # the decode steps: one CUDA graph, for the first shape on the card
        self.steps = DecodeSteps()
        self.preprocessor = HostPreprocessor(
            mcfg.encoder_name, image_size=mcfg.vision.image_size)

    @torch.inference_mode()
    def memory_from_pixels(self, pixels: torch.Tensor) -> torch.Tensor:
        """Preprocessed NCHW f32 pixels → image tokens (B, N / 4, D): the
        vision tower's last hidden state through the projector."""
        with span("mit.encode"):
            pixels = pixels.to(device=self.device, dtype=torch.float32)
            feats = vision_forward(self.params["encoder"], self.mcfg.vision,
                                   pixels, self.compute_dtype,
                                   self.use_kernel)
            return project_patches(self.params["projector"],
                                   self.mcfg.decoder, feats)

    @torch.inference_mode()
    def generate_from_memory(self, memory: torch.Tensor,
                             prompt_ids=None, max_new_tokens: int = 32,
                             method: str = "greedy",
                             end_token_id: Optional[int] = None,
                             **unsupported) -> List[List[int]]:
        """Image tokens (B, P, D) → each row's generated ids after
        ``[image tokens; prompt_ids]`` (a (T,) prompt for every row, or
        (B, T)), up to and including END (``end_token_id``, default the
        tokenizer's; a negative id never ends a row), at most
        ``max_new_tokens``."""
        if method != "greedy" or unsupported:
            raise NotImplementedError(UNSUPPORTED)
        with span("mit.decode"):
            end_id = (self.tokenizer.end_id if end_token_id is None
                      else end_token_id)
            if prompt_ids is None:
                prompt_ids = [self.tokenizer.start_id]
            prompt = torch.as_tensor(prompt_ids, dtype=torch.int64)
            out = greedy_generate_vlm(
                self.params["lm"], self.mcfg.decoder, self.prepared, memory,
                prompt, max_new_tokens, end_id, self.steps)
            with span("mit.decode.readback"):
                rows = out.cpu().tolist()
                moe.flush_counters()
            return [[t for t in r if t >= 0] for r in rows]

    def generate_batch(self, images, prompt_ids=None,
                       max_new_tokens: int = 32, method: str = "greedy",
                       end_token_id: Optional[int] = None, **unsupported):
        return self.generate_from_memory(
            self.memory_from_images(images), prompt_ids, max_new_tokens,
            method, end_token_id, **unsupported)

    def caption_batch(self, images, method: str = "greedy",
                      max_len: Optional[int] = None,
                      beam_size: Optional[int] = None) -> List[str]:
        if method != "greedy" or beam_size is not None:
            raise NotImplementedError(UNSUPPORTED)
        ids = self.generate_batch(images, max_new_tokens=max_len or 32)
        return [self.postprocess(s) for s in ids]
