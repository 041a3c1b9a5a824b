"""High-level captioning API (port of ``mit_tpu/decode/api.py``, greedy).

``Captioner`` encodes a batch of images to decoder memory and decodes
captions with the KV-cached greedy loop; ``postprocess`` is the reference's
text clean-up (cut at the first END, strip START, decode with specials kept,
drop UNK, collapse whitespace). Beam search and sampling are not ported yet
and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from mit_tpu_torch.data.preprocess import HostPreprocessor
from mit_tpu_torch.decode.greedy import greedy_generate
from mit_tpu_torch.models.model import ModelConfig, encode_images, project_features

DECODE_NOT_PORTED = (
    "only greedy decoding is ported; beam search and sampling are not yet: "
    "ROADMAP.md, queue 1, beam, sampling and the service"
)


class Captioner:
    """Holds parameters (on their device), the model config and a
    tokenizer. The tokenizer needs ``pad_id``, ``start_id``, ``end_id`` for
    decoding, and ``decode`` and ``unk_token`` for :meth:`postprocess`.

    ``use_kernel=False`` runs the encoder's attention through the plain
    PyTorch path instead of ``flash_attention_btd``, for comparison.
    """

    def __init__(
        self,
        params: dict,
        mcfg: ModelConfig,
        tokenizer,
        compute_dtype=torch.float32,
        use_kernel: bool = True,
    ):
        self.params = params
        self.mcfg = mcfg
        self.tokenizer = tokenizer
        self.compute_dtype = compute_dtype
        self.use_kernel = use_kernel
        self.device = params["decoder"]["token_embedding"].device
        self.preprocessor = HostPreprocessor(
            mcfg.encoder_name, image_size=mcfg.vision.image_size
        )

    # ------------------------------------------------------------------
    def memory_from_images(self, images: Sequence) -> torch.Tensor:
        """PIL images → decoder memory (B, S, D)."""
        pixels = np.stack([self.preprocessor(im) for im in images])
        return self.memory_from_pixels(torch.from_numpy(pixels))

    @torch.inference_mode()
    def memory_from_pixels(self, pixels: torch.Tensor) -> torch.Tensor:
        """Preprocessed NCHW f32 pixel batch → decoder memory (B, S, D)."""
        pixels = pixels.to(device=self.device, dtype=torch.float32)
        feats = encode_images(self.params, self.mcfg, pixels,
                              self.compute_dtype, self.use_kernel)
        return project_features(self.params, self.mcfg, feats,
                                self.compute_dtype)

    # ------------------------------------------------------------------
    def generate(self, image, start_token_id: Optional[int] = None,
                 end_token_id: Optional[int] = None, max_len: int = 100,
                 method: str = "greedy") -> List[int]:
        """One image → token ids incl. START and (if produced) END."""
        return self.generate_batch(
            [image], start_token_id, end_token_id, max_len, method
        )[0]

    def generate_batch(self, images: Sequence,
                       start_token_id: Optional[int] = None,
                       end_token_id: Optional[int] = None, max_len: int = 100,
                       method: str = "greedy") -> List[List[int]]:
        return self.generate_from_memory(
            self.memory_from_images(images), start_token_id, end_token_id,
            max_len, method,
        )

    def generate_from_memory(
        self,
        memory: torch.Tensor,
        start_token_id: Optional[int] = None,
        end_token_id: Optional[int] = None,
        max_len: int = 100,
        method: str = "greedy",
    ) -> List[List[int]]:
        if method in ("beam", "sample"):
            raise NotImplementedError(DECODE_NOT_PORTED)
        if method != "greedy":
            raise ValueError(
                f"Unsupported generation method: {method}. "
                "Choose 'greedy', 'beam' or 'sample'."
            )
        tok = self.tokenizer
        start_id = tok.start_id if start_token_id is None else start_token_id
        end_id = tok.end_id if end_token_id is None else end_token_id
        # the decoder's positional table caps generation length
        max_len = min(max_len, self.mcfg.decoder.max_seq_len)
        tokens, lengths = greedy_generate(
            self.params["decoder"], self.mcfg.decoder, memory, start_id,
            end_id, tok.pad_id, max_len, compute_dtype=self.compute_dtype,
        )
        tokens = tokens.cpu().numpy()
        lengths = lengths.cpu().numpy()
        return [tokens[i, : lengths[i]].tolist() for i in range(tokens.shape[0])]

    # ------------------------------------------------------------------
    def postprocess(self, generated_ids: List[int]) -> str:
        """The reference's post-processing (its inference.py:96-126)."""
        tok = self.tokenizer
        ids = list(generated_ids)
        if tok.end_id in ids:
            ids = ids[: ids.index(tok.end_id)]
        if ids and ids[0] == tok.start_id:
            ids = ids[1:]
        text = tok.decode(ids, skip_special_tokens=False)
        text = text.replace(tok.unk_token, "").strip()
        return " ".join(text.split())

    def caption(self, image, method: str = "greedy",
                max_len: Optional[int] = None) -> str:
        return self.caption_batch([image], method, max_len)[0]

    def caption_batch(self, images: Sequence, method: str = "greedy",
                      max_len: Optional[int] = None) -> List[str]:
        ids = self.generate_batch(
            images, max_len=max_len or self.mcfg.decoder.max_seq_len,
            method=method,
        )
        return [self.postprocess(s) for s in ids]


def load_captioner(checkpoint_path: str, cfg, compute_dtype=torch.float32,
                   device="cuda") -> Captioner:
    """Captioner from a reference-layout safetensors checkpoint and the
    tokenizer files of ``cfg`` (a ``mit_tpu.config.Config``): tokenizer →
    model config with the actual vocab size → weights onto ``device``."""
    from mit_tpu.text.tokenizer import get_tokenizer
    from mit_tpu_torch.train.checkpoint import load_safetensors

    tokenizer = get_tokenizer(cfg, force_reload=True)
    cfg = cfg.with_tokenizer_ids(tokenizer)
    mcfg = ModelConfig.build(cfg, vocab_size=tokenizer.get_vocab_size())
    params = load_safetensors(checkpoint_path, mcfg, device)
    return Captioner(params, mcfg, tokenizer, compute_dtype)
