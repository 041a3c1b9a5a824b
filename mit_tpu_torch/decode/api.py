"""High-level captioning API (port of ``mit_tpu/decode/api.py``).

``Captioner`` encodes a batch of images to decoder memory (the CLS token
or, in ``memory_mode="full"``, the whole sequence) and decodes
captions with the KV-cached loops: ``method`` "greedy", "beam" (real beam
search, ``beam_size`` beams) or "sample" (temperature, top-k, top-p, drawn
from a ``torch.Generator``). ``postprocess`` is the reference's text
clean-up (cut at the first END, strip START, decode with specials kept,
drop UNK, collapse whitespace). ``load_captioner`` builds one from a
reference-layout checkpoint, ``pretrained_captioner`` over a pretrained
encoder held in local HF files.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from mit_tpu_torch.data.preprocess import HostPreprocessor
from mit_tpu_torch.decode.beam import beam_generate
from mit_tpu_torch.decode.greedy import greedy_generate
from mit_tpu_torch.decode.sampling import sample_generate
from mit_tpu_torch.models.model import (
    ModelConfig,
    encode_images,
    init_model_params_pretrained,
    project_features,
)
from mit_tpu_torch.models.vision import quantize_vision_params
from mit_tpu_torch.utils.profiling import span

class Captioner:
    """Holds parameters (on their device), the model config and a
    tokenizer. The tokenizer needs ``pad_id``, ``start_id``, ``end_id`` for
    decoding, and ``decode`` and ``unk_token`` for :meth:`postprocess`.

    ``use_kernel=False`` runs the encoder's kernels' plain PyTorch versions
    instead, for comparison.

    ``encoder_quant``: "none" keeps the float encoder; "int8" quantizes the
    frozen encoder's GEMMs to int8 (W8A8) once, here at load; "int8_defect"
    is the quality gate's negative control, int8 with every layer's fc2
    scale doubled, never to be served. ``fused_layers`` picks the int8
    encoder's form (``vision_forward_int8``).

    ``fused_decode`` runs every decode step's layers in the fused
    decode-layer kernel (``decoder_step(fused=True)``), under every method.
    It is off by default, as ``MIT_FUSED_DECODE`` is in the JAX package: it
    changes bf16 numerics. ``beam_size`` is the default of ``method="beam"``
    (the config's ``BEAM_SIZE``).
    """

    def __init__(
        self,
        params: dict,
        mcfg: ModelConfig,
        tokenizer,
        compute_dtype=torch.float32,
        use_kernel: bool = True,
        encoder_quant: str = "none",
        fused_layers: bool = True,
        fused_decode: bool = False,
        beam_size: int = 3,
    ):
        if encoder_quant not in ("none", "int8", "int8_defect"):
            raise ValueError(
                "encoder_quant must be 'none', 'int8' or 'int8_defect', "
                f"got {encoder_quant!r}"
            )
        if encoder_quant.startswith("int8") and "patch" not in params["encoder"]:
            enc = quantize_vision_params(params["encoder"], mcfg.vision)
            if encoder_quant == "int8_defect":
                fc2 = enc["layers"]["fc2"]
                enc["layers"]["fc2"] = fc2._replace(scale=fc2.scale * 2.0)
            params = dict(params, encoder=enc)
        self.params = params
        self.mcfg = mcfg
        self.tokenizer = tokenizer
        self.compute_dtype = compute_dtype
        self.use_kernel = use_kernel
        self.fused_layers = fused_layers
        self.fused_decode = fused_decode
        self.beam_size = beam_size
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
        with span("mit.encode"):
            pixels = pixels.to(device=self.device, dtype=torch.float32)
            feats = encode_images(self.params, self.mcfg, pixels,
                                  self.compute_dtype, self.use_kernel,
                                  self.fused_layers)
            return project_features(self.params, self.mcfg, feats,
                                    self.compute_dtype)

    # ------------------------------------------------------------------
    def generate(self, image, start_token_id: Optional[int] = None,
                 end_token_id: Optional[int] = None, max_len: int = 100,
                 method: str = "greedy", beam_size: Optional[int] = None,
                 **sample_kwargs) -> List[int]:
        """One image → token ids incl. START and (if produced) END.
        ``method="sample"`` takes temperature, top_k, top_p and generator."""
        return self.generate_batch(
            [image], start_token_id, end_token_id, max_len, method, beam_size,
            **sample_kwargs,
        )[0]

    def generate_batch(self, images: Sequence,
                       start_token_id: Optional[int] = None,
                       end_token_id: Optional[int] = None, max_len: int = 100,
                       method: str = "greedy", beam_size: Optional[int] = None,
                       **sample_kwargs) -> List[List[int]]:
        return self.generate_from_memory(
            self.memory_from_images(images), start_token_id, end_token_id,
            max_len, method, beam_size, **sample_kwargs,
        )

    def generate_from_memory(
        self,
        memory: torch.Tensor,
        start_token_id: Optional[int] = None,
        end_token_id: Optional[int] = None,
        max_len: int = 100,
        method: str = "greedy",
        beam_size: Optional[int] = None,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        generator: Optional[torch.Generator] = None,
    ) -> List[List[int]]:
        """Decoder memory (B, S, D) → token id lists: (B, 1, D) CLS memory,
        or the full sequence in ``memory_mode="full"``. ``generator`` (on the
        memory's device) feeds ``method="sample"``; None seeds one with 0, as
        the JAX package's ``rng=None`` is ``PRNGKey(0)``."""
        with span("mit.decode"):
            tok = self.tokenizer
            start_id = (tok.start_id if start_token_id is None
                        else start_token_id)
            end_id = tok.end_id if end_token_id is None else end_token_id
            # the decoder's positional table caps generation length
            max_len = min(max_len, self.mcfg.decoder.max_seq_len)
            dec, dcfg = self.params["decoder"], self.mcfg.decoder
            common = dict(compute_dtype=self.compute_dtype,
                          fused=self.fused_decode)
            if method == "greedy":
                tokens, lengths = greedy_generate(
                    dec, dcfg, memory, start_id, end_id, tok.pad_id, max_len,
                    **common,
                )
            elif method == "beam":
                tokens, _ = beam_generate(
                    dec, dcfg, memory, start_id, end_id, tok.pad_id, max_len,
                    beam_size or self.beam_size, **common,
                )
                lengths = (tokens != tok.pad_id).sum(dim=1)
            elif method == "sample":
                if generator is None:
                    generator = torch.Generator(device=memory.device)
                    generator.manual_seed(0)
                tokens, lengths = sample_generate(
                    dec, dcfg, memory, generator, start_id, end_id, tok.pad_id,
                    max_len, temperature=temperature, top_k=top_k, top_p=top_p,
                    **common,
                )
            else:
                raise ValueError(
                    f"Unsupported generation method: {method}. "
                    "Choose 'greedy', 'beam' or 'sample'."
                )
            with span("mit.decode.readback"):
                tokens = tokens.cpu().numpy()
                lengths = lengths.cpu().numpy()
                return [tokens[i, : lengths[i]].tolist()
                        for i in range(tokens.shape[0])]

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
                max_len: Optional[int] = None,
                beam_size: Optional[int] = None) -> str:
        return self.caption_batch([image], method, max_len, beam_size)[0]

    def caption_batch(self, images: Sequence, method: str = "greedy",
                      max_len: Optional[int] = None,
                      beam_size: Optional[int] = None) -> List[str]:
        ids = self.generate_batch(
            images, max_len=max_len or self.mcfg.decoder.max_seq_len,
            method=method, beam_size=beam_size,
        )
        return [self.postprocess(s) for s in ids]


def load_captioner(checkpoint_path: str, cfg, compute_dtype=torch.float32,
                   device="cuda", encoder_quant: str = "none",
                   fused_decode: bool = False) -> Captioner:
    """Captioner from a reference-layout safetensors checkpoint and the
    tokenizer files of ``cfg`` (a ``mit_tpu_torch.config.Config``):
    tokenizer → model config with the actual vocab size → weights onto
    ``device``, the encoder quantized as ``encoder_quant`` says."""
    # imported here: the tokenizer needs the ``regex`` package, which the
    # captioning path over token ids does not
    from mit_tpu_torch.text.tokenizer import get_tokenizer
    from mit_tpu_torch.train.checkpoint import load_safetensors

    tokenizer = get_tokenizer(cfg, force_reload=True)
    cfg = cfg.with_tokenizer_ids(tokenizer)
    mcfg = ModelConfig.build(cfg, vocab_size=tokenizer.get_vocab_size())
    params = load_safetensors(checkpoint_path, mcfg, device)
    return Captioner(params, mcfg, tokenizer, compute_dtype,
                     encoder_quant=encoder_quant, fused_decode=fused_decode,
                     beam_size=cfg.BEAM_SIZE)


def pretrained_captioner(
    cfg,
    name_or_path: Optional[str] = None,
    decoder_checkpoint: Optional[str] = None,
    compute_dtype=torch.float32,
    local_files_only: bool = True,
    encoder_quant: str = "none",
    device="cuda",
    fused_decode: bool = False,
) -> Captioner:
    """Captioner over a pretrained encoder on ``device``: ``name_or_path``
    (default ``cfg.ENCODER_MODEL_NAME``; a repo id, an HF-layout directory
    or a weights file) through :mod:`mit_tpu_torch.models.pretrained`, a
    decoder and projection drawn from ``cfg.RANDOM_SEED``, both overwritten
    by ``decoder_checkpoint`` (a reference-layout safetensors file) when one
    is given. A repo id is fetched only with ``local_files_only=False``."""
    from mit_tpu_torch.text.tokenizer import get_tokenizer
    from mit_tpu_torch.train.checkpoint import load_safetensors

    tokenizer = get_tokenizer(cfg, force_reload=True)
    cfg = cfg.with_tokenizer_ids(tokenizer)
    mcfg, params = init_model_params_pretrained(
        torch.Generator().manual_seed(cfg.RANDOM_SEED), cfg,
        vocab_size=tokenizer.get_vocab_size(), name_or_path=name_or_path,
        local_files_only=local_files_only, device=device)
    if decoder_checkpoint is not None:
        trained = load_safetensors(decoder_checkpoint, mcfg, device)
        for k in ("decoder", "projection"):
            if k in trained and k in params:
                params[k] = trained[k]
    return Captioner(params, mcfg, tokenizer, compute_dtype,
                     encoder_quant=encoder_quant, fused_decode=fused_decode,
                     beam_size=cfg.BEAM_SIZE)
