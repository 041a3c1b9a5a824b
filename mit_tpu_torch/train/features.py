"""Frozen-encoder feature cache (port of ``mit_tpu/train/features.py``).

The encoder is frozen, so its output is a function of the image alone: it
is computed once per unique image, kept on the host, and the training step
reads features instead of running the encoder. CLS mode stores (U, 1,
H_enc) in f32; full-sequence mode stores bf16 when the encoder computed in
bf16 (the cast loses nothing the step would have seen) and f32 otherwise.
``max_bytes`` bounds the host footprint: a build that would exceed it
raises :class:`FeatureCacheTooLarge` before encoding anything, and the
training loop then runs the encoder in the step instead.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from mit_tpu_torch.models.model import ModelConfig, encode_images


class FeatureCacheTooLarge(ValueError):
    """The projected cache size exceeds ``max_bytes``; train uncached."""


class FeatureCache:
    """Encoder features (U, S, H_enc), a host tensor, keyed by image path."""

    def __init__(self, features: torch.Tensor, path_to_row: Dict[str, int],
                 failed_paths: Optional[set] = None):
        self.features = features
        self.path_to_row = path_to_row
        # images that failed to decode at build time: the loader gives their
        # items the dummy (all-PAD, zero-loss) caption
        self.failed_paths = failed_paths or set()

    @classmethod
    def build(cls, dataset, encoder_params: dict, mcfg: ModelConfig,
              device, batch_size: int = 32, num_workers: int = 2,
              max_bytes: Optional[int] = None, verbose: bool = True,
              compute_dtype=torch.float32) -> "FeatureCache":
        """Encode every unique image of ``dataset`` on ``device`` with the
        encoder tree ``encoder_params`` (float, or int8 from
        ``quantize_vision_params``) in ``compute_dtype``, the dtype the
        training step computes in."""
        unique_paths: List[str] = sorted(set(dataset.image_paths))
        path_to_row = {p: i for i, p in enumerate(unique_paths)}
        full_seq = mcfg.memory_mode != "cls"
        dtype = (torch.bfloat16 if full_seq and compute_dtype == torch.bfloat16
                 else torch.float32)
        seq = mcfg.vision.seq_len if full_seq else 1
        est = (len(unique_paths) * seq * mcfg.vision.hidden_size
               * dtype.itemsize)
        if max_bytes is not None and est > max_bytes:
            raise FeatureCacheTooLarge(
                f"feature cache would need {est / 1e9:.2f} GB "
                f"({len(unique_paths)} images x {seq} x "
                f"{mcfg.vision.hidden_size} @ {dtype}) > max_bytes="
                f"{max_bytes / 1e9:.2f} GB"
            )
        params = {"encoder": encoder_params}
        size = mcfg.vision.image_size
        failed = set()

        def load(path):
            try:
                return dataset.load_image(path)
            except Exception:
                failed.add(path)        # set.add holds the interpreter lock
                return np.zeros((3, size, size), np.float32)

        rows = []
        with ThreadPoolExecutor(max(1, num_workers)) as pool:
            for i in range(0, len(unique_paths), batch_size):
                chunk = unique_paths[i:i + batch_size]
                pixels = torch.from_numpy(np.stack(list(pool.map(load, chunk))))
                feats = encode_images(params, mcfg, pixels.to(device),
                                      compute_dtype)
                rows.append(feats.to("cpu", dtype))
                if verbose and (i // batch_size) % 20 == 0:
                    print(f"\r  feature cache: "
                          f"{min(i + batch_size, len(unique_paths))}"
                          f"/{len(unique_paths)} images", end="")
        if verbose:
            print()
        return cls(torch.cat(rows), path_to_row, failed)

    def lookup(self, paths: List[str]) -> torch.Tensor:
        """(B, S, H_enc) features in the cache's dtype; unknown paths (the
        dummy item's) give zeros."""
        rows = [self.path_to_row.get(p, -1) for p in paths]
        out = self.features[torch.tensor([max(r, 0) for r in rows])]
        missing = torch.tensor([r < 0 for r in rows])
        out[missing] = 0
        return out

    @property
    def nbytes(self) -> int:
        return self.features.numel() * self.features.element_size()


def attach_features(batch: dict, cache: Optional[FeatureCache]) -> dict:
    """Replace a loader batch's images with cached features; the padding
    rows of a partial batch get zeros (their targets are all PAD)."""
    if cache is None:
        return batch
    feats = cache.lookup(batch["image_paths"])
    b = batch["decoder_input_tokens"].shape[0]
    if feats.shape[0] < b:
        feats = torch.cat([feats, feats.new_zeros((b - feats.shape[0],
                                                   *feats.shape[1:]))])
    out = dict(batch)
    out["features"] = feats
    out.pop("images", None)
    return out
