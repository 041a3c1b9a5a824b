"""Pretrained encoder loading: name or path → (VisionConfig, params) (port
of ``mit_tpu/models/pretrained.py``).

Resolves an HF repo id, a local HF-layout directory or a bare weights file
(safetensors, torch ``.bin`` / ``.pt``), slices the vision tower out of the
state dict and converts it with
:func:`mit_tpu_torch.models.vision.params_from_hf_vision`. No model class is
built: only the state dict is read. Safetensors go through the port's own
codec (``train/checkpoint.py``), so neither ``safetensors`` nor
``transformers`` is needed; ``huggingface_hub`` is imported only to look up
a repo id, in the local HF cache unless the caller passes
``local_files_only=False``.

The geometry comes from ``config.json`` beside the weights (a plain dict,
vision-only or composite with a nested ``vision_config``) or, without one,
from the tensor shapes. ViT, CLIP and BLIP towers load, also from
composite checkpoints where the tower nests under ``vision_model.``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional, Tuple

import torch

from mit_tpu_torch.models.vision import (
    FAMILY_BASE,
    VisionConfig,
    detect_hf_prefix,
    params_from_hf_vision,
)
from mit_tpu_torch.train.checkpoint import load_file

_WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin", "pytorch_model.pt")


def load_state_dict(path: str) -> dict:
    """A raw state dict from a safetensors file or a torch pickle; a
    ``model_state_dict`` or ``state_dict`` wrapper (the reference's training
    checkpoints) is unwrapped."""
    if path.endswith(".safetensors"):
        return load_file(path)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # reference-era .pt checkpoints hold python objects besides tensors
        obj = torch.load(path, map_location="cpu", weights_only=False)
    for wrapper in ("model_state_dict", "state_dict"):
        if isinstance(obj, dict) and isinstance(obj.get(wrapper), dict):
            obj = obj[wrapper]
    return obj


def detect_family(sd: dict) -> str:
    """The encoder family from the state dict's keys: ViT has
    ``patch_embeddings.projection``, BLIP one ``self_attn.qkv``, CLIP
    ``self_attn.q_proj``."""
    has_vit = has_qkv = has_qproj = False
    for k in sd:
        if "patch_embeddings.projection" in k:
            has_vit = True
        elif "self_attn.qkv." in k:
            has_qkv = True
        elif "self_attn.q_proj" in k:
            has_qproj = True
    if has_vit:
        return "vit"
    if has_qkv:
        return "blip"
    if has_qproj:
        return "clip"
    raise ValueError(
        "Could not detect a ViT/CLIP/BLIP vision tower in the state dict "
        f"({len(sd)} keys; e.g. {sorted(sd)[:3]})."
    )


def config_from_json_dict(d: dict, family: Optional[str] = None) -> VisionConfig:
    """A parsed HF ``config.json`` → VisionConfig; a composite CLIP/BLIP
    config gives its nested ``vision_config``."""
    model_type = str(d.get("model_type", "")).lower()
    if isinstance(d.get("vision_config"), dict):
        d = d["vision_config"]
        model_type = str(d.get("model_type", model_type)).lower()
    if family is None:
        family = ("blip" if "blip" in model_type
                  else "clip" if "clip" in model_type else "vit")
    base = FAMILY_BASE[family]
    return base._replace(
        image_size=int(d.get("image_size", base.image_size)),
        patch_size=int(d.get("patch_size", base.patch_size)),
        hidden_size=int(d.get("hidden_size", base.hidden_size)),
        num_layers=int(d.get("num_hidden_layers", base.num_layers)),
        num_heads=int(d.get("num_attention_heads", base.num_heads)),
        intermediate_size=int(d.get("intermediate_size", base.intermediate_size)),
        hidden_act=str(d.get("hidden_act", base.hidden_act)),
        layer_norm_eps=float(d.get("layer_norm_eps", base.layer_norm_eps)),
    )


def infer_config_from_state_dict(sd: dict, family: str,
                                 prefix: str) -> VisionConfig:
    """The geometry from tensor shapes, where no config.json exists. The
    head count is not in the shapes: ``hidden_size // 64``, the head width of
    every model the reference names."""
    base = FAMILY_BASE[family]
    if family == "vit":
        conv = sd[prefix + "embeddings.patch_embeddings.projection.weight"]
        pos = sd[prefix + "embeddings.position_embeddings"]
        fc1 = sd[prefix + "encoder.layer.0.intermediate.dense.weight"]
        layer_re = re.compile(re.escape(prefix) + r"encoder\.layer\.(\d+)\.")
    else:
        conv = sd[prefix + "embeddings.patch_embedding.weight"]
        pos_key = ("embeddings.position_embedding.weight" if family == "clip"
                   else "embeddings.position_embedding")
        pos = sd[prefix + pos_key]
        fc1 = sd[prefix + "encoder.layers.0.mlp.fc1.weight"]
        layer_re = re.compile(re.escape(prefix) + r"encoder\.layers\.(\d+)\.")
    hidden, patch = int(conv.shape[0]), int(conv.shape[2])
    seq_len = int(pos.shape[-2]) if pos.ndim > 1 else int(pos.shape[0])
    grid = int(round((seq_len - 1) ** 0.5))
    num_layers = 1 + max(
        int(m.group(1)) for k in sd if (m := layer_re.match(k)) is not None)
    return base._replace(
        image_size=patch * grid,
        patch_size=patch,
        hidden_size=hidden,
        num_layers=num_layers,
        num_heads=max(1, hidden // 64),
        intermediate_size=int(fc1.shape[0]),
    )


def resolve_encoder_source(
    name_or_path: str, local_files_only: bool = True
) -> Tuple[str, Optional[str]]:
    """(weights path, config.json path or None) for a weights file, an
    HF-layout directory or an HF repo id. A repo id is looked up in the
    local HF cache, and over the network only when the caller passes
    ``local_files_only=False`` (the JAX package's default is to fetch)."""
    p = os.path.expanduser(name_or_path)
    if os.path.isfile(p):
        cj = os.path.join(os.path.dirname(p) or ".", "config.json")
        return p, cj if os.path.isfile(cj) else None
    if os.path.isdir(p):
        weights = next((os.path.join(p, c) for c in _WEIGHT_FILES
                        if os.path.isfile(os.path.join(p, c))), None)
        if weights is None:
            found = sorted(f for f in os.listdir(p)
                           if f.endswith((".safetensors", ".bin")))
            if not found:
                raise FileNotFoundError(
                    f"No weights file (*.safetensors / *.bin) in directory {p}.")
            weights = os.path.join(p, found[0])
        cj = os.path.join(p, "config.json")
        return weights, cj if os.path.isfile(cj) else None

    try:
        from huggingface_hub import hf_hub_download
    except Exception as e:          # the hub is not promised where the port runs
        raise ValueError(
            f"'{name_or_path}' is not a local path and huggingface_hub is "
            f"unavailable ({e}).")
    errors = []
    for local_only in ([True] if local_files_only else [True, False]):
        for cand in _WEIGHT_FILES:
            try:
                weights = hf_hub_download(name_or_path, cand,
                                          local_files_only=local_only)
            except Exception as e:  # the hub raises many kinds for a miss
                errors.append(f"{cand} (local_only={local_only}): {e}")
                continue
            try:
                cj = hf_hub_download(name_or_path, "config.json",
                                     local_files_only=local_only)
            except Exception:       # a checkpoint without a config
                cj = None
            return weights, cj
    raise ValueError(
        f"Could not resolve pretrained encoder '{name_or_path}': not a local "
        "file/directory, and the HF hub lookup failed.\n  "
        + "\n  ".join(errors[-4:]))


def load_pretrained_encoder(
    name_or_path: str,
    family: Optional[str] = None,
    local_files_only: bool = True,
    device=None,
) -> Tuple[VisionConfig, dict]:
    """(VisionConfig, params on ``device``) of a pretrained vision tower: an
    HF repo id, a ``save_pretrained`` directory or a weights file, of any of
    the three families; a composite CLIP/BLIP checkpoint gives its vision
    tower. A repo id is fetched only with ``local_files_only=False``."""
    weights_path, config_path = resolve_encoder_source(name_or_path,
                                                       local_files_only)
    sd = load_state_dict(weights_path)
    if family is None:
        family = detect_family(sd)
    prefix = detect_hf_prefix(sd, FAMILY_BASE[family])
    if config_path is not None:
        with open(config_path, "r", encoding="utf-8") as f:
            cfg = config_from_json_dict(json.load(f), family=family)
    else:
        cfg = infer_config_from_state_dict(sd, family, prefix)
    return cfg, params_from_hf_vision(sd, cfg, prefix, device)
