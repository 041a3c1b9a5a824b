"""Checkpoints (port of ``mit_tpu/train/checkpoint.py``).

- **Weights**: ``.safetensors`` in the reference's key layout:
  ``encoder.*`` (HF vision naming), ``projection.*`` and ``decoder.*``
  (torch naming), so a checkpoint flows both ways between the two
  packages. The format is an 8-byte little-endian header length, a JSON
  header of {dtype, shape, data_offsets} per tensor and the raw
  little-endian bytes; :func:`save_file` and :func:`load_file` are the JAX
  package's pure-Python codec (``mit_tpu.utils.safetensors_io``) carried
  over, so the port needs neither the ``safetensors`` package nor the JAX
  package to read or write a checkpoint.
- **Train state** (resume): ``train_state.pt`` (``torch.save`` of the step,
  the trainable parameters and the optimizer state; the JAX package uses
  orbax) beside the same ``train_state_meta.json`` sidecar and keys (epoch,
  best val loss, config).
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from mit_tpu_torch.models.convert import params_from_jax
from mit_tpu_torch.models.decoder import (
    params_from_torch_state_dict,
    torch_state_dict_from_params,
)
from mit_tpu_torch.models.model import ModelConfig
from mit_tpu_torch.models.vision import (
    detect_hf_prefix,
    hf_vision_state_dict_from_params,
    params_from_hf_vision,
)
from mit_tpu_torch.train.steps import OptState, TrainState, tree_leaves

STATE_FILE = "train_state.pt"
META_FILE = "train_state_meta.json"

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}
_DTYPE_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def save_file(tensors: dict, path: str) -> None:
    """numpy arrays → a safetensors file (names sorted, header padded to 8
    bytes, as the JAX package writes it)."""
    header, payload = {}, bytearray()
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        if arr.dtype not in _DTYPE_NAMES:
            raise ValueError(f"unsupported dtype {arr.dtype} for {name}")
        start = len(payload)
        payload += arr.tobytes()
        header[name] = {"dtype": _DTYPE_NAMES[arr.dtype],
                        "shape": list(arr.shape),
                        "data_offsets": [start, len(payload)]}
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hjson += b" " * ((8 - len(hjson) % 8) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        f.write(bytes(payload))


def load_file(path: str) -> dict:
    """A safetensors file → numpy arrays; BF16 tensors widen to f32."""
    with open(path, "rb") as f:
        data = f.read()
    (hlen,) = struct.unpack_from("<Q", data, 0)
    header = json.loads(data[8:8 + hlen].decode("utf-8"))
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        buf = data[8 + hlen + start:8 + hlen + end]
        shape = tuple(meta["shape"])
        if meta["dtype"] == "BF16":
            bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
        elif meta["dtype"] in _DTYPES:
            out[name] = np.frombuffer(buf, _DTYPES[meta["dtype"]]).reshape(shape)
        else:
            raise ValueError(f"unsupported dtype {meta['dtype']} in {path}")
    return out


def reference_state_dict_from_params(params: dict, mcfg: ModelConfig) -> dict:
    """The float model's numpy f32 state dict in the reference's naming."""
    sd = hf_vision_state_dict_from_params(params["encoder"], mcfg.vision,
                                          "encoder.")
    if "projection" in params:
        p = lambda a: a.detach().to("cpu", torch.float32).numpy()
        sd["projection.weight"] = p(params["projection"]["w"]).T
        sd["projection.bias"] = p(params["projection"]["b"])
    sd.update(torch_state_dict_from_params(params["decoder"], "decoder."))
    return sd


def params_from_reference_state_dict(sd: dict, mcfg: ModelConfig,
                                     device=None) -> dict:
    """A reference-format state dict → the port's parameters on ``device``."""
    params = {
        "encoder": params_from_hf_vision(
            sd, mcfg.vision, detect_hf_prefix(sd, mcfg.vision), device
        ),
        "decoder": params_from_torch_state_dict(
            sd, mcfg.decoder, "decoder.", device
        ),
    }
    if mcfg.needs_projection:
        params["projection"] = params_from_jax({
            "w": np.asarray(sd["projection.weight"], np.float32).T,
            "b": sd["projection.bias"],
        }, device)
    return params


def save_safetensors(path: str, params: dict, mcfg: ModelConfig) -> None:
    """Write the float model's weights in the reference's layout."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_file(reference_state_dict_from_params(params, mcfg), path)


def load_safetensors(path: str, mcfg: ModelConfig, device=None) -> dict:
    """A reference-layout checkpoint → the port's parameters on ``device``."""
    return params_from_reference_state_dict(load_file(path), mcfg, device)


def checkpoint_filename(cfg, epoch: int, val_loss: float) -> str:
    """Reference naming: prefix, encoder name with '/' made '_', the 1-based
    epoch and the val loss."""
    safe = cfg.ENCODER_MODEL_NAME.replace("/", "_")
    return f"{cfg.CHECKPOINT_PREFIX}_{safe}_epoch_{epoch + 1}_val_loss_{val_loss:.4f}"


_CKPT_RE = re.compile(r"_epoch_(\d+)_val_loss_([\d.]+)\.safetensors$")


def parse_checkpoint_filename(name: str) -> Optional[Tuple[int, float]]:
    m = _CKPT_RE.search(name)
    if not m:
        return None
    return int(m.group(1)), float(m.group(2).rstrip("."))


# ----------------------------------------------------------------------
# train state (resume)
# ----------------------------------------------------------------------
def save_train_state(directory: str, state: TrainState, epoch: int,
                     best_val_loss: float, cfg) -> str:
    """Save the step, trainable parameters and optimizer state, then the
    sidecar; each file is written whole and renamed into place."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, STATE_FILE)
    tree = {"step": state.step, "params": state.params,
            "opt_state": state.opt_state._asdict()}
    torch.save(tree, path + ".tmp")
    os.replace(path + ".tmp", path)
    meta = {"epoch": epoch, "best_val_loss": best_val_loss,
            "config": json.loads(cfg.to_json())}
    meta_path = os.path.join(directory, META_FILE)
    with open(meta_path + ".tmp", "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(meta_path + ".tmp", meta_path)
    return path


def restore_train_state(directory: str, template: TrainState
                        ) -> Tuple[TrainState, int, float]:
    """(state, start_epoch, best_val_loss); raises if absent. ``template``
    gives the device the state is restored onto."""
    device = tree_leaves(template.params)[0].device
    tree = torch.load(os.path.join(directory, STATE_FILE),
                      map_location=device, weights_only=True)
    with open(os.path.join(directory, META_FILE)) as f:
        meta = json.load(f)
    state = TrainState(tree["step"], tree["params"],
                       OptState(**tree["opt_state"]))
    # resume at the epoch after the last completed one
    return state, meta["epoch"] + 1, meta["best_val_loss"]
