"""Frozen vision encoders: ViT / CLIP-vision / BLIP-vision (port of
``mit_tpu/models/vision.py``, float path).

One generic pre-LN ViT; family differences are data: pre/post LayerNorm,
GELU (exact erf) or quick_gelu, patch-projection bias, LayerNorm eps. The
patch embedding is a matmul over unfolded patches. Self-attention runs
through :func:`~mit_tpu_torch.ops.flash_attention.flash_attention_btd`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mit_tpu_torch.models.convert import layer_params, params_from_jax
from mit_tpu_torch.ops.attention import layer_norm, multihead_attention


class VisionConfig(NamedTuple):
    """Generic pre-LN ViT family config (fields as in the JAX package).

    ``family``: vit — final LN over all tokens, eps 1e-12; clip — LN right
    after the embeddings (``ln_pre``), no final LN; blip — final LN.
    """

    family: str = "vit"
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"          # "gelu" (erf) | "quick_gelu"
    layer_norm_eps: float = 1e-12
    patch_bias: bool = True
    ln_pre: bool = False
    ln_post: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1


# Shapes from the published HF configs, as in the JAX package.
PRESETS = {
    "google/vit-base-patch16-224-in21k": VisionConfig(
        family="vit", image_size=224, patch_size=16, hidden_size=768,
        num_layers=12, num_heads=12, intermediate_size=3072,
        hidden_act="gelu", layer_norm_eps=1e-12,
        patch_bias=True, ln_pre=False, ln_post=True,
    ),
    "openai/clip-vit-base-patch32": VisionConfig(
        family="clip", image_size=224, patch_size=32, hidden_size=768,
        num_layers=12, num_heads=12, intermediate_size=3072,
        hidden_act="quick_gelu", layer_norm_eps=1e-5,
        patch_bias=False, ln_pre=True, ln_post=False,
    ),
    "openai/clip-vit-large-patch14": VisionConfig(
        family="clip", image_size=224, patch_size=14, hidden_size=1024,
        num_layers=24, num_heads=16, intermediate_size=4096,
        hidden_act="quick_gelu", layer_norm_eps=1e-5,
        patch_bias=False, ln_pre=True, ln_post=False,
    ),
    "Salesforce/blip-image-captioning-base": VisionConfig(
        family="blip", image_size=384, patch_size=16, hidden_size=768,
        num_layers=12, num_heads=12, intermediate_size=3072,
        hidden_act="gelu", layer_norm_eps=1e-5,
        patch_bias=True, ln_pre=False, ln_post=True,
    ),
    "mit/tiny-vit-debug": VisionConfig(
        family="vit", image_size=224, patch_size=56, hidden_size=48,
        num_layers=1, num_heads=2, intermediate_size=64,
        hidden_act="gelu", layer_norm_eps=1e-12,
        patch_bias=True, ln_pre=False, ln_post=True,
    ),
}


def config_for_encoder(name: str) -> VisionConfig:
    """Exact preset names win; else "blip" / "clip" / fallback "vit"."""
    if name in PRESETS:
        return PRESETS[name]
    low = name.lower()
    if "blip" in low:
        return PRESETS["Salesforce/blip-image-captioning-base"]
    if "clip" in low:
        return PRESETS["openai/clip-vit-base-patch32"]
    return PRESETS["google/vit-base-patch16-224-in21k"]


def init_vision_params(generator: torch.Generator, cfg: VisionConfig,
                       device=None) -> dict:
    """Random weights, N(0, 0.02) matrices, zero biases, unit LN scales.

    Drawn on the CPU from ``generator``, then moved to ``device``.
    """
    d, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    pdim = cfg.patch_size * cfg.patch_size * 3
    init = lambda *shape: torch.randn(*shape, generator=generator) * 0.02
    zeros = lambda *shape: torch.zeros(*shape)
    ln = lambda *lead: {"scale": torch.ones(*lead, d), "bias": zeros(*lead, d)}
    params = {
        "patch_w": init(pdim, d),
        "patch_b": zeros(d),
        "cls": init(d),
        "pos": init(cfg.seq_len, d),
        "layers": {
            "attn": {
                "wq": init(L, d, d), "wk": init(L, d, d),
                "wv": init(L, d, d), "wo": init(L, d, d),
                "bq": zeros(L, d), "bk": zeros(L, d),
                "bv": zeros(L, d), "bo": zeros(L, d),
            },
            "ln1": ln(L), "ln2": ln(L),
            "fc1": init(L, d, f), "b1": zeros(L, f),
            "fc2": init(L, f, d), "b2": zeros(L, d),
        },
    }
    if cfg.ln_pre:
        params["ln_pre"] = ln()
    if cfg.ln_post:
        params["ln_post"] = ln()
    return params_from_jax(params, device)


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, 3, H, W) NCHW → (B, N, 3*patch*patch), torch Conv2d flattening
    order (C, kH, kW) and row-major patch grid."""
    b, c, h, w = pixel_values.shape
    gh, gw = h // patch, w // patch
    x = pixel_values.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)          # (B, gh, gw, C, p, p)
    return x.reshape(b, gh * gw, c * patch * patch)


def vision_forward(
    params: dict,
    cfg: VisionConfig,
    pixel_values: torch.Tensor,           # (B, 3, H, W) f32 NCHW
    compute_dtype=torch.float32,
    use_kernel: bool = True,
    cls_only: bool = False,
) -> torch.Tensor:
    """last_hidden_state (B, N+1, D), or with ``cls_only`` the CLS row
    (B, 1, D) only: the last layer then attends with the CLS query alone and
    runs its MLP on one token, since the other rows feed nothing downstream
    in CLS-memory mode. ``use_kernel`` sends the self-attention of every
    full layer through ``flash_attention_btd``.
    """
    cd = compute_dtype
    eps = cfg.layer_norm_eps
    b = pixel_values.shape[0]
    d = cfg.hidden_size
    act = _quick_gelu if cfg.hidden_act == "quick_gelu" else F.gelu

    x = _patchify(pixel_values.to(cd), cfg.patch_size) @ params["patch_w"].to(cd)
    if cfg.patch_bias:
        x = x + params["patch_b"].to(cd)
    cls = params["cls"].to(cd).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(cd)[None]
    if cfg.ln_pre:
        x = layer_norm(params["ln_pre"], x, eps)

    def mlp(x, layer):
        h = layer_norm(layer["ln2"], x, eps)
        h = act(h @ layer["fc1"].to(cd) + layer["b1"].to(cd))
        return x + (h @ layer["fc2"].to(cd) + layer["b2"].to(cd))

    n_full = cfg.num_layers - 1 if cls_only else cfg.num_layers
    for i in range(n_full):
        layer = layer_params(params["layers"], i)
        h = layer_norm(layer["ln1"], x, eps)
        x = x + multihead_attention(
            layer["attn"], h, h, cfg.num_heads, compute_dtype=cd,
            use_kernel=use_kernel,
        )
        x = mlp(x, layer)

    if cls_only:
        layer = layer_params(params["layers"], cfg.num_layers - 1)
        attn = layer["attn"]
        h = layer_norm(layer["ln1"], x, eps)
        heads, hd = cfg.num_heads, d // cfg.num_heads
        # keys/values over the full sequence, query = the CLS row only
        q1 = h[:, :1] @ attn["wq"].to(cd) + attn["bq"].to(cd)
        k = h @ attn["wk"].to(cd) + attn["bk"].to(cd)
        v = h @ attn["wv"].to(cd) + attn["bv"].to(cd)
        s = k.shape[1]
        scores = torch.einsum(
            "bhd,bshd->bhs", q1.reshape(b, heads, hd).float(),
            k.reshape(b, s, heads, hd).float(),
        ) / math.sqrt(hd)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum(
            "bhs,bshd->bhd", probs.to(cd), v.reshape(b, s, heads, hd)
        )
        a = ctx.reshape(b, 1, d) @ attn["wo"].to(cd) + attn["bo"].to(cd)
        x = mlp(x[:, :1] + a, layer)

    if cfg.ln_post:
        x = layer_norm(params["ln_post"], x, eps)
    return x


# ----------------------------------------------------------------------
# HF weight conversion (state dict of numpy arrays or torch tensors)
# ----------------------------------------------------------------------
def _np(a):
    if hasattr(a, "detach"):
        a = a.detach().cpu().float().numpy()
    return np.asarray(a, dtype=np.float32)


def params_from_hf_vision(sd: dict, cfg: VisionConfig, prefix: str = "",
                          device=None) -> dict:
    """Convert an HF vision state dict (any of the three families).

    ``prefix`` strips container nesting, e.g. ``"vision_model."`` or the
    ``"encoder."`` of the reference's combined checkpoint.
    """
    g = lambda n: _np(sd[prefix + n])
    L, d = cfg.num_layers, cfg.hidden_size

    if cfg.family == "vit":
        conv_w = g("embeddings.patch_embeddings.projection.weight")
        patch_b = g("embeddings.patch_embeddings.projection.bias")
        cls = g("embeddings.cls_token").reshape(d)
        pos = g("embeddings.position_embeddings").reshape(-1, d)
        lyr = "encoder.layer.{i}."
        names = {
            "q": lyr + "attention.attention.query",
            "k": lyr + "attention.attention.key",
            "v": lyr + "attention.attention.value",
            "o": lyr + "attention.output.dense",
            "ln1": lyr + "layernorm_before",
            "ln2": lyr + "layernorm_after",
            "fc1": lyr + "intermediate.dense",
            "fc2": lyr + "output.dense",
        }
        ln_post = "layernorm"
    else:  # clip / blip share the CLIP-style encoder naming
        conv_w = g("embeddings.patch_embedding.weight")
        cls = g("embeddings.class_embedding").reshape(d)
        if cfg.family == "clip":
            patch_b = np.zeros((d,), np.float32)
            pos = g("embeddings.position_embedding.weight")
        else:  # blip
            patch_b = g("embeddings.patch_embedding.bias")
            pos = g("embeddings.position_embedding").reshape(-1, d)
        lyr = "encoder.layers.{i}."
        names = {
            "q": lyr + "self_attn.q_proj",
            "k": lyr + "self_attn.k_proj",
            "v": lyr + "self_attn.v_proj",
            "o": lyr + "self_attn.out_proj",
            "ln1": lyr + "layer_norm1",
            "ln2": lyr + "layer_norm2",
            "fc1": lyr + "mlp.fc1",
            "fc2": lyr + "mlp.fc2",
        }
        ln_post = "post_layernorm"

    def per_layer(fmt, kind):
        if kind == "w":   # torch Linear (out, in) → (in, out)
            return np.stack([g(fmt.format(i=i) + ".weight").T for i in range(L)])
        return np.stack([g(fmt.format(i=i) + ".bias") for i in range(L)])

    def per_layer_ln(fmt):
        return {
            "scale": np.stack([g(fmt.format(i=i) + ".weight") for i in range(L)]),
            "bias": np.stack([g(fmt.format(i=i) + ".bias") for i in range(L)]),
        }

    if cfg.family == "blip":   # BLIP packs q/k/v rows into one (3D, D) qkv
        qkv_w = np.stack(
            [g(f"encoder.layers.{i}.self_attn.qkv.weight") for i in range(L)]
        )
        qkv_b = np.stack(
            [g(f"encoder.layers.{i}.self_attn.qkv.bias") for i in range(L)]
        )
        wq, wk, wv = np.split(qkv_w, 3, axis=1)
        bq, bk, bv = np.split(qkv_b, 3, axis=1)
        proj = "encoder.layers.{i}.self_attn.projection"
        attn = {
            "wq": np.swapaxes(wq, 1, 2), "wk": np.swapaxes(wk, 1, 2),
            "wv": np.swapaxes(wv, 1, 2), "wo": per_layer(proj, "w"),
            "bq": bq, "bk": bk, "bv": bv, "bo": per_layer(proj, "b"),
        }
    else:
        attn = {}
        for key in "qkvo":
            attn["w" + key] = per_layer(names[key], "w")
            attn["b" + key] = per_layer(names[key], "b")

    params = {
        # torch conv weight (D, C, p, p) → flatten (C, p, p) → (C*p*p, D)
        "patch_w": conv_w.reshape(d, -1).T,
        "patch_b": patch_b,
        "cls": cls,
        "pos": pos,
        "layers": {
            "attn": attn,
            "ln1": per_layer_ln(names["ln1"]),
            "ln2": per_layer_ln(names["ln2"]),
            "fc1": per_layer(names["fc1"], "w"), "b1": per_layer(names["fc1"], "b"),
            "fc2": per_layer(names["fc2"], "w"), "b2": per_layer(names["fc2"], "b"),
        },
    }
    if cfg.ln_pre:
        params["ln_pre"] = {"scale": g("pre_layrnorm.weight"),
                            "bias": g("pre_layrnorm.bias")}
    if cfg.ln_post:
        params["ln_post"] = {"scale": g(ln_post + ".weight"),
                             "bias": g(ln_post + ".bias")}
    return params_from_jax(params, device)


def detect_hf_prefix(sd: dict, cfg: VisionConfig) -> str:
    """Key prefix of the vision tower inside a state dict: bare, under
    ``vision_model.``, or under the reference's combined-model ``encoder.``."""
    probe = (
        "embeddings.patch_embeddings.projection.weight"
        if cfg.family == "vit"
        else "embeddings.patch_embedding.weight"
    )
    for prefix in ("", "vision_model.", "encoder.", "encoder.vision_model."):
        if prefix + probe in sd:
            return prefix
    raise KeyError(
        f"Could not locate a {cfg.family} vision tower in state dict "
        f"(looked for '*{probe}')."
    )
