"""Frozen vision encoders: ViT / CLIP-vision / BLIP-vision (port of
``mit_tpu/models/vision.py``, float path).

One generic pre-LN ViT; family differences are data: pre/post LayerNorm,
GELU (exact erf) or quick_gelu, patch-projection bias, LayerNorm eps. The
patch embedding is a matmul over unfolded patches. Self-attention runs
through :func:`~mit_tpu_torch.ops.flash_attention.flash_attention_btd`, and
the residual adds, biases, LayerNorms and activations between the products
through the two kernels of :mod:`mit_tpu_torch.ops.encoder_fused`.

Under a device mesh the float encoder splits over "model" as the decoder
does (Megatron's layout, ``parallel.mesh.vision_param_specs(tp=True)``):
a rank holds its heads' columns of ``wq/wk/wv`` and rows of ``wo``, and its
columns of ``fc1`` and rows of ``fc2``. Each sublayer ends in one sum over
"model" (``reduce_from_model``), and the replicated biases and LayerNorms
apply once, after it. The JAX package gets this from GSPMD, with its
attention kernel run per shard over the local heads
(``custom_partitioning``); here each rank launches the same kernels over its
own heads.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mit_tpu_torch.models.convert import layer_params, params_from_jax
from mit_tpu_torch.ops.attention import layer_norm, multihead_attention
from mit_tpu_torch.ops.encoder_fused import (
    add_layer_norm,
    add_layer_norm_reference,
    bias_act,
    bias_act_reference,
)
from mit_tpu_torch.ops.flash_attention import (
    flash_attention_btd_fusedqkv,
    flash_attention_btd_fusedqkv_reference,
)
from mit_tpu_torch.ops.int8_layer import (
    fused_int8_vit_layer,
    fused_int8_vit_layer_reference,
)
from mit_tpu_torch.ops.int8_mlp import (
    fused_int8_mlp,
    fused_int8_mlp_reference,
    int8_linear,
    int8_linear_reference,
)
from mit_tpu_torch.ops.quant import quantize_weight
from mit_tpu_torch.parallel.collectives import (
    Shard,
    copy_to_model,
    reduce_from_model,
)


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


# the preset each family's missing config fields come from
FAMILY_BASE = {
    "vit": PRESETS["google/vit-base-patch16-224-in21k"],
    "clip": PRESETS["openai/clip-vit-base-patch32"],
    "blip": PRESETS["Salesforce/blip-image-captioning-base"],
}


def config_from_hf(hf_config, family: Optional[str] = None) -> VisionConfig:
    """A transformers config object (ViT, CLIP-vision or BLIP-vision, or a
    composite CLIP/BLIP config, whose ``vision_config`` is taken) →
    ``VisionConfig``. Read by attribute, so transformers is not imported;
    ``family`` comes from the class name when omitted."""
    if hasattr(hf_config, "vision_config"):
        hf_config = hf_config.vision_config
    if family is None:
        cls = type(hf_config).__name__.lower()
        family = "blip" if "blip" in cls else "clip" if "clip" in cls else "vit"
    base = FAMILY_BASE[family]
    return base._replace(
        image_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        hidden_act=getattr(hf_config, "hidden_act", base.hidden_act),
        layer_norm_eps=getattr(hf_config, "layer_norm_eps", base.layer_norm_eps),
    )


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
    shard: Optional[Shard] = None,
) -> torch.Tensor:
    """last_hidden_state (B, N+1, D), or with ``cls_only`` the CLS row
    (B, 1, D) only: the last layer then attends with the CLS query alone and
    runs its MLP on one token, since the other rows feed nothing downstream
    in CLS-memory mode. ``use_kernel`` sends the self-attention of every
    full layer through ``flash_attention_btd``.

    Between the products the elementwise work runs in two kernels
    (``ops/encoder_fused.py``): each sublayer boundary is one
    :func:`add_layer_norm` (the residual add, the product's bias and the
    next LayerNorm: ``ln_pre``, ``ln1``, ``ln2``, ``ln_post``, or none after
    the last layer of a tower without ``ln_post``), and fc1's bias and
    activation one :func:`bias_act`. A tower of L layers makes 2L + 1
    boundaries (2L + 2 with ``ln_pre``) and L activations, with or without
    ``cls_only``; the attention hands over its out-projection before
    ``bo`` (``multihead_attention(out_bias=False)``). ``use_kernel=False``
    runs the attention's and both kernels' plain versions.

    ``shard`` with a "model" group: ``params`` are this rank's piece of the
    tree (``shard_tree`` with ``vision_param_specs(tp=True)``), and every
    rank returns the whole output: the boundaries take the sums over
    "model", so the replicated biases apply once.
    """
    cd = compute_dtype
    eps = cfg.layer_norm_eps
    b = pixel_values.shape[0]
    d = cfg.hidden_size
    act = "quick_gelu" if cfg.hidden_act == "quick_gelu" else "gelu"
    group = shard.group if shard is not None else None
    heads = cfg.num_heads
    if group is not None:
        width = params["layers"]["attn"]["wq"].shape[-1]
        if width * shard.m != d:
            raise ValueError(
                f"a split encoder needs this rank's {d // shard.m} of {d} "
                f"attention columns, got {width}")
        heads //= shard.m
    hd = d // cfg.num_heads
    boundary_fn = add_layer_norm if use_kernel else add_layer_norm_reference
    bias_act_fn = bias_act if use_kernel else bias_act_reference

    def boundary(x, a, bias, ln):
        return boundary_fn(x, a, bias, ln, eps)

    def mlp(x, h, layer, ln_next):
        # column-parallel fc1, row-parallel fc2: b2 after the sum
        f = bias_act_fn(copy_to_model(h, group) @ layer["fc1"].to(cd),
                        layer["b1"], act)
        return boundary(x, reduce_from_model(f @ layer["fc2"].to(cd), group),
                        layer["b2"], ln_next)

    x = _patchify(pixel_values.to(cd), cfg.patch_size) @ params["patch_w"].to(cd)
    if cfg.patch_bias:
        x = x + params["patch_b"].to(cd)
    cls = params["cls"].to(cd).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(cd)[None]
    if cfg.ln_pre:
        x = boundary(None, x, None, params["ln_pre"])[1]
    layers = [layer_params(params["layers"], i) for i in range(cfg.num_layers)]
    # the LayerNorm after each layer: the next layer's ln1, then ln_post
    ln_next = [layer["ln1"] for layer in layers[1:]] + [
        params["ln_post"] if cfg.ln_post else None]
    x, h = boundary(None, x, None, layers[0]["ln1"])

    n_full = cfg.num_layers - 1 if cls_only else cfg.num_layers
    for i in range(n_full):
        layer = layers[i]
        a = multihead_attention(
            layer["attn"], h, h, cfg.num_heads, compute_dtype=cd,
            use_kernel=use_kernel, shard=shard, out_bias=False,
        )
        x, h = boundary(x, a, layer["attn"]["bo"], layer["ln2"])
        x, h = mlp(x, h, layer, ln_next[i])

    if cls_only:
        layer = layers[-1]
        attn = layer["attn"]
        h = copy_to_model(h, group)
        # keys/values over the full sequence, query = the CLS row only; this
        # rank's heads
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
        a = reduce_from_model(ctx.reshape(b, 1, heads * hd)
                              @ attn["wo"].to(cd), group)
        x, h = boundary(x[:, :1], a, attn["bo"], layer["ln2"])
        x, h = mlp(x, h, layer, ln_next[-1])

    return h if cfg.ln_post else x



# ----------------------------------------------------------------------
# int8 (W8A8) encoder: every GEMM int8 × int8 → int32 with per-row dynamic
# activation scales; LayerNorm, softmax, GELU and residuals stay f32/bf16.
# ----------------------------------------------------------------------
def quantize_vision_params(params: dict, cfg: VisionConfig) -> dict:
    """Float encoder params → int8 GEMM weights (``QuantizedLinear``
    leaves), as ``mit_tpu.models.vision.quantize_vision_params``: the same
    codes and scales, with Q, K and V fused into one (L, D, 3D) weight.
    Layer norms, cls and pos pass through unchanged."""
    lay = params["layers"]
    attn = lay["attn"]
    cat = lambda *ts: torch.cat(ts, dim=-1)
    qp = {
        "patch": quantize_weight(
            params["patch_w"], params["patch_b"] if cfg.patch_bias else None,
        ),
        "cls": params["cls"],
        "pos": params["pos"],
        "layers": {
            "attn": {
                "qkv": quantize_weight(cat(attn["wq"], attn["wk"], attn["wv"]),
                                       cat(attn["bq"], attn["bk"], attn["bv"])),
                "o": quantize_weight(attn["wo"], attn["bo"]),
            },
            "ln1": lay["ln1"],
            "ln2": lay["ln2"],
            "fc1": quantize_weight(lay["fc1"], lay["b1"]),
            "fc2": quantize_weight(lay["fc2"], lay["b2"]),
        },
    }
    for k in ("ln_pre", "ln_post"):
        if k in params:
            qp[k] = params[k]
    return qp


def vision_forward_int8(
    qparams: dict,
    cfg: VisionConfig,
    pixel_values: torch.Tensor,           # (B, 3, H, W) f32 NCHW
    compute_dtype=torch.bfloat16,
    use_kernel: bool = True,
    cls_only: bool = False,
    fused_layers: bool = True,
) -> torch.Tensor:
    """int8 twin of :func:`vision_forward` over :func:`quantize_vision_params`
    weights (port of ``mit_tpu.models.vision.vision_forward_int8``).

    The JAX package picks its layer kernel by what fits the TPU's VMEM; the
    port keeps its two tiers as the two numeric forms they are:

    - ``fused_layers=True`` (the default, the TPU's form at ViT-B): full
      layers run :func:`~mit_tpu_torch.ops.int8_layer.fused_int8_vit_layer`
      (LayerNorm in f32 before quantizing, bf16 qkv, f32 context and
      residual stream);
    - ``fused_layers=False``: the per-op form, ``int8_linear`` for QKV and
      the out-projection, ``flash_attention_btd_fusedqkv`` and
      ``fused_int8_mlp``, with plain LayerNorms and residual adds in the
      compute dtype.

    Patch embedding and the CLS-only last layer go through ``int8_linear``
    and ``fused_int8_mlp`` in both forms; the last layer's one-query
    attention is plain einsums, as in the JAX package. ``use_kernel=False``
    runs every kernel's plain version instead.
    """
    if use_kernel:
        linear, mlp = int8_linear, fused_int8_mlp
        attn, layer_fn = flash_attention_btd_fusedqkv, fused_int8_vit_layer
    else:
        linear, mlp = int8_linear_reference, fused_int8_mlp_reference
        attn = flash_attention_btd_fusedqkv_reference
        layer_fn = fused_int8_vit_layer_reference
    cd = compute_dtype
    eps = cfg.layer_norm_eps
    b = pixel_values.shape[0]
    d = cfg.hidden_size
    heads, hd = cfg.num_heads, d // cfg.num_heads
    act = "quick_gelu" if cfg.hidden_act == "quick_gelu" else "gelu"

    patch_q = qparams["patch"]
    if patch_q.bias is None:
        patch_q = patch_q._replace(bias=torch.zeros(
            d, dtype=torch.float32, device=patch_q.scale.device))
    x = linear(_patchify(pixel_values.to(cd), cfg.patch_size), patch_q, cd)
    cls = qparams["cls"].to(cd).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + qparams["pos"].to(cd)[None]
    if cfg.ln_pre:
        x = layer_norm(qparams["ln_pre"], x, eps)

    def attn_block(x, layer):
        qkv = linear(layer_norm(layer["ln1"], x, eps), layer["attn"]["qkv"], cd)
        return x + linear(attn(qkv, hd), layer["attn"]["o"], cd)

    def mlp_block(x, layer):
        h = layer_norm(layer["ln2"], x, eps)
        return x + mlp(h, layer["fc1"], layer["fc2"], act, cd)

    def full_layer(x, layer):
        if fused_layers:
            return layer_fn(x, layer["ln1"], layer["attn"]["qkv"],
                            layer["attn"]["o"], layer["ln2"], layer["fc1"],
                            layer["fc2"], heads, eps, act)
        return mlp_block(attn_block(x, layer), layer)

    n_full = cfg.num_layers - 1 if cls_only else cfg.num_layers
    for i in range(n_full):
        x = full_layer(x, layer_params(qparams["layers"], i))

    if cls_only:
        layer = layer_params(qparams["layers"], cfg.num_layers - 1)
        qkv = linear(layer_norm(layer["ln1"], x, eps), layer["attn"]["qkv"], cd)
        s = qkv.shape[1]
        q1 = qkv[:, 0, :d].reshape(b, heads, hd)
        k = qkv[:, :, d:2 * d].reshape(b, s, heads, hd)
        v = qkv[:, :, 2 * d:].reshape(b, s, heads, hd)
        scores = torch.einsum("bhd,bshd->bhs", q1.float(), k.float())
        probs = torch.softmax(scores / math.sqrt(hd), dim=-1)
        ctx = torch.einsum("bhs,bshd->bhd", probs.to(cd), v)
        a = linear(ctx.reshape(b, 1, d), layer["attn"]["o"], cd)
        x = mlp_block(x[:, :1] + a, layer)

    if cfg.ln_post:
        x = layer_norm(qparams["ln_post"], x, eps)
    return x


# ----------------------------------------------------------------------
# HF weight conversion (state dict of numpy arrays or torch tensors)
# ----------------------------------------------------------------------
def _np(a):
    if hasattr(a, "detach"):
        a = a.detach().cpu().float().numpy()
    return np.asarray(a, dtype=np.float32)


def _hf_layout(cfg: VisionConfig):
    """(per-layer module names, final LayerNorm name) of a family's HF
    vision tower."""
    if cfg.family == "vit":
        lyr = "encoder.layer.{i}."
        return {
            "q": lyr + "attention.attention.query",
            "k": lyr + "attention.attention.key",
            "v": lyr + "attention.attention.value",
            "o": lyr + "attention.output.dense",
            "ln1": lyr + "layernorm_before",
            "ln2": lyr + "layernorm_after",
            "fc1": lyr + "intermediate.dense",
            "fc2": lyr + "output.dense",
        }, "layernorm"
    lyr = "encoder.layers.{i}."   # clip / blip share the CLIP-style naming
    return {
        "q": lyr + "self_attn.q_proj",
        "k": lyr + "self_attn.k_proj",
        "v": lyr + "self_attn.v_proj",
        "o": lyr + "self_attn.out_proj",
        "ln1": lyr + "layer_norm1",
        "ln2": lyr + "layer_norm2",
        "fc1": lyr + "mlp.fc1",
        "fc2": lyr + "mlp.fc2",
    }, "post_layernorm"


def params_from_hf_vision(sd: dict, cfg: VisionConfig, prefix: str = "",
                          device=None) -> dict:
    """Convert an HF vision state dict (any of the three families).

    ``prefix`` strips container nesting, e.g. ``"vision_model."`` or the
    ``"encoder."`` of the reference's combined checkpoint.
    """
    g = lambda n: _np(sd[prefix + n])
    L, d = cfg.num_layers, cfg.hidden_size
    names, ln_post = _hf_layout(cfg)

    if cfg.family == "vit":
        conv_w = g("embeddings.patch_embeddings.projection.weight")
        patch_b = g("embeddings.patch_embeddings.projection.bias")
        cls = g("embeddings.cls_token").reshape(d)
        pos = g("embeddings.position_embeddings").reshape(-1, d)
    else:
        conv_w = g("embeddings.patch_embedding.weight")
        cls = g("embeddings.class_embedding").reshape(d)
        if cfg.family == "clip":
            patch_b = np.zeros((d,), np.float32)
            pos = g("embeddings.position_embedding.weight")
        else:  # blip
            patch_b = g("embeddings.patch_embedding.bias")
            pos = g("embeddings.position_embedding").reshape(-1, d)

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


def hf_vision_state_dict_from_params(params: dict, cfg: VisionConfig,
                                     prefix: str = "") -> dict:
    """The reverse of :func:`params_from_hf_vision` for a float tree: HF
    naming with numpy f32 values (``mit_tpu.models.vision.
    hf_vision_state_dict_from_params``)."""
    p = _np
    d, L = cfg.hidden_size, cfg.num_layers
    names, ln_post = _hf_layout(cfg)
    out = {}
    patch_w = p(params["patch_w"]).T.reshape(d, 3, cfg.patch_size,
                                              cfg.patch_size)
    if cfg.family == "vit":
        emb = prefix + "embeddings."
        out[emb + "patch_embeddings.projection.weight"] = patch_w
        out[emb + "patch_embeddings.projection.bias"] = p(params["patch_b"])
        out[emb + "cls_token"] = p(params["cls"]).reshape(1, 1, d)
        out[emb + "position_embeddings"] = p(params["pos"]).reshape(1, -1, d)
    else:
        emb = prefix + "embeddings."
        out[emb + "patch_embedding.weight"] = patch_w
        if cfg.family == "blip":
            out[emb + "patch_embedding.bias"] = p(params["patch_b"])
            out[emb + "class_embedding"] = p(params["cls"]).reshape(1, 1, d)
            out[emb + "position_embedding"] = p(params["pos"]).reshape(1, -1, d)
        else:  # clip
            out[emb + "class_embedding"] = p(params["cls"])
            out[emb + "position_embedding.weight"] = p(params["pos"])

    lay = params["layers"]
    attn = lay["attn"]
    for i in range(L):
        name = lambda key: prefix + names[key].format(i=i)
        if cfg.family == "blip":
            base = prefix + f"encoder.layers.{i}.self_attn."
            out[base + "qkv.weight"] = np.concatenate(
                [p(attn[w][i]).T for w in ("wq", "wk", "wv")], axis=0)
            out[base + "qkv.bias"] = np.concatenate(
                [p(attn[b][i]) for b in ("bq", "bk", "bv")])
            out[base + "projection.weight"] = p(attn["wo"][i]).T
            out[base + "projection.bias"] = p(attn["bo"][i])
        else:
            for key in "qkvo":
                out[name(key) + ".weight"] = p(attn["w" + key][i]).T
                out[name(key) + ".bias"] = p(attn["b" + key][i])
        for ln in ("ln1", "ln2"):
            out[name(ln) + ".weight"] = p(lay[ln]["scale"][i])
            out[name(ln) + ".bias"] = p(lay[ln]["bias"][i])
        for fc, b in (("fc1", "b1"), ("fc2", "b2")):
            out[name(fc) + ".weight"] = p(lay[fc][i]).T
            out[name(fc) + ".bias"] = p(lay[b][i])
    if cfg.ln_pre:
        out[prefix + "pre_layrnorm.weight"] = p(params["ln_pre"]["scale"])
        out[prefix + "pre_layrnorm.bias"] = p(params["ln_pre"]["bias"])
    if cfg.ln_post:
        out[prefix + ln_post + ".weight"] = p(params["ln_post"]["scale"])
        out[prefix + ln_post + ".bias"] = p(params["ln_post"]["bias"])
    return out


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
