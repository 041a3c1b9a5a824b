"""Kimi-VL-A3B's language model and projector: the captioner's second
language-model family, a DeepSeek-V3-style sparse decoder (no counterpart
in the JAX package).

Published shape (``moonshotai/Kimi-VL-A3B-Instruct`` config.json,
``text_config``, model type ``deepseek_v3``): 27 pre-RMSNorm layers of
width 2048; latent attention (MLA, :mod:`mit_tpu_torch.ops.mla`) with 16
heads; layer 0 a dense SwiGLU of 11,264, layers 1-26 mixture-of-experts
layers (:mod:`mit_tpu_torch.ops.moe`) of 64 sigmoid-routed experts of
1,408, six a token, and two shared experts; vocabulary 163,840 and an
untied ``lm_head``. The projector (``multi_modal_projector``) LayerNorms
each patch of the vision tower, merges 2 x 2 patches row-major into one
token and runs ``Linear -> GELU -> Linear`` to the model's width. The image
tokens are the prefix of one causal sequence, the prompt follows.

Parameters live in the port's layout: ``(in, out)`` matrices, layers
stacked on a leading axis, in the compute dtype (bf16 on the card). Every
product runs in that dtype; the residual stream between the layers stays
f32, as the fused decode layer's does (``ops/decode_layer.py``): rounded
to bf16 at each of its 54 additions, it moves the router's inputs enough
to flip experts, and with them the greedy token at 4-9 % of the positions
against the f32 reference. The
attention and norms of every layer sit under ``layers``; the dense FFNs
under ``dense`` and the expert layers under ``moe``, each stacked over its
own layers.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from mit_tpu_torch.ops.attention import layer_norm
from mit_tpu_torch.ops.mla import mla_decode, mla_prefill, rms_norm
from mit_tpu_torch.ops.moe import moe_layer, swiglu
from mit_tpu_torch.utils.cuda_graphs import GraphHolder, capture
from mit_tpu_torch.utils.profiling import span

class KimiVLConfig(NamedTuple):
    """The language model's and the projector's shape; field names are the
    published config's. The defaults are Kimi-VL-A3B-Instruct's."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    max_position_embeddings: int = 131072
    vision_width: int = 1024          # the projector's input, a patch
    merge: int = 2                    # patches merged a side
    projector_eps: float = 1e-5

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_width(self) -> int:
        """Values the latent cache keeps a token and a layer."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def n_moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    @property
    def shared_width(self) -> int:
        return self.moe_intermediate_size * self.n_shared_experts

    @classmethod
    def from_hf(cls, text_config: dict, vision_width: int = 1024
                ) -> "KimiVLConfig":
        """From the published ``text_config`` keys. Settings the port does
        not implement raise rather than run as something else."""
        fixed = {"q_lora_rank": None, "n_group": 1, "topk_group": 1,
                 "moe_layer_freq": 1, "scoring_func": "sigmoid",
                 "topk_method": "noaux_tc", "rope_scaling": None,
                 "attention_bias": False, "tie_word_embeddings": False,
                 "hidden_act": "silu"}
        for k, want in fixed.items():
            if k in text_config and text_config[k] != want:
                raise NotImplementedError(
                    f"kimi_vl: {k}={text_config[k]!r} is not implemented "
                    f"(only {want!r})")
        keys = set(cls._fields) - {"vision_width", "merge", "projector_eps"}
        return cls(vision_width=vision_width,
                   **{k: text_config[k] for k in keys if k in text_config})


KIMI_VL_A3B = KimiVLConfig()


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------
def param_shapes(cfg: KimiVLConfig) -> dict:
    """{path: shape} of every leaf of ``{"lm": ..., "projector": ...}``."""
    d, h, v = cfg.hidden_size, cfg.num_attention_heads, cfg.vocab_size
    L, Ld, Lm = (cfg.num_hidden_layers, cfg.first_k_dense_replace,
                 cfg.n_moe_layers)
    e, fe, fs, f = (cfg.n_routed_experts, cfg.moe_intermediate_size,
                    cfg.shared_width, cfg.intermediate_size)
    w4 = cfg.vision_width * cfg.merge ** 2
    return {
        "lm/embed": (v, d),
        "lm/layers/attn_norm": (L, d), "lm/layers/mlp_norm": (L, d),
        "lm/layers/wq": (L, d, h * cfg.q_head_dim),
        "lm/layers/wkva": (L, d, cfg.latent_width),
        "lm/layers/kv_norm": (L, cfg.kv_lora_rank),
        "lm/layers/wkvb": (L, cfg.kv_lora_rank,
                           h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
        "lm/layers/wo": (L, h * cfg.v_head_dim, d),
        "lm/dense/w_gate": (Ld, d, f), "lm/dense/w_up": (Ld, d, f),
        "lm/dense/w_down": (Ld, f, d),
        "lm/moe/router": (Lm, d, e), "lm/moe/router_bias": (Lm, e),
        "lm/moe/w_gate": (Lm, e, d, fe), "lm/moe/w_up": (Lm, e, d, fe),
        "lm/moe/w_down": (Lm, e, fe, d),
        "lm/moe/shared_gate": (Lm, d, fs), "lm/moe/shared_up": (Lm, d, fs),
        "lm/moe/shared_down": (Lm, fs, d),
        "lm/norm": (d,), "lm/lm_head": (d, v),
        "projector/ln_scale": (cfg.vision_width,),
        "projector/ln_bias": (cfg.vision_width,),
        "projector/w1": (w4, w4), "projector/b1": (w4,),
        "projector/w2": (w4, d), "projector/b2": (d,),
    }


def is_norm_scale(path: str) -> bool:
    return path.endswith(("_norm", "/norm", "ln_scale"))


def put(tree: dict, path: str, value) -> None:
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def init_kimi_vl_params(generator: torch.Generator, cfg: KimiVLConfig,
                        device=None, dtype=torch.float32,
                        std: float = 0.02) -> dict:
    """Random ``{"lm", "projector"}`` weights from ``generator`` (drawn on
    the CPU), on ``device``: matrices, biases and the router's correction
    bias N(0, std), norm scales 1, the projector's LayerNorm bias 0."""
    tree: dict = {}
    for path, shape in param_shapes(cfg).items():
        if is_norm_scale(path):
            leaf = torch.ones(shape)
        elif path.endswith("ln_bias"):
            leaf = torch.zeros(shape)
        else:
            leaf = torch.randn(shape, generator=generator) * std
        put(tree, path, leaf.to(device=device, dtype=dtype))
    return tree


def prepare(lm: dict, cfg: KimiVLConfig) -> tuple:
    """Each layer's operands, made once per captioner so that a step slices
    nothing: views of the weights, the router in f32 (it runs in f32, as
    published), and the two halves of ``wkvb`` for the absorbed decode,
    ``w_uk_t`` (H, nope, rank) and ``w_uv`` (H, rank, v). → a tuple of one
    dict a layer; a dense layer's holds ``dense``, an expert layer's
    ``moe``."""
    lay, nd = lm["layers"], cfg.first_k_dense_replace
    h, nope = cfg.num_attention_heads, cfg.qk_nope_head_dim
    w = lay["wkvb"].reshape(cfg.num_hidden_layers, cfg.kv_lora_rank, h,
                            nope + cfg.v_head_dim)
    w_uk_t = w[..., :nope].permute(0, 2, 3, 1).contiguous()
    w_uv = w[..., nope:].permute(0, 2, 1, 3).contiguous()
    out = []
    for i in range(cfg.num_hidden_layers):
        p = {k: v[i] for k, v in lay.items()}
        p.update(w_uk_t=w_uk_t[i], w_uv=w_uv[i])
        if i < nd:
            p["dense"] = {k: v[i] for k, v in lm["dense"].items()}
        else:
            m = {k: v[i - nd] for k, v in lm["moe"].items()}
            m["router"] = m["router"].float()
            m["router_bias"] = m["router_bias"].float()
            p["moe"] = m
        out.append(p)
    return tuple(out)


# ----------------------------------------------------------------------
# the projector
# ----------------------------------------------------------------------
def merge_patches(x: torch.Tensor, merge: int) -> torch.Tensor:
    """(B, N, w) patches of a square grid → (B, N / merge², merge² · w):
    each ``merge`` x ``merge`` block's patches concatenated row-major, the
    blocks in row-major order (the published ``patch_merger``)."""
    b, n, w = x.shape
    g = math.isqrt(n)
    if g * g != n or g % merge:
        raise ValueError(f"{n} patches are no square grid divisible by "
                         f"{merge}")
    k = g // merge
    x = x.reshape(b, k, merge, k, merge, w).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, k * k, merge * merge * w)


def project_patches(pp: dict, cfg: KimiVLConfig,
                    features: torch.Tensor) -> torch.Tensor:
    """The vision tower's last hidden state (B, N + 1, w), CLS first →
    image tokens (B, N / merge², D): the CLS row dropped, each patch
    LayerNormed, merged, then ``Linear -> GELU (erf) -> Linear``."""
    x = layer_norm({"scale": pp["ln_scale"], "bias": pp["ln_bias"]},
                   features[:, 1:], cfg.projector_eps)
    x = merge_patches(x, cfg.merge).to(pp["w1"].dtype)
    x = F.gelu(x @ pp["w1"] + pp["b1"])
    return x @ pp["w2"] + pp["b2"]


# ----------------------------------------------------------------------
# the language model
# ----------------------------------------------------------------------
def rope_tables(positions: torch.Tensor, cfg: KimiVLConfig) -> torch.Tensor:
    """(T, rope dim / 2) unit complex numbers at ``positions`` (T,): pair i
    turns by θ^(-2i/d) · position."""
    d = cfg.qk_rope_head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, d, 2, dtype=torch.int64, device=positions.device).float() / d))
    freqs = positions.float()[:, None] * inv[None]
    return torch.polar(torch.ones_like(freqs), freqs)


def _layer(p: dict, cfg: KimiVLConfig, x: torch.Tensor, attend,
           phase: str) -> torch.Tensor:
    """One layer on the f32 residual stream ``x`` (B, T, D); its branches
    run in the weights' dtype."""
    eps = cfg.rms_norm_eps
    with span("mit.lm.mla"):
        x = x + attend(rms_norm(x, p["attn_norm"], eps))
    b, t, d = x.shape
    h = rms_norm(x, p["mlp_norm"], eps).reshape(b * t, d)
    if "dense" in p:
        dn = p["dense"]
        f = swiglu(h, dn["w_gate"], dn["w_up"], dn["w_down"])
    else:
        m = p["moe"]
        f = moe_layer(h, m["router"], m["router_bias"], m["w_gate"],
                      m["w_up"], m["w_down"], m["shared_gate"],
                      m["shared_up"], m["shared_down"],
                      cfg.num_experts_per_tok, cfg.routed_scaling_factor,
                      cfg.norm_topk_prob, phase)
    return x + f.reshape(b, t, d)


def _logits(lm: dict, cfg: KimiVLConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, D) last hidden rows → (B, V) logits in f32 (``lm_head`` in the
    weights' dtype, then upcast, as published)."""
    return (rms_norm(x, lm["norm"], cfg.rms_norm_eps) @ lm["lm_head"]).float()


def lm_prefill(lm: dict, cfg: KimiVLConfig, layers: tuple,
               x: torch.Tensor, cache: torch.Tensor, tables) -> torch.Tensor:
    """Input embeddings (B, T, D) at positions 0..T-1 → the last
    position's logits (B, V); writes every layer's latent rows into
    ``cache`` (L, B, S, rank + rope) at 0..T-1. ``layers`` from
    :func:`prepare`; ``tables``: ``rope_tables`` of positions 0..S-1."""
    cis = tables[:x.shape[1]]
    x = x.float()
    for i, p in enumerate(layers):
        attend = lambda h, p=p, c=cache[i]: mla_prefill(p, h, cfg, cis, c)
        x = _layer(p, cfg, x, attend, "prefill")
    return _logits(lm, cfg, x[:, -1])


def lm_step(lm: dict, cfg: KimiVLConfig, layers: tuple,
            tokens: torch.Tensor, pos: torch.Tensor, cache: torch.Tensor,
            tables: torch.Tensor) -> torch.Tensor:
    """One decode step: ``tokens`` (B,) at position ``pos`` (a 0-dim int64
    tensor on the device, every row the same) → logits (B, V); each layer's
    fresh latent row goes into ``cache`` at ``pos`` and its attention reads
    the whole cache with the positions past ``pos`` masked. Every shape is
    fixed and ``pos`` is read on the device, so the step replays from a CUDA
    graph (:class:`DecodeSteps`)."""
    x = lm["embed"][tokens][:, None].float()
    cis = tables.index_select(0, pos.view(1))
    future = torch.arange(cache.shape[2], device=cache.device) > pos
    for i, p in enumerate(layers):
        attend = lambda h, p=p, c=cache[i]: mla_decode(p, h, cfg, cis, c,
                                                       pos, future)
        x = _layer(p, cfg, x, attend, "decode")
    return _logits(lm, cfg, x[:, 0])


def init_cache(cfg: KimiVLConfig, batch: int, length: int, device,
               dtype) -> torch.Tensor:
    """The latent cache: (layers, B, length, rank + rope) — ``c_kv`` after
    its RMSNorm and ``k_pe`` after RoPE."""
    return torch.zeros((cfg.num_hidden_layers, batch, length,
                        cfg.latent_width), device=device, dtype=dtype)


class DecodeState:
    """The decode loop's buffers for one (batch, length, new tokens, dtype,
    device): the latent cache, the RoPE table, the token fed next, its
    position, the column it goes to and the generated ids (-1 where none).
    A step reads and advances them in place (:func:`decode_step`)."""

    def __init__(self, cfg: KimiVLConfig, batch: int, length: int,
                 new_tokens: int, dtype, device):
        self.cache = init_cache(cfg, batch, length, device, dtype)
        self.tables = rope_tables(torch.arange(length, device=device), cfg)
        long = dict(dtype=torch.int64, device=device)
        self.tok = torch.zeros(batch, **long)
        self.pos = torch.zeros((), **long)
        self.col = torch.zeros((), **long)
        self.out = torch.full((batch, new_tokens), -1, **long)

    def start(self, first: torch.Tensor, pos: int) -> None:
        """After the prefill: ``first`` (B,) generated, fed next at
        ``pos``."""
        self.tok.copy_(first)
        self.pos.fill_(pos)
        self.col.fill_(1)
        self.out.fill_(-1)
        self.out[:, 0] = first


def decode_step(lm: dict, cfg: KimiVLConfig, layers: tuple,
                st: DecodeState) -> None:
    """One greedy step on ``st``, in place: the argmax goes into ``st.out``
    and becomes the next token; position and column advance."""
    logits = lm_step(lm, cfg, layers, st.tok, st.pos, st.cache, st.tables)
    st.tok.copy_(logits.argmax(-1))
    st.out.index_copy_(1, st.col.view(1), st.tok[:, None])
    st.pos.add_(1)
    st.col.add_(1)


class DecodeSteps(GraphHolder):
    """How one captioner runs its decode steps, under the rule of
    :mod:`mit_tpu_torch.utils.cuda_graphs`: on the card the first shape
    (batch, length, new tokens, dtype) it meets is captured as one CUDA
    graph of :func:`decode_step` on a :class:`DecodeState` kept here, and
    every later call of that shape replays it: the step's 2,000-odd
    launches in one call, so the host's issue no longer holds the card.
    Any other shape, and CPU tensors, step eagerly on a fresh state. The
    capture's warm-up builds and warms every kernel and the expert layer's
    device-side sums. A replay runs none of the step's Python: the expert
    layer's device-side counters count its work, its host launch counter
    does not, and spans inside the step reach a trace at the warm-up only.
    ``graph_replays`` counts steps replayed."""

    def bind(self, lm: dict, cfg: KimiVLConfig, layers: tuple, key: tuple):
        """→ (state, step) for one generation of ``key`` = (batch, length,
        new tokens, dtype, device)."""
        def build():
            st = DecodeState(cfg, *key)
            graph, _ = capture(lambda: decode_step(lm, cfg, layers, st),
                               key[-1])
            self.graph_captures += 1
            return st, graph

        held = self.held_for(key if key[-1].type == "cuda" else None, build)
        if held is not None:
            st, graph = held
            return st, lambda: self.replay(graph)
        st = DecodeState(cfg, *key)

        def step():
            self.eager_steps += 1
            decode_step(lm, cfg, layers, st)
        return st, step


def greedy_generate_vlm(lm: dict, cfg: KimiVLConfig, layers: tuple,
                        image_tokens: torch.Tensor, prompt_ids: torch.Tensor,
                        max_new_tokens: int, end_id: Optional[int] = None,
                        steps: Optional[DecodeSteps] = None) -> torch.Tensor:
    """Greedy decoding after ``[image tokens; prompt]``: a prefill over the
    prefix, then one cached step a token. → (B, max_new_tokens) int64 ids;
    with ``end_id`` (not None, >= 0) a row holds -1 after its END and the
    loop stops once every row has ended (one host check a step). ``steps``
    (one a caller, kept across calls) graphs the steps on the card; without
    it every step runs eagerly."""
    b = image_tokens.shape[0]
    dev = image_tokens.device
    prompt = prompt_ids.to(dev).long()
    if prompt.dim() == 1:
        prompt = prompt[None].expand(b, -1)
    x = torch.cat([image_tokens.to(lm["embed"].dtype), lm["embed"][prompt]],
                  dim=1)
    t0 = x.shape[1]
    length = t0 + max_new_tokens - 1
    if length > cfg.max_position_embeddings:
        raise ValueError("the sequence outgrows max_position_embeddings")
    key = (b, length, max_new_tokens, x.dtype, dev)
    if steps is None:
        st = DecodeState(cfg, *key)
        step = lambda: decode_step(lm, cfg, layers, st)
    else:
        st, step = steps.bind(lm, cfg, layers, key)
    with span("mit.lm.prefill"):
        first = lm_prefill(lm, cfg, layers, x, st.cache, st.tables).argmax(-1)
    st.start(first, t0)
    ending = end_id is not None and end_id >= 0
    for j in range(1, max_new_tokens):
        if ending and bool((st.out[:, :j] == end_id).any(1).all()):
            break
        with span("mit.lm.step"):
            step()
    out = st.out.clone()
    if ending:
        hit = (out == end_id).int()
        out[(hit.cumsum(1) - hit) > 0] = -1
    return out
