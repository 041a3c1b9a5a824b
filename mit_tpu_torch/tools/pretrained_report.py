"""Pretrained-encoder parity runbook (port of ``scripts/pretrained_report.py``).

    python -m mit_tpu_torch.tools.pretrained_report [--out FILE] \
        [--families vit,clip,blip] [--checkpoint ckpt.safetensors] \
        [--image test.jpg] [--device cuda]

For each encoder family (vit, clip, blip: ``FAMILIES``):

1. the weights are resolved through :mod:`mit_tpu_torch.models.pretrained`
   from local files only (``MIT_ALLOW_DOWNLOAD=1`` lets a repo id be
   fetched), first from ``MIT_WEIGHTS_DIR`` (:func:`local_weights_dir`);
2. they run in the port's tower (:func:`vision_forward`, its kernels on the
   card) and in Hugging Face's own torch model (on the CPU) on the same
   seeded pixels, and ``last_hidden_state`` is compared (``FEATURE_TOL``
   relative to the output's scale).

With ``--checkpoint`` (a reference-layout ``.safetensors``), the greedy
captions of the port's KV-cached ``greedy_generate`` are compared token for
token with a torch rebuild of the reference's uncached loop
(:func:`_torch_reference_model`) and with the port's own uncached oracle
(``greedy_generate_uncached``), all three from the same checkpoint bytes.

One JSON report is written (``--out``, default ``pretrained_report_torch.json``
in the working directory): each family ``{"status": "match" | "mismatch" |
"SKIP", ...}`` and ``caption_parity`` likewise. ``SKIP`` always carries its
reason: weights that do not resolve, or ``transformers`` missing (it is
imported only inside the functions that need it, and the card's machine does
not promise it). The exit code is 1 on a mismatch, else 0. The towers run on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

FAMILIES = {
    "vit": "google/vit-base-patch16-224-in21k",
    "clip": "openai/clip-vit-base-patch32",
    "blip": "Salesforce/blip-image-captioning-base",
}

# f32 forwards of the same weights differ by the order of their sums; twelve
# layers bring that to about 1e-4 on activations of unit scale
FEATURE_TOL = 5e-3


def local_weights_dir(repo: str, family: str) -> "str | None":
    """The directory under ``MIT_WEIGHTS_DIR`` that holds this family's
    weights (``config.json`` and weights, as ``save_pretrained`` writes
    them), at ``<org>/<name>``, ``<org>--<name>``, ``<name>`` or
    ``<family>``, in that order; None without one."""
    root = os.environ.get("MIT_WEIGHTS_DIR")
    if not root:
        return None
    for cand in (repo, repo.replace("/", "--"), os.path.basename(repo), family):
        p = os.path.join(root, cand)
        if os.path.isdir(p):
            return p
    return None


def _hf_last_hidden(src: str, family: str, pixels: np.ndarray,
                    local_only: bool) -> np.ndarray:
    """Hugging Face's torch vision tower of ``src`` → last_hidden_state, on
    the CPU (the reference side)."""
    if family == "clip":
        from transformers import CLIPVisionModel

        model = CLIPVisionModel.from_pretrained(src, local_files_only=local_only)
    elif family == "blip":
        from transformers import BlipForConditionalGeneration

        model = BlipForConditionalGeneration.from_pretrained(
            src, local_files_only=local_only).vision_model
    else:
        from transformers import ViTModel

        model = ViTModel.from_pretrained(src, add_pooling_layer=False,
                                         local_files_only=local_only)
    with torch.no_grad():
        out = model.eval()(pixel_values=torch.from_numpy(pixels))
    return out.last_hidden_state.float().numpy()


def _transformers_missing() -> "str | None":
    try:
        import transformers  # noqa: F401
    except Exception as e:      # any failure to import is a reason to skip
        return f"transformers is not importable ({type(e).__name__}): {e}"
    return None


def check_family(family: str, repo: str, allow_download: bool,
                 device="cuda") -> dict:
    """Resolve, run both towers, compare. Never raises: a failure to resolve
    or to build Hugging Face's side is a ``SKIP`` with its reason."""
    from mit_tpu_torch.models.pretrained import load_pretrained_encoder
    from mit_tpu_torch.models.vision import vision_forward

    local_only = not allow_download
    src = local_weights_dir(repo, family) or repo
    try:
        vcfg, params = load_pretrained_encoder(
            src, family=family, local_files_only=local_only, device=device)
    except Exception as e:      # the record says why
        return {"status": "SKIP",
                "reason": f"weights unreachable ({type(e).__name__}): {e}",
                "repo": repo, "source": src}
    geometry = {"hidden": vcfg.hidden_size, "layers": vcfg.num_layers,
                "seq_len": vcfg.seq_len}
    missing = _transformers_missing()
    if missing:
        return {"status": "SKIP", "reason": missing, "repo": repo,
                "source": src, "loaded_geometry": geometry}

    rng = np.random.default_rng(0)
    pixels = rng.normal(size=(2, 3, vcfg.image_size, vcfg.image_size)).astype(
        np.float32)
    with torch.no_grad():
        ours = vision_forward(params, vcfg, torch.from_numpy(pixels).to(device))
    ours = ours.cpu().numpy()
    try:
        theirs = _hf_last_hidden(src, family, pixels, local_only)
    except Exception as e:      # the record says why
        return {"status": "SKIP",
                "reason": "the port's tower loaded, but Hugging Face's torch "
                          f"side did not ({type(e).__name__}): {e}",
                "repo": repo, "source": src, "loaded_geometry": geometry}
    max_abs = float(np.abs(ours - theirs).max())
    scale = float(np.abs(theirs).max())
    return {
        "status": ("match" if max_abs <= FEATURE_TOL * max(1.0, scale)
                   else "mismatch"),
        "repo": repo,
        "source": src,
        "last_hidden_max_abs_err": max_abs,
        "last_hidden_scale": scale,
        "cls_max_abs_err": float(np.abs(ours[:, 0] - theirs[:, 0]).max()),
        "shape": list(ours.shape),
    }


# ----------------------------------------------------------------------
# caption parity on a reference-layout checkpoint
# ----------------------------------------------------------------------
def _torch_reference_model(sd: dict, cfg, vcfg):
    """The reference's image-to-text model rebuilt in torch (a transformers
    ``ViTModel``, a projection and ``nn.TransformerDecoder``), its state
    dict loaded from the reference-layout checkpoint; its
    ``generate_greedy`` is the reference's uncached loop."""
    import torch.nn as nn
    from transformers import ViTConfig, ViTModel

    d_dec = cfg.DECODER_EMBED_DIM
    vocab = sd["decoder.token_embedding.weight"].shape[0]

    class Dec(nn.Module):
        def __init__(self):
            super().__init__()
            self.token_embedding = nn.Embedding(vocab, d_dec, padding_idx=0)
            layer = nn.TransformerDecoderLayer(
                d_model=d_dec, nhead=cfg.DECODER_HEADS,
                dim_feedforward=cfg.DECODER_FF_DIM, dropout=0.0,
                batch_first=True)
            self.transformer_decoder = nn.TransformerDecoder(
                layer, cfg.DECODER_LAYERS)
            self.fc_out = nn.Linear(d_dec, vocab)
            pos = torch.arange(cfg.MAX_SEQ_LEN).unsqueeze(1)
            div = torch.exp(torch.arange(0, d_dec, 2)
                            * (-math.log(10000.0) / d_dec))
            pe = torch.zeros(cfg.MAX_SEQ_LEN, d_dec)
            pe[:, 0::2] = torch.sin(pos * div)
            pe[:, 1::2] = torch.cos(pos * div)
            # not persistent: the table is a function of its shape; the
            # reference's checkpoints hold it as `decoder.pos_encoder.pe`
            # and the port's do not, and both load
            self.register_buffer("pe", pe.unsqueeze(0), persistent=False)

        def forward(self, tgt, memory):
            t = tgt.size(1)
            causal = (torch.triu(torch.ones(t, t)) == 1).transpose(0, 1)
            causal = (causal.float()
                      .masked_fill(causal == 0, float("-inf"))
                      .masked_fill(causal == 1, 0.0))
            x = self.token_embedding(tgt) * math.sqrt(d_dec)
            x = x + self.pe[:, :t, :]
            out = self.transformer_decoder(
                tgt=x, memory=memory, tgt_mask=causal,
                tgt_key_padding_mask=tgt == 0)
            return self.fc_out(out)

    class Ref(nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = ViTModel(
                ViTConfig(hidden_size=vcfg.hidden_size,
                          num_hidden_layers=vcfg.num_layers,
                          num_attention_heads=vcfg.num_heads,
                          intermediate_size=vcfg.intermediate_size,
                          image_size=vcfg.image_size,
                          patch_size=vcfg.patch_size),
                add_pooling_layer=False)
            enc_dim = vcfg.hidden_size
            self.projection = (nn.Linear(enc_dim, d_dec) if enc_dim != d_dec
                               else nn.Identity())
            self.decoder = Dec()

        def generate_greedy(self, pixels, start_id, end_id, max_len):
            # the reference's uncached greedy loop, one image
            with torch.no_grad():
                feats = self.encoder(
                    pixel_values=pixels).last_hidden_state[:, 0, :]
                memory = self.projection(feats).unsqueeze(1)
                ids = torch.tensor([[start_id]], dtype=torch.long)
                for _ in range(max_len - 1):
                    logits = self.decoder(ids, memory)
                    nxt = torch.argmax(logits[:, -1, :], dim=-1).unsqueeze(0)
                    ids = torch.cat([ids, nxt], dim=1)
                    if nxt.item() == end_id:
                        break
            return ids[0].tolist()

    model = Ref()
    tensors = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()}
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    # the positional table is the one difference allowed
    leftovers = [k for k in list(missing) + list(unexpected)
                 if ".pe" not in k and "pos_encoder" not in k]
    if leftovers:
        raise RuntimeError(f"state-dict mismatch beyond the pe buffer: "
                           f"{leftovers[:6]}")
    return model.eval()


def check_captions(ckpt_path: str, image_path: "str | None", cfg=None,
                   device="cuda") -> dict:
    """One image's greedy captions, token for token: the reference's loop
    rebuilt in torch (on the CPU), the port's KV-cached ``greedy_generate``
    and its uncached oracle (on ``device``), all from the checkpoint at
    ``ckpt_path``. ``cfg`` defaults to the package's ``CONFIG``."""
    from mit_tpu_torch.config import CONFIG
    from mit_tpu_torch.decode.greedy import (
        greedy_generate,
        greedy_generate_uncached,
    )
    from mit_tpu_torch.models.model import (
        ModelConfig,
        encode_images,
        project_features,
    )
    from mit_tpu_torch.models.pretrained import load_state_dict
    from mit_tpu_torch.train.checkpoint import params_from_reference_state_dict

    cfg = cfg or CONFIG
    try:
        sd = load_state_dict(ckpt_path)
        sd = {k: np.asarray(v.float().numpy() if hasattr(v, "numpy") else v)
              for k, v in sd.items()}
        vocab = int(sd["decoder.token_embedding.weight"].shape[0])
        mcfg = ModelConfig.build(cfg, vocab_size=vocab)
        params = params_from_reference_state_dict(sd, mcfg, device)
    except Exception as e:      # the record says why
        return {"status": "SKIP",
                "reason": f"checkpoint not loadable ({type(e).__name__}): {e}"}
    missing = _transformers_missing()
    if missing:
        return {"status": "SKIP", "reason": missing, "checkpoint": ckpt_path}
    tm = _torch_reference_model(sd, cfg, mcfg.vision)

    if image_path and os.path.isfile(image_path):
        from PIL import Image

        from mit_tpu_torch.data.preprocess import HostPreprocessor

        with Image.open(image_path) as im:
            pixels = HostPreprocessor(cfg.ENCODER_MODEL_NAME)(im)[None]
        img_src = image_path
    else:
        pixels = np.random.default_rng(0).normal(
            size=(1, 3, mcfg.vision.image_size, mcfg.vision.image_size)
        ).astype(np.float32)
        img_src = "random-noise image (no --image supplied)"

    start_id, end_id = cfg.START_TOKEN_ID, cfg.END_TOKEN_ID
    pad_id, max_len = cfg.PAD_TOKEN_ID, cfg.MAX_SEQ_LEN
    ref_tokens = tm.generate_greedy(torch.from_numpy(pixels), start_id,
                                    end_id, max_len)
    with torch.no_grad():
        feats = encode_images(params, mcfg,
                              torch.from_numpy(pixels).to(device))
        memory = project_features(params, mcfg, feats)
    tokens, lengths = greedy_generate(params["decoder"], mcfg.decoder, memory,
                                      start_id, end_id, pad_id, max_len)
    ours = tokens[0, :int(lengths[0])].tolist()
    oracle = greedy_generate_uncached(params["decoder"], mcfg.decoder, memory,
                                      start_id, end_id, pad_id, max_len)
    uncached = [t for t in oracle[0].tolist() if t != pad_id]
    same = ours == ref_tokens == uncached
    return {
        "status": "match" if same else "mismatch",
        "checkpoint": ckpt_path,
        "image": img_src,
        "reference_tokens": ref_tokens,
        "our_tokens": ours,
        "uncached_tokens": uncached,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="pretrained_report_torch.json",
                    help="Report path (default: in the working directory).")
    ap.add_argument("--checkpoint", default=None,
                    help="Reference-layout .safetensors for caption parity.")
    ap.add_argument("--image", default=None,
                    help="Image for the caption-parity check.")
    ap.add_argument("--families", default="vit,clip,blip")
    ap.add_argument("--device", default="cuda",
                    help="Device of the port's side (default: cuda; cpu "
                         "only when asked for).")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device cpu to run "
                           "the runbook on the CPU")

    allow = os.environ.get("MIT_ALLOW_DOWNLOAD", "0") == "1"
    report = {"allow_download": allow, "device": args.device, "families": {}}
    for fam in args.families.split(","):
        fam = fam.strip()
        repo = FAMILIES[fam]
        print(f"[{fam}] {repo} ...", flush=True)
        rec = check_family(fam, repo, allow, args.device)
        print(f"[{fam}] {rec['status']}"
              + (f" ({rec.get('reason', '')})" if rec["status"] == "SKIP"
                 else f" max|d|={rec.get('last_hidden_max_abs_err'):.2e}"))
        report["families"][fam] = rec

    if args.checkpoint:
        print(f"[captions] {args.checkpoint} ...", flush=True)
        rec = check_captions(args.checkpoint, args.image, device=args.device)
        print(f"[captions] {rec['status']}")
        report["caption_parity"] = rec
    else:
        report["caption_parity"] = {
            "status": "SKIP",
            "reason": "no --checkpoint supplied (pass a reference-layout "
                      ".safetensors to compare captions)"}

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"Report written to {args.out}")
    statuses = [r["status"] for r in report["families"].values()]
    statuses.append(report["caption_parity"]["status"])
    return 1 if "mismatch" in statuses else 0


if __name__ == "__main__":
    sys.exit(main())
