"""Linear probes of the gate's frozen CLS feature, per attribute (port of
the repository's ``scripts/gate_probe.py``).

    python -m mit_tpu_torch.tools.gate_probe [--n_per 64] [--steps 400] \
        [--output FILE] [--device cuda]

How much of colour, shape and position a frozen random-init ViT-B CLS
feature (the gate's default model, drawn from seed 0) carries: for each
render variant it renders ``n_per`` labelled images a shape, encodes them
in bf16 (``device_preprocess`` on uint8, then the encoder), fits a
multinomial logistic probe a attribute by full-batch gradient descent on
80 % of them and reports its accuracy on the rest. A probe near chance
means no decoder training can caption that attribute.

Variants: ``current`` (the JAX gate's first render: s in [26, 38), a noisy
background), ``big`` (s in [48, 64)), ``cleanbg`` (a constant grey
background) and ``big_clean`` (both; the gate's render since).

Prints one JSON line; with ``--output`` it also writes it there (it writes
nothing else). Runs on a CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from mit_tpu_torch.tools import compositional_gate as cg

VARIANTS = {
    "current": (26, 38, True),
    "big": (48, 64, True),
    "cleanbg": (26, 38, False),
    "big_clean": (48, 64, False),
}


def render_variant(rng, color_rgb, shape, pos_yx, s_lo, s_hi, noisy_bg):
    """One 224 x 224 uint8 image of a variant."""
    img = (rng.integers(95, 160, (224, 224, 3)) if noisy_bg
           else np.full((224, 224, 3), 127)).astype(np.uint8)
    cy = int(pos_yx[0] + rng.integers(-12, 13))
    cx = int(pos_yx[1] + rng.integers(-12, 13))
    s = int(rng.integers(s_lo, s_hi))
    m = cg.shape_mask(shape, cy, cx, s)
    jitter = np.clip(
        np.asarray(color_rgb, np.int16) + rng.integers(-20, 21, 3), 0, 255
    ).astype(np.uint8)
    img[m] = jitter
    return img


def variant_images(n_per: int, s_lo: int, s_hi: int, noisy: bool):
    """(uint8 images (N, 224, 224, 3), labels {attribute: (N,)}): ``n_per``
    a shape, colour and position drawn uniformly, from seed 11."""
    colors, shapes, positions = list(cg.COLORS), list(cg.SHAPES), \
        list(cg.POSITIONS)
    rng = np.random.default_rng(11)
    imgs, lab = [], {"color": [], "shape": [], "position": []}
    for si, shape in enumerate(shapes):
        for _ in range(n_per):
            ci = int(rng.integers(0, len(colors)))
            pi = int(rng.integers(0, len(positions)))
            imgs.append(render_variant(
                rng, cg.COLORS[colors[ci]], shape,
                cg.POSITIONS[positions[pi]], s_lo, s_hi, noisy))
            lab["color"].append(ci)
            lab["shape"].append(si)
            lab["position"].append(pi)
    return np.stack(imgs), {k: np.asarray(v) for k, v in lab.items()}


def fit(xtr: np.ndarray, ytr: np.ndarray, n_cls: int, steps: int):
    """(w, b) of a multinomial logistic regression with an L2 term of
    1e-3, by ``steps`` full-batch gradient steps of 0.5 from zeros (f32)."""
    import torch

    x = torch.from_numpy(np.asarray(xtr, np.float32))
    y = torch.from_numpy(np.asarray(ytr, np.int64))
    w = torch.zeros((x.shape[1], n_cls), requires_grad=True)
    b = torch.zeros((n_cls,), requires_grad=True)
    for _ in range(steps):
        lp = torch.log_softmax(x @ w + b, dim=-1)
        nll = -lp.gather(1, y[:, None])[:, 0].mean()
        loss = nll + 1e-3 * (w * w).sum()
        gw, gb = torch.autograd.grad(loss, (w, b))
        with torch.no_grad():
            w -= 0.5 * gw
            b -= 0.5 * gb
    return w.detach().numpy(), b.detach().numpy()


def probe(x, y, n_cls: int, rng_np, steps: int) -> float:
    """Held-out accuracy of a probe fit on a random 80 % of (x, y),
    features standardized by the fitting part's mean and std."""
    n = len(x)
    idx = rng_np.permutation(n)
    n_tr = int(0.8 * n)
    tr, te = idx[:n_tr], idx[n_tr:]
    mu, sd = x[tr].mean(0), x[tr].std(0) + 1e-6
    xn = (x - mu) / sd
    w, b = fit(xn[tr], y[tr], n_cls, steps)
    pred = np.argmax(xn[te] @ w + b, axis=1)
    return float((pred == y[te]).mean())


def cls_features(u8: np.ndarray, device: str = "cuda",
                 batch: int = 64) -> np.ndarray:
    """(N, 768) f32 CLS features of uint8 images through the default
    model's frozen random encoder (seed 0), in bf16."""
    import torch

    from mit_tpu_torch.config import Config
    from mit_tpu_torch.data.preprocess import device_preprocess
    from mit_tpu_torch.models.model import (
        ModelConfig,
        encode_images,
        init_model_params,
    )

    cfg = Config()
    mcfg = ModelConfig.build(cfg, vocab_size=100)
    params = init_model_params(torch.Generator().manual_seed(0), mcfg, device)
    feats = []
    for i in range(0, len(u8), batch):
        px = device_preprocess(torch.from_numpy(u8[i:i + batch]).to(device),
                               cfg.ENCODER_MODEL_NAME)
        f = encode_images(params, mcfg, px, torch.bfloat16)
        feats.append(f.float()[:, 0, :].cpu().numpy())
    return np.concatenate(feats)


def run(n_per: int = 64, steps: int = 400, device: str = "cuda",
        features=None) -> dict:
    """The probe line over every variant; ``features(u8, device)`` gives
    the images' features (default :func:`cls_features`)."""
    features = features or cls_features
    out = {"metric": "gate_cls_probe",
           "n_images_per_variant": n_per * len(cg.SHAPES),
           "encoder": "frozen random ViT-B (the gate's flagship config)"}
    sizes = {"color": len(cg.COLORS), "shape": len(cg.SHAPES),
             "position": len(cg.POSITIONS)}
    for name, (s_lo, s_hi, noisy) in VARIANTS.items():
        u8, lab = variant_images(n_per, s_lo, s_hi, noisy)
        x = features(u8, device)
        rng_np = np.random.default_rng(3)
        out[name] = {f"{k}_acc": round(probe(x, lab[k], n, rng_np, steps), 4)
                     for k, n in sizes.items()}
        print(f"{name}: {out[name]}", file=sys.stderr)
    out["chance"] = {k: round(1 / n, 3) for k, n in sizes.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_per", type=int, default=64,
                    help="images per shape class per variant; colours and "
                    "positions drawn uniformly")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--output", default=None,
                    help="also write the JSON line to this file")
    ap.add_argument("--device", default="cuda",
                    help="default: cuda; cpu only when asked")
    args = ap.parse_args(argv)
    out = run(args.n_per, args.steps, args.device)
    line = json.dumps(out)
    print(line)
    if args.output:
        with open(args.output, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
