"""A trained port checkpoint decoded by both packages, and the JAX loop
trained from the port's initial weights: the two checks that tell a fault
of the port's decoding or training from a property of the gate's recipe
(the seed-42 draw that collapses under ``mit_tpu_torch.tools.gate_draws``).

The weights cross with :func:`to_jax`, numpy in the JAX package's pytree
(the port keeps that layout, so ``params_to_jax`` is the inverse of
``models.convert.params_from_jax``), then ``jnp.asarray``.

Run as a script (the JAX package runs on the CPU):

    JAX_PLATFORMS=cpu python tests/test_torch_f3.py decode SEED_DIR \
        [--seed 42] [--out FILE]

captions the train-val split of a ``gate_draws`` seed directory with its
best-val checkpoint, in f32 on the CPU, by the port's ``Captioner`` and by
the JAX package's on the same memory, and prints one JSON line: whether the
tokens agree, the caption lengths, and each package's teacher-forced
argmax accuracy and loss by position.

    JAX_PLATFORMS=cpu python tests/test_torch_f3.py train-jax WORKDIR \
        [--seed 42] [--epochs 12]

trains the JAX loop on ``gate_draws``' corpus and recipe at ``--seed``,
from the port's initial weights at that seed (the encoder, projection and
decoder the port's ``train()`` draws), and prints ``gate_draws``' line for
it with ``"package": "mit_tpu, port init"``.
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

if __name__ == "__main__":          # run as a script: the repository's packages
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from mit_tpu.models import decoder as jdec
from mit_tpu.models import model as jmodel
from mit_tpu_torch.models import decoder as tdec
from mit_tpu_torch.models import model as tmodel
from mit_tpu_torch.models.convert import params_to_jax


def to_jax(params: dict) -> dict:
    """The port's float parameters → the JAX package's pytree of jnp
    arrays, leaf by leaf."""
    return jax.tree.map(jnp.asarray, params_to_jax(params))


def port_initial_params(cfg, vocab_size: int):
    """(mcfg, params) on the CPU exactly as the port's ``train()`` draws
    them at ``cfg.RANDOM_SEED``."""
    from mit_tpu_torch.train.loop import build_model_params

    return build_model_params(
        cfg, tmodel.ModelConfig.build(cfg, vocab_size=vocab_size),
        torch.Generator().manual_seed(cfg.RANDOM_SEED), vocab_size, "cpu")


def checksum(params: dict) -> float:
    """Σ|w| over every leaf in f64: the same draw on two machines."""
    return float(sum(np.abs(x).astype(np.float64).sum()
                     for x in jax.tree.leaves(params_to_jax(params))))


def jax_config(cfg):
    """The JAX package's ``Config`` with every field of the port's."""
    from mit_tpu.config import Config as JConfig

    return JConfig.from_json(cfg.to_json())


def by_position(logits: np.ndarray, targets: np.ndarray, pad_id: int):
    """(argmax accuracy, mean NLL) at each target position over non-PAD
    targets: lists as long as the longest caption."""
    logits = logits.astype(np.float64)
    logp = logits - logits.max(-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
    nll = -np.take_along_axis(logp, targets[..., None], -1)[..., 0]
    hit = logits.argmax(-1) == targets
    real = targets != pad_id
    n = int(real.any(0).nonzero()[0].max()) + 1
    acc = [float(hit[:, t][real[:, t]].mean()) for t in range(n)]
    loss = [float(nll[:, t][real[:, t]].mean()) for t in range(n)]
    return acc, loss


# ----------------------------------------------------------------------
# tests: the converter carries a port model into JAX unchanged
# ----------------------------------------------------------------------
TINY_DEC = dict(vocab_size=40, embed_dim=32, num_heads=4, num_layers=2,
                ff_dim=48, max_seq_len=12, dropout=0.0, pad_idx=0)


def test_converted_decoder_gives_the_ports_logits_and_tokens():
    """A port decoder drawn from a torch generator, carried into JAX:
    teacher-forced logits within 2e-5 and greedy tokens identical, f32."""
    from mit_tpu.decode.greedy import greedy_generate as jgreedy
    from mit_tpu_torch.decode.greedy import greedy_generate as tgreedy

    params = tdec.init_decoder_params(torch.Generator().manual_seed(42),
                                      tdec.DecoderConfig(**TINY_DEC))
    jparams = to_jax(params)
    assert jax.tree.structure(jparams) == jax.tree.structure(
        jdec.init_decoder_params(jax.random.PRNGKey(0),
                                 jdec.DecoderConfig(**TINY_DEC)))
    r = np.random.default_rng(0)
    toks = r.integers(1, 40, (3, 11))
    mem = r.normal(size=(3, 1, 32)).astype(np.float32)
    ours = tdec.decoder_forward(params, tdec.DecoderConfig(**TINY_DEC),
                                torch.from_numpy(toks), torch.from_numpy(mem))
    ref = jdec.decoder_forward(jparams, jdec.DecoderConfig(**TINY_DEC),
                               jnp.asarray(toks, jnp.int32), jnp.asarray(mem))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    t_tok, t_len = tgreedy(params, tdec.DecoderConfig(**TINY_DEC),
                           torch.from_numpy(mem), 2, 3, 0, 12)
    j_tok, j_len = jgreedy(jparams, jdec.DecoderConfig(**TINY_DEC),
                           jnp.asarray(mem), 2, 3, 0, 12)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))


def test_port_initial_params_follow_the_seed_and_cross_whole(monkeypatch):
    """``port_initial_params`` is ``train()``'s draw: the same seed gives
    the same tree, another seed another; the JAX tree has every leaf."""
    from mit_tpu_torch.config import Config
    from mit_tpu_torch.models import vision as tvis

    monkeypatch.setitem(tvis.PRESETS, "tiny/f3-vit", tvis.VisionConfig(
        family="vit", image_size=32, patch_size=16, hidden_size=24,
        num_layers=1, num_heads=2, intermediate_size=32, hidden_act="gelu",
        layer_norm_eps=1e-12, patch_bias=True, ln_pre=False, ln_post=True))
    cfg = Config(ENCODER_MODEL_NAME="tiny/f3-vit", PRETRAINED_ENCODER="off",
                 DECODER_EMBED_DIM=16, DECODER_LAYERS=1, DECODER_HEADS=2,
                 DECODER_FF_DIM=24, MAX_SEQ_LEN=8, RANDOM_SEED=42)
    _, a = port_initial_params(cfg, 30)
    _, b = port_initial_params(cfg, 30)
    _, c = port_initial_params(cfg.replace(RANDOM_SEED=7), 30)
    la, lb, lc = (jax.tree.leaves(params_to_jax(p)) for p in (a, b, c))
    assert all(np.array_equal(x, y) for x, y in zip(la, lb))
    assert not np.array_equal(la[-1], lc[-1]) or not np.array_equal(
        la[0], lc[0])
    assert set(to_jax(a)) == {"encoder", "projection", "decoder"}


# ----------------------------------------------------------------------
# script modes
# ----------------------------------------------------------------------
def decode_both(data_dir: str, seed: int) -> dict:
    """The best-val checkpoint of ``data_dir`` decoded by both packages on
    the train-val split at ``seed``; the JSON line."""
    from PIL import Image

    from mit_tpu.decode.api import Captioner as JCaptioner
    from mit_tpu_torch.config import CONFIG
    from mit_tpu_torch.data.dataset import ImageTextDataset, split_indices
    from mit_tpu_torch.decode.api import load_captioner
    from mit_tpu_torch.tools import compositional_gate as gate
    from mit_tpu_torch.tools import gate_draws

    cfg = gate_draws.recipe(CONFIG, data_dir, seed, gate_draws.EPOCHS)
    ckpt = gate.best_checkpoint(data_dir)
    cap = load_captioner(ckpt, cfg, device="cpu")
    tok = cap.tokenizer
    cfg = cfg.with_tokenizer_ids(tok)
    jcfg = jax_config(cfg)
    jmcfg = jmodel.ModelConfig.build(jcfg, vocab_size=tok.get_vocab_size())
    jcap = JCaptioner(to_jax(cap.params), jmcfg, tok, jcfg, jnp.float32)
    ds = ImageTextDataset(cfg.IMAGE_DIR, cfg.CAPTIONS_FILE, cfg.MAX_SEQ_LEN,
                          tok, cfg.ENCODER_MODEL_NAME, use_native_loader=False)
    _, va = split_indices(len(ds), cfg.TRAIN_SPLIT_RATIO, cfg.RANDOM_SEED)
    paths = [ds.image_paths[i] for i in va]
    images = []
    for p in paths:
        with Image.open(p) as im:
            images.append(im.convert("RGB"))
    mem = cap.memory_from_images(images)                    # (N, 1, D) f32
    t_ids = cap.generate_from_memory(mem, max_len=cfg.MAX_SEQ_LEN)
    j_ids = jcap.generate_from_memory(jnp.asarray(mem.numpy()),
                                      max_len=cfg.MAX_SEQ_LEN)
    # the JAX package's own encoder on its own pixels, for the memory
    j_mem = np.asarray(jcap.memory_from_images(images))
    seq = np.stack([np.asarray(ds.encode_caption(ds.captions[i]))
                    for i in va])
    inp, tgt = seq[:, :-1], seq[:, 1:]
    t_logits = tdec.decoder_forward(
        cap.params["decoder"], cap.mcfg.decoder, torch.from_numpy(inp), mem
    ).numpy()
    j_logits = np.asarray(jdec.decoder_forward(
        jcap.params["decoder"], jmcfg.decoder, jnp.asarray(inp, jnp.int32),
        jnp.asarray(mem.numpy())))
    t_acc, t_loss = by_position(t_logits, tgt, tok.pad_id)
    j_acc, j_loss = by_position(j_logits, tgt, tok.pad_id)
    real = tgt != tok.pad_id
    mean_nll = lambda lg: float(np.mean(by_token_nll(lg, tgt)[real]))
    _, init = port_initial_params(cfg, tok.get_vocab_size())
    return {
        "metric": "f3_decode_both", "checkpoint": os.path.basename(ckpt),
        "seed": seed, "images": len(paths), "init_checksum": checksum(init),
        "tokens_equal": sum(a == b for a, b in zip(t_ids, j_ids)),
        "mean_len_port": float(np.mean([len(x) for x in t_ids])),
        "mean_len_jax": float(np.mean([len(x) for x in j_ids])),
        "memory_max_abs_diff": float(np.abs(j_mem - mem.numpy()).max()),
        "logits_max_abs_diff": float(np.abs(t_logits - j_logits).max()),
        "teacher_forced_loss_port": mean_nll(t_logits),
        "teacher_forced_loss_jax": mean_nll(j_logits),
        "tf_argmax_acc_by_position_port": t_acc,
        "tf_argmax_acc_by_position_jax": j_acc,
        "tf_loss_by_position_port": t_loss,
        "first_captions_port": [cap.postprocess(x) for x in t_ids[:4]],
        "first_captions_jax": [jcap.postprocess(x) for x in j_ids[:4]],
        "first_ids_port": t_ids[:4],
        "first_references": [ds.captions[i] for i in va[:4]],
    }


def by_token_nll(logits: np.ndarray, targets: np.ndarray) -> np.ndarray:
    logits = logits.astype(np.float64)
    logp = logits - logits.max(-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
    return -np.take_along_axis(logp, targets[..., None], -1)[..., 0]


def train_jax_from_port_init(workdir: str, seed: int, epochs: int) -> dict:
    """The JAX loop on ``gate_draws``' corpus and recipe at ``seed``, from
    the port's initial weights; the sweep's line for it."""
    from mit_tpu.config import CONFIG as JCONFIG
    from mit_tpu.train import loop as jloop
    from mit_tpu_torch.config import CONFIG
    from mit_tpu_torch.tools import compositional_gate as gate
    from mit_tpu_torch.tools import gate_draws

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_gate_draws import sweep_jax

    def port_init(cfg, mcfg, key, vocab_size):
        tcfg = gate_draws.recipe(CONFIG, cfg.DATA_DIR, seed, epochs)
        _, params = port_initial_params(tcfg, vocab_size)
        print(f"JAX loop starts from the port's seed-{seed} weights, "
              f"init_checksum {checksum(params)!r}.", flush=True)
        return mcfg, to_jax(params)

    jloop.build_model_params = port_init
    line, = sweep_jax(workdir, (seed,), epochs, gate_draws.PER_COMBO,
                      cfg=JCONFIG)
    line["package"] = "mit_tpu, port init"
    return line


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["decode", "train-jax"])
    ap.add_argument("path")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    os.environ["HF_HUB_OFFLINE"] = "1"
    if args.mode == "decode":
        result = decode_both(os.path.join(args.path, ""), args.seed)
    else:
        result = train_jax_from_port_init(args.path, args.seed, args.epochs)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(result) + "\n")
