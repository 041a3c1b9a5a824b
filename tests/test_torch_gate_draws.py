"""The gate-draws sweep (``mit_tpu_torch.tools.gate_draws``) and its JAX
counterpart, on the CPU at a tiny size; and, run as a script, the JAX
package's loop swept over the same seeds, corpus and recipe at full size:

    JAX_PLATFORMS=cpu python tests/test_torch_gate_draws.py WORKDIR \
        [--seeds 0 1 2 3 7 42]

prints the tool's lines with ``"package": "mit_tpu"``, so the two
packages' draws can be set side by side: whether a draw collapses under
the gate's recipe in JAX too, or only in the port.
"""

import argparse
import glob
import json
import os
import sys

import pytest

import jax

if __name__ == "__main__":          # run as a script: the repository's packages
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from mit_tpu.models import vision as jvis
from mit_tpu_torch.config import Config
from mit_tpu_torch.models import vision as tvis
from mit_tpu_torch.tools import compositional_gate as gate
from mit_tpu_torch.tools import gate_draws

TINY = dict(family="vit", image_size=224, patch_size=56, hidden_size=48,
            num_layers=1, num_heads=2, intermediate_size=64,
            hidden_act="gelu", layer_norm_eps=1e-12, patch_bias=True,
            ln_pre=False, ln_post=True)


def sweep_jax(workdir, seeds, epochs, per_combo, cfg=None):
    """The JAX loop over ``seeds`` on the tool's corpus and recipe, each
    best-val checkpoint scored as ``evaluate.py`` scores it on that seed's
    val split; the lines it printed."""
    from mit_tpu.config import CONFIG
    from mit_tpu.data.dataset import ImageTextDataset, split_indices
    from mit_tpu.decode.api import load_captioner
    from mit_tpu.eval.bleu import evaluate_captioner
    from mit_tpu.train.loop import train

    corpus = gate_draws.write_corpus(workdir, per_combo)
    lines = []
    for seed in seeds:
        run_cfg = gate_draws.recipe(
            CONFIG if cfg is None else cfg,
            gate_draws.seed_dir(workdir, corpus, seed), seed, epochs)
        train(run_cfg, auto_prepare=False, wandb_enabled=False)
        ckpt = gate.best_checkpoint(run_cfg.DATA_DIR)
        captioner = load_captioner(ckpt, run_cfg)
        c = captioner.cfg
        ds = ImageTextDataset(c.IMAGE_DIR, c.CAPTIONS_FILE, c.MAX_SEQ_LEN,
                              captioner.tokenizer, c.ENCODER_MODEL_NAME)
        _, va = split_indices(len(ds), c.TRAIN_SPLIT_RATIO, c.RANDOM_SEED)
        refs = {}
        for i in va:
            refs.setdefault(ds.image_paths[i], []).append(ds.captions[i])
        scores = evaluate_captioner(captioner, [ds.image_paths[i] for i in va],
                                    refs, batch_size=32, method="greedy")
        lines.append(gate_draws.draw_line("mit_tpu", seed, ckpt, scores))
        gate_draws.keep_only(run_cfg.DATA_DIR, ckpt)
        print(json.dumps(lines[-1]), flush=True)
    return lines


@pytest.fixture
def tiny(monkeypatch):
    """The gate's recipe on a tiny encoder and decoder, in f32."""
    for presets, vc in ((tvis.PRESETS, tvis.VisionConfig),
                        (jvis.PRESETS, jvis.VisionConfig)):
        monkeypatch.setitem(presets, "tiny/test-vit", vc(**TINY))
    return dict(MAX_SEQ_LEN=16, DECODER_EMBED_DIM=32, DECODER_LAYERS=1,
                DECODER_HEADS=2, DECODER_FF_DIM=48, NUM_WORKERS=1,
                COMPUTE_DTYPE="float32", ENCODER_MODEL_NAME="tiny/test-vit",
                IMAGE_PROCESSOR_NAME="tiny/test-vit",
                PRETRAINED_ENCODER="off")


def test_port_sweep_trains_each_seed_apart(tmp_path, tiny):
    """Each seed trains in its own directory over the one corpus (the
    gate's seen combinations), and its best-val checkpoint is scored on its
    own val split."""
    lines = gate_draws.sweep(str(tmp_path), seeds=(3, 5), epochs=1,
                             per_combo=1, device="cpu", cfg=Config(**tiny))
    caps = json.load(open(tmp_path / "corpus" / "captions.json"))
    assert len(caps) == 160 - gate.HELD_OUT
    assert [r["seed"] for r in lines] == [3, 5]
    for r in lines:
        d = tmp_path / f"seed_{r['seed']}"
        assert os.path.islink(d / "images")
        ckpt = gate.best_checkpoint(str(d))
        assert glob.glob(str(d / "*.safetensors")) == [ckpt]
        assert not os.path.exists(d / "latest")
        assert r["best_val_loss"] == gate.val_of(ckpt) < float("inf")
        assert 0.0 <= r["train_val_bleu4"] <= 1.0
        assert r["learned"] == (r["train_val_bleu4"] > gate.LEARNED)
    out = gate_draws.summary_line("mit_tpu_torch", lines, 1, 1)
    assert out["seeds"] == [3, 5] and out["not_learned"] == sum(
        not r["learned"] for r in lines)


def test_jax_sweep_scores_as_the_port_scores(tmp_path, tiny):
    """The JAX sweep at one seed writes the port tool's corpus, and its
    scores equal the port's ``evaluate_checkpoint`` of the same checkpoint
    on that seed's split, so the two sweeps' lines compare."""
    from mit_tpu.config import Config as JConfig
    from mit_tpu_torch.tools.evaluate import evaluate_checkpoint

    work = tmp_path / "jax"
    jline, = sweep_jax(str(work), (3,), 1, 1, cfg=JConfig(**tiny))
    assert jline["package"] == "mit_tpu" and jline["seed"] == 3
    d = os.path.join(str(work), "seed_3", "")
    ckpt = gate.best_checkpoint(d)
    ours = evaluate_checkpoint(
        ckpt, gate_draws.recipe(Config(**tiny), d, 3, 1), device="cpu")
    assert gate_draws.draw_line("mit_tpu", 3, ckpt, ours) == jline
    port_corpus = gate_draws.write_corpus(str(tmp_path / "port"), 1)
    assert open(os.path.join(port_corpus, "captions.json")).read() == \
        (work / "corpus" / "captions.json").read_text()


@pytest.mark.parametrize("bleu4,learned", [(0.0, False), (0.5, False),
                                           (0.51, True), (0.87, True)])
def test_a_draw_has_learned_over_the_gate_floor(bleu4, learned):
    line = gate_draws.draw_line(
        "mit_tpu_torch", 42, "x_epoch_3_val_loss_0.3100.safetensors",
        {"bleu4": bleu4, "cider_d": 1.0, "mean_caption_len": 8.0})
    assert line["learned"] is learned and line["best_val_loss"] == 0.31
    assert gate_draws.summary_line("mit_tpu_torch", [line], 12, 8)[
        "not_learned"] == int(not learned)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=list(gate_draws.SEEDS))
    args = ap.parse_args()
    os.environ["HF_HUB_OFFLINE"] = "1"
    rows = sweep_jax(args.workdir, args.seeds, gate_draws.EPOCHS,
                     gate_draws.PER_COMBO)
    print(json.dumps(gate_draws.summary_line(
        "mit_tpu", rows, gate_draws.EPOCHS, gate_draws.PER_COMBO)))
