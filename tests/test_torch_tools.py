"""Port parity: ``mit_tpu_torch.tools.evaluate`` against the repository's
``evaluate.py``, and the helpers of ``mit_tpu_torch.tools.
compositional_gate`` against ``scripts/compositional_gate.py``, on the CPU.

The evaluation runs both CLIs on one checkpoint (a tiny encoder and
decoder, drawn by JAX, under each package's ``CONFIG``) whose references
hold some of its own captions, so BLEU-4 and CIDEr-D are not 0;
the scores must be equal. The gate renders the same JPEG bytes, holds out
the same combinations, and its rule rejects each way a run can fail.
"""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest

import jax

from mit_tpu import config as jconfig
from mit_tpu.models import model as jmodel
from mit_tpu.train import checkpoint as jckpt
from mit_tpu_torch import config as tconfig
from mit_tpu_torch.tools import color_sanity
from mit_tpu_torch.tools import compositional_gate as gate
from mit_tpu_torch.tools import evaluate as tevaluate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(ENCODER_MODEL_NAME="mit/tiny-vit-debug",
             IMAGE_PROCESSOR_NAME="mit/tiny-vit-debug", MAX_SEQ_LEN=12,
             VOCAB_SIZE=300, DECODER_EMBED_DIM=32, DECODER_LAYERS=2,
             DECODER_HEADS=2, DECODER_FF_DIM=48, BEAM_SIZE=3,
             TRAIN_SPLIT_RATIO=0.5)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_gate():
    return _load("jax_compositional_gate",
                 os.path.join(REPO, "scripts", "compositional_gate.py"))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A data dir of 8 rendered images with the tokenizer trained on their
    captions, a JAX-drawn checkpoint, and references that hold the JAX
    captioner's greedy or beam caption for 7 of the images."""
    from mit_tpu.decode.api import load_captioner
    from mit_tpu_torch.train.loop import ensure_tokenizer

    d = str(tmp_path_factory.mktemp("evaluate")) + "/"
    combos = [(c, s, p) for c, s, p in zip(
        gate.COLORS, gate.SHAPES * 2, list(gate.POSITIONS) * 2)]
    gate.write_split(d, combos, 1, np.random.default_rng(5))
    cfg = tconfig.CONFIG.replace(DATA_DIR=d, **SMALL)
    ensure_tokenizer(cfg)
    jcfg = jconfig.CONFIG.replace(DATA_DIR=d, **SMALL)
    vocab = json.load(open(cfg.VOCAB_PATH))
    mcfg = jmodel.ModelConfig.build(jcfg, vocab_size=len(vocab))
    params = jmodel.init_model_params(jax.random.PRNGKey(3), mcfg)
    path = os.path.join(d, "model.safetensors")
    jckpt.save_safetensors(path, params, mcfg)
    cap = load_captioner(path, jcfg)
    caps = json.load(open(cfg.CAPTIONS_FILE))
    names = sorted(caps)
    from PIL import Image

    for name in names[1:]:
        with Image.open(os.path.join(cfg.IMAGE_DIR, name)) as im:
            im = im.convert("RGB")
            caps[name].append(cap.caption_batch(
                [im], method="greedy" if len(name) % 2 else "beam")[0])
    with open(cfg.CAPTIONS_FILE, "w") as f:
        json.dump(caps, f)
    return path, d


@pytest.mark.parametrize("split,method", [("all", "greedy"), ("val", "beam")])
def test_evaluate_matches_jax_evaluate(checkpoint, monkeypatch, capsys,
                                       split, method):
    path, d = checkpoint
    monkeypatch.setattr(jconfig, "CONFIG", jconfig.CONFIG.replace(**SMALL))
    monkeypatch.setattr(tconfig, "CONFIG", tconfig.CONFIG.replace(**SMALL))
    monkeypatch.delenv("MIT_FUSED_DECODE", raising=False)
    argv = ["--checkpoint_path", path, "--data_dir", d, "--split", split,
            "--method", method]
    jevaluate = _load("jax_evaluate", os.path.join(REPO, "evaluate.py"))
    assert jevaluate.main(argv) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tevaluate.main(argv + ["--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours == theirs
    assert ours["bleu4"] > 0 and ours["cider_d"] > 0
    assert ours["num_images"] == 8 or split == "val"


def test_evaluate_refuses_cuda_without_a_card(monkeypatch, checkpoint):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tevaluate.main(["--checkpoint_path", checkpoint[0]])


def test_gate_renders_the_jax_gates_jpegs(jax_gate, tmp_path):
    """The same split of combinations and, for the same seeds, the same
    captions and JPEG bytes."""
    seen, held = gate.split_combos()
    assert len(held) == 32 and len(seen) == 128
    combos = [(c, s, p) for c in jax_gate.COLORS for s in jax_gate.SHAPES
              for p in jax_gate.POSITIONS]
    rng = np.random.default_rng(7)
    held_idx = set(rng.choice(len(combos), size=32, replace=False).tolist())
    assert held == [c for i, c in enumerate(combos) if i in held_idx]
    assert (gate.COLORS, gate.SHAPES, gate.POSITIONS) == (
        jax_gate.COLORS, jax_gate.SHAPES, jax_gate.POSITIONS)
    picks = held[:3] + seen[::40]
    for mod, sub in ((gate, "ours"), (jax_gate, "theirs")):
        assert mod.write_split(str(tmp_path / sub), picks, 2,
                               np.random.default_rng(1)) == 2 * len(picks)
    for f in ("captions.json",) + tuple(
            os.path.join("images", n)
            for n in sorted(os.listdir(tmp_path / "ours" / "images"))):
        assert (tmp_path / "ours" / f).read_bytes() == \
            (tmp_path / "theirs" / f).read_bytes(), f
    for shape in gate.SHAPES:
        np.testing.assert_array_equal(gate.shape_mask(shape, 60, 150, 50),
                                      jax_gate.shape_mask(shape, 60, 150, 50))


def _r(bleu4):
    return {"bleu4": bleu4, "cider_d": 2.0 * bleu4}


@pytest.mark.parametrize("case,train,f32,int8,canary,ok", [
    ("passes", 0.9, 0.73, 0.74, 0.42, True),
    ("gap_over_tolerance", 0.9, 0.73, 0.67, 0.42, False),
    ("saturated", 0.9, 0.995, 0.995, 0.5, False),
    ("unlearned", 0.5, 0.3, 0.31, 0.1, False),
    ("canary_does_not_trip", 0.9, 0.73, 0.74, 0.70, False),
    ("no_canary", 0.9, 0.73, 0.74, None, True),
])
def test_gate_rule_rejects_each_failure(case, train, f32, int8, canary, ok):
    out = gate.verdict(_r(train), _r(f32), _r(int8),
                       None if canary is None else _r(canary), 0.05)
    assert out["ok"] is ok
    assert list(out)[-1] == "ok"
    assert out["heldout_bleu4_bf16"] == f32 and out["tolerance"] == 0.05
    assert ("canary_trips" in out) == (canary is not None)


def test_gate_picks_the_best_val_checkpoint(tmp_path):
    names = ["ckpt_epoch_3_val_loss_1.2000.safetensors",
             "ckpt_epoch_9_val_loss_0.8000.safetensors",
             "ckpt_epoch_10_val_loss_0.9000.safetensors", "other.safetensors"]
    for n in names:
        (tmp_path / n).write_bytes(b"")
    assert gate.best_checkpoint(str(tmp_path)) == str(tmp_path / names[1])
    assert gate.val_of(names[3]) == float("inf")


def test_color_sanity_writes_its_corpus(tmp_path, monkeypatch):
    """400 noisy JPEGs in 8 colour classes and their captions; the training
    and evaluation run through the port's CLIs (stubbed here)."""
    calls = []
    monkeypatch.setattr(color_sanity.subprocess, "run",
                        lambda cmd, **k: calls.append(cmd))
    monkeypatch.setattr(color_sanity.glob, "glob",
                        lambda pattern: [str(tmp_path / "x.safetensors")])
    monkeypatch.setattr(color_sanity.os.path, "getmtime", lambda p: 0)
    assert color_sanity.main([str(tmp_path)]) == 0
    caps = json.load(open(tmp_path / "captions.json"))
    assert len(caps) == 400 and caps["blue_07.jpg"] == [
        "a blue square on the screen"]
    assert [c[2] for c in calls] == ["mit_tpu_torch.train.cli",
                                     "mit_tpu_torch.tools.evaluate"]
    assert "--no_hf_upload" in calls[0]
    shutil.rmtree(tmp_path / "images")


def test_gate_default_workdir_is_new_under_tmpdir(tmp_path, monkeypatch):
    """Without a workdir the gate and the colour sanity each work in a new
    directory under TMPDIR, so two runs never share a corpus or a
    checkpoint; --skip_train needs an earlier run's workdir."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    runs = []
    monkeypatch.setattr(gate, "train", lambda data, epochs: runs.append(data))
    monkeypatch.setattr(gate, "write_split", lambda d, *a: 0)
    monkeypatch.setattr(gate.glob, "glob", lambda pattern: [])
    with pytest.raises(RuntimeError, match="no checkpoint"):  # after training
        gate.main([])
    assert len(runs) == 1 and os.path.dirname(
        os.path.dirname(runs[0].rstrip("/"))) == str(tmp_path)
    with pytest.raises(SystemExit) as e:
        gate.main(["--skip_train"])
    assert e.value.code == 2          # argparse: no workdir given

    monkeypatch.setattr(color_sanity, "train",
                        lambda data, epochs: runs.append(data))
    monkeypatch.setattr(color_sanity, "write_dataset", lambda d: 0)
    with pytest.raises(ValueError):   # max() of no checkpoint
        color_sanity.main([])
    assert os.path.dirname(runs[1].rstrip("/")) == str(tmp_path)
    assert runs[0] != runs[1]


def test_gate_skip_train_without_a_checkpoint_writes_nothing(tmp_path,
                                                             monkeypatch):
    """--skip_train on a workdir with no checkpoint stops with a message
    and neither writes a corpus nor trains."""
    touched = []
    monkeypatch.setattr(gate, "write_split",
                        lambda *a: touched.append("write"))
    monkeypatch.setattr(gate, "train", lambda *a: touched.append("train"))
    with pytest.raises(SystemExit) as e:
        gate.main([str(tmp_path), "--skip_train"])
    assert "no checkpoint" in str(e.value.code) and touched == []
    assert os.listdir(tmp_path) == []
