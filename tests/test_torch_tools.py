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


# ----------------------------------------------------------------------
# the gate's three diagnostics against scripts/
# ----------------------------------------------------------------------
def _script(name):
    return _load(f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))


CAPTIONS = ["a red square in the top left", "a red circle in the top right",
            "a blue ring", "the green cross in the bottom left corner",
            "a a a a", "", "red square top left", "a purple triangle in the "
            "top left top right", "A WHITE Ring In The Bottom Right"]


def test_gate_diagnose_parses_as_the_script():
    from mit_tpu_torch.tools import gate_diagnose

    js = _script("gate_diagnose")
    for name in ("red_square_top-left_00.jpg", "/x/y/black_ring_bottom-"
                 "right_17.jpg", "white_cross_top-right_3.png"):
        assert gate_diagnose.parse_name(name) == js.parse_name(name)
    for cap in CAPTIONS:
        assert gate_diagnose.parse_pred(cap) == js.parse_pred(cap)


class _FixedCaptioner:
    """Captions in a fixed turn, whatever the image."""

    def __init__(self):
        self.n = 0

    def caption_batch(self, images, method="greedy"):
        out = [CAPTIONS[(self.n + i) % len(CAPTIONS)]
               for i in range(len(images))]
        self.n += len(images)
        return out


def test_gate_diagnose_line_is_the_scripts(tmp_path, monkeypatch, capsys):
    """The whole report on one workdir, both captioners replaced by one
    that captions in a fixed turn: the same JSON line."""
    import sys

    from PIL import Image

    import mit_tpu.decode.api as japi
    import mit_tpu_torch.decode.api as tapi
    from mit_tpu_torch.tools import gate_diagnose

    for split, combos in (("train", gate.split_combos()[0][:7]),
                          ("heldout", gate.split_combos()[1][:5])):
        os.makedirs(tmp_path / split / "images")
        for c, s, p in combos:
            Image.new("RGB", (8, 8)).save(
                tmp_path / split / "images" / f"{c}_{s}_{p.replace(' ', '-')}"
                f"_00.jpg")
    for v in ("0.5000", "0.3000"):
        (tmp_path / "train" / f"m_epoch_1_val_loss_{v}.safetensors").touch()
    monkeypatch.setattr(japi, "load_captioner", lambda *a, **k:
                        _FixedCaptioner())
    monkeypatch.setattr(tapi, "load_captioner", lambda *a, **k:
                        _FixedCaptioner())
    monkeypatch.setattr(sys, "argv", ["gate_diagnose.py", str(tmp_path),
                                      "--batch_size", "3"])
    _script("gate_diagnose").main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    gate_diagnose.main([str(tmp_path), "--batch_size", "3", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert got["checkpoint"].endswith("0.3000.safetensors")
    assert got["train"]["n"] == 7 and got["heldout"]["n"] == 5


def test_loss_curve_fabricates_the_scripts_corpus_and_line(tmp_path,
                                                          monkeypatch):
    """The mini-Flickr fixture byte for byte, and the output JSON of the
    same training summary."""
    import sys

    import mit_tpu.train.loop as jloop
    import mit_tpu_torch.train.loop as tloop
    from mit_tpu_torch.tools import loss_curve

    js = _script("loss_curve")
    js.fabricate_mini_flickr(str(tmp_path / "jax"), n_images=6, caps_per=3)
    loss_curve.fabricate_mini_flickr(str(tmp_path / "port"), n_images=6,
                                     caps_per=3)
    for rel in ["captions.json"] + [f"images/mini_{i:05d}.jpg"
                                    for i in range(6)]:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel
    summary = {"epochs": [{"epoch": 1, "train_loss": 3.123456,
                           "val_loss": 2.987654},
                          {"epoch": 2, "train_loss": 2.5}]}
    seen = []

    def fake_train(cfg, **kw):
        seen.append((cfg.NUM_EPOCHS, cfg.BATCH_SIZE,
                     cfg.HF_UPLOAD_BEST_CHECKPOINTS, kw.get("auto_prepare")))
        return summary

    monkeypatch.setattr(jloop, "train", fake_train)
    monkeypatch.setattr(tloop, "train", fake_train)
    args = ["--epochs", "2", "--batch_size", "4", "--fixture_dir",
            str(tmp_path / "jax")]
    monkeypatch.setattr(sys, "argv", ["loss_curve.py", *args, "--output",
                                      str(tmp_path / "jax.json")])
    js.main()
    loss_curve.main([*args, "--output", str(tmp_path / "port.json"),
                     "--device", "cpu"])
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert seen[0] == seen[1] == (2, 4, False, False)


def test_gate_probe_renders_the_scripts_images():
    from mit_tpu_torch.tools import gate_probe

    js = _script("gate_probe")
    for name, (s_lo, s_hi, noisy) in gate_probe.VARIANTS.items():
        a, b = np.random.default_rng(5), np.random.default_rng(5)
        for color, shape, pos in list(zip(gate.COLORS, gate.SHAPES,
                                          gate.POSITIONS))[:4]:
            np.testing.assert_array_equal(
                gate_probe.render_variant(a, gate.COLORS[color], shape,
                                          gate.POSITIONS[pos], s_lo, s_hi,
                                          noisy),
                js.render_variant(b, js.cg.COLORS[color], shape,
                                  js.cg.POSITIONS[pos], s_lo, s_hi, noisy))


def test_gate_probe_line_and_its_output_file(tmp_path, monkeypatch, capsys):
    """The probe line's keys, its chance levels and accuracies, from
    features that carry the colour and nothing else; written where asked
    and nowhere else."""
    from mit_tpu_torch.tools import gate_probe

    def features(u8, device):
        # the images' mean colour over the shape's area: colour carried
        m = (u8 != 127).any(-1)
        return np.stack([u8[i][m[i]].mean(0) if m[i].any() else np.zeros(3)
                         for i in range(len(u8))]).astype(np.float32)

    out = gate_probe.run(n_per=8, steps=60, device="cpu",
                         features=features)
    assert set(out) == {"metric", "n_images_per_variant", "encoder", "chance",
                        *gate_probe.VARIANTS}
    assert out["n_images_per_variant"] == 8 * len(gate.SHAPES)
    assert out["chance"] == {"color": 0.125, "shape": 0.2, "position": 0.25}
    # on the clean background the mean colour names the colour
    assert out["cleanbg"]["color_acc"] >= 0.5
    monkeypatch.setattr(gate_probe, "cls_features", features)
    before = set(os.listdir(REPO)) | set(os.listdir(os.path.join(
        REPO, "benchmarks")))
    path = tmp_path / "probe.json"
    gate_probe.main(["--n_per", "2", "--steps", "2", "--device", "cpu",
                     "--output", str(path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert path.read_text() == line + "\n"
    assert set(os.listdir(REPO)) | set(os.listdir(os.path.join(
        REPO, "benchmarks"))) == before
