"""The port's pretrained-parity runbook (``mit_tpu_torch/tools/
pretrained_report.py``) on the CPU, mirroring ``tests/test_pretrained_report.py``
on weights synthesized in the test: a random Hugging Face torch ViT written
with ``save_pretrained`` (the family check) and a reference-layout
safetensors of a random model of the port (the caption check). A repo id
that is not on disk gives ``SKIP`` with its reason, and so does a missing
``transformers``. On one local ViT directory the JAX package's runbook and
the port's both report ``match``.
"""

import importlib.util
import json
import os
import shutil
import sys

import pytest
import torch

from mit_tpu_torch.tools import pretrained_report as report

os.environ.setdefault("USE_TF", "0")
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def local_vit_dir(tmp_path_factory):
    """A tiny random ViT in Hugging Face's ``save_pretrained`` layout
    (config.json + model.safetensors)."""
    from transformers import ViTConfig, ViTModel

    torch.manual_seed(0)
    d = tmp_path_factory.mktemp("hf_vit")
    model = ViTModel(
        ViTConfig(hidden_size=48, num_hidden_layers=2, num_attention_heads=2,
                  intermediate_size=64, image_size=32, patch_size=16),
        add_pooling_layer=False,
    )
    model.save_pretrained(str(d))
    return str(d)


def test_check_family_match_on_local_weights(local_vit_dir):
    rec = report.check_family("vit", local_vit_dir, allow_download=False,
                              device="cpu")
    assert rec["status"] == "match", rec
    assert rec["last_hidden_max_abs_err"] <= report.FEATURE_TOL * max(
        1.0, rec["last_hidden_scale"])
    assert rec["shape"][1] == 5          # 4 patches + CLS


def test_check_family_skip_reports_reason():
    rec = report.check_family("vit", "no/such-model-xyz",
                              allow_download=False, device="cpu")
    assert rec["status"] == "SKIP"
    assert "unreachable" in rec["reason"]


def test_check_family_without_transformers_skips_with_the_reason(
        local_vit_dir, monkeypatch):
    """Where transformers does not import (the card's machine does not
    promise it) the port's tower still loads and the family says why it
    skipped; nothing is compared with anything else instead."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    rec = report.check_family("vit", local_vit_dir, allow_download=False,
                              device="cpu")
    assert rec["status"] == "SKIP", rec
    assert "transformers is not importable" in rec["reason"]
    assert rec["loaded_geometry"] == {"hidden": 48, "layers": 2, "seq_len": 5}


def _tiny_config():
    from mit_tpu_torch.config import Config

    return Config(
        ENCODER_MODEL_NAME="mit/tiny-vit-debug",
        IMAGE_PROCESSOR_NAME="mit/tiny-vit-debug",
        DECODER_EMBED_DIM=32, DECODER_LAYERS=2, DECODER_HEADS=2,
        DECODER_FF_DIM=48, DECODER_DROPOUT=0.0, MAX_SEQ_LEN=14,
    )


def test_check_captions_match_on_reference_layout_checkpoint(tmp_path):
    """A reference-layout checkpoint gives the same greedy tokens in the
    torch rebuild of the reference's loop, the port's KV-cached decode and
    the port's uncached oracle."""
    from mit_tpu_torch.models.model import ModelConfig, init_model_params
    from mit_tpu_torch.train.checkpoint import save_safetensors

    cfg = _tiny_config()
    mcfg = ModelConfig.build(cfg, vocab_size=90)
    params = init_model_params(torch.Generator().manual_seed(7), mcfg)
    path = str(tmp_path / "ref_ckpt.safetensors")
    save_safetensors(path, params, mcfg)

    rec = report.check_captions(path, image_path=None, cfg=cfg, device="cpu")
    assert rec["status"] == "match", rec
    assert rec["our_tokens"] == rec["reference_tokens"] == \
        rec["uncached_tokens"]
    assert len(rec["our_tokens"]) >= 2


def test_check_captions_skip_on_bad_checkpoint(tmp_path):
    bad = tmp_path / "nope.safetensors"
    bad.write_bytes(b"not a checkpoint")
    rec = report.check_captions(str(bad), image_path=None, device="cpu")
    assert rec["status"] == "SKIP"
    assert "not loadable" in rec["reason"]


def test_runbook_cli_writes_report(tmp_path, monkeypatch):
    """``--out`` and, without it, ``pretrained_report_torch.json`` in the
    working directory; never a path under ``benchmarks/``."""
    out = str(tmp_path / "report.json")
    rc = report.main(["--out", out, "--families", "vit", "--device", "cpu"])
    assert rc == 0                        # SKIP is not a failure
    data = json.load(open(out))
    assert data["families"]["vit"]["status"] in ("match", "SKIP")
    assert data["caption_parity"]["status"] == "SKIP"
    monkeypatch.chdir(tmp_path)
    assert report.main(["--families", "vit", "--device", "cpu"]) == 0
    assert os.path.isfile(tmp_path / "pretrained_report_torch.json")
    assert not os.path.exists(tmp_path / "benchmarks")


def test_weights_dir_sweep_flips_family_to_match(local_vit_dir, monkeypatch,
                                                 tmp_path):
    """``MIT_WEIGHTS_DIR`` holding ``<family>/`` turns the family from SKIP
    to a verdict, the repo id unchanged; ``<org>/<name>`` wins over it."""
    root = tmp_path / "drop"
    shutil.copytree(local_vit_dir, root / "vit")

    repo = "google/vit-base-patch16-224-in21k"
    rec_skip = report.check_family("vit", repo, allow_download=False,
                                   device="cpu")
    assert rec_skip["status"] == "SKIP"

    monkeypatch.setenv("MIT_WEIGHTS_DIR", str(root))
    rec = report.check_family("vit", repo, allow_download=False, device="cpu")
    assert rec["status"] == "match", rec
    assert rec["source"] == str(root / "vit")

    mirror = root / "google" / "vit-base-patch16-224-in21k"
    shutil.copytree(local_vit_dir, mirror)
    assert report.local_weights_dir(repo, "vit") == str(mirror)


def test_both_runbooks_match_on_one_local_vit(local_vit_dir):
    """The JAX package's runbook and the port's on the same directory: both
    ``match`` at the same output shape, under the same tolerance and over
    the same families."""
    spec = importlib.util.spec_from_file_location(
        "pretrained_report_jax",
        os.path.join(HERE, "..", "scripts", "pretrained_report.py"))
    jax_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_report)
    theirs = jax_report.check_family("vit", local_vit_dir,
                                     allow_download=False)
    ours = report.check_family("vit", local_vit_dir, allow_download=False,
                               device="cpu")
    assert theirs["status"] == ours["status"] == "match", (theirs, ours)
    assert ours["shape"] == theirs["shape"]
    assert report.FEATURE_TOL == jax_report.FEATURE_TOL
    assert report.FAMILIES == jax_report.FAMILIES
