"""The port stands alone: nothing under mit_tpu_torch/ nor chip_smoke.py
imports jax or the JAX package, and its own copies of the JAX-free modules
(config, text, data.prepare) behave as the originals do.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPORT = re.compile(r"^\s*(from|import)\s+(mit_tpu(\.|\s|$)|jax(\.|\s|$))", re.M)
CORPUS = [
    "a dog runs across the green field",
    "two dogs play with a red ball",
    "a cat sits on the warm window sill",
    "children are playing football, happily!",
    "A man in a blue shirt is riding a bicycle down the street.",
    "the quick brown fox jumps over the lazy dog's back",
    "naïve café — unicode, digits 1234 and   spaces",
]


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "mit_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_no_port_source_imports_jax_or_the_jax_package():
    paths = _port_sources()
    assert len(paths) > 30
    bad = {}
    for path in paths:
        with open(path, encoding="utf-8") as f:
            hits = [m.group(0).strip() for m in IMPORT.finditer(f.read())]
        if hits:
            bad[os.path.relpath(path, REPO)] = hits
    assert not bad, bad
    assert IMPORT.search("    from mit_tpu.config import CONFIG\n")
    assert IMPORT.search("import jax\n") and IMPORT.search("import mit_tpu\n")
    assert not IMPORT.search("from mit_tpu_torch.config import CONFIG\n")


@pytest.mark.parametrize("modules", [
    "mit_tpu_torch.decode.cli, mit_tpu_torch.train.cli",
    "mit_tpu_torch.decode.api, mit_tpu_torch.decode.beam, "
    "mit_tpu_torch.decode.sampling, mit_tpu_torch.train.loop, "
    "mit_tpu_torch.config, mit_tpu_torch.data.prepare",
    "mit_tpu_torch.text, mit_tpu_torch.text.native",
    "mit_tpu_torch.decode.service, mit_tpu_torch.eval.bleu, "
    "mit_tpu_torch.eval.cider",
    "mit_tpu_torch.models.pretrained, mit_tpu_torch.models.encoder_tools, "
    "mit_tpu_torch.utils.profiling, mit_tpu_torch.tools.profile_pipeline",
    "mit_tpu_torch.kernels.host, mit_tpu_torch.data.native_loader, "
    "mit_tpu_torch.tools.evaluate, mit_tpu_torch.tools.compositional_gate, "
    "mit_tpu_torch.tools.color_sanity, mit_tpu_torch.tools.gate_draws",
    "mit_tpu_torch.parallel, mit_tpu_torch.parallel.mesh, "
    "mit_tpu_torch.parallel.collectives, mit_tpu_torch.tools.gate_diagnose, "
    "mit_tpu_torch.tools.loss_curve, mit_tpu_torch.tools.gate_probe",
    "mit_tpu_torch.tools.pretrained_report, mit_tpu_torch.ops.masks, "
    "mit_tpu_torch.ops.positional, mit_tpu_torch.decode.greedy",
])
def test_port_modules_load_neither_jax_nor_the_jax_package(modules):
    """Importing the port's entry points leaves neither in sys.modules, nor
    transformers or huggingface_hub (the card's machine does not promise
    them); the decode, train and model packages do not pull in the
    tokenizer's `regex` or Pillow either."""
    light = "text" not in modules
    code = (
        f"import sys, {modules}\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "bad = sorted(top & {'jax', 'jaxlib', 'mit_tpu', 'transformers',\n"
        "                    'huggingface_hub'})\n"
        "assert not bad, bad\n"
        + ("assert not top & {'regex', 'PIL'}, sorted(top & {'regex', 'PIL'})\n"
           if light else "")
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_config_copy_matches_the_jax_package():
    import dataclasses
    import json

    from mit_tpu.config import CONFIG as JCONFIG
    from mit_tpu.config import Config as JConfig
    from mit_tpu_torch.config import CONFIG, Config

    # the port's own knobs, which the JAX package lacks, at their defaults
    port_only = {"LANGUAGE_MODEL": "decoder"}
    ours = dataclasses.asdict(CONFIG)
    assert {k: ours.pop(k) for k in port_only} == port_only
    assert ours == dataclasses.asdict(JCONFIG)
    written = json.loads(CONFIG.to_json())
    assert {k: written.pop(k) for k in port_only} == port_only
    assert json.dumps(written, indent=2, sort_keys=True) == JCONFIG.to_json()
    assert Config.from_json(JCONFIG.to_json()) == CONFIG
    kw = dict(DATA_DIR="/data/x/", MAX_SEQ_LEN=20, BEAM_SIZE=5)
    ours, theirs = Config(**kw), JConfig(**kw)
    for prop in ("OUTPUT_DIR", "VOCAB_PATH", "MERGES_PATH", "CAPTIONS_FILE"):
        assert getattr(ours, prop) == getattr(theirs, prop)
    assert ours.replace(BEAM_SIZE=2).BEAM_SIZE == 2


def test_tokenizer_copy_round_trips_like_the_jax_package(tmp_path):
    """Train on the same corpus with both packages: the same files, ids,
    padded batches and decoded text; each loads the other's files."""
    from mit_tpu.config import Config as JConfig
    from mit_tpu.text import tokenizer as jtok
    from mit_tpu_torch.config import Config
    from mit_tpu_torch.text import tokenizer as ttok

    jcfg = JConfig(DATA_DIR=str(tmp_path / "jax") + "/", MAX_SEQ_LEN=24)
    tcfg = Config(DATA_DIR=str(tmp_path / "torch") + "/", MAX_SEQ_LEN=24)
    for cfg in (jcfg, tcfg):
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    theirs = jtok.train_tokenizer(iter(CORPUS), 400, jcfg.VOCAB_PATH,
                                  jcfg.MERGES_PATH, jcfg)
    ours = ttok.train_tokenizer(iter(CORPUS), 400, tcfg.VOCAB_PATH,
                                tcfg.MERGES_PATH, tcfg)
    for a, b in ((jcfg.VOCAB_PATH, tcfg.VOCAB_PATH),
                 (jcfg.MERGES_PATH, tcfg.MERGES_PATH)):
        with open(a, encoding="utf-8") as fa, open(b, encoding="utf-8") as fb:
            assert fa.read() == fb.read()
    assert ours.get_vocab_size() == theirs.get_vocab_size()
    for name in ("pad_id", "start_id", "end_id", "unk_id"):
        assert getattr(ours, name) == getattr(theirs, name)
    texts = CORPUS + ["unseen wörds and emoji 🙂", ""]
    for text in texts:
        ids = ours.encode(text)
        assert ids == theirs.encode(text)
        assert ours.decode(ids) == theirs.decode(ids)
        assert (ours.decode(ids, skip_special_tokens=False)
                == theirs.decode(ids, skip_special_tokens=False))
    np.testing.assert_array_equal(ours.encode_batch(texts),
                                  theirs.encode_batch(texts))
    # each package loads the other's files
    crossed = ttok.get_tokenizer(tcfg.replace(DATA_DIR=jcfg.DATA_DIR),
                                 force_reload=True)
    assert crossed.encode(CORPUS[4]) == theirs.encode(CORPUS[4])
    # the C++ encoder attaches where its library builds, as in JAX
    from mit_tpu_torch.kernels import host

    assert ours.use_native() == (host.status()["bpe_core"] == "built")
    assert tcfg.with_tokenizer_ids(ours).PAD_TOKEN_ID == ours.pad_id
