"""Port parity: KV-cached decoding and the captioning API of mit_tpu_torch
against mit_tpu on the CPU.

Greedy tokens must be identical to the JAX package's on the same weights:
through a cache-ladder crossing, an early END, and a mid-sequence PAD
emission (generated PADs stay masked as keys). The whole slice runs from a
checkpoint the JAX package writes to caption strings from both packages.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mit_tpu.decode import greedy as jgreedy
from mit_tpu.decode import step as jstep
from mit_tpu.models.decoder import DecoderConfig as JDecoderConfig
from mit_tpu.models.decoder import init_decoder_params
from mit_tpu_torch.decode import greedy as tgreedy
from mit_tpu_torch.decode import step as tstep
from mit_tpu_torch.models.convert import params_from_jax
from mit_tpu_torch.models.decoder import DecoderConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, H, L, F, MAXLEN = 60, 32, 4, 2, 64, 40
PAD, START, END = 0, 2, 3
KW = dict(vocab_size=V, embed_dim=D, num_heads=H, num_layers=L, ff_dim=F,
          max_seq_len=MAXLEN, dropout=0.0, pad_idx=PAD)
JCFG, TCFG = JDecoderConfig(**KW), DecoderConfig(**KW)


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray,
                        init_decoder_params(jax.random.PRNGKey(1), JCFG))


@pytest.fixture(scope="module")
def memory():
    return np.random.default_rng(7).normal(size=(4, 1, D)).astype(np.float32)


def test_decoder_step_matches_jax(params, memory):
    toks = np.array([[START, 10, 0, 7, 9], [START, 4, 4, 60 - 1, 0],
                     [START, 0, 8, 9, 3], [START, 5, 6, 7, 8]], np.int64)
    jcache = jstep.init_cache(params, JCFG, jnp.asarray(memory), max_len=8)
    tcache = tstep.init_cache(params_from_jax(params), TCFG,
                              torch.from_numpy(memory), max_len=8)
    tparams = tstep.prepare_decode_params(params_from_jax(params))
    for t in range(toks.shape[1]):
        key_pad = np.zeros((4, 8), bool)
        key_pad[:, : t + 1] = toks[:, : t + 1] == PAD
        ref, jcache = jstep.decoder_step(
            params, JCFG, jnp.asarray(toks[:, t], jnp.int32),
            jnp.asarray(t, jnp.int32), jcache, key_pad=jnp.asarray(key_pad),
        )
        out, tcache = tstep.decoder_step(
            tparams, TCFG, torch.from_numpy(toks[:, t]), t, tcache,
            key_pad=torch.from_numpy(key_pad),
        )
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=2e-4, err_msg=f"position {t}")
    for a, b in zip(tcache.k, jcache.k):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def _rigged(params, token, bias):
    p = dict(params)
    b = np.zeros((V,), np.float32)
    b[token] = bias
    p["fc_out_b"] = b
    return p


@pytest.mark.parametrize("case", ["ladder", "early_end", "forced_pad"])
def test_greedy_tokens_match_jax(params, memory, case):
    p = {"ladder": params,
         "early_end": _rigged(params, END, 100.0),
         "forced_pad": _rigged(params, PAD, 4.0)}[case]
    ref, ref_len = jgreedy.greedy_generate(p, JCFG, jnp.asarray(memory),
                                           START, END, PAD, MAXLEN)
    out, out_len = tgreedy.greedy_generate(
        params_from_jax(p), TCFG, torch.from_numpy(memory), START, END, PAD,
        MAXLEN,
    )
    ref, out = np.asarray(ref), out.numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    if case == "ladder":       # decoding ran past the first bucket (16)
        assert (out != PAD).sum(1).max() > 16
    elif case == "early_end":
        assert (out[:, 1] == END).all() and (out[:, 2:] == PAD).all()
    else:                      # some row emits PAD and then goes on
        assert any(
            (row[1:-1] == PAD).any() and row[np.argmax(row == PAD) + 1:].any()
            for row in out
        )


def test_bucket_ladder_and_checks():
    assert tgreedy._bucket_schedule(100) == jgreedy._bucket_schedule(100)
    assert tgreedy._bucket_schedule(16) == (16,)
    assert tgreedy.check_bucket_sizes(None, 40) == (16, 32, 40)
    for bad in [(8, 4, 40), (16, 32), ()]:
        with pytest.raises(ValueError, match="bucket_sizes"):
            tgreedy.check_bucket_sizes(bad, 40)


def test_ladder_matches_single_bucket(params, memory):
    tp, mem = params_from_jax(params), torch.from_numpy(memory)
    single, _ = tgreedy.greedy_generate(tp, TCFG, mem, START, END, PAD, MAXLEN,
                                        bucket_sizes=(MAXLEN,))
    ladder, _ = tgreedy.greedy_generate(tp, TCFG, mem, START, END, PAD, MAXLEN,
                                        bucket_sizes=(4, 8, MAXLEN))
    torch.testing.assert_close(single, ladder)


def test_grow_cache_keeps_rows(params, memory):
    cache = tstep.init_cache(params_from_jax(params), TCFG,
                             torch.from_numpy(memory), max_len=4)
    for a in cache.k + cache.v:
        a.normal_()
    grown = tstep.grow_cache(cache, 16)
    for a, g in zip(cache.k + cache.v, grown.k + grown.v):
        assert g.shape == (4, 16, D)
        torch.testing.assert_close(g[:, :4], a)
        assert not g[:, 4:].any()
    with pytest.raises(ValueError, match="max_len"):
        tgreedy.greedy_generate(params_from_jax(params), TCFG,
                                torch.from_numpy(memory), START, END, PAD,
                                MAXLEN + 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstep.init_cache(params_from_jax(params), TCFG,
                         torch.zeros(4, 3, D), max_len=8)


# ----------------------------------------------------------------------
def test_checkpoint_to_captions_matches_jax(tmp_path):
    """A checkpoint the JAX package saves → both load_captioner → the same
    caption strings (and token ids) for the same images."""
    from PIL import Image

    from mit_tpu.config import Config
    from mit_tpu.decode.api import load_captioner as jax_load_captioner
    from mit_tpu.models.model import ModelConfig, init_model_params
    from mit_tpu.text.tokenizer import train_tokenizer
    from mit_tpu.train.checkpoint import save_safetensors
    from mit_tpu_torch.decode.api import load_captioner

    cfg = Config(
        DATA_DIR=str(tmp_path) + "/", MAX_SEQ_LEN=20,
        ENCODER_MODEL_NAME="mit/tiny-vit-debug", DECODER_EMBED_DIM=32,
        DECODER_LAYERS=2, DECODER_HEADS=2, DECODER_FF_DIM=64,
    )
    tok = train_tokenizer(
        iter(["a dog runs", "a cat sits", "dogs and cats play"]),
        300, cfg.VOCAB_PATH, cfg.MERGES_PATH, cfg,
    )
    mcfg = ModelConfig.build(cfg.with_tokenizer_ids(tok), tok.get_vocab_size())
    ckpt = str(tmp_path / "model.safetensors")
    save_safetensors(ckpt, init_model_params(jax.random.PRNGKey(3), mcfg), mcfg)

    r = np.random.default_rng(5)
    images = [Image.fromarray(r.integers(0, 256, (48, 64, 3), np.uint8))
              for _ in range(3)]
    ref = jax_load_captioner(ckpt, cfg)
    ours = load_captioner(ckpt, cfg, device="cpu")
    assert ours.generate_batch(images) == ref.generate_batch(images)
    captions = ours.caption_batch(images)
    assert captions == ref.caption_batch(images)
    assert all(isinstance(c, str) and "<END>" not in c for c in captions)
    # beam search is ported: the same captions as the JAX package's; the
    # checkpoint's config carries BEAM_SIZE to the default beam width
    assert ours.beam_size == cfg.BEAM_SIZE
    assert (ours.generate_batch(images, method="beam")
            == ref.generate_batch(images, method="beam"))
    assert (ours.caption_batch(images, method="beam", beam_size=2)
            == ref.caption_batch(images, method="beam", beam_size=2))
    # sampling draws from its own generator: temperature 0 is greedy
    assert (ours.generate_batch(images, method="sample", temperature=0.0)
            == ours.generate_batch(images))
    assert isinstance(ours.caption(images[0], method="sample"), str)
    with pytest.raises(ValueError, match="nucleus"):
        ours.caption(images[0], method="nucleus")


def _run(args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_api_import_is_jax_free():
    proc = _run(["-c", (
        "import sys, mit_tpu_torch.decode.api, mit_tpu_torch.decode.cli\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'mit_tpu'))\n"
        "assert not bad, bad\n"
    )])
    assert proc.returncode == 0, proc.stderr


def test_cli_refuses_to_run_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    proc = _run(["-m", "mit_tpu_torch.decode.cli", "--image_path",
                 str(tmp_path / "x.jpg")])
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda_or_repo(tmp_path, where):
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        with open(script) as src, open(tmp_path / "chip_smoke.py", "w") as dst:
            dst.write(src.read())
        script = str(tmp_path / "chip_smoke.py")
    proc = _run([script], cwd=cwd)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
