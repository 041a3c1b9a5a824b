"""Port parity: the host libraries of ``native/`` (the C++ JPEG loader and
BPE core) through ``mit_tpu_torch.kernels.host``, ``mit_tpu_torch.data.
native_loader`` and ``mit_tpu_torch.text.native``, against ``mit_tpu`` on
the CPU.

Images are seeded *textured* JPEGs (noise over a gradient), where the C++
loader and PIL differ by one 0..255 step after the resize; solid colours
hide that. Pixels are held bitwise equal between the packages' loaders,
datasets and feature-cache inputs; token ids bitwise equal between the C++
and Python BPE. The training loop on textured JPEGs gives the JAX loop's
losses within 1e-5 (f32, dropout 0, the same encoder checkpoint and the
same decoder draw).
"""

import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from mit_tpu.config import Config as JConfig
from mit_tpu.data import dataset as jdata
from mit_tpu.data import native_loader as jnative
from mit_tpu.models import decoder as jdec
from mit_tpu.models import model as jmodel
from mit_tpu.models import vision as jvis
from mit_tpu.train import features as jfeatures
from mit_tpu_torch.config import Config
from mit_tpu_torch.data import dataset as tdata
from mit_tpu_torch.data import native_loader as tnative
from mit_tpu_torch.kernels import host
from mit_tpu_torch.models import decoder as tdec
from mit_tpu_torch.models import model as tmodel
from mit_tpu_torch.models import vision as tvis
from mit_tpu_torch.models.convert import params_from_jax
from mit_tpu_torch.train import features as tfeatures

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="no C++ compiler")


@pytest.fixture
def image_loader_built():
    """Skip a case that needs the C++ JPEG loader where it does not build
    (a machine with g++ but without libjpeg's headers), naming why."""
    why = host.status()["image_loader"]
    if why != "built":
        pytest.skip("the C++ JPEG loader does not build here: "
                    + why.splitlines()[0])


FAMILIES = {
    "vit": "google/vit-base-patch16-224-in21k",       # bilinear, fixed
    "clip": "openai/clip-vit-base-patch32",           # bicubic, edge + crop
    "blip": "Salesforce/blip-image-captioning-base",  # bicubic, 384 fixed
}
SIZES = [(320, 240), (180, 260), (97, 131)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def textured(w, h, seed):
    """A seeded RGB image with edges and noise: a colour gradient, blocks
    and per-pixel noise, as uint8 (H, W, 3)."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([255 * xx / w, 255 * yy / h,
                     128 + 100 * np.sin(xx / 7.0 + yy / 11.0)], -1)
    blocks = r.integers(0, 90, (h // 16 + 1, w // 16 + 1, 3)).repeat(
        16, 0).repeat(16, 1)[:h, :w]
    img = base + blocks + r.normal(0, 25, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg_bytes(w, h, seed, mode="RGB"):
    from PIL import Image

    im = Image.fromarray(textured(w, h, seed))
    if mode != "RGB":
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=90)
    return buf.getvalue()


def test_host_libraries_build_into_the_build_dir_and_concurrently(tmp_path):
    """Both libraries build with g++ into mit_tpu_torch/_build under a
    hash of source and flags; four processes building the same library at
    once each load a whole one. (A JPEG loader that does not build, for
    want of libjpeg's headers, must say so with the compiler's error.)"""
    state = host.status()
    assert state["bpe_core"] == "built"
    if state["image_loader"] != "built":
        assert state["image_loader"].startswith("RuntimeError: g++ failed")
    for name in (n for n in host.LIBRARIES if state[n] == "built"):
        path = host.library_path(name)
        assert path.parent == host.BUILD_DIR and path.exists()
        assert path.name.startswith(f"lib{name}_")
    code = ("import sys; sys.path.insert(0, {repo!r})\n"
            "from mit_tpu_torch.kernels import host\n"
            "host.BUILD_DIR = __import__('pathlib').Path({d!r})\n"
            "host.load('bpe_core'); print(host.library_path('bpe_core'))\n")
    d = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c",
                               code.format(repo=REPO, d=d)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(set(outs)) == 1 and os.path.exists(outs[0])
    assert os.listdir(d) == [os.path.basename(outs[0])]   # no temp file left


def test_a_library_that_does_not_build_says_why_and_falls_back(
        tmp_path, monkeypatch, textured_corpus):
    """A source that does not compile (here: a missing header, as libjpeg's
    on a machine without it) gives the compiler's error in status(), is
    built once, and leaves the dataset on PIL and the tokenizer on the
    Python BPE."""
    from mit_tpu_torch.text.tokenizer import Tokenizer as TTok

    (tmp_path / "bad.cpp").write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(host, "NATIVE", tmp_path)
    monkeypatch.setattr(host, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(host, "LIBRARIES", {"image_loader": ("bad.cpp", ()),
                                            "bpe_core": ("bad.cpp", ())})
    monkeypatch.setattr(host, "_loaded", {})
    monkeypatch.setattr(host, "_failed", {})
    monkeypatch.setattr(tnative, "_lib", None)
    state = host.status()
    assert set(state) == {"image_loader", "bpe_core"}
    for why in state.values():
        assert why.startswith("RuntimeError: g++ failed") and \
            "no_such_header.h" in why.splitlines()[0]
    calls = []
    monkeypatch.setattr(host, "build", lambda name: calls.append(name))
    with pytest.raises(RuntimeError):
        host.load("image_loader")
    assert calls == [] and not tnative.native_available()
    cfg = textured_corpus
    ds = tdata.ImageTextDataset(
        cfg.IMAGE_DIR, cfg.CAPTIONS_FILE, cfg.MAX_SEQ_LEN,
        TTok.from_files(cfg.VOCAB_PATH, cfg.MERGES_PATH, cfg),
        FAMILIES["vit"], verbose=False)
    assert ds.native_loader is None and ds.tokenizer._native is None
    from PIL import Image

    with Image.open(ds.image_paths[0]) as im:
        np.testing.assert_array_equal(ds[0]["image"], ds.preprocessor(im))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.usefixtures("image_loader_built")
def test_native_loader_matches_jax_bitwise(family, w, h):
    name = FAMILIES[family]
    data = jpeg_bytes(w, h, seed=w * h)
    ours = tnative.NativeImageLoader(name).load_jpeg_bytes(data)
    want = jnative.NativeImageLoader(name).load_jpeg_bytes(data)
    np.testing.assert_array_equal(ours, want)
    # and at another input size (a loaded encoder's image_size)
    ours = tnative.NativeImageLoader(name, image_size=96).load_jpeg_bytes(data)
    want = jnative.NativeImageLoader(name, image_size=96).load_jpeg_bytes(data)
    assert ours.shape == (3, 96, 96)
    np.testing.assert_array_equal(ours, want)


@pytest.mark.parametrize("case", ["grayscale", "png", "corrupt"])
@pytest.mark.usefixtures("image_loader_built")
def test_native_loader_edge_cases_match_jax(case, tmp_path):
    """A grayscale JPEG decodes natively (three equal channels); a PNG goes
    to PIL; a corrupt JPEG raises ValueError, in both packages."""
    from PIL import Image

    name = FAMILIES["vit"]
    ours, theirs = tnative.NativeImageLoader(name), jnative.NativeImageLoader(name)
    if case == "grayscale":
        p = tmp_path / "g.jpg"
        p.write_bytes(jpeg_bytes(100, 80, 3, mode="L"))
        got = ours.load_path(str(p))
        np.testing.assert_array_equal(got, theirs.load_path(str(p)))
        np.testing.assert_array_equal(got[0], got[1])
    elif case == "png":
        p = tmp_path / "x.png"
        Image.fromarray(textured(64, 48, 4)).save(p)
        got = ours.load_path(str(p))
        assert got.shape == (3, 224, 224)
        np.testing.assert_array_equal(got, theirs.load_path(str(p)))
        with Image.open(p) as im:
            np.testing.assert_array_equal(got, ours._fallback(im))
    else:
        for loader in (ours, theirs):
            with pytest.raises(ValueError):
                loader.load_jpeg_bytes(b"definitely not a jpeg")
    assert tnative.native_available()


@pytest.fixture(scope="module")
def textured_corpus(tmp_path_factory):
    """8 textured JPEGs of several sizes, a PNG, a corrupt .jpg; 2 captions
    each; the training tokenizer written beside them."""
    from PIL import Image

    from mit_tpu_torch.train.loop import ensure_tokenizer

    d = tmp_path_factory.mktemp("textured")
    cfg = Config(DATA_DIR=str(d) + "/", MAX_SEQ_LEN=16, VOCAB_SIZE=300)
    os.makedirs(cfg.IMAGE_DIR)
    caps = {}
    for i in range(8):
        name = f"im{i}.jpg"
        with open(os.path.join(cfg.IMAGE_DIR, name), "wb") as f:
            f.write(jpeg_bytes(40 + 23 * i, 60 + 11 * i, seed=i))
        caps[name] = [f"a photo number {i} with things",
                      f"another view of item {i}"]
    Image.fromarray(textured(50, 70, 99)).save(
        os.path.join(cfg.IMAGE_DIR, "extra.png"))
    caps["extra.png"] = ["a picture saved losslessly"]
    with open(os.path.join(cfg.IMAGE_DIR, "broken.jpg"), "wb") as f:
        f.write(b"\xff\xd8 not really a jpeg")
    caps["broken.jpg"] = ["an image that does not decode"]
    with open(cfg.CAPTIONS_FILE, "w") as f:
        json.dump(caps, f)
    ensure_tokenizer(cfg)
    return cfg


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.usefixtures("image_loader_built")
def test_dataset_items_match_jax_bitwise(textured_corpus, family):
    """Every item of both packages' ImageTextDataset, the dummy item of the
    corrupt file included, is equal bit for bit; the port's dataset keeps
    its native loader."""
    from mit_tpu.text.tokenizer import Tokenizer as JTok
    from mit_tpu_torch.text.tokenizer import Tokenizer as TTok

    cfg = textured_corpus
    args = (cfg.IMAGE_DIR, cfg.CAPTIONS_FILE, cfg.MAX_SEQ_LEN)
    ours = tdata.ImageTextDataset(
        *args, TTok.from_files(cfg.VOCAB_PATH, cfg.MERGES_PATH, cfg),
        FAMILIES[family], verbose=False)
    theirs = jdata.ImageTextDataset(
        *args, JTok.from_files(cfg.VOCAB_PATH, cfg.MERGES_PATH, JConfig(
            DATA_DIR=cfg.DATA_DIR, MAX_SEQ_LEN=cfg.MAX_SEQ_LEN)),
        FAMILIES[family], verbose=False)
    assert ours.native_loader is not None and theirs.native_loader is not None
    assert len(ours) == len(theirs) == 18
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a["image_path"] == b["image_path"]
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["caption_tokens"], b["caption_tokens"])
    dummies = [i for i in range(len(ours))
               if ours[i]["image_path"] == tdata.DUMMY_PATH]
    assert len(dummies) == 1 and not ours[dummies[0]]["image"].any()
    # use_native_loader=False keeps PIL, which moves textured pixels
    pil = tdata.ImageTextDataset(
        *args, ours.tokenizer, FAMILIES[family], verbose=False,
        use_native_loader=False)
    assert pil.native_loader is None
    assert not np.array_equal(pil[0]["image"], ours[0]["image"])


@pytest.mark.usefixtures("image_loader_built")
def test_feature_cache_inputs_match_jax_bitwise(textured_corpus, monkeypatch):
    """FeatureCache.build feeds the encoder the JAX cache's pixels (its
    dataset's native loader's) bit for bit, and the two caches' features
    agree within 1e-5; the corrupt file is a failed path in both."""
    from mit_tpu_torch.text.tokenizer import Tokenizer as TTok

    cfg = textured_corpus
    tok = TTok.from_files(cfg.VOCAB_PATH, cfg.MERGES_PATH, cfg)
    vis = dict(family="vit", image_size=224, patch_size=56, hidden_size=48,
               num_layers=1, num_heads=2, intermediate_size=64,
               hidden_act="gelu", layer_norm_eps=1e-12, patch_bias=True,
               ln_pre=False, ln_post=True)
    dec = dict(vocab_size=300, embed_dim=32, num_heads=2, num_layers=1,
               ff_dim=48, max_seq_len=16, dropout=0.0, pad_idx=0)
    mj = jmodel.ModelConfig(FAMILIES["vit"], jvis.VisionConfig(**vis),
                            jdec.DecoderConfig(**dec), "cls")
    mt = tmodel.ModelConfig(FAMILIES["vit"], tvis.VisionConfig(**vis),
                            tdec.DecoderConfig(**dec), "cls")
    enc = jax.tree.map(np.asarray, jmodel.init_model_params(
        jax.random.PRNGKey(0), mj)["encoder"])
    args = (cfg.IMAGE_DIR, cfg.CAPTIONS_FILE, cfg.MAX_SEQ_LEN, tok,
            FAMILIES["vit"])
    ours_ds = tdata.ImageTextDataset(*args, verbose=False)
    theirs_ds = jdata.ImageTextDataset(*args, verbose=False)

    seen = []
    real = tfeatures.encode_images

    def spy(params, mcfg, pixels, *a, **k):
        seen.append(pixels.clone())
        return real(params, mcfg, pixels, *a, **k)

    monkeypatch.setattr(tfeatures, "encode_images", spy)
    ours = tfeatures.FeatureCache.build(ours_ds, params_from_jax(enc), mt,
                                        "cpu", batch_size=4, verbose=False)
    theirs = jfeatures.FeatureCache.build(theirs_ds, enc, mj, batch_size=4,
                                          verbose=False)
    paths = sorted(set(ours_ds.image_paths))
    pixels = torch.cat(seen).numpy()
    assert pixels.shape[0] == len(paths) == 10
    for row, path in enumerate(paths):
        if path in theirs.failed_paths:
            assert not pixels[row].any()
        else:
            np.testing.assert_array_equal(
                pixels[row], theirs_ds.native_loader.load_path(path))
    assert ours.failed_paths == theirs.failed_paths and len(ours.failed_paths) == 1
    assert ours.path_to_row == theirs.path_to_row
    np.testing.assert_allclose(ours.features.numpy(),
                               np.asarray(theirs.features), rtol=1e-5,
                               atol=1e-5)


def _write_encoder(root):
    """A seeded ViT tower at 224 px in patches of 56 (17 tokens), written in
    the HF layout through the port's codec: both packages load it."""
    from mit_tpu_torch.train.checkpoint import save_file

    vcfg = tvis.VisionConfig(
        family="vit", image_size=224, patch_size=56, hidden_size=64,
        num_layers=1, num_heads=1, intermediate_size=96, hidden_act="gelu",
        layer_norm_eps=1e-12, patch_bias=True, ln_pre=False, ln_post=True)
    params = tvis.init_vision_params(torch.Generator().manual_seed(3), vcfg)
    os.makedirs(root)
    save_file(tvis.hf_vision_state_dict_from_params(params, vcfg, ""),
              os.path.join(root, "model.safetensors"))
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"model_type": "vit", "hidden_size": 64,
                   "num_hidden_layers": 1, "num_attention_heads": 1,
                   "intermediate_size": 96, "image_size": 224,
                   "patch_size": 56, "hidden_act": "gelu",
                   "layer_norm_eps": 1e-12}, f)
    return root


def _loop_cfg(pkg_config, data_dir, encoder):
    return pkg_config(
        DATA_DIR=data_dir, MAX_SEQ_LEN=16, VOCAB_SIZE=300, BATCH_SIZE=4,
        NUM_EPOCHS=2, DECODER_EMBED_DIM=32, DECODER_LAYERS=1, DECODER_HEADS=2,
        DECODER_FF_DIM=48, DECODER_DROPOUT=0.0, LEARNING_RATE=3e-3,
        NUM_WORKERS=1, COMPUTE_DTYPE="float32", PRETRAINED_ENCODER=encoder,
        ENCODER_MODEL_NAME="tiny/test-vit", IMAGE_PROCESSOR_NAME="tiny/test-vit",
        HF_UPLOAD_BEST_CHECKPOINTS=False)


@pytest.mark.parametrize("cache", [True, False], ids=["cached", "in_graph"])
@pytest.mark.usefixtures("image_loader_built")
def test_train_loop_on_textured_jpegs_matches_jax(textured_corpus, tmp_path,
                                                  monkeypatch, cache):
    """train() on textured JPEGs (and a PNG and a corrupt file) gives the
    JAX loop's train and val losses of both epochs within 1e-5: the same
    encoder checkpoint, the same decoder draw, dropout 0, and the same
    pixels, which the C++ loader decodes in both packages. (With PIL
    pixels, one step off after the resize, the second epoch's val loss
    moves about 2e-4.)"""
    from mit_tpu.train.loop import train as jtrain
    from mit_tpu_torch.train import loop as tloop

    enc = _write_encoder(str(tmp_path / "encoder"))
    tcfg = _loop_cfg(Config, str(tmp_path / "torch") + "/", enc).replace(
        CACHE_ENCODER_FEATURES=cache)
    jcfg = _loop_cfg(JConfig, str(tmp_path / "jax") + "/", enc).replace(
        CACHE_ENCODER_FEATURES=cache)
    for d in (tcfg.DATA_DIR, jcfg.DATA_DIR):
        shutil.copytree(textured_corpus.DATA_DIR, d)
    k_init = jax.random.split(jax.random.PRNGKey(tcfg.RANDOM_SEED))[1]

    def jax_drawn_trainable(generator, mcfg, device=None):
        jm = jmodel.ModelConfig(
            mcfg.encoder_name, jvis.VisionConfig(**mcfg.vision._asdict()),
            jdec.DecoderConfig(**mcfg.decoder._asdict()), mcfg.memory_mode)
        params = jax.tree.map(np.asarray, jmodel.init_model_params(k_init, jm))
        return params_from_jax({k: v for k, v in params.items()
                                if k != "encoder"}, device)

    monkeypatch.setattr(tmodel, "_init_trainable", jax_drawn_trainable)
    ours = tloop.train(tcfg, auto_prepare=False, wandb_enabled=False,
                       device="cpu")
    theirs = jtrain(jcfg, auto_prepare=False, wandb_enabled=False)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose([e[key] for e in ours["epochs"]],
                                   [e[key] for e in theirs["epochs"]],
                                   rtol=1e-5)


# ----------------------------------------------------------------------
# the C++ BPE
# ----------------------------------------------------------------------
CORPUS = [
    "A black cat sat on a mat.",
    "Two dogs are running through a grassy field together.",
    "A man in a red shirt climbs a steep rock face.",
    "Children play soccer on a sunny afternoon in the park.",
    "The quick brown fox jumps over the lazy dog 42 times!",
]
PROBES = CORPUS + [
    "", "a", "unseen zebra words 999",
    "  múltiple   spaces and unicode café 😀",
    "the cat sat " * 40, "tabs\tand\nnewlines", "'s 're 've ''' ---",
]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    from mit_tpu.text.tokenizer import Tokenizer as JTok
    from mit_tpu_torch.text.tokenizer import train_tokenizer

    d = tmp_path_factory.mktemp("ntok")
    cfg = Config(DATA_DIR=str(d) + "/", MAX_SEQ_LEN=32)
    ours = train_tokenizer(iter(CORPUS), 400, cfg.VOCAB_PATH,
                           cfg.MERGES_PATH, cfg)
    theirs = JTok.from_files(cfg.VOCAB_PATH, cfg.MERGES_PATH,
                             JConfig(DATA_DIR=cfg.DATA_DIR, MAX_SEQ_LEN=32))
    return ours, theirs


def test_native_bpe_ids_match_python_bpe_and_jax(tokenizers):
    from mit_tpu.text.native import NativeBPE as JNative
    from mit_tpu_torch.text.native import NativeBPE

    ours, theirs = tokenizers
    native, jnat = NativeBPE(ours.bpe), JNative(theirs.bpe)
    for text in PROBES:
        ids = native.encode_ids(text)
        assert ids == ours.bpe.encode_ids(text, unk_id=ours.unk_id), text
        assert ids == jnat.encode_ids(text), text


def test_from_files_attaches_the_native_bpe(tokenizers):
    """from_files (train_tokenizer's return) carries the C++ encoder, and
    encode gives the same padded ids with it and without it, as JAX's."""
    from mit_tpu_torch.text.native import NativeBPE

    ours, theirs = tokenizers
    assert isinstance(ours._native, NativeBPE)
    with_native = [ours.encode(t) for t in PROBES]
    ours._native = None
    try:
        assert [ours.encode(t) for t in PROBES] == with_native
    finally:
        assert ours.use_native()
    assert with_native == [theirs.encode(t) for t in PROBES]
