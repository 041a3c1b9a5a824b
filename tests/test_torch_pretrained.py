"""Port parity: pretrained encoder loading (``mit_tpu_torch.models.
pretrained``), ``config_from_hf``, ``init_model_params_pretrained``, the
training loop's ``PRETRAINED_ENCODER`` modes, ``pretrained_captioner`` and
``encoder_tools`` against their ``mit_tpu`` counterparts on the CPU, f32.

No network: checkpoints are written in the test in the layouts a hub
download has (``save_pretrained`` of transformers models from a torch seed),
as bare weights files, as reference-style ``.pt`` wrappers and as F16
safetensors. Both packages load the same file.
"""

import json
import os
import shutil

# transformers writes the checkpoints; its TensorFlow backend is not needed
os.environ.setdefault("USE_TF", "0")

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mit_tpu.config import Config as JConfig
from mit_tpu.models import decoder as jdec
from mit_tpu.models import encoder_tools as jtools
from mit_tpu.models import model as jmodel
from mit_tpu.models import pretrained as jpre
from mit_tpu.models import vision as jvis
from mit_tpu.train import checkpoint as jckpt
from mit_tpu_torch.config import Config
from mit_tpu_torch.models import encoder_tools as ttools
from mit_tpu_torch.models import model as tmodel
from mit_tpu_torch.models import pretrained as tpre
from mit_tpu_torch.models import vision as tvis
from mit_tpu_torch.models.convert import params_from_jax, params_to_jax
from mit_tpu_torch.train.checkpoint import load_file, save_file

# the geometry of tests/test_pretrained.py: head width 64, as the shape
# inference assumes
D, L, H, F, IMG, PATCH = 128, 2, 2, 64, 32, 16
FAMILIES = ("vit", "clip", "blip")
DEC = dict(DECODER_EMBED_DIM=64, DECODER_LAYERS=1, DECODER_HEADS=2,
           DECODER_FF_DIM=128, MAX_SEQ_LEN=16)


def _geometry(**kw):
    return dict(dict(hidden_size=D, num_hidden_layers=L, num_attention_heads=H,
                     intermediate_size=F, image_size=IMG, patch_size=PATCH), **kw)


def _hf_model(family, composite=False, **geometry):
    """A transformers vision tower (or composite model) from a torch seed."""
    import transformers as tf

    torch.manual_seed(FAMILIES.index(family) + 10 * composite)
    g = _geometry(**geometry)
    if family == "vit":
        return tf.ViTModel(tf.ViTConfig(**g), add_pooling_layer=False).eval()
    text = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=64, vocab_size=99)
    if family == "clip":
        if composite:
            return tf.CLIPModel(tf.CLIPConfig(
                text_config=text, vision_config=g, projection_dim=16)).eval()
        return tf.CLIPVisionModel(tf.CLIPVisionConfig(**g)).eval()
    if composite:
        return tf.BlipModel(tf.BlipConfig(
            text_config=text, vision_config=g, projection_dim=16)).eval()
    return tf.BlipVisionModel(tf.BlipVisionConfig(**g)).eval()


def _vision_tower(m):
    return getattr(m, "vision_model", m)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """{(family, form): (path, the torch tower it holds)} for every source
    form a pretrained encoder comes in."""
    root = tmp_path_factory.mktemp("pretrained")
    out = {}
    for family in FAMILIES:
        m = _hf_model(family)
        d = root / f"{family}_dir"
        m.save_pretrained(d)
        out[family, "dir"] = (str(d), m)
        # a bare weights file, no config.json beside it: geometry inferred
        (root / f"{family}_bare").mkdir()
        bare = root / f"{family}_bare" / f"{family}.safetensors"
        shutil.copy(d / "model.safetensors", bare)
        out[family, "bare_safetensors"] = (str(bare), m)
        # the reference's training checkpoint: weights under model_state_dict
        pt = root / f"{family}_ckpt.pt"
        torch.save({"epoch": 3, "model_state_dict": m.state_dict(),
                    "best_val_loss": 2.5}, pt)
        out[family, "pt_wrapper"] = (str(pt), m)
        # F16 weights beside the config
        (root / f"{family}_f16").mkdir()
        save_file({k: v.astype(np.float16)
                   for k, v in load_file(str(d / "model.safetensors")).items()},
                  str(root / f"{family}_f16" / "model.safetensors"))
        shutil.copy(d / "config.json", root / f"{family}_f16" / "config.json")
        out[family, "f16"] = (str(root / f"{family}_f16"), m)
    for family in ("clip", "blip"):
        m = _hf_model(family, composite=True)
        d = root / f"{family}_composite"
        m.save_pretrained(d)
        out[family, "composite"] = (str(d), m)
    return out


def _pixels(b=2, size=IMG, seed=0):
    return np.random.default_rng(seed).normal(size=(b, 3, size, size)).astype(
        np.float32)


def _assert_bit_equal(tparams, jparams):
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(tparams),
                 jax.tree.map(np.asarray, jparams))


CASES = [(f, form) for f in FAMILIES
         for form in ("dir", "bare_safetensors", "pt_wrapper", "f16")]
CASES += [("clip", "composite"), ("blip", "composite")]


@pytest.mark.parametrize("family,form", CASES,
                         ids=[f"{f}-{form}" for f, form in CASES])
def test_load_pretrained_encoder_matches_jax(sources, family, form):
    """The same VisionConfig, bit-equal parameters and forwards within 1e-4
    of the JAX package's (and 2e-4 of the torch tower the file holds)."""
    path, m = sources[family, form]
    tcfg, tparams = tpre.load_pretrained_encoder(path, local_files_only=True)
    jcfg, jparams = jpre.load_pretrained_encoder(path, local_files_only=True)
    assert tcfg._asdict() == jcfg._asdict()
    assert tcfg.family == family and tcfg.hidden_size == D
    assert (tcfg.num_layers, tcfg.num_heads, tcfg.image_size) == (L, H, IMG)
    _assert_bit_equal(tparams, jparams)
    px = _pixels()
    ours = tvis.vision_forward(tparams, tcfg, torch.from_numpy(px)).numpy()
    want = np.asarray(jvis.vision_forward(jparams, jcfg, jnp.asarray(px)))
    np.testing.assert_allclose(ours, want, atol=1e-4)
    with torch.no_grad():
        hf = _vision_tower(m)(pixel_values=torch.from_numpy(px))
    if form == "f16":      # the file holds the tower's weights rounded to f16
        return
    np.testing.assert_allclose(ours, hf.last_hidden_state.numpy(), atol=2e-4)


@pytest.mark.parametrize("family,form", [(f, "dir") for f in FAMILIES]
                         + [("clip", "composite"), ("blip", "composite")])
def test_state_dict_pieces_match_jax(sources, family, form):
    """load_state_dict, detect_family, detect_hf_prefix and
    infer_config_from_state_dict give JAX's answers."""
    path = os.path.join(sources[family, form][0], "model.safetensors")
    tsd, jsd = tpre.load_state_dict(path), jpre.load_state_dict(path)
    assert sorted(tsd) == sorted(jsd)
    assert tpre.detect_family(tsd) == jpre.detect_family(jsd) == family
    prefix = tvis.detect_hf_prefix(tsd, tvis.FAMILY_BASE[family])
    # a CLIP vision model nests its tower, a BLIP vision model does not
    nested = form == "composite" or family == "clip"
    assert prefix == ("vision_model." if nested else "")
    ours = tpre.infer_config_from_state_dict(tsd, family, prefix)
    want = jpre.infer_config_from_state_dict(jsd, family, prefix)
    assert ours._asdict() == want._asdict()
    with pytest.raises(ValueError):
        tpre.detect_family({"decoder.embed.weight": 0})
    with pytest.raises(ValueError):
        jpre.detect_family({"decoder.embed.weight": 0})


JSON_DICTS = [
    {"model_type": "vit", "hidden_size": 384, "num_hidden_layers": 6,
     "num_attention_heads": 6, "intermediate_size": 1536, "image_size": 160,
     "patch_size": 16},
    {"model_type": "clip_vision_model", "hidden_size": 1024,
     "num_hidden_layers": 24, "num_attention_heads": 16,
     "intermediate_size": 4096, "image_size": 224, "patch_size": 14,
     "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5},
    {"model_type": "clip", "vision_config": {
        "model_type": "clip_vision_model", "hidden_size": 512,
        "num_hidden_layers": 8, "num_attention_heads": 8,
        "intermediate_size": 2048, "image_size": 224, "patch_size": 32}},
    {"model_type": "blip", "vision_config": {"hidden_size": 768,
                                             "image_size": 384}},
    {"model_type": "blip_vision_model", "hidden_act": "gelu"},
    {},
]


@pytest.mark.parametrize("d", JSON_DICTS, ids=[
    "vit", "clip_vision", "clip_composite", "blip_composite_sparse",
    "blip_vision_defaults", "empty"])
@pytest.mark.parametrize("family", [None, "clip"])
def test_config_from_json_dict_matches_jax(d, family):
    ours = tpre.config_from_json_dict(json.loads(json.dumps(d)), family)
    want = jpre.config_from_json_dict(json.loads(json.dumps(d)), family)
    assert ours._asdict() == want._asdict()


def _hf_configs():
    import transformers as tf

    g = _geometry(image_size=48, hidden_act="gelu_new", layer_norm_eps=1e-6)
    text = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2)
    return {
        "vit": tf.ViTConfig(**g),
        "clip_vision": tf.CLIPVisionConfig(**_geometry(patch_size=14,
                                                      image_size=224)),
        "blip_vision": tf.BlipVisionConfig(**g),
        "clip_composite": tf.CLIPConfig(text_config=text, vision_config=g),
        "blip_composite": tf.BlipConfig(text_config=text, vision_config=g),
    }


@pytest.mark.parametrize("name", ["vit", "clip_vision", "blip_vision",
                                  "clip_composite", "blip_composite"])
@pytest.mark.parametrize("family", [None, "vit"])
def test_config_from_hf_matches_jax(name, family):
    hf = _hf_configs()[name]
    ours = tvis.config_from_hf(hf, family)
    want = jvis.config_from_hf(hf, family)
    assert ours._asdict() == want._asdict()


def test_resolve_encoder_source_matches_jax(sources, tmp_path):
    vit_dir = sources["vit", "dir"][0]
    stray = tmp_path / "stray"
    stray.mkdir()
    shutil.copy(os.path.join(vit_dir, "model.safetensors"),
                stray / "weights.bin")
    (stray / "notes.txt").write_text("not weights")
    cases = [vit_dir, os.path.join(vit_dir, "model.safetensors"),
             sources["vit", "bare_safetensors"][0],
             sources["vit", "pt_wrapper"][0], str(stray)]
    for path in cases:
        ours = tpre.resolve_encoder_source(path, local_files_only=True)
        assert ours == jpre.resolve_encoder_source(path, local_files_only=True)
    assert tpre.resolve_encoder_source(str(stray)) == (
        str(stray / "weights.bin"), None)
    empty = tmp_path / "empty"
    empty.mkdir()
    for pkg in (tpre, jpre):
        with pytest.raises(FileNotFoundError):
            pkg.resolve_encoder_source(str(empty))


@pytest.mark.parametrize("hub", ["offline", "absent"])
def test_unresolvable_repo_id_raises_in_both(monkeypatch, hub):
    """A repo id that is neither local nor cached, with local files only,
    raises ValueError in both packages; so does any repo id where
    huggingface_hub is missing."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    if hub == "absent":
        monkeypatch.setitem(__import__("sys").modules, "huggingface_hub", None)
    for pkg in (tpre, jpre):
        with pytest.raises(ValueError, match="definitely/not-a-real"):
            pkg.load_pretrained_encoder("definitely/not-a-real-model-zzz",
                                        local_files_only=True)


@pytest.mark.parametrize("loader", ["resolve_encoder_source",
                                    "load_pretrained_encoder",
                                    "init_model_params_pretrained"])
def test_repo_id_is_looked_up_locally_by_default(monkeypatch, loader):
    """With their defaults the port's loaders look a repo id up in the
    local HF cache only: hf_hub_download is never let onto the network (the
    JAX package's defaults fetch). pretrained_captioner defaults alike."""
    import inspect
    import sys
    import types

    from mit_tpu_torch.decode.api import pretrained_captioner

    asked = []

    def hf_hub_download(repo_id, filename, local_files_only=False):
        asked.append(local_files_only)
        raise FileNotFoundError(filename)

    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
        hf_hub_download=hf_hub_download))
    repo = "definitely/not-a-real-model-zzz"
    call = {
        "resolve_encoder_source": lambda: tpre.resolve_encoder_source(repo),
        "load_pretrained_encoder": lambda: tpre.load_pretrained_encoder(repo),
        "init_model_params_pretrained":
            lambda: tmodel.init_model_params_pretrained(
                torch.Generator().manual_seed(0), Config(**DEC), 50, repo,
                device="cpu"),
    }[loader]
    with pytest.raises(ValueError, match="not-a-real"):
        call()
    assert asked and all(x is True for x in asked)
    assert inspect.signature(pretrained_captioner).parameters[
        "local_files_only"].default is True


def _configs(**kw):
    return (Config(**DEC, **kw), JConfig(**DEC, **kw))


def _outcome(build, cfg, mcfg, *args):
    try:
        return build(cfg, mcfg, *args)
    except Exception as e:      # the outcome under test may be a raise
        return type(e)


# "mit/tiny-vit-debug" is a preset in both packages and a repo id that
# resolves nowhere here, so its random fallback is small
@pytest.mark.parametrize("mode,name,want", [
    ("off", "mit/tiny-vit-debug", "random"),
    ("auto", "vit_dir", "loaded"),
    ("auto", "mit/tiny-vit-debug", "random"),
    ("required", "clip_composite", "loaded"),
    ("required", "mit/tiny-vit-debug", "raised"),
    ("<path>", "blip_dir", "loaded"),
    ("<path>", "mit/tiny-vit-debug", "raised"),
])
def test_build_model_params_modes_match_jax(sources, monkeypatch, mode, name,
                                            want):
    """Each PRETRAINED_ENCODER mode gives the JAX package's outcome: a loaded
    encoder (equal to JAX's, its geometry in mcfg), a random one under the
    preset's geometry, or the same exception."""
    from mit_tpu.train.loop import build_model_params as jbuild
    from mit_tpu_torch.train.loop import build_model_params as tbuild

    monkeypatch.delenv("MIT_ALLOW_DOWNLOAD", raising=False)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    key = tuple(name.split("_"))
    path = sources[key][0] if key in sources else name
    kw = (dict(PRETRAINED_ENCODER=mode, ENCODER_MODEL_NAME=path)
          if mode != "<path>" else dict(PRETRAINED_ENCODER=path))
    tcfg, jcfg = _configs(**kw)
    tm, jm = tmodel.ModelConfig.build(tcfg, 64), jmodel.ModelConfig.build(jcfg, 64)
    ours = _outcome(tbuild, tcfg, tm, torch.Generator().manual_seed(0), 64,
                    "cpu")
    theirs = _outcome(jbuild, jcfg, jm, jax.random.PRNGKey(0), 64)
    if want == "raised":
        assert isinstance(ours, type) and ours is theirs, (ours, theirs)
        return
    (tm2, tparams), (jm2, jparams) = ours, theirs
    assert tm2.vision._asdict() == jm2.vision._asdict()
    assert tparams["decoder"]["token_embedding"].shape == (64, 64)
    if want == "random":
        assert tm2 == tm and tm2.vision == tvis.config_for_encoder(path)
        return
    assert tm2.vision.hidden_size == D and tm2.vision != tm.vision
    _assert_bit_equal(tparams["encoder"], jparams["encoder"])
    assert {k for k in tparams} == {k for k in jparams}


def test_init_model_params_pretrained_matches_jax(sources):
    path = sources["clip", "composite"][0]
    tcfg, jcfg = _configs()
    tm, tparams = tmodel.init_model_params_pretrained(
        torch.Generator().manual_seed(0), tcfg, 64, path, True, "cpu")
    jm, jparams = jmodel.init_model_params_pretrained(
        jax.random.PRNGKey(0), jcfg, 64, path, True)
    assert tm.vision._asdict() == jm.vision._asdict()
    assert tm.decoder._asdict() == jm.decoder._asdict()
    _assert_bit_equal(tparams["encoder"], jparams["encoder"])
    for k in ("decoder", "projection"):
        assert (jax.tree.map(np.shape, params_to_jax(tparams[k]))
                == jax.tree.map(np.shape, jparams[k]))


# ----------------------------------------------------------------------
# booting the trainer and the captioner
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 images of 40 x 40, 2 captions each (tests/test_torch_train.py's
    corpus), and a ViT checkpoint at the family's 224 px (the JAX dataset
    preprocesses at the family default) in patches of 56 (17 tokens)."""
    from PIL import Image

    d = tmp_path_factory.mktemp("pretrained_train")
    data = d / "data"
    (data / "images").mkdir(parents=True)
    caps = {}
    for i in range(8):
        name = f"im{i}.jpg"
        Image.new("RGB", (40, 40), (i * 30 % 255, 60, 90)).save(
            data / "images" / name)
        caps[name] = [f"a photo number {i} with things",
                      f"another view of item {i}"]
    with open(data / "captions.json", "w") as f:
        json.dump(caps, f)
    m = _hf_model("vit", image_size=224, patch_size=56)
    m.save_pretrained(d / "vit224")
    return str(data) + "/", str(d / "vit224"), m


def _train_cfg(pkg_config, data_dir, encoder):
    return pkg_config(
        DATA_DIR=data_dir, MAX_SEQ_LEN=16, VOCAB_SIZE=300, BATCH_SIZE=4,
        NUM_EPOCHS=1, DECODER_EMBED_DIM=32, DECODER_LAYERS=1, DECODER_HEADS=2,
        DECODER_FF_DIM=48, DECODER_DROPOUT=0.0, LEARNING_RATE=3e-3,
        NUM_WORKERS=1, COMPUTE_DTYPE="float32", PRETRAINED_ENCODER=encoder,
        ENCODER_MODEL_NAME="tiny/test-vit", IMAGE_PROCESSOR_NAME="tiny/test-vit",
        HF_UPLOAD_BEST_CHECKPOINTS=False)


def test_train_boots_from_the_pretrained_encoder(corpus, tmp_path,
                                                 monkeypatch):
    """train() with PRETRAINED_ENCODER=<dir> trains over the loaded encoder:
    its best checkpoint carries that encoder unchanged, and its losses equal
    the JAX loop's at dropout 0 (the same decoder init, drawn by JAX)."""
    from mit_tpu.train.loop import train as jtrain
    from mit_tpu_torch.train import loop as tloop

    data_dir, enc_dir, m = corpus
    # one corpus and tokenizer, copied so that each loop writes its own
    # checkpoints
    tcfg = _train_cfg(Config, str(tmp_path / "torch") + "/", enc_dir)
    jcfg = _train_cfg(JConfig, str(tmp_path / "jax") + "/", enc_dir)
    shutil.copytree(data_dir, tcfg.DATA_DIR)
    os.makedirs(tcfg.OUTPUT_DIR, exist_ok=True)
    tloop.ensure_tokenizer(tcfg)
    shutil.copytree(tcfg.DATA_DIR, jcfg.DATA_DIR)
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
    saved = load_file(ours["best_checkpoint"])
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(saved["encoder." + k], v.numpy())
    theirs = jtrain(jcfg, auto_prepare=False, wandb_enabled=False)
    np.testing.assert_allclose(ours["epochs"][0]["train_loss"],
                               theirs["epochs"][0]["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(ours["best_val_loss"], theirs["best_val_loss"],
                               rtol=1e-5)


def test_pretrained_captioner_greedy_tokens_match_jax(sources, tmp_path):
    """The same directory and decoder checkpoint: the port's captioner holds
    JAX's weights and gives JAX's greedy tokens, f32."""
    from PIL import Image

    from mit_tpu.decode.api import pretrained_captioner as jcaptioner
    from mit_tpu_torch.decode.api import pretrained_captioner as tcaptioner
    from mit_tpu_torch.text.tokenizer import train_tokenizer

    enc = sources["clip", "composite"][0]
    data = tmp_path / "data"
    data.mkdir()
    kw = dict(DATA_DIR=str(data) + "/", VOCAB_SIZE=300, **DEC)
    tcfg, jcfg = Config(**kw), JConfig(**kw)
    vocab = train_tokenizer(
        iter(["a dog runs", "a cat sits", "a bird flies"] * 3),
        tcfg.VOCAB_SIZE, tcfg.VOCAB_PATH, tcfg.MERGES_PATH, tcfg,
    ).get_vocab_size()
    jm, _ = jmodel.init_model_params_pretrained(
        jax.random.PRNGKey(0), jcfg, vocab, enc, True)
    trained = jmodel.init_model_params(jax.random.PRNGKey(7), jm)
    ckpt = str(tmp_path / "decoder.safetensors")
    jckpt.save_safetensors(ckpt, trained, jm)

    ours = tcaptioner(tcfg, enc, ckpt, local_files_only=True, device="cpu")
    theirs = jcaptioner(jcfg, enc, ckpt, local_files_only=True)
    assert ours.mcfg.vision._asdict() == theirs.mcfg.vision._asdict()
    assert ours.device.type == "cpu"
    for k in ("encoder", "decoder", "projection"):
        _assert_bit_equal(ours.params[k], theirs.params[k])
    _assert_bit_equal(ours.params["decoder"], trained["decoder"])
    r = np.random.default_rng(3)
    images = [Image.fromarray(r.integers(0, 256, (40 + 7 * i, 52, 3),
                                         dtype=np.uint8)) for i in range(3)]
    want = theirs.generate_batch(images, max_len=12)
    assert ours.generate_batch(images, max_len=12) == want
    assert [ours.postprocess(t) for t in want] == [theirs.postprocess(t)
                                                   for t in want]


# ----------------------------------------------------------------------
# encoder_tools
# ----------------------------------------------------------------------
def test_encode_image_matches_jax(monkeypatch):
    from PIL import Image

    name = "mit/tiny-vit-debug"
    monkeypatch.setattr(jtools, "_cache", {})
    monkeypatch.setattr(ttools, "_cache", {})
    vcfg = jvis.config_for_encoder(name)
    params = jax.tree.map(np.asarray,
                          jvis.init_vision_params(jax.random.PRNGKey(1), vcfg))
    img = Image.fromarray(np.random.default_rng(4).integers(
        0, 256, (60, 90, 3), dtype=np.uint8))
    want = jtools.encode_image(img, name, jax.tree.map(jnp.asarray, params))
    ours = ttools.encode_image(img, name, params_from_jax(params),
                               device="cpu")
    assert ours.shape == want.shape == (1, vcfg.seq_len, vcfg.hidden_size)
    np.testing.assert_allclose(ours, want, atol=1e-4)
    # the first call fixed the name's weights, as in the JAX package
    np.testing.assert_array_equal(ttools.encode_image(img, name), ours)
    other = ttools.encode_image(img, "openai/clip-vit-base-patch32",
                                device="cpu")
    assert other.shape == (1, 50, 768) and np.isfinite(other).all()


@pytest.mark.parametrize("name", [None, "openai/clip-vit-large-patch14",
                                  "Salesforce/blip-image-captioning-base",
                                  "some/unknown-model", "mit/tiny-vit-debug"])
def test_get_encoder_output_dim_matches_jax(name):
    assert ttools.get_encoder_output_dim(name) == jtools.get_encoder_output_dim(
        name)
    kw = dict(ENCODER_MODEL_NAME=name or "openai/clip-vit-large-patch14")
    assert (ttools.get_encoder_output_dim(None, Config(**kw))
            == jtools.get_encoder_output_dim(None, JConfig(**kw)))
