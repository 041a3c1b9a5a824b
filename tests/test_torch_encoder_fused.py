"""The float encoder's fused elementwise passes (``ops/encoder_fused.py``,
``csrc/encoder_fused.cu``) on the CPU: the plain versions against the
composition of PyTorch ops the encoder ran before them, a replay of the
kernel's LayerNorm arithmetic within one rounding of it, the wrappers'
routes and refusals, and ``vision_forward`` built on them against the old
per-op composition, kept here as the reference: ViT, CLIP and BLIP, CLS
and full memory, f32 and bf16, and split over a 2-way "model" group (two
gloo processes: this file run as a script with ``--worker``).

Torch only. The kernels themselves run on the card:
``tests/test_torch_kernels.py`` (marked ``cuda``).
"""

import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, REPO)

from mit_tpu_torch import kernels  # noqa: E402
from mit_tpu_torch.models import vision as tvis  # noqa: E402
from mit_tpu_torch.models.convert import layer_params  # noqa: E402
from mit_tpu_torch.ops import attention as tattn  # noqa: E402
from mit_tpu_torch.ops import encoder_fused as ef  # noqa: E402
from mit_tpu_torch.parallel.collectives import (  # noqa: E402
    copy_to_model,
    reduce_from_model,
)

DTYPES = [torch.float32, torch.bfloat16]
WIDTHS = [48, 768, 1024, 1280]
TIMEOUT = 120                   # seconds the 2-rank spawn may take


def _data(m, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(m, d, generator=g) * 2).to(dtype)
    a = (torch.randn(m, d, generator=g) + 0.5).to(dtype)
    bias = torch.randn(d, generator=g) * 0.3
    ln = {"scale": 1 + 0.2 * torch.randn(d, generator=g),
          "bias": 0.1 * torch.randn(d, generator=g)}
    return x, a, bias, ln


# the composition of PyTorch ops that the encoder ran at a boundary
def _composition(x, a, bias, ln, eps):
    y = a if bias is None else a + bias.to(a.dtype)
    y = y if x is None else x + y
    if ln is None:
        return y, None
    yf = y.float()
    mean = yf.mean(-1, keepdim=True)
    var = yf.var(-1, unbiased=False, keepdim=True)
    h = (yf - mean) * torch.rsqrt(var + eps)
    return y, (h * ln["scale"] + ln["bias"]).to(y.dtype)


def _kernel_layer_norm(y, ln, eps):
    """The kernel's LayerNorm replayed: each row's f32 sum in order, the
    mean, the two-pass biased variance over the same values, then each
    element's steps rounded to f32, then one rounding to y's dtype."""
    yf = y.float()
    d = yf.shape[-1]
    mean = (yf.sum(-1, keepdim=True, dtype=torch.float32) / d).float()
    c = yf - mean
    var = ((c * c).sum(-1, keepdim=True, dtype=torch.float32) / d).float()
    r = torch.rsqrt(var + eps)
    return (((c * r) * ln["scale"]) + ln["bias"]).to(y.dtype)


def _ulp(h):
    """The spacing of h's dtype at |h| (at least its smallest normal's)."""
    info = torch.finfo(h.dtype)
    hf = h.float().abs().clamp_min(info.tiny)
    return torch.exp2(torch.floor(torch.log2(hf))) * info.eps


VARIANTS = {
    "boundary": dict(x=True, bias=True, ln=True),
    "no_residual": dict(x=False, bias=False, ln=True),   # ln_pre, layer 0
    "no_ln": dict(x=True, bias=True, ln=False),          # CLIP's last
}


def _variant(x, bias, ln, which):
    v = VARIANTS[which]
    return (x if v["x"] else None, bias if v["bias"] else None,
            ln if v["ln"] else None)


@pytest.mark.parametrize("which", sorted(VARIANTS))
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_add_layer_norm_plain_is_the_composition(dtype, d, which):
    """The plain version is the encoder's old composition bit for bit, at
    every width, ragged row counts, each variant; the kernel's LayerNorm
    arithmetic, replayed, lands within one rounding of the dtype."""
    x, a, bias, ln = _data(37, d, dtype, d)
    x, bias, ln = _variant(x, bias, ln, which)
    eps = 1e-5 if d != 768 else 1e-12
    y, h = ef.add_layer_norm_reference(x, a, bias, ln, eps)
    y_c, h_c = _composition(x, a, bias, ln, eps)
    assert torch.equal(y, y_c) and y.dtype == dtype
    if ln is None:
        assert h is None and h_c is None
        return
    assert torch.equal(h, h_c)
    replay = _kernel_layer_norm(y, ln, eps)
    gap = (replay.float() - h.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((gap <= _ulp(h)).all()), gap.max()
    else:
        torch.testing.assert_close(replay, h, rtol=2e-6, atol=2e-6)


def test_add_layer_norm_plain_without_adds_returns_the_product():
    _, a, _, ln = _data(5, 48, torch.float32, 0)
    y, h = ef.add_layer_norm_reference(None, a, None, ln, 1e-12)
    assert y is a and h.shape == a.shape


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("f", [64, 3072, 4096, 5120])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_bias_act_plain_is_the_composition(dtype, f, act):
    """act(a + bias) as the encoder composed it: the bias cast to the
    dtype, the add, then quick_gelu's multiply, sigmoid and multiply or
    F.gelu (erf), bit for bit."""
    _, a, _, _ = _data(19, f, dtype, f)
    bias = torch.randn(f, generator=torch.Generator().manual_seed(f))
    h = a + bias.to(dtype)
    want = h * torch.sigmoid(1.702 * h) if act == "quick_gelu" else F.gelu(h)
    got = ef.bias_act_reference(a, bias, act)
    assert got.dtype == dtype and torch.equal(got, want)


def test_wrappers_take_the_plain_versions_for_cpu_tensors():
    x, a, bias, ln = _data(9, 48, torch.bfloat16, 1)
    before = ef.add_layer_norm.launches, ef.bias_act.launches
    y, h = ef.add_layer_norm(x, a, bias, ln, 1e-5)
    y_p, h_p = ef.add_layer_norm_reference(x, a, bias, ln, 1e-5)
    assert torch.equal(y, y_p) and torch.equal(h, h_p)
    out = ef.bias_act(a, bias, "quick_gelu")
    assert torch.equal(out, ef.bias_act_reference(a, bias, "quick_gelu"))
    assert (ef.add_layer_norm.launches, ef.bias_act.launches) == before


def test_wrappers_refuse_a_device_with_no_kernel():
    _, a, bias, ln = _data(4, 48, torch.float32, 2)
    meta = a.to("meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        ef.add_layer_norm(None, meta, None, ln, 1e-5)
    with pytest.raises(ValueError, match="no kernel for meta"):
        ef.bias_act(meta, bias, "gelu")
    with pytest.raises(ValueError, match="unknown act"):
        ef.bias_act_reference(a, bias, "relu")


# ----------------------------------------------------------------------
# the checks the card's wrappers make before a launch
# ----------------------------------------------------------------------
def _ln_checked(change):
    d = change.get("d", 768)
    dtype = change.get("dtype", torch.bfloat16)
    a = torch.zeros(change.get("rows", 4), d, dtype=dtype)
    x = torch.zeros(4, change.get("x_d", d), dtype=change.get("x_dtype", dtype))
    bias = torch.zeros(change.get("bias_d", d), dtype=change.get(
        "bias_dtype", torch.float32))
    ln = {"scale": torch.ones(change.get("ln_d", d)), "bias": torch.zeros(d)}
    ef._check_add_layer_norm(
        None if change.get("no_x") else x, a,
        None if change.get("no_bias") else bias,
        None if change.get("no_ln") else ln)


@pytest.mark.parametrize("change,error", [
    (dict(dtype=torch.float16), TypeError),
    (dict(d=2056), ValueError),                      # past LN_MAX_D
    (dict(d=44), ValueError),                        # not 16 bytes of bf16
    (dict(rows=0), ValueError),
    (dict(x_d=1024), ValueError),
    (dict(x_dtype=torch.float32), ValueError),
    (dict(bias_d=767), ValueError),
    (dict(bias_dtype=torch.bfloat16), ValueError),
    (dict(ln_d=767), ValueError),
    (dict(no_x=True, no_bias=True, no_ln=True), ValueError),
])
def test_add_layer_norm_input_checks(change, error):
    with pytest.raises(error):
        _ln_checked(change)


@pytest.mark.parametrize("change", [
    dict(), dict(d=48), dict(d=1280), dict(d=2048), dict(d=44,
    dtype=torch.float32), dict(no_x=True, no_bias=True), dict(no_ln=True)])
def test_add_layer_norm_takes_the_encoders_shapes(change):
    _ln_checked(change)


def test_rows_take_a_strided_view_and_refuse_what_needs_a_copy():
    big = torch.zeros(4, 9, 768, dtype=torch.bfloat16)
    rows = ef._rows(big[:, :1], "x")
    assert rows.shape == (4, 768) and rows.stride(0) == 9 * 768
    with pytest.raises(ValueError, match="without a copy"):
        ef._rows(big[:, :2].transpose(0, 1), "x")
    with pytest.raises(ValueError, match="16-byte"):
        ef._rows(big[:, :, 1:9], "x")


@pytest.mark.parametrize("change,error", [
    (dict(act="relu"), ValueError),
    (dict(dtype=torch.float16), TypeError),
    (dict(f=3071), ValueError),
    (dict(bias_f=3071), ValueError),
    (dict(strided=True), ValueError),
    (dict(rows=0), ValueError),
])
def test_bias_act_input_checks(change, error):
    f = change.get("f", 3072)
    a = torch.zeros(change.get("rows", 4), f,
                    dtype=change.get("dtype", torch.bfloat16))
    if change.get("strided"):
        a = torch.zeros(4, 2 * f, dtype=torch.bfloat16)[:, ::2]
    with pytest.raises(error):
        ef._check_bias_act(a, torch.zeros(change.get("bias_f", f)),
                           change.get("act", "gelu"))


def test_bias_act_takes_the_encoders_shapes():
    for f, act in ((3072, "gelu"), (4096, "quick_gelu"), (5120, "gelu"),
                   (64, "gelu")):
        ef._check_bias_act(torch.zeros(3, f, dtype=torch.bfloat16),
                           torch.zeros(f), act)


@pytest.mark.parametrize("name", ["mit_add_layer_norm", "mit_bias_act"])
def test_the_entry_points_are_defined_with_their_arguments(name):
    import re

    src = (kernels.CSRC / "encoder_fused.cu").read_text()
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
    assert m is not None, f"{name} is not defined in encoder_fused.cu"
    n = len([p for p in m.group(1).split(",") if p.strip()])
    assert n == len(kernels.ENTRY_POINTS[name])


def test_multihead_attention_takes_the_encoders_form():
    """``out_bias=False``: the out-projection's sum before bo, which the
    default form adds, bit for bit."""
    g = torch.Generator().manual_seed(4)
    d, heads = 64, 4
    p = {w: torch.randn(d, d, generator=g) * 0.1
         for w in ("wq", "wk", "wv", "wo")}
    p.update({"b" + w[1]: torch.randn(d, generator=g) * 0.1 for w in list(p)})
    x = torch.randn(2, 7, d, generator=g)
    whole = tattn.multihead_attention(p, x, x, heads)
    part = tattn.multihead_attention(p, x, x, heads, out_bias=False)
    assert torch.equal(part + p["bo"], whole)
    with torch.no_grad():
        p["bo"].zero_()
    assert not torch.equal(part, whole)
    assert torch.equal(part, tattn.multihead_attention(p, x, x, heads))


def old_linear(x, params, w, b, cd):
    """Q's, K's and V's projection as the port made it before ``addmm``:
    the product and the bias add, each rounded to ``cd``."""
    return x.to(cd) @ params[w].to(cd) + params[b].to(cd)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_linear_is_the_old_form_rounded_once(dtype):
    """``_linear``'s addmm against the product and the bias add: within f32
    rounding, and in bf16 within one rounding of the output."""
    g = torch.Generator().manual_seed(5)
    p = {"w": torch.randn(96, 80, generator=g) * 0.1,
         "b": torch.randn(80, generator=g)}
    x = torch.randn(3, 11, 96, generator=g)
    got = tattn._linear(x, p, "w", "b", dtype)
    want = old_linear(x, p, "w", "b", dtype)
    assert got.shape == (3, 11, 80) and got.dtype == dtype
    exact = (x.to(dtype).double() @ p["w"].to(dtype).double()
             + p["b"].to(dtype).double())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:   # one rounding of the exact sum, the old form's two at most two
        ulp = exact.abs() * 2.0 ** -8
        assert ((got.double() - exact).abs() <= ulp + 1e-30).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-2)


# ----------------------------------------------------------------------
# vision_forward against the old per-op composition
# ----------------------------------------------------------------------
def composition_forward(params, cfg, pixel_values, compute_dtype=torch.float32,
                        use_kernel=True, cls_only=False, shard=None):
    """The float encoder as it ran before the fused passes: a LayerNorm,
    a bias add and a residual add each, the activation after its bias add.
    Q, K and V as ``multihead_attention`` makes them (with
    ``_linear`` patched to :func:`old_linear`, the old form to the
    letter)."""
    cd = compute_dtype
    eps = cfg.layer_norm_eps
    b, d = pixel_values.shape[0], cfg.hidden_size
    act = ((lambda t: t * torch.sigmoid(1.702 * t))
           if cfg.hidden_act == "quick_gelu" else F.gelu)
    group = shard.group if shard is not None else None
    heads = cfg.num_heads // (shard.m if group is not None else 1)
    hd = d // cfg.num_heads
    ln = tattn.layer_norm
    x = tvis._patchify(pixel_values.to(cd), cfg.patch_size) \
        @ params["patch_w"].to(cd)
    if cfg.patch_bias:
        x = x + params["patch_b"].to(cd)
    cls = params["cls"].to(cd).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(cd)[None]
    if cfg.ln_pre:
        x = ln(params["ln_pre"], x, eps)

    def mlp(x, layer):
        h = ln(layer["ln2"], x, eps)
        h = act(copy_to_model(h, group) @ layer["fc1"].to(cd)
                + layer["b1"].to(cd))
        return x + (reduce_from_model(h @ layer["fc2"].to(cd), group)
                    + layer["b2"].to(cd))

    n_full = cfg.num_layers - 1 if cls_only else cfg.num_layers
    for i in range(n_full):
        layer = layer_params(params["layers"], i)
        h = ln(layer["ln1"], x, eps)
        a = tattn.multihead_attention(
            layer["attn"], h, h, cfg.num_heads, compute_dtype=cd,
            use_kernel=use_kernel, shard=shard)
        x = x + a
        x = mlp(x, layer)
    if cls_only:
        layer = layer_params(params["layers"], cfg.num_layers - 1)
        attn = layer["attn"]
        h = copy_to_model(ln(layer["ln1"], x, eps), group)
        q1 = h[:, :1] @ attn["wq"].to(cd) + attn["bq"].to(cd)
        k = h @ attn["wk"].to(cd) + attn["bk"].to(cd)
        v = h @ attn["wv"].to(cd) + attn["bv"].to(cd)
        s = k.shape[1]
        scores = torch.einsum(
            "bhd,bshd->bhs", q1.reshape(b, heads, hd).float(),
            k.reshape(b, s, heads, hd).float()) / math.sqrt(hd)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhs,bshd->bhd", probs.to(cd),
                           v.reshape(b, s, heads, hd))
        a = (reduce_from_model(ctx.reshape(b, 1, heads * hd)
                               @ attn["wo"].to(cd), group) + attn["bo"].to(cd))
        x = mlp(x[:, :1] + a, layer)
    if cfg.ln_post:
        x = ln(params["ln_post"], x, eps)
    return x


# tiny towers of each family (4 heads, 2 layers, 5 x 5 patches)
TOWER = dict(image_size=40, patch_size=8, hidden_size=64, num_layers=2,
             num_heads=4, intermediate_size=96)
FAMILIES = {
    "vit": "google/vit-base-patch16-224-in21k",
    "clip": "openai/clip-vit-base-patch32",
    "blip": "Salesforce/blip-image-captioning-base",
}


def tower(family, seed=0):
    """A family's preset cut to TOWER, its biases and LayerNorms drawn (an
    initializer's zeros and ones would hide a bias or a scale applied in
    the wrong place), and pixels for a batch of 3."""
    cfg = tvis.PRESETS[FAMILIES[family]]._replace(**TOWER)
    g = torch.Generator().manual_seed(seed)
    params = tvis.init_vision_params(g, cfg)

    def draw(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                draw(v)
            elif k.startswith("b") or k in ("scale", "patch_b", "cls"):
                tree[k] = v + 0.1 * torch.randn(v.shape, generator=g)
    draw(params)
    px = torch.randn(3, 3, 40, 40, generator=g)
    return cfg, params, px


@pytest.mark.parametrize("cls_only", [False, True], ids=["full", "cls"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_vision_forward_is_the_old_composition(family, dtype, cls_only,
                                                monkeypatch):
    """Bit for bit the per-op composition with Q, K and V in the encoder's
    form, both routes; 2L + 1 boundaries (2L + 2 with ln_pre) a call, all
    through the wrapper or all through its plain version by the route. In
    f32 within 1e-5 of the old form to the letter too (only the three
    addmm's roundings differ)."""
    cfg, params, px = tower(family)
    want = composition_forward(params, cfg, px, dtype, cls_only=cls_only)
    n = 2 * cfg.num_layers + 1 + cfg.ln_pre
    calls = {"add_layer_norm": 0, "add_layer_norm_reference": 0}
    for name in calls:
        def spy(*args, fn=getattr(tvis, name), name=name):
            calls[name] += 1
            return fn(*args)
        monkeypatch.setattr(tvis, name, spy)
    for use_kernel, route in ((True, "add_layer_norm"),
                              (False, "add_layer_norm_reference")):
        before = dict(calls)
        got = tvis.vision_forward(params, cfg, px, dtype, use_kernel,
                                  cls_only=cls_only)
        assert calls[route] - before[route] == n
        assert sum(calls.values()) - sum(before.values()) == n
        assert got.shape == (3, 1 if cls_only else cfg.seq_len, 64)
        if use_kernel:
            assert torch.equal(got, want)
        else:      # the plain attention path beside the kernel's wrapper
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=1e-5 if dtype == torch.float32
                                       else 0.1)
    if dtype == torch.float32:
        monkeypatch.setattr(tattn, "_linear", old_linear)
        old = composition_forward(params, cfg, px, dtype, cls_only=cls_only)
        torch.testing.assert_close(want, old, rtol=1e-5, atol=1e-5)


def test_vision_forward_at_one_layer_in_cls_mode():
    """A one-layer tower in CLS mode has no full layer: the embeddings'
    LayerNorm feeds the CLS layer straight away."""
    cfg, params, px = tower("clip")
    cfg = cfg._replace(num_layers=1)
    got = tvis.vision_forward(params, cfg, px, cls_only=True)
    want = composition_forward(params, cfg, px, cls_only=True)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# the split encoder: two gloo ranks
# ----------------------------------------------------------------------
def check_split(rank, world, init):
    """Each family's tower split over a "model" group of ``world``, CLS and
    full, f32 and bf16: this rank's output of vision_forward and of the
    composition on the same shard, and the whole tower's on one rank."""
    import torch.distributed as dist

    from mit_tpu_torch.parallel import mesh as pmesh

    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        mesh = pmesh.init_distributed_mesh((1, world), "cpu")
        out = {}
        for family in FAMILIES:
            cfg, params, px = tower(family)
            local = pmesh.shard_encoder(params, cfg, mesh)
            shard = mesh.step_shard(px.shape[0])
            for dtype in DTYPES:
                for cls_only in (False, True):
                    got = tvis.vision_forward(local, cfg, px, dtype,
                                              cls_only=cls_only, shard=shard)
                    ref = composition_forward(local, cfg, px, dtype,
                                              cls_only=cls_only, shard=shard)
                    one = tvis.vision_forward(params, cfg, px, dtype,
                                              cls_only=cls_only)
                    key = f"{family} {str(dtype)[6:]} {cls_only}"
                    out[key] = (torch.equal(got, ref),
                                (got.float() - one.float()).abs().max().item(),
                                one.float().abs().max().item())
        return out
    finally:
        dist.destroy_process_group()


def test_split_vision_forward_is_the_old_composition(tmp_path):
    """Under a 2-way model split every rank's output is bit for bit the
    composition's on its shard, and within f32 rounding of the whole tower
    on one device (bf16: within 3 % of its largest value)."""
    init = tmp_path / f"split_{time.monotonic_ns()}.init"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = []
    for r in range(2):
        log = open(tmp_path / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, "--worker", str(r), "2", str(init),
             str(tmp_path / f"rank{r}.json")],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    deadline = time.monotonic() + TIMEOUT
    try:
        for p, _ in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the split ranks did not end in {TIMEOUT} s")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"rank{r}.log").read_text()
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert len(res) == 2 * 2 * len(FAMILIES)
        for key, (same, err, top) in res.items():
            assert same, f"rank {r} {key}"
            assert err <= (1e-5 * max(top, 1.0) if "float32" in key
                           else 0.03 * top), (r, key, err, top)


if __name__ == "__main__" and sys.argv[1] == "--worker":
    rank, world, init, out = sys.argv[2:6]
    torch.set_num_threads(1)
    result = check_split(int(rank), int(world), init)
    with open(out, "w") as f:
        json.dump(result, f)
