"""The grouped SwiGLU expert kernel (``csrc/moe_experts.cu``) against its
plain composition (``ops.moe.grouped_swiglu_plain``). Torch only, so the
card runs it without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_moe_kernel.py

Tests marked ``cuda`` need an NVIDIA GPU and skip without one. At
Kimi-VL-A3B's widths (D 2048, F 1408, 64 experts, 6 a token) they hold the
kernel to the composition at the decode step's 384 routes and the
prefill's 30,720, with experts given no rows, to bf16 rounding: both sum
in f32 and round the hidden and the output to bf16, so they differ where
a sum's order flips a rounding, by an ulp of the largest values (2 %
of the largest output bounds it). The rest checks, on the CPU, what
surrounds the kernel: its input checks and the plain route.
"""

import pytest
import torch

from mit_tpu_torch.models import kimi_vl as kv
from mit_tpu_torch.ops import moe

D, F, E, K = 2048, 1408, 64, 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(device, e=E, d=D, f=F, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    w = lambda *s: (torch.randn(s, generator=g, device=device) * 0.02
                    ).to(torch.bfloat16)
    return w(e, d, f), w(e, d, f), w(e, f, d)


def _routes(t, experts, device, seed=1, e=E, d=D):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((t, d), generator=g, device=device).to(torch.bfloat16)
    idx = torch.rand((t, experts), generator=g, device=device) \
        .topk(K, -1).indices
    return x, moe.group_routes(idx, e)


@pytest.mark.cuda
@pytest.mark.parametrize("experts", [E, E // 2, K], ids=["all", "half",
                                                          "six"])
@pytest.mark.parametrize("t", [64, 5120, 1], ids=["decode", "prefill",
                                                  "one_row"])
def test_kernel_matches_the_composition(cuda, t, experts):
    wg, wu, wd = _weights(cuda)
    x, (_, token, offsets) = _routes(t, experts, cuda)
    before = moe.moe_experts.launches
    got = moe.grouped_swiglu(x, token, offsets, wg, wu, wd).float()
    assert moe.moe_experts.launches == before + 2
    want = moe.grouped_swiglu_plain(x, token, offsets, wg, wu, wd).float()
    assert got.shape == (t * K, D)
    scale = want.abs().max()
    assert float((got - want).abs().max()) <= 2e-2 * float(scale)
    assert float((got - want).abs().mean()) <= 1e-3 * float(scale)


@pytest.mark.cuda
def test_kernel_at_small_widths_and_ragged_tiles(cuda):
    """Tiles of 64 rows cut unevenly: 0, 1, 63, 64, 65 and 130 rows."""
    e, d, f = 6, 128, 192
    wg, wu, wd = _weights(cuda, e, d, f)
    counts = [0, 1, 63, 64, 65, 130]
    token = torch.randint(0, 40, (sum(counts),), device=cuda,
                          dtype=torch.int32)
    offsets = torch.tensor([0] + counts, device=cuda).cumsum(0) \
        .to(torch.int32)
    x = torch.randn((40, d), device=cuda).to(torch.bfloat16)
    got = moe.grouped_swiglu(x, token, offsets, wg, wu, wd).float()
    want = moe.grouped_swiglu_plain(x, token, offsets, wg, wu, wd).float()
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())


@pytest.mark.cuda
def test_moe_layer_on_the_card_matches_the_cpu(cuda):
    """The whole expert layer (route, kernel, combine, shared expert) on the
    card against the same layer on the CPU in f32 from the same bf16
    weights: bf16 differences only."""
    g = torch.Generator().manual_seed(3)
    e, d, f, t = 16, 256, 128, 96
    w = lambda *s: (torch.randn(s, generator=g) * 0.06).to(torch.bfloat16)
    args = [w(d, e).float(), (torch.randn(e, generator=g) * 0.05),
            w(e, d, f), w(e, d, f), w(e, f, d), w(d, f), w(d, f), w(f, d)]
    x = torch.randn((t, d), generator=g).to(torch.bfloat16)
    got = moe.moe_layer(x.to(cuda), *[a.to(cuda) for a in args], 4, 2.446,
                        True, "prefill").float().cpu()
    want = moe.moe_layer(x.float(), *[a.float() for a in args], 4, 2.446,
                         True, "prefill")
    assert float((got - want).abs().max()) <= 3e-2 * float(want.abs().max())


@pytest.mark.cuda
def test_graphed_decode_equals_the_eager_one(cuda):
    """The decode step replayed from a CUDA graph gives the eager step's
    tokens, and the expert layer's device-side counters count the same
    calls, rows and experts either way (the graph is made at the first
    call; the second call replays it only). The host launches the
    prefill's kernels alone then; another shape steps eagerly."""
    cfg = kv.KimiVLConfig(
        vocab_size=512, hidden_size=128, intermediate_size=192,
        moe_intermediate_size=64, num_hidden_layers=3, num_attention_heads=2,
        kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=32,
        v_head_dim=32, n_routed_experts=16, n_shared_experts=1,
        num_experts_per_tok=4, vision_width=64)
    p = kv.init_kimi_vl_params(torch.Generator().manual_seed(0), cfg,
                               device=cuda, dtype=torch.bfloat16, std=0.09)
    layers = kv.prepare(p["lm"], cfg)
    img = torch.randn((8, 4, 128), device=cuda).to(torch.bfloat16)
    prompt = torch.tensor([3, 5, 7])
    runs = {}
    steps = kv.DecodeSteps()
    for name, held in (("eager", None), ("graphed", steps)):
        if held is not None:          # the first call makes the graph
            kv.greedy_generate_vlm(p["lm"], cfg, layers, img, prompt, 9,
                                   steps=held)
        moe.reset_counters()
        with torch.inference_mode():
            out = kv.greedy_generate_vlm(p["lm"], cfg, layers, img, prompt, 9,
                                         steps=held)
            moe.flush_counters()
        runs[name] = (out.cpu(), dict(moe.moe_experts.calls),
                      dict(moe.moe_experts.rows),
                      dict(moe.moe_experts.experts_hit),
                      moe.moe_route.max_load, moe.moe_experts.launches)
    assert torch.equal(runs["eager"][0], runs["graphed"][0])
    assert runs["eager"][1:4] == runs["graphed"][1:4]
    assert runs["eager"][4] == pytest.approx(runs["graphed"][4])
    assert runs["eager"][1] == {"prefill": 2, "decode": 16}
    assert runs["eager"][2] == {"prefill": 2 * 8 * 7 * 4,
                                "decode": 16 * 8 * 4}
    assert runs["eager"][5] == 2 * 18 and runs["graphed"][5] == 2 * 2
    assert (steps.graph_captures, steps.graph_replays,
            steps.eager_steps) == (1, 16, 0)
    with torch.inference_mode():
        kv.greedy_generate_vlm(p["lm"], cfg, layers, img[:4], prompt, 9,
                               steps=steps)
    assert (steps.graph_captures, steps.graph_replays,
            steps.eager_steps) == (1, 16, 8)


@pytest.mark.parametrize("change", [
    dict(dtype=torch.float32), dict(d=100), dict(offsets_len=3),
    dict(token_dtype=torch.int64)])
def test_kernel_input_checks(change):
    e, d, f = 4, change.get("d", 64), 64
    w = lambda *s: torch.zeros(s, dtype=change.get("dtype", torch.bfloat16))
    x = torch.zeros((3, d), dtype=change.get("dtype", torch.bfloat16))
    token = torch.zeros(6, dtype=change.get("token_dtype", torch.int32))
    offsets = torch.zeros(change.get("offsets_len", e + 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        moe._check_kernel_inputs(x, token, offsets, w(e, d, f), w(e, d, f),
                                 w(e, f, d))


def test_the_cpu_runs_the_composition():
    e, d, f = 8, 64, 64
    wg, wu, wd = _weights("cpu", e, d, f)
    x, (_, token, offsets) = _routes(5, e, "cpu", e=e, d=d)
    before = moe.moe_experts.launches
    got = moe.grouped_swiglu(x, token, offsets, wg, wu, wd)
    assert moe.moe_experts.launches == before
    assert torch.equal(got, moe.grouped_swiglu_plain(x, token, offsets, wg,
                                                     wu, wd))
