"""The greedy and beam loops replayed from CUDA graphs
(``decode/graphs.py`` ``DecodeGraphs``) against the same loops run eagerly.

Torch only (no JAX), so the card's tests run without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_graph.py

On the CPU the holder never captures: the loops step eagerly through it
and count their steps. The static-state loop itself (its reset, the
ladder's grows, the beams' two cache sets, the device-indexed token
writes) runs here too, through ``replay_greedy`` and ``replay_beam`` with
``capture`` patched to make each "graph" a call of the iteration it would
capture, and is held bit for bit to the eager loop. Tests marked ``cuda``
capture and replay real graphs on the card at B 64 and beam K 3 (192
rows) and hold them bit for bit to the eager fused route.
"""

import functools
import types

import pytest
import torch

from mit_tpu_torch.decode import beam as tbeam
from mit_tpu_torch.decode import graphs as tgraphs
from mit_tpu_torch.decode import greedy as tgreedy
from mit_tpu_torch.decode import sampling as tsampling
from mit_tpu_torch.decode import step as tstep
from mit_tpu_torch.decode.api import Captioner
from mit_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
from mit_tpu_torch.models.model import ModelConfig
from mit_tpu_torch.models.vision import PRESETS

PAD, START, END = 0, 2, 3
NEVER = -1                  # an END id no token has: the whole ladder runs
TINY = "mit/tiny-vit-debug"
CFG = DecoderConfig(vocab_size=60, embed_dim=32, num_heads=4, num_layers=2,
                    ff_dim=64, max_seq_len=24, dropout=0.0, pad_idx=PAD)
LADDER = (4, 8, 16, 24)


class _Ids:
    pad_id, start_id, end_id = PAD, START, END


def _params(cfg=CFG, end_bias=1.5, seed=0, device="cpu"):
    """Seeded decoder weights, END's logit raised so rows end at
    different steps."""
    p = init_decoder_params(torch.Generator().manual_seed(seed), cfg, device)
    p["fc_out_b"][END] += end_bias
    return p


def _memory(b, s=1, cfg=CFG, seed=1, device="cpu", dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, s, cfg.embed_dim), generator=g).to(device, dtype)


def _steps_taken(fn):
    """fn's result and the decoder steps it ran, by either route."""
    before = sum(tstep.decoder_step.routes.values())
    out = fn()
    return out, sum(tstep.decoder_step.routes.values()) - before


class _Call:
    """A "graph" that replays by calling the iteration it was made from."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.fixture
def called_graphs(monkeypatch):
    """``capture`` on the CPU: each iteration run once from position 0,
    as the warm-up is, then kept as a recorder of the call."""
    def capture(st, device):
        graphs = {}
        for i in range(len(st.buckets)):
            for p in range(st.sets):
                st.pos.zero_()
                st.iteration(i, p)
                graphs[i, p] = _Call(functools.partial(st.iteration, i, p))
        return graphs

    monkeypatch.setattr(tgraphs, "capture", capture)


def _greedy(params, mem, end=END, steps=None, fused=True, mask=None,
            cfg=CFG, ladder=LADDER, dtype=torch.float32):
    return tgreedy.greedy_generate(
        params, cfg, mem, START, end, PAD, cfg.max_seq_len,
        memory_padding_mask=mask, compute_dtype=dtype, bucket_sizes=ladder,
        fused=fused, steps=steps)


def _beam(params, mem, end=END, steps=None, fused=True, k=3, cfg=CFG,
          ladder=LADDER, dtype=torch.float32):
    return tbeam.beam_generate(
        params, cfg, mem, START, end, PAD, cfg.max_seq_len, k,
        compute_dtype=dtype, bucket_sizes=ladder, fused=fused, steps=steps)


def _replayed(method, params, mem, holder, end=END, k=3, cfg=CFG,
              ladder=LADDER, dtype=torch.float32):
    """The loop replayed by ``holder`` (``replay_greedy``/``replay_beam``),
    as ``greedy_generate``/``beam_generate`` run it where it engages."""
    if method == "greedy":
        return tgreedy.replay_greedy(holder, params, cfg, mem, START, end,
                                     PAD, cfg.max_seq_len, ladder, dtype)
    return tbeam.replay_beam(holder, params, cfg, mem, START, end, PAD,
                             cfg.max_seq_len, k, ladder, dtype)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------- the CPU


@pytest.mark.parametrize("method", ["greedy", "beam"])
@pytest.mark.parametrize("fused", [True, False])
def test_cpu_tensors_step_eagerly_and_count(method, fused):
    """CPU tensors never capture; every step counts in ``eager_steps``."""
    params, mem, holder = _params(), _memory(4), tgraphs.DecodeGraphs()
    run = _greedy if method == "greedy" else _beam
    _, taken = _steps_taken(lambda: run(params, mem, steps=holder,
                                        fused=fused))
    assert taken > 0 and holder.eager_steps == taken
    assert holder.graph_captures == holder.graph_replays == 0
    assert holder.state is None and holder.key is None


# the served decoder's geometry, which the fused kernel takes on the card
SERVED = DecoderConfig(vocab_size=10000)


@pytest.mark.parametrize("case, want", [
    ("cuda, served geometry", True), ("cpu", False), ("unfused", False),
    ("full memory", False), ("padded memory", False),
    ("unkernelled geometry", False)])
def test_engages_only_on_the_fused_cls_route_on_cuda(case, want):
    """The graphs engage on CUDA tensors over the fused route and the CLS
    cross constant alone: not on the CPU, the unfused route, full or
    padded memory, or a geometry the kernel does not take on the card."""
    memory = types.SimpleNamespace(
        shape=(4, 5 if case == "full memory" else 1, 512),
        is_cuda=case != "cpu")
    mask = torch.zeros((4, 1), dtype=torch.bool) \
        if case == "padded memory" else None
    cfg = CFG if case == "unkernelled geometry" else SERVED
    assert tgraphs.engages(case != "unfused", cfg, memory, mask) is want


@pytest.mark.parametrize("ladder, max_len, ends", [
    ((4, 8, 16, 24), 24, None), ((16, 24), 24, 9), ((23, 24), 24, None)])
def test_ladder_steps_every_position_and_reads_before_each(ladder, max_len,
                                                           ends):
    """``ladder`` yields positions 0 to ``max_len - 2`` in order, each in
    the first bucket that holds it, flags the first step of every later
    bucket for a grow, reads ``finished`` before every step and ends at
    the first read that is all true."""
    finished = torch.zeros(2, dtype=torch.bool)
    reads = []

    def read():
        reads.append(1)
        return finished

    got = []
    for i, pos, grows in tgraphs.ladder(ladder, max_len, read):
        got.append((i, pos, grows))
        if pos == ends:
            finished.fill_(True)
    last = max_len - 2 if ends is None else ends
    assert [pos for _, pos, _ in got] == list(range(last + 1))
    assert all(pos < ladder[i] and (i == 0 or pos >= ladder[i - 1])
               for i, pos, _ in got)
    assert [pos for i, pos, grows in got if grows] == \
        [b for b in ladder[:-1] if b <= last]
    assert len(reads) == len(got) + (ends is not None)


@pytest.mark.parametrize("method", ["greedy", "beam"])
@pytest.mark.parametrize("end", [END, NEVER])
def test_eager_through_the_holder_equals_without(method, end):
    """On the CPU the loops through a holder give the free functions'
    tokens, lengths and scores."""
    params, mem = _params(), _memory(5)
    run = _greedy if method == "greedy" else _beam
    want = run(params, mem, end=end)
    holder = tgraphs.DecodeGraphs()
    for _ in range(2):
        assert _same(run(params, mem, end=end, steps=holder), want)


@pytest.mark.parametrize("method", ["greedy", "beam"])
@pytest.mark.parametrize("end", [END, NEVER])
@pytest.mark.parametrize("ladder", [LADDER, (16, 24), (24,)])
def test_static_loop_equals_eager_bit_for_bit(called_graphs, method, end,
                                              ladder):
    """The holder's static-state loop (reset, grows, the beams' two cache
    sets, the device-indexed writes) gives the eager loop's tokens, lengths
    and beam scores bit for bit, with END disabled (the whole ladder) and
    served, over three batches in a row of different memory; it captures
    one iteration a bucket (two under beam) once, and replays one a step."""
    params, holder = _params(), tgraphs.DecodeGraphs()
    run = _greedy if method == "greedy" else _beam
    sets = 1 if method == "greedy" else 2
    replays = 0
    for seed in (1, 2, 1):
        mem = _memory(6, seed=seed)
        want, taken = _steps_taken(lambda: run(params, mem, end=end,
                                               ladder=ladder))
        got = _replayed(method, params, mem, holder, end=end, ladder=ladder)
        assert _same(got, want)
        replays += taken
        assert holder.graph_replays == replays
    assert holder.graph_captures == sets * len(ladder)
    assert holder.eager_steps == 0
    if end == NEVER:
        assert taken == CFG.max_seq_len - 1


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_static_loop_in_bf16_equals_eager(called_graphs, method):
    """The same in bf16, the compute dtype the card runs."""
    params, holder = _params(), tgraphs.DecodeGraphs()
    run = _greedy if method == "greedy" else _beam
    for seed in (4, 5):
        mem = _memory(4, seed=seed)
        want = run(params, mem, dtype=torch.bfloat16)
        got = _replayed(method, params, mem, holder, dtype=torch.bfloat16)
        assert _same(got, want)


@pytest.mark.parametrize("other", ["batch", "beams", "max_len", "ladder",
                                   "dtype", "method", "weights"])
def test_a_second_key_steps_eagerly(called_graphs, other):
    """The holder keeps the first key's graphs: a call of any other key is
    refused (its caller steps eagerly) and captures and replays nothing,
    and the first key still replays, with the eager loop's results."""
    params, holder = _params(), tgraphs.DecodeGraphs()
    mem = _memory(4)
    first = lambda: _replayed("beam", params, mem, holder)
    first()
    captures, replays = holder.graph_captures, holder.graph_replays
    kw = {"batch": dict(mem=_memory(3)), "beams": dict(k=2),
          "max_len": dict(cfg=CFG._replace(max_seq_len=20), ladder=(8, 20)),
          "ladder": dict(ladder=(8, 24)), "dtype": dict(dtype=torch.bfloat16),
          "weights": dict(params=_params(seed=5))}
    if other == "method":
        assert _replayed("greedy", params, mem, holder) is None
    else:
        args = dict(dict(params=params, mem=mem), **kw[other])
        assert _replayed("beam", holder=holder, **args) is None
    assert (holder.graph_captures, holder.graph_replays) == (captures, replays)
    assert _same(first(), _beam(params, mem))
    assert holder.graph_replays > replays


def _captioner(params, dtype=torch.float32, mode="cls"):
    mcfg = ModelConfig(TINY, PRESETS[TINY], CFG, mode)
    return Captioner({"decoder": params, "encoder": {}}, mcfg, _Ids(), dtype,
                     fused_decode=True, beam_size=3)


def _lists(tokens):
    """tokens (B, T) → the captioner's lists: each row's tokens not PAD."""
    lengths = (tokens != PAD).sum(1).tolist()
    return [row[:n] for row, n in zip(tokens.tolist(), lengths)]


def test_captioner_steps_eagerly_through_its_holder_on_the_cpu():
    """``Captioner.generate_from_memory`` hands its own holder to the
    greedy and beam loops, which step eagerly on the CPU and count every
    step there; sampling takes no holder. The token lists are the eager
    loops'."""
    params = _params()
    cap = _captioner(params)
    holder = cap.decode_graphs
    ladder = tgreedy._bucket_schedule(CFG.max_seq_len)
    counted = 0
    for method, run in (("greedy", _greedy), ("beam", _beam)):
        mem = _memory(4, seed=len(method))
        want = _lists(run(params, mem, ladder=ladder)[0])
        got, taken = _steps_taken(
            lambda: cap.generate_from_memory(mem, method=method))
        assert got == want
        counted += taken
        assert holder.eager_steps == counted > 0
    _, taken = _steps_taken(
        lambda: cap.generate_from_memory(mem, method="sample", top_k=4))
    assert taken > 0 and holder.eager_steps == counted
    assert holder.graph_captures == holder.graph_replays == 0
    assert holder.state is None


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the served decoder: 6 x 512, 8 heads, FF 2048 (the fused kernel's
# geometry), vocab 10,000, max_len 100, ladder 16, 32, 64, 100
CARD = DecoderConfig(vocab_size=10000)
CARD_LADDER = (16, 32, 64, 100)
# END's bias: rows of these weights end anywhere from the first step to
# never (the lengths of a bf16 batch on the CPU's plain layers: 8 to 13
# distinct, 2 to 100)
CARD_END = 1.5


def _card_run(method, params, mem, end, steps=None):
    kw = dict(cfg=CARD, ladder=CARD_LADDER, dtype=torch.bfloat16,
              steps=steps)
    if method == "greedy":
        return _greedy(params, mem, end=end, **kw)
    return _beam(params, mem, end=end, k=3, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_graphed_loop_equals_eager_on_card(cuda, method):
    """B 64 (beam: K 3, 192 rows), bf16, the fused kernel: graphed tokens,
    lengths and beam scores equal the eager fused route's bit for bit, with
    END disabled (all four buckets) and with END served, over two batches
    of different memory in a row; one capture a bucket (two under beam),
    one replay a step taken."""
    params = _params(CARD, end_bias=CARD_END, device=cuda)
    holder = tgraphs.DecodeGraphs()
    replays = 0
    for end, seed in ((NEVER, 1), (END, 1), (END, 2), (NEVER, 2)):
        mem = _memory(64, cfg=CARD, seed=seed, device=cuda)
        want, taken = _steps_taken(lambda: _card_run(method, params, mem, end))
        got = _card_run(method, params, mem, end, holder)
        torch.cuda.synchronize()
        assert _same(got, want), (method, end, seed)
        replays += taken
        assert holder.graph_replays == replays
        if end == NEVER:
            assert taken == CARD.max_seq_len - 1
    sets = 1 if method == "greedy" else 2
    assert holder.graph_captures == sets * len(CARD_LADDER)
    assert holder.eager_steps == 0


@pytest.mark.cuda
def test_served_end_stops_rows_at_different_steps_on_card(cuda):
    """The served END ends rows at different lengths, so the graphed loop
    is held where rows finish while others go on."""
    params = _params(CARD, end_bias=CARD_END, device=cuda)
    mem = _memory(64, cfg=CARD, seed=1, device=cuda)
    holder = tgraphs.DecodeGraphs()
    tokens, lengths = _card_run("greedy", params, mem, END, holder)
    assert len(set(lengths.tolist())) > 2
    assert int(lengths.min()) < CARD_LADDER[-2]


@pytest.mark.cuda
def test_another_batch_size_steps_eagerly_on_card(cuda):
    """After B 64 captured, B 32 steps eagerly and equals the eager loop;
    B 64 still replays."""
    params = _params(CARD, end_bias=CARD_END, device=cuda)
    holder = tgraphs.DecodeGraphs()
    mem = _memory(64, cfg=CARD, seed=1, device=cuda)
    _card_run("beam", params, mem, END, holder)
    captures, replays = holder.graph_captures, holder.graph_replays
    small = mem[:32].contiguous()
    want, taken = _steps_taken(lambda: _card_run("beam", params, small, END))
    got = _card_run("beam", params, small, END, holder)
    assert _same(got, want)
    assert holder.eager_steps == taken
    assert (holder.graph_captures, holder.graph_replays) == (captures, replays)
    _card_run("beam", params, mem, END, holder)
    assert holder.graph_replays == 2 * replays


@pytest.mark.cuda
def test_captioner_replays_on_card(cuda):
    """``Captioner.generate_from_memory`` at the served shape: the graphed
    token lists equal a fresh eager loop's, greedy and beam each on a
    captioner of its own."""
    params = _params(CARD, end_bias=CARD_END, device=cuda)
    mcfg = ModelConfig(TINY, PRESETS[TINY], CARD, "cls")
    mem = _memory(64, cfg=CARD, seed=3, device=cuda)
    for method in ("greedy", "beam"):
        cap = Captioner({"decoder": params, "encoder": {}}, mcfg, _Ids(),
                        torch.bfloat16, fused_decode=True, beam_size=3)
        first = cap.generate_from_memory(mem, method=method)
        again = cap.generate_from_memory(mem, method=method)
        assert first == again == _lists(_card_run(method, params, mem,
                                                  END)[0])
        assert cap.decode_graphs.graph_captures > 0
        assert cap.decode_graphs.eager_steps == 0
