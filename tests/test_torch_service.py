"""Port parity: the continuously batched ``CaptionService`` of mit_tpu_torch
against mit_tpu on the CPU.

The service (fewer slots than requests, slots at their own positions,
admission as slots free up) must give every request exactly the tokens the
JAX package's batch loops give it: greedy and beam K = 3, CLS and full
memory, windows of several tokens, caches shorter than the captions (the
overflow re-decoded at full length), chunks of memory that stay on the
device. Two runs of the JAX ``CaptionService`` (greedy CLS, beam over full
memory) hold the port's service to the JAX service itself. JAX's sampling
stream cannot be reproduced, so the sampled service is held to greedy at
temperature 0 and at top-k 1, to its own seed, and to valid captions. The
model is tiny (2 layers, D 32, 4 heads, 14 positions) with the END logit's
bias raised, so captions end at many lengths and slots are reused.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mit_tpu.decode import beam as jbeam
from mit_tpu.decode import greedy as jgreedy
from mit_tpu.models.decoder import DecoderConfig as JDecoderConfig
from mit_tpu.models.decoder import init_decoder_params
from mit_tpu_torch.decode import beam as tbeam
from mit_tpu_torch.decode import greedy as tgreedy
from mit_tpu_torch.decode import step as tstep
from mit_tpu_torch.decode.api import Captioner
from mit_tpu_torch.decode.service import CaptionService
from mit_tpu_torch.models.convert import params_from_jax
from mit_tpu_torch.models.decoder import DecoderConfig
from mit_tpu_torch.models.model import ModelConfig
from mit_tpu_torch.models.vision import PRESETS

V, D, H, L, F, MAXLEN = 60, 32, 4, 2, 48, 14
PAD, START, END = 0, 2, 3
KW = dict(vocab_size=V, embed_dim=D, num_heads=H, num_layers=L, ff_dim=F,
          max_seq_len=MAXLEN, dropout=0.0, pad_idx=PAD)
JCFG, TCFG = JDecoderConfig(**KW), DecoderConfig(**KW)
ENCODER = "mit/tiny-vit-debug"
S_MEM = PRESETS[ENCODER].seq_len          # full memory: 17 rows an image
N = 12                                    # requests a case


class Ids:
    pad_id, start_id, end_id, unk_id = PAD, START, END, 1
    unk_token = "<UNK>"

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(map(str, ids))


@functools.lru_cache(maxsize=None)
def _params():
    p = jax.tree.map(np.asarray,
                     init_decoder_params(jax.random.PRNGKey(0), JCFG))
    bias = np.zeros((V,), np.float32)
    bias[END] = 1.0                       # captions END at 3 to 14 tokens
    return dict(p, fc_out_b=bias)


def _captioner(mode, **kw):
    return Captioner({"decoder": params_from_jax(_params()), "encoder": {}},
                     ModelConfig(ENCODER, PRESETS[ENCODER], TCFG, mode),
                     Ids(), beam_size=3, **kw)


@functools.lru_cache(maxsize=None)
def _memories(mode, seed=1):
    s = 1 if mode == "cls" else S_MEM
    return np.random.default_rng(seed).normal(size=(N, s, D)).astype(np.float32)


def _row(seq, method):
    """A result in the batch loops' form. A greedy or sampled caption is its
    whole row, PAD after its end: the service returns every token up to the
    end, a generated PAD included, where the batch loops' lengths count the
    tokens that are not PAD. A beam caption is as both packages' beam
    results are: the row cut at its count of tokens that are not PAD."""
    seq = list(seq)
    assert len(seq) <= MAXLEN
    if method == "beam":
        return tuple(seq)
    return tuple(seq + [PAD] * (MAXLEN - len(seq)))


def _length(row):
    """Caption length of a whole greedy row: up to its END, or all of it."""
    return row.index(END) + 1 if END in row else len(row)


@functools.lru_cache(maxsize=None)
def _jax_batch(mode, method, k=3):
    """The JAX package's batch loop on the mode's memories → rows."""
    mem = jnp.asarray(_memories(mode))
    if method == "greedy":
        tokens, _ = jgreedy.greedy_generate(_params(), JCFG, mem, START, END,
                                            PAD, MAXLEN)
        return tuple(tuple(row) for row in np.asarray(tokens).tolist())
    tokens, _ = jbeam.beam_generate(_params(), JCFG, mem, START, END, PAD,
                                    MAXLEN, beam_size=k)
    return tuple(_row(row[:sum(t != PAD for t in row)], "beam")
                 for row in np.asarray(tokens).tolist())


def _serve(svc, mems, order=None, interleave=0):
    """Submit ``mems`` (host rows) in ``order``, ``interleave`` windows after
    the first two → results in submission order, as rows (``_row``)."""
    order = list(range(len(mems))) if order is None else order
    rids = {}
    for n, i in enumerate(order):
        if interleave and n == 2:
            for _ in range(interleave):
                svc.step()
        rids[i] = svc.submit_memory(mems[i])
    results = svc.run_to_completion()
    assert set(results) == set(rids.values())
    return tuple(_row(results[rids[i]], svc.method) for i in range(len(mems)))


def _routes():
    return dict(tstep.decoder_step.routes)


# ----------------------------------------------------------------------
# greedy and beam against the JAX batch loops
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode,window", [("cls", 1), ("cls", 2), ("cls", 4),
                                         ("cls", 7), ("full", 1), ("full", 4)])
def test_service_greedy_matches_jax_batch(mode, window):
    """Three slots for twelve requests, submitted in a shuffled order with
    windows run between submissions: every request's tokens are the JAX
    batch greedy loop's; continuous batching takes fewer windows than the
    serial sum of the caption lengths. Every step runs unfused."""
    want = _jax_batch(mode, "greedy")
    svc = CaptionService(_captioner(mode), num_slots=3, steps_per_sync=window)
    if mode == "full":
        assert "k" in svc.cross and "const" not in svc.cross
    order = list(np.random.default_rng(window).permutation(N))
    before = _routes()
    got = _serve(svc, _memories(mode), order, interleave=3)
    assert _routes()["fused"] == before["fused"]
    assert got == want
    assert svc.steps_run < sum(_length(t) - 1 for t in want)
    assert window == 1 or svc.windows < svc.steps_run
    assert min(map(_length, want)) < MAXLEN == max(map(_length, want))


@pytest.mark.parametrize("mode,k,window", [("cls", 3, 1), ("cls", 3, 3),
                                           ("full", 3, 1), ("cls", 2, 2)])
def test_service_beam_matches_jax_batch(mode, k, window):
    """Beam search, K rows a slot, fewer slots than requests, interleaved
    submission: the JAX batch ``beam_generate``'s tokens for every request."""
    want = _jax_batch(mode, "beam", k)
    svc = CaptionService(_captioner(mode), num_slots=2, method="beam",
                         beam_size=k, steps_per_sync=window)
    assert svc.R == 2 * k
    assert _serve(svc, _memories(mode), interleave=2) == want


@pytest.mark.parametrize("mode", ["cls", "full"])
def test_service_beam_size_one_is_greedy(mode):
    mems = _memories(mode)
    greedy = _serve(CaptionService(_captioner(mode), num_slots=4), mems)
    beam = _serve(CaptionService(_captioner(mode), num_slots=4,
                                 method="beam", beam_size=1), mems)
    assert greedy == _jax_batch(mode, "greedy")
    # a beam result is cut at its count of tokens that are not PAD
    assert beam == tuple(row[:sum(t != PAD for t in row)] for row in greedy)


@pytest.mark.parametrize("mode,method", [("cls", "greedy"), ("cls", "beam"),
                                         ("full", "greedy"), ("full", "beam")])
def test_service_cache_overflow_matches_jax_batch(mode, method):
    """A 6-row cache: captions that reach it are evicted and re-decoded at
    full length through the batch loops, and every request still gets the
    JAX batch loop's tokens."""
    svc = CaptionService(_captioner(mode), num_slots=3, method=method,
                         cache_len=6)
    assert svc.k_cache[0].shape[1] == 6
    assert _serve(svc, _memories(mode)) == _jax_batch(mode, method)
    assert svc.overflowed > 0 and not svc._overflow


def test_service_slot_reuse_hides_a_longer_stale_caption():
    """One slot: a caption of 14 tokens, then one that ends sooner. The
    second is admitted into the slot whose cache rows past its position
    still hold the first caption's keys and values; the visibility mask
    alone hides them, and the tokens are the JAX batch loop's."""
    want = _jax_batch("cls", "greedy")
    lengths = [_length(t) for t in want]
    long_, short = int(np.argmax(lengths)), int(np.argmin(lengths))
    assert lengths[long_] == MAXLEN and lengths[short] < MAXLEN // 2
    svc = CaptionService(_captioner("cls"), num_slots=1)
    mems = _memories("cls")
    got = _serve(svc, [mems[long_], mems[short], mems[long_]])
    assert got == (want[long_], want[short], want[long_])
    # the long caption's rows are still there, past the short one's end
    stale = svc.k_cache[0][0, lengths[short]:MAXLEN - 1]
    assert bool(stale.abs().sum(-1).gt(0).all())


def test_service_matches_the_jax_service():
    """The JAX CaptionService itself, greedy over CLS memory (windows of 3)
    and beam K = 3 over full memory: the same tokens for every request."""
    from mit_tpu.config import Config
    from mit_tpu.decode.api import Captioner as JCaptioner
    from mit_tpu.decode.service import CaptionService as JCaptionService
    from mit_tpu.models.model import ModelConfig as JModelConfig
    from mit_tpu.models.vision import PRESETS as JPRESETS

    for mode, kw in (("cls", dict(steps_per_sync=3)),
                     ("full", dict(method="beam", beam_size=3))):
        jcap = JCaptioner({"decoder": _params(), "encoder": {}},
                          JModelConfig(ENCODER, JPRESETS[ENCODER], JCFG, mode),
                          Ids(), Config(MAX_SEQ_LEN=MAXLEN))
        mems = _memories(mode)[:7]
        want = _serve(JCaptionService(jcap, num_slots=3, **kw), mems)
        got = _serve(CaptionService(_captioner(mode), num_slots=3, **kw), mems)
        assert got == want, mode


# ----------------------------------------------------------------------
# the fused route: the plain fused layers on CPU tensors
# ----------------------------------------------------------------------
@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_fused_service_equals_batch_fused(method):
    """``fused=True`` over CLS memory: every service step runs the fused
    layers (their plain version on CPU tensors) at per-row positions, and
    the tokens are the port's batch loops' with ``fused=True``; over full
    memory the same service runs unfused."""
    mems = _memories("cls")
    tp = params_from_jax(_params())
    if method == "greedy":
        tokens, _ = tgreedy.greedy_generate(
            tp, TCFG, torch.from_numpy(mems), START, END, PAD, MAXLEN,
            fused=True)
    else:
        tokens, _ = tbeam.beam_generate(tp, TCFG, torch.from_numpy(mems),
                                        START, END, PAD, MAXLEN, 3, fused=True)
        tokens = [row[:sum(t != PAD for t in row)] for row in tokens.tolist()]
    want = tuple(_row(row, method) for row in
                 (tokens if method == "beam" else tokens.tolist()))
    svc = CaptionService(_captioner("cls", fused_decode=True), num_slots=3,
                         method=method, steps_per_sync=2)
    assert svc.fused
    before = _routes()
    assert _serve(svc, mems, interleave=1) == want
    after = _routes()
    assert after["unfused"] == before["unfused"]
    assert after["fused"] - before["fused"] >= svc.windows
    full = CaptionService(_captioner("full"), num_slots=3, method=method,
                          fused=True)
    before = _routes()
    assert _serve(full, _memories("full")) == _jax_batch("full", method)
    assert _routes()["fused"] == before["fused"]


# ----------------------------------------------------------------------
# chunks on the device, the stream, sampling, checks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["cls", "full"])
def test_zero_copy_chunks_equal_the_host_path(mode):
    """Chunks submitted as tensors (a padded chunk whose last rows are not
    requests) caption as per-row host submission does, and are dropped once
    their rows finish."""
    mems = _memories(mode)
    host = _serve(CaptionService(_captioner(mode), num_slots=3, cache_len=8),
                  mems)
    svc = CaptionService(_captioner(mode), num_slots=3, cache_len=8)
    rids = svc.submit_memory_batch(torch.from_numpy(mems[:4]))
    rids += svc.submit_memory_batch(
        torch.from_numpy(np.concatenate([mems[4:], mems[:2]])), real=N - 4)
    assert len(rids) == N
    results = svc.run_to_completion()
    assert tuple(_row(results[r], "greedy") for r in rids) == host
    assert host == _jax_batch(mode, "greedy")
    assert not svc._chunks


def test_run_stream_returns_ids_in_stream_order():
    """A lazy stream of chunks (sizes 5, 4 and 3 real rows of 5, 4, 4):
    the ids come back in stream order, each with the JAX batch loop's
    tokens, and chunks are pulled as the queue empties."""
    mems = torch.from_numpy(_memories("cls"))
    pulled = []

    def encodes():
        for lo, hi, pad in ((0, 5, 0), (5, 9, 0), (9, 12, 1)):
            pulled.append(lo)
            chunk = torch.cat([mems[lo:hi], mems[:pad]])
            yield chunk, hi - lo

    svc = CaptionService(_captioner("cls"), num_slots=3, cache_len=8)
    ids = svc.run_stream(encodes(), lookahead=1)
    assert ids == sorted(ids) and len(ids) == N and pulled == [0, 5, 9]
    assert tuple(_row(svc.result(r), "greedy") for r in ids) == \
        _jax_batch("cls", "greedy")
    assert not svc._chunks


def test_caption_stream_equals_chunked_encode_and_batch_greedy():
    """Images through the tiny encoder, chunks of 4: captions equal the
    port's chunk-by-chunk encode, batch greedy and postprocess."""
    from PIL import Image

    from mit_tpu.models.model import ModelConfig as JModelConfig
    from mit_tpu.models.model import init_model_params
    from mit_tpu.models.vision import PRESETS as JPRESETS

    jparams = init_model_params(
        jax.random.PRNGKey(4), JModelConfig(ENCODER, JPRESETS[ENCODER], JCFG,
                                            "cls"))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    params["decoder"] = params_from_jax(_params())
    cap = Captioner(params, ModelConfig(ENCODER, PRESETS[ENCODER], TCFG,
                                        "cls"), Ids())
    rng = np.random.default_rng(9)
    images = [Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8))
              for _ in range(7)]
    mem = torch.cat([cap.memory_from_images(images[:4]),
                     cap.memory_from_images(images[4:])])
    want = [cap.postprocess(t) for t in cap.generate_from_memory(
        mem, max_len=MAXLEN)]
    svc = CaptionService(cap, num_slots=3)
    assert svc.caption_stream(images, encode_batch_size=4) == want
    assert len(set(want)) > 1


def test_sampling_service():
    """Temperature 0 and top-k 1 give greedy's tokens; a seed and a
    submission order repeat the same captions and another seed draws
    others; bucketed, every caption is valid."""
    mems = _memories("cls")
    greedy = _jax_batch("cls", "greedy")
    run = lambda **kw: _serve(CaptionService(
        _captioner("cls"), num_slots=3, method="sample", **kw), mems)
    assert run(temperature=0.0) == greedy
    assert run(top_k=1, seed=5) == greedy
    a, b, c = run(top_k=10, seed=0), run(top_k=10, seed=0), run(top_k=10,
                                                                  seed=1)
    assert a == b and a != c
    for caps in (a, run(top_k=10, seed=2, cache_len=6)):
        for row in caps:
            seq = row[:_length(row)]
            assert seq[0] == START and 2 <= len(seq) <= MAXLEN
            assert all(0 <= t < V for t in row)
            assert all(t == PAD for t in row[len(seq):])


def test_service_checks_its_arguments():
    cap = _captioner("cls")
    with pytest.raises(ValueError, match="cache_len"):
        CaptionService(cap, num_slots=2, cache_len=3)
    with pytest.raises(ValueError, match="method"):
        CaptionService(cap, num_slots=2, method="nucleus")
    svc = CaptionService(cap, num_slots=2, cache_len=4, max_len=40)
    assert (svc.T, svc.Tc) == (MAXLEN, 4)


def test_service_decode_step_is_one_greedy_token():
    """``service_decode_step`` on fresh slots (START at position 0, the CLS
    cross constant of each memory) gives the batch greedy loop's first
    generated token and writes each slot's row 0 of the cache."""
    from mit_tpu_torch.decode import service as tservice

    mems = torch.from_numpy(_memories("cls"))
    tp = params_from_jax(_params())
    cross = {"const": tservice._cross_const_for(tp["layers"]["cross"], mems)}
    k = [torch.zeros(N, 4, D) for _ in range(L)]
    v = [torch.zeros(N, 4, D) for _ in range(L)]
    ids = tservice.service_decode_step(
        tstep.prepare_decode_params(tp), TCFG, torch.full((N,), START),
        torch.zeros(N, dtype=torch.long), torch.ones(N, dtype=torch.bool),
        torch.zeros(N, 4, dtype=torch.bool), k, v, cross)
    assert ids.tolist() == [row[1] for row in _jax_batch("cls", "greedy")]
    assert all(bool(a[:, 0].abs().sum(-1).gt(0).all()) for a in k + v)
    assert not any(a[:, 1:].any() for a in k + v)


# ----------------------------------------------------------------------
# the slot-sharded service (JAX tests/test_service.py:121-146)
# ----------------------------------------------------------------------
def _two_devices():
    from mit_tpu_torch.parallel.mesh import create_mesh

    return create_mesh((2, 1), devices=["cpu", "cpu"])


@pytest.mark.parametrize("mode,method,kw", [
    ("cls", "greedy", dict(steps_per_sync=3)),
    ("cls", "greedy", dict(fused=True)),
    ("cls", "beam", dict(steps_per_sync=2)),
    ("full", "greedy", dict(cache_len=6)),
    ("full", "beam", dict()),
    ("cls", "sample", dict(top_k=10, seed=3, steps_per_sync=2)),
], ids=["greedy", "greedy_fused", "beam", "full_bucketed", "full_beam",
        "sample"])
def test_service_sharded_mesh_matches_unsharded(mode, method, kw):
    """Slots split over two "data" devices: every request's tokens equal
    the one-device service's, greedy, beam and sampled, and (greedy and
    beam) the JAX package's batch loops; each device holds its half of the
    slots' caches."""
    mems = _memories(mode)
    make = lambda **m: CaptionService(_captioner(mode), num_slots=4,
                                      method=method, **kw, **m)
    ref = _serve(make(), mems, interleave=1)
    svc = make(mesh=_two_devices())
    assert _serve(svc, mems, interleave=1) == ref
    if method != "sample" and "cache_len" not in kw:
        assert ref == _jax_batch(mode, method)
    assert [(sh.lo, sh.hi) for sh in svc.shards] == [(0, 2), (2, 4)]
    k = 3 if method == "beam" else 1
    assert all(sh.k_cache[0].shape[0] == 2 * k for sh in svc.shards)


def test_sharded_service_takes_device_chunks_and_streams():
    """``run_stream`` over chunks kept on the first device: admission
    gathers a chunk's rows there and moves them to each shard's device
    (both shards share the CPU here, so no row changes device), and the
    sharded service gives the one-device service's tokens."""
    mems = torch.from_numpy(_memories("cls", seed=4))

    def serve(**m):
        svc = CaptionService(_captioner("cls"), num_slots=4, **m)
        ids = svc.run_stream(iter([(mems[:5], 5), (mems[5:], 7)]))
        return [svc.result(i) for i in ids]

    assert serve(mesh=_two_devices()) == serve()


def test_service_mesh_slot_divisibility_enforced():
    with pytest.raises(ValueError, match="divisible"):
        CaptionService(_captioner("cls"), num_slots=3, mesh=_two_devices())
