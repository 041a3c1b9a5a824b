"""The one rule for replaying CUDA graphs (``utils/cuda_graphs.py``), which
the train step and both decode families hold to.

Torch only (no JAX), so the card's tests run without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_graphs.py

On the CPU the holder runs with a fake ``build`` and fake graphs; the test
marked ``cuda`` captures a real graph on the card.
"""

import pytest
import torch

from mit_tpu_torch.utils import cuda_graphs


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _Build:
    """A ``build`` that counts its calls and returns a new object each."""

    def __init__(self):
        self.calls = 0

    def __call__(self):
        self.calls += 1
        return object()


def test_the_first_key_builds_once_and_keeps_what_it_built():
    holder, build = cuda_graphs.GraphHolder(), _Build()
    first = holder.held_for(("a", 1), build)
    assert first is not None and build.calls == 1
    for _ in range(3):
        assert holder.held_for(("a", 1), build) is first
    assert build.calls == 1 and holder.key == ("a", 1)


@pytest.mark.parametrize("later", [("b", 1), None])
def test_another_key_or_none_builds_nothing(later):
    holder, build = cuda_graphs.GraphHolder(), _Build()
    first = holder.held_for(("a", 1), build)
    assert holder.held_for(later, build) is None
    assert build.calls == 1
    assert holder.held_for(("a", 1), build) is first


def test_a_none_key_first_leaves_the_holder_open():
    """A call no graph serves does not take the holder: the first key that
    is not None still builds."""
    holder, build = cuda_graphs.GraphHolder(), _Build()
    assert holder.held_for(None, build) is None
    assert build.calls == 0 and holder.key is None
    assert holder.held_for(("b",), build) is not None
    assert build.calls == 1 and holder.key == ("b",)


def test_a_failed_build_keeps_no_key():
    holder = cuda_graphs.GraphHolder()

    def failing():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError):
        holder.held_for(("a",), failing)
    assert holder.key is None and holder.held is None
    assert holder.held_for(("a",), _Build()) is not None


def test_counters():
    """``replay`` counts every replay; ``build`` counts its captures and the
    caller its eager steps, and ``held_for`` moves no counter."""
    holder, graph = cuda_graphs.GraphHolder(), _Graph()
    assert (holder.graph_captures, holder.graph_replays,
            holder.eager_steps) == (0, 0, 0)
    holder.held_for(("a",), _Build())
    holder.held_for(("b",), _Build())
    assert (holder.graph_captures, holder.graph_replays,
            holder.eager_steps) == (0, 0, 0)
    for _ in range(3):
        holder.replay(graph)
    assert graph.replays == holder.graph_replays == 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pooled", [False, True])
def test_a_captured_fn_replays_to_what_it_computes_on_card(cuda, pooled):
    """The capture's warm-up runs ``fn`` once; each replay then computes
    what ``fn`` computes from the inputs as they stand, bit for bit."""
    x = torch.randn(64, 64, device=cuda)
    acc = torch.zeros(64, device=cuda)
    calls = []

    def fn():
        calls.append(1)
        acc.add_((x @ x).sum(0))
        return torch.tanh(x) * 2

    pool = torch.cuda.graph_pool_handle() if pooled else None
    graph, out = cuda_graphs.capture(fn, cuda, pool)
    assert len(calls) == 2                  # the warm-up and the capture
    torch.cuda.synchronize()
    warmed = acc.clone()
    for seed in range(3):
        x.copy_(torch.randn(64, 64, generator=torch.Generator().manual_seed(
            seed)).to(cuda))
        before = acc.clone()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, torch.tanh(x) * 2)
        assert torch.equal(acc, before + (x @ x).sum(0))
    assert len(calls) == 2 and not torch.equal(acc, warmed)
