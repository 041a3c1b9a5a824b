"""Replay from CUDA graphs: the one rule the train step and the decode loops
share (``train.steps.TrainStep``, ``decode.graphs.DecodeGraphs`` and
``models.kimi_vl.DecodeSteps`` are :class:`GraphHolder` s).

A holder captures for the first key it meets on the card and replays every
later call with that key; a call with any other key, or with None for a key
(a call that no graph serves: CPU tensors, a path the graph does not take),
runs eagerly. Counters, alike in every holder: ``graph_captures`` counts the
graphs captured, ``graph_replays`` the replays run, and ``eager_steps`` the
steps or calls run eagerly.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def capture(fn: Callable, device: torch.device, pool=None,
            generator: Optional[torch.Generator] = None) -> tuple:
    """→ (graph, ``fn()``'s outputs in the capture): ``fn()`` run once on a
    side stream first, as a capture wants what it records run before (lazy
    set-up: the kernel library, cuBLAS's workspaces, autograd's device
    threads), then captured into a CUDA graph, on the memory pool ``pool``
    where one is given, with ``generator`` registered where one is given (a
    replay then draws from it at its seed and offset as they stand when the
    replay starts)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        if generator is not None:
            graph.register_generator_state(generator)
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
    return graph, out


class GraphHolder:
    """The first-key rule (see the module docstring) and its counters. What
    a holder keeps for its key is what ``build`` made: its graphs and the
    static buffers they read and write."""

    def __init__(self):
        self.key = self.held = None
        self.graph_captures = self.graph_replays = self.eager_steps = 0

    def held_for(self, key, build: Callable):
        """→ ``build()``'s result, made at the first key that is not None and
        kept for every later call with that key; None for a None key or any
        other key, whose call the caller runs eagerly. ``build`` counts the
        graphs it captures in ``graph_captures``."""
        if key is None or self.key not in (None, key):
            return None
        if self.key is None:
            self.held, self.key = build(), key
        return self.held

    def replay(self, graph) -> None:
        """``graph.replay()``, counted."""
        self.graph_replays += 1
        graph.replay()
