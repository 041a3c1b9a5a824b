"""The mixture-of-experts layer of DeepSeek-V3 and Kimi-VL: a sigmoid router
in f32, grouped SwiGLU experts, a shared expert (no counterpart in the JAX
package).

- :func:`moe_route`: ``s = sigmoid(x W_g)`` in f32; the top-k experts are
  chosen on ``s + e_score_correction_bias`` (``noaux_tc`` with one group),
  and weighted by the chosen ``s`` renormalized to sum 1
  (``norm_topk_prob``) times ``routed_scaling_factor``.
- :func:`moe_experts`: the k routes of every token sorted by expert, each
  expert's SwiGLU run over its rows, the rows put back in route order. For
  CUDA tensors one grouped kernel (``csrc/moe_experts.cu``) runs every
  expert that has rows in one call; for CPU tensors the plain composition
  :func:`grouped_swiglu_plain` does, which rounds where the kernel rounds.
- :func:`moe_layer`: route, experts, the combine ``Σ w_i E_i(x)`` (in f32,
  as the published code weighs the experts' outputs) and the shared expert
  added once.

Counters (attributes, as ``fused_decode_layer.launches`` is):
``moe_experts.calls``, ``.rows`` (routed rows) and ``.experts_hit``, each
``{"prefill": n, "decode": n}``, and ``moe_route.max_load``, the largest
rows an expert over the mean, summed over calls (counted where the routes
are grouped): summed on the device by every call, a replayed CUDA graph's
too, and folded in by :func:`flush_counters`, which the decode loop calls
where it reads its tokens back anyway. ``moe_experts.launches`` counts the
kernels the host launches (two a call on the card); a CUDA graph's
capture launches none, and its replays launch from the graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mit_tpu_torch.utils.profiling import span

PHASES = ("prefill", "decode")
# the kernel's tiles: rows of an expert a block, columns, and depth a stage
TILE_M, TILE_N, TILE_K = 64, 64, 64


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """``down(silu(x W_gate) · x W_up)`` in the weights' dtype."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def moe_route(x: torch.Tensor, w_router: torch.Tensor, bias: torch.Tensor,
              top_k: int, scale: float, normalize: bool = True):
    """x (T, D) → (experts (T, k) int64, weights (T, k) f32). ``w_router``
    (D, E) and ``bias`` (E,) are f32."""
    s = torch.sigmoid(x.float() @ w_router)
    idx = torch.topk(s + bias, top_k, dim=-1).indices
    w = s.gather(1, idx)
    if normalize:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * scale


def group_routes(idx: torch.Tensor, n_experts: int):
    """Routes (T, k) → (order (R,): route numbers sorted by expert, stable;
    token (R,) int32: each sorted route's token; offsets (E + 1,) int32:
    where each expert's rows start)."""
    flat = idx.reshape(-1)
    sorted_e, order = torch.sort(flat, stable=True)
    token = (order // idx.shape[1]).to(torch.int32)
    offsets = torch.searchsorted(
        sorted_e, torch.arange(n_experts + 1, device=idx.device)
    ).to(torch.int32)
    return order, token, offsets


def grouped_swiglu_plain(x, token, offsets, w_gate, w_up, w_down):
    """The plain composition of the grouped kernel: for every expert e with
    rows, its rows ``x[token[off[e]:off[e+1]]]`` through gate and up (f32
    sums), ``silu(g) · u`` rounded to x's dtype, then down (f32 sums)
    rounded. → (R, D) in sorted-route order."""
    off = offsets.tolist()
    y = torch.empty((token.shape[0], w_down.shape[-1]), dtype=x.dtype,
                    device=x.device)
    for e in range(len(off) - 1):
        lo, hi = off[e], off[e + 1]
        if hi == lo:
            continue
        rows = x[token[lo:hi].long()].float()
        g = rows @ w_gate[e].float()
        u = rows @ w_up[e].float()
        h = (F.silu(g) * u).to(x.dtype)
        y[lo:hi] = (h.float() @ w_down[e].float()).to(x.dtype)
    return y


def row_tile_bound(routes: int, n_experts: int) -> int:
    """An upper bound on the kernel's row tiles, Σ_e ceil(rows_e / TILE_M),
    known without reading the counts back."""
    return -(-routes // TILE_M) + n_experts


def _check_kernel_inputs(x, token, offsets, w_gate, w_up, w_down):
    e, d, f = w_gate.shape
    if x.dtype != torch.bfloat16 or any(w.dtype != torch.bfloat16
                                        for w in (w_gate, w_up, w_down)):
        raise ValueError("the grouped expert kernel takes bf16 only")
    if w_up.shape != (e, d, f) or w_down.shape != (e, f, d):
        raise ValueError(f"expert weights (E, D, F), (E, D, F), (E, F, D); "
                         f"got {tuple(w_gate.shape)}, {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)}")
    if x.dim() != 2 or x.shape[1] != d:
        raise ValueError(f"x must be (T, {d}), got {tuple(x.shape)}")
    if d % TILE_K or f % TILE_K or d % TILE_N or f % TILE_N:
        raise ValueError(f"D {d} and F {f} must be multiples of {TILE_K}")
    if token.dtype != torch.int32 or offsets.dtype != torch.int32 or \
            offsets.shape != (e + 1,):
        raise ValueError("token and offsets must be int32, offsets (E + 1,)")
    for t in (x, token, offsets, w_gate, w_up, w_down):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("every operand contiguous, on x's device")


def grouped_swiglu(x, token, offsets, w_gate, w_up, w_down):
    """Every expert's SwiGLU over its rows: CPU tensors run
    :func:`grouped_swiglu_plain`; CUDA tensors the grouped kernel (two
    launches: gate and up with ``silu · mul`` into a bf16 hidden, then
    down), which reads each hit expert's weights once at decode and skips
    experts without rows; anything else raises."""
    if x.device.type == "cpu":
        return grouped_swiglu_plain(x, token, offsets, w_gate, w_up, w_down)
    if x.device.type != "cuda":
        raise ValueError(f"no grouped expert kernel for {x.device}")
    _check_kernel_inputs(x, token, offsets, w_gate, w_up, w_down)
    from mit_tpu_torch import kernels

    e, d, f = w_gate.shape
    r = token.shape[0]
    hidden = torch.empty((r, f), dtype=x.dtype, device=x.device)
    y = torch.empty((r, d), dtype=x.dtype, device=x.device)
    rc = kernels.lib().mit_moe_experts(
        x.data_ptr(), token.data_ptr(), offsets.data_ptr(),
        w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        hidden.data_ptr(), y.data_ptr(), d, f, e, r,
        row_tile_bound(r, e), torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "mit_moe_experts")
    if not torch.cuda.is_current_stream_capturing():
        moe_experts.launches += 2
    return y


def moe_experts(x: torch.Tensor, idx: torch.Tensor, w_gate, w_up, w_down,
                phase: str) -> torch.Tensor:
    """x (T, D), routes (T, k) → each route's expert output (T, k, D), in
    x's dtype."""
    t, k = idx.shape
    n_exp = w_gate.shape[0]
    order, token, offsets = group_routes(idx, n_exp)
    y_sorted = grouped_swiglu(x.contiguous(), token, offsets, w_gate, w_up,
                              w_down)
    y = torch.empty_like(y_sorted)
    y[order] = y_sorted
    # the call, its rows, the experts hit and the largest rows an expert
    # over the mean, summed on the device until flush_counters
    counts = (offsets[1:] - offsets[:-1]).float()
    sums = _sums(phase, x.device)
    sums.add_(torch.stack((sums.new_ones(()), counts.sum(),
                           counts.count_nonzero().float(),
                           counts.max() * (n_exp / (t * k)))))
    return y.reshape(t, k, -1)


def moe_layer(x: torch.Tensor, w_router, router_bias, w_gate, w_up, w_down,
              shared_gate, shared_up, shared_down, top_k: int, scale: float,
              normalize: bool, phase: str) -> torch.Tensor:
    """x (T, D) → ``Σ_i w_i E_i(x) + shared(x)``: the routed outputs weighed
    in f32 and summed, rounded to x's dtype, plus the shared expert."""
    with span("mit.moe.route"):
        idx, w = moe_route(x, w_router, router_bias, top_k, scale, normalize)
    with span("mit.moe.experts"):
        y = moe_experts(x, idx, w_gate, w_up, w_down, phase)
    routed = (y.float() * w[..., None]).sum(1).to(x.dtype)
    return routed + swiglu(x, shared_gate, shared_up, shared_down)


def _sums(phase: str, device) -> torch.Tensor:
    """The phase's device-side sums (calls, rows, experts hit, max load) on
    ``device``, added to in place (so that a replayed CUDA graph adds to
    them too)."""
    key = (phase, str(device))
    if key not in _SUMS:
        # a normal tensor even when made under inference mode, so that
        # reset_counters may zero it outside
        with torch.inference_mode(False):
            _SUMS[key] = torch.zeros(4, device=device)
    return _SUMS[key]


def flush_counters() -> None:
    """Fold the device-side sums into ``moe_experts.calls``, ``.rows``,
    ``.experts_hit`` and ``moe_route.max_load`` (reads them back: call
    where the host waits)."""
    for (phase, _), t in _SUMS.items():
        calls, rows, hit, load = t.tolist()
        moe_experts.calls[phase] += round(calls)
        moe_experts.rows[phase] += round(rows)
        moe_experts.experts_hit[phase] += round(hit)
        moe_route.max_load += load
        t.zero_()


def reset_counters() -> None:
    moe_experts.calls = dict.fromkeys(PHASES, 0)
    moe_experts.rows = dict.fromkeys(PHASES, 0)
    moe_experts.experts_hit = dict.fromkeys(PHASES, 0)
    moe_experts.launches = 0
    moe_route.max_load = 0.0
    for t in _SUMS.values():
        t.zero_()


_SUMS: dict = {}
reset_counters()
