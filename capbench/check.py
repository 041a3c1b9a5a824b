"""The comparisons that decide ``correct``: served captions against the
plain reference's logits, and the first training steps against the
reference's steps. The reference runs after the window has closed and the
program's state is freed, in blocks of rows."""

from __future__ import annotations

import numpy as np
import torch

from capbench.reference import model as ref

BLOCK = 16          # images a block of the reference


def sample(rng, captions: dict, min_tokens: int, min_requests: int) -> list:
    """Keys of ``captions`` (key → token list) to compare: the longest
    caption, then others drawn from ``rng`` until the sample holds at
    least ``min_tokens`` served tokens and ``min_requests`` captions."""
    keys = sorted(captions)
    if not keys:
        return []
    longest = max(keys, key=lambda k: (len(captions[k]), -k))
    rest = [k for k in keys if k != longest]
    rng.shuffle(rest)
    out, tokens = [longest], len(captions[longest]) - 1
    for k in rest:
        if tokens >= min_tokens and len(out) >= min_requests:
            break
        out.append(k)
        tokens += len(captions[k]) - 1
    return out


def well_formed(cap, cfg: dict) -> bool:
    """START first, every id in the vocabulary, no longer than max_len."""
    ids, dc = cfg["special_ids"], cfg["decoder"]
    return (len(cap) >= 2 and cap[0] == ids["start"]
            and len(cap) <= dc["max_seq_len"]
            and all(0 <= t < dc["vocab_size"] for t in cap))


def logit_gaps(weights: dict, cfg: dict, images_u8: torch.Tensor, captions,
               k: int = 1, control: bool = False) -> np.ndarray:
    """Each served token's gap below the f32 reference's ``k``-th best
    logit at its position, over all ``captions`` (their images
    ``images_u8``, on the device): greedy decoding (k = 1) puts the best
    token next, and a beam search of k beams extends each kept hypothesis
    by one of its k best. With ``control`` the tokens judged at each
    position are those that the fp8 reference puts in its ``k`` best, on
    the same prompts and tokens, and the widest of their gaps counts."""
    gaps = []
    with torch.no_grad():
        for lo in range(0, len(captions), BLOCK):
            imgs = images_u8[lo:lo + BLOCK]
            caps = captions[lo:lo + BLOCK]
            exact = ref.served_logits(weights, cfg, imgs, caps, ref.F32)
            low = (ref.served_logits(weights, cfg, imgs, caps,
                                     ref.Arith("fp8")) if control else None)
            for i, (lg, cap) in enumerate(zip(exact, caps)):
                if control:
                    judged = low[i].topk(k, dim=-1).indices
                else:
                    judged = torch.tensor(cap[1:], device=lg.device)[:, None]
                kth = lg.topk(k, dim=-1).values[:, -1]
                worst = lg.gather(-1, judged).min(-1).values
                gaps.append((kth - worst).cpu().numpy())
    return np.concatenate(gaps) if gaps else np.zeros(0)


def beam_agreement(weights: dict, cfg: dict, images_u8: torch.Tensor,
                   captions, k: int, judged: str = "program"):
    """Each image's caption judged against the f32 reference's own beam
    search of ``k`` beams: whether it differs from that search's best
    caption, and its shortfall in total log-probability below that
    caption's (both totals scored by the f32 reference; a judged caption
    with a higher total reads below 0). The caption judged is the served
    one ("program"), the best caption of the same beam search run by the
    fp8 reference ("control"), or the f32 reference's greedy caption
    ("greedy": greedy decoding in place of the beam search, a fault).
    → (differs (n,) bool, shortfall (n,), length of the judged caption
    less the reference's (n,))."""
    dec, dc, ids = weights["decoder"], cfg["decoder"], cfg["special_ids"]
    max_len = dc["max_seq_len"]
    differs, gaps, longer = [], [], []
    with torch.no_grad():
        for lo in range(0, len(captions), BLOCK):
            imgs = images_u8[lo:lo + BLOCK]
            mem = ref.memory_of(weights, cfg, imgs)
            best, total = ref.beam_search(dec, dc, mem, ids, k, max_len)
            if judged == "program":
                caps = captions[lo:lo + BLOCK]
            elif judged == "control":
                low = ref.Arith("fp8")
                caps, _ = ref.beam_search(
                    dec, dc, ref.memory_of(weights, cfg, imgs, low), ids, k,
                    max_len, low)
            elif judged == "greedy":
                caps, _ = ref.beam_search(dec, dc, mem, ids, 1, max_len)
            else:
                raise ValueError(f"unknown caption source {judged!r}")
            score = ref.caption_logprob(dec, dc, caps, mem, ids["pad"])
            gaps.append((total - score).cpu().numpy())
            differs += [list(c) != b for c, b in zip(caps, best)]
            longer += [len(c) - len(b) for c, b in zip(caps, best)]
    return np.array(differs), np.concatenate(gaps), np.array(longer)


def served(ctx, weights: dict, images_host: np.ndarray, captions: dict,
           image_of: dict, rng, min_tokens: int, min_requests: int,
           control: bool = False, k: int = 1, judged: str = None) -> dict:
    """The served captions' check: malformed captions read infinite, else
    the widest gap of a sampled served token below the reference's best
    (its ``k``-th best under a beam search of k beams), and the gap that
    99 % of the sampled tokens keep within. Under a beam search every
    caption is also held against the reference's own search
    (:func:`beam_agreement`): the mean shortfall of their totals below its
    best captions' (how many differ, and by how much, go to the run's
    info). A near-tie that moves END by one step moves a total by one
    token's log-probability, so the mean is taken over every caption, not
    the sample. ``image_of[key]`` is the row of ``images_host`` a caption
    came from. ``judged`` = "greedy" reads the beam number of the
    greedy-decoding fault alone."""
    cfg = ctx.cfg
    bad = [k for k, c in captions.items() if not well_formed(c, cfg)]
    keys = sample(rng, captions, min_tokens, min_requests)
    inf = float("inf")
    if bad or not keys:
        out = {"max_logit_gap": inf, "p99_logit_gap": inf}
        if k > 1:
            out["beam_score_gap_mean"] = inf
        return out
    images = lambda ks: torch.from_numpy(np.stack(
        [images_host[image_of[c]] for c in ks])).to(ctx.device)
    out = {}
    if judged is None:
        gaps = logit_gaps(weights, cfg, images(keys),
                          [captions[c] for c in keys], k, control)
        ctx.info["check_sample"] = {"captions": len(keys),
                                    "tokens": int(gaps.size)}
        out = {"max_logit_gap": float(gaps.max()),
               "p99_logit_gap": float(np.quantile(gaps, 0.99))}
    if k > 1:
        src = judged or ("control" if control else "program")
        every = sorted(captions)
        differs, g, longer = beam_agreement(
            weights, cfg, images(every), [captions[c] for c in every], k,
            src)
        out["beam_score_gap_mean"] = float(g.mean())
        ctx.info.setdefault("beam_sample", {})[src] = {
            "images": int(differs.size), "differ": int(differs.sum()),
            "longer": int((longer > 0).sum()),
            "shorter": int((longer < 0).sum()),
            "shortfall_over_1": int((g > 1.0).sum()),
            "gain_over_1": int((g < -1.0).sum()),
            "shortfall_max": float(g.max())}
    return out


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gap(prog: dict, want: dict, moved: set) -> float:
    """The worst leaf's gap between two norms: |‖a‖ − ‖b‖| over the larger
    of the reference leaf's norm and the median leaf's, over ``moved``
    leaves."""
    ref_norms = {k: _norm(want[k]) for k in moved}
    med = float(np.median(list(ref_norms.values())))
    return max(abs(_norm(prog[k]) - ref_norms[k]) / max(ref_norms[k], med)
               for k in moved)


def leaf_diffs(prog: dict, want: dict, moved: set) -> dict:
    """Each leaf's norm of the difference, ‖a − b‖, over the larger of the
    reference leaf's norm and the median leaf's, over ``moved`` leaves."""
    ref_norms = {k: _norm(want[k]) for k in moved}
    med = float(np.median(list(ref_norms.values())))
    return {k: _norm(prog[k].double() - want[k].double())
            / max(ref_norms[k], med) for k in moved}


def moved_leaves(first_grad: dict) -> set:
    """Leaves whose reference gradient is not nought to rounding: a norm of
    at least a thousandth of the median leaf's (a key's bias under softmax
    and a single-key cross-attention's query and key are not)."""
    norms = {k: _norm(g) for k, g in first_grad.items()}
    med = float(np.median(list(norms.values())))
    return {k for k, n in norms.items() if n >= 1e-3 * med}


def training(prog: dict, want: dict) -> dict:
    """``prog`` and ``want`` each hold ``losses`` (the steps' losses),
    ``first_grad`` (leaf → the first step's gradient as the optimizer got
    it), ``start`` and ``params`` (leaf → before and after the steps).
    → the worst relative loss gap over the steps, the worst leaf's gap of
    first-gradient norms and of the norms of the parameters' change, and
    the worst leaf's norm of the first gradient's difference (rounding
    turns a gradient more than it stretches it, so this one tells a
    precision apart where the gaps of norms do not)."""
    moved = moved_leaves(want["first_grad"])
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                    want["losses"]))
    change = lambda d: {k: d["params"][k] - d["start"][k] for k in moved}
    diffs = leaf_diffs(prog["first_grad"], want["first_grad"], moved)
    return {"loss_rel_gap": loss,
            "first_grad_norm_gap": leaf_gap(prog["first_grad"],
                                            want["first_grad"], moved),
            "param_change_norm_gap": leaf_gap(change(prog), change(want),
                                              moved),
            "first_grad_diff": max(diffs.values()),
            "first_grad_diff_median": float(np.median(list(diffs.values())))}
