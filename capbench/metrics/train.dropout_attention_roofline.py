"""The decoder self-attention's dropout kernels' share of their roofline in
a training step: the forward's and the backward's least times at the
batch's (B, H, T, T, hd) (``capbench/arith.py``) times their launches,
over the profiler's device time of the kernels this file's patterns
match."""

from capbench import arith

TRAFFIC = ("train_steps",)
MOVES = "train_images_per_s"
UNIT = "%"
FORWARD = ("dropout_fwd_tc_kernel",)
BACKWARD = ("dropout_bwd_tc_kernel",)


def read(r):
    nf, sf = r.matched(FORWARD)
    nb, sb = r.matched(BACKWARD)
    if nf + nb == 0 or sf + sb <= 0:
        return None
    dc = r.cfg["decoder"]
    b, h = r.cell["params"]["batch"], dc["num_heads"]
    t, hd = dc["max_seq_len"] - 1, dc["embed_dim"] // h
    dt = r.cfg["compute_dtype"]
    fwd = arith.attention_bound(b, h, t, t, dt, hd=hd)["bound_ms"]
    bwd = arith.dropout_attention_bwd_bound(b, h, t, t, dt, hd=hd)["bound_ms"]
    return 100.0 * (nf * fwd + nb * bwd) * 1e-3 / (sf + sb)
