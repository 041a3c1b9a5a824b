"""The encoder's self-attention kernel's share of its roofline in a batch
decoded by beam search: the least time of a launch at the cell's shapes (q,
k, v read and the output written once, two (T, T, hd) products; bound by
bytes at these shapes in bf16) times the launches, over the profiler's
device time of the kernels this file's patterns match."""

from capbench import arith

TRAFFIC = ("batch_closed_loop",)
MOVES = "captions_per_s.beam"
UNIT = "%"
PATTERNS = ("flash_attention_btd_tc_kernel", "flash_attention_f32_kernel")


def read(r):
    n, secs = r.matched(PATTERNS)
    if n == 0 or secs <= 0:
        return None
    e = r.cfg["encoder"]
    t = (e["image_size"] // e["patch_size"]) ** 2 + 1
    h = e["num_attention_heads"]
    b = arith.attention_bound(r.cell["params"]["batch"], h, t, t,
                              r.cfg["compute_dtype"],
                              hd=e["hidden_size"] // h)
    return 100.0 * n * b["bound_ms"] * 1e-3 / secs
