"""The grouped expert kernel's share of its roofline in the profiled
stretch: for each phase (prefill, decode), the least time of its calls
from the program's counters of that stretch (routed rows and experts hit:
the hit experts' weights and the rows in and out once, or 2 x 3 x D x F
operations a row, whichever bounds; ``arith_vlm.experts_bound``), summed,
over the profiler's device time of the kernels this file's patterns
match. None where the program counts no expert call."""

from capbench import arith_vlm

TRAFFIC = ("vlm_batch_closed_loop",)
MOVES = "captions_per_s"
UNIT = "%"
PATTERNS = ("moe_gate_up_kernel", "moe_down_kernel")


def read(r):
    n, secs = r.matched(PATTERNS)
    if n == 0 or secs <= 0:
        return None
    d = r.cfg["hidden_size"]
    f = r.cfg["moe_intermediate_size"]
    least_ms = 0.0
    for phase in ("prefill", "decode"):
        rows = r.profiled.get(f"vlm.moe.{phase}.rows", 0.0)
        hit = r.profiled.get(f"vlm.moe.{phase}.experts_hit", 0.0)
        if rows > 0:
            least_ms += arith_vlm.experts_bound(rows, hit, d, f)["bound_ms"]
    if least_ms <= 0:
        return None
    return 100.0 * least_ms * 1e-3 / secs
