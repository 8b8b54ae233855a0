"""``lm.mfu``: the whole training step's share of the chip's dense bf16
peak over the window: the window's counted FLOPs (``tmbench.lm_counts``:
6 a weight a token, the routed experts from ``lm.moe.kept``, the causal
attention core; no recompute) over the window's length."""
from tmbench.lm_counts import PEAK_FLOPS


def read(run: dict) -> float | None:
    """Percent of the peak the window's steps reached."""
    d = run["data"]
    if not d.get("window_flops") or not d.get("window_s"):
        return None
    return 100.0 * d["window_flops"] / d["window_s"] / PEAK_FLOPS
