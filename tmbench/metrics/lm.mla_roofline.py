"""``lm.mla_roofline``: the latent attention's share of the chip's dense
bf16 peak over the traced steps: its counted FLOPs (projections and the
causal core, forward and backward; ``tmbench.lm_counts.mla_flops``) over
the device time under ``lm.mla`` (``tmbench.lm_spans``: its forward,
recompute and backward kernels)."""
from tmbench.lm_counts import PEAK_FLOPS
from tmbench.lm_spans import inclusive


def read(run: dict) -> float | None:
    """Percent of the peak MLA's kernels reached."""
    spent = inclusive(run.get("trace"), "lm.mla")
    flops = run["data"].get("traced_mla_flops")
    if spent <= 0 or not flops:
        return None
    return 100.0 * flops / (spent * PEAK_FLOPS)
