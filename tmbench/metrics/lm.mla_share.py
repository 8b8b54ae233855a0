"""``lm.mla_share``: the share of the traced slice's busy device time spent
under ``lm.mla`` (``tmbench.lm_spans``: its forward, recompute and
backward kernels)."""
from tmbench.lm_spans import inclusive


def read(run: dict) -> float | None:
    """Percent of the device's busy time that MLA took."""
    trace = run.get("trace")
    spent = inclusive(trace, "lm.mla")
    if spent <= 0 or not trace["busy_s"]:
        return None
    return 100.0 * spent / trace["busy_s"]
