"""``train.ta_update_roofline``: ``ta_update``'s share of its roofline over
the traced steps: each class round's least time (``counts.ta_update_work``
with the Type I rows of the reference's replay of those rounds) over the
device time of ``ta_update_kernel`` by name."""
from tmbench.trace import kernel_seconds


def read(run: dict) -> float | None:
    """Percent of the update kernel's roofline reached."""
    spent = kernel_seconds(run.get("trace"), "ta_update_kernel")
    if spent <= 0:
        return None
    return 100.0 * run["data"]["traced_update_bound_s"] / spent
