"""``score.walk_roofline``: the list walk's share of its roofline over the
traced batches: the least time of the lists, literals and votes these
batches need (``counts.walk_work`` on the benchmark's own include mask)
over the device time of ``indexed_walk_kernel`` by name."""
from tmbench.trace import kernel_seconds


def read(run: dict) -> float | None:
    """Percent of the walk kernel's roofline reached."""
    spent = kernel_seconds(run.get("trace"), "indexed_walk_kernel")
    if spent <= 0:
        return None
    return 100.0 * run["data"]["traced_walk_bound_s"] / spent
