"""Percent of the traced slice in which no kernel or copy ran on the
device (``torch.profiler``'s device events, their union against the
slice's length)."""
from tmbench.trace import idle_share


def read(run: dict) -> float | None:
    """Idle share of the device over the traced slice."""
    return idle_share(run.get("trace"))
