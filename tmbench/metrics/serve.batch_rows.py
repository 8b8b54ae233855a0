"""``serve.batch_rows``: real rows per batch the server formed over the
window (its ``stats()`` counters: ``rows_real / batches``)."""


def read(run: dict) -> float | None:
    """Mean real rows per dispatched batch."""
    s = run["data"].get("stats")
    return s["rows_real"] / s["batches"] if s and s["batches"] else None
