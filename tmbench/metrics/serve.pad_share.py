"""``serve.pad_share``: percent of the rows sent to the device that were
padding to a bucket, over the window (``1 - rows_real / rows_padded``)."""


def read(run: dict) -> float | None:
    """Padding rows as a percent of the bucket rows dispatched."""
    s = run["data"].get("stats")
    if not s or not s["rows_padded"]:
        return None
    return 100.0 * (1.0 - s["rows_real"] / s["rows_padded"])
