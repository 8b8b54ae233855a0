"""``score_rows_per_s``: rows scored in the window over the window's
length (to the last batch's scores on the host)."""


def read(run: dict) -> float | None:
    """Rows per second of the window."""
    d = run["data"]
    return d["rows"] / d["window_s"] if d.get("window_s") else None
