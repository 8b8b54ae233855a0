"""``score.mfu``: the whole scoring step's share of the chip's peak over
the window: the least time of the window's scoring work (each row's
falsifying inclusions against the int32 logic peak, or the rows in, the
scores out and each batch's list entries against the memory peak, the
larger) over the window's length. Never dense work."""


def read(run: dict) -> float | None:
    """Percent of the peak the window's scoring reached."""
    d = run["data"]
    return 100.0 * d["window_bound_s"] / d["window_s"] if d.get("window_s") else None
