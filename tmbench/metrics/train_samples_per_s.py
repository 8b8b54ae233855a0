"""``train_samples_per_s``: samples learned by the cell's training step
in the window over the window's length (to the last step's end on the
device)."""


def read(run: dict) -> float | None:
    """Samples per second of the window."""
    d = run["data"]
    return d["samples"] / d["window_s"] if d.get("window_s") else None
