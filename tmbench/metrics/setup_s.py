"""``setup_s``: seconds from the process's start until the window opened
(imports, CUDA context, kernel build or load, inputs, state and index,
warm-up)."""


def read(run: dict) -> float | None:
    """The run's set-up time."""
    return run["setup_s"]
