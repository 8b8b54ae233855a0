"""``train.mfu``: the whole learning step's share of the chip's peak over
the traced steps: per class round the include bits of the row read once,
the states of the clauses whose feedback reads them read once and the
states that change written once (counted from the reference's replay of
the same draws), against the memory peak, over the traced slice's
length."""


def read(run: dict) -> float | None:
    """Percent of the peak the traced steps reached."""
    trace = run.get("trace")
    if not trace or trace["busy_s"] <= 0 or not trace["window_s"]:
        return None
    return 100.0 * run["data"]["traced_learn_bound_s"] / trace["window_s"]
