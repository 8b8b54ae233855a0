"""``serve_p50_ms``: the median latency of every request of the window,
from its due time on the schedule to its answer (a failed request counts
at the window's length)."""
import numpy as np


def read(run: dict) -> float | None:
    """Median of the window's request latencies (ms)."""
    lat = run["data"].get("latency_ms")
    return float(np.percentile(lat, 50)) if lat is not None and len(lat) else None
