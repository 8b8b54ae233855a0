"""``serve_p95_ms``: the 95th percentile of the latencies ``serve_p50_ms``
takes the median of."""
import numpy as np


def read(run: dict) -> float | None:
    """95th percentile of the window's request latencies (ms)."""
    lat = run["data"].get("latency_ms")
    return float(np.percentile(lat, 95)) if lat is not None and len(lat) else None
