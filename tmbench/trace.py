"""A bounded slice of a run under ``torch.profiler``, reduced to what the
per-layer metrics read: the seconds in which an operation ran on the
device, the slice's length, device seconds by kernel name, and the
breakdown the result line carries (the device operations that took most
time, and the longest idle gaps of the device by what the host was doing).

The trace is written to a temporary directory (under ``TMPDIR``), read
back and deleted.
"""
from __future__ import annotations

import heapq
import json
import tempfile
import time
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


class Slice:
    """``start()`` / ``stop()`` around the traced work (``stop`` waits for
    the device first), then ``summary()`` reads the trace."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self.window_s = None

    @staticmethod
    def warm(device: torch.device) -> None:
        """Start and stop the profiler once (set-up), so that starting it
        inside a window does not stall the run for its first start."""
        sl = Slice(device)
        sl.start()
        torch.zeros(1, device=device).add_(1)
        sl.stop()

    def start(self) -> None:
        """Begin tracing."""
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        """Wait for the device, end tracing."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)

    def __enter__(self) -> "Slice":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def summary(self) -> dict:
        """The slice reduced (see :func:`reduce_events`)."""
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            self._prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text()).get("traceEvents", [])
        return reduce_events(events, self.window_s)


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events: list[dict], window_s: float) -> dict:
    """Chrome-trace events (µs) → ``{"window_s", "busy_s", "kernel_s":
    {name: s}, "device_ops": [[name, s]], "idle_gaps": [[name, s]]}``.
    ``busy_s`` is the union of device intervals, never more than the
    slice (raises if it is); an idle gap is named by the innermost host
    operation running at its midpoint."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if cat in DEVICE_CATS:
            dev.append((span, e.get("name", "?")))
        elif cat in HOST_CATS:
            host.append((span, e.get("name", "?")))
    by_name: dict[str, float] = {}
    for (a, b), name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    merged = _merge([span for span, _ in dev])
    busy = sum(b - a for a, b in merged) * 1e-6
    if busy > window_s:
        raise ValueError(f"the device was busy {busy} s in a slice of "
                         f"{window_s} s: the trace holds device work from "
                         "outside the slice, or the union is wrong")
    starts = [a for (a, _), _ in host] + [a for a, _ in merged]
    ends = [b for (_, b), _ in host] + [b for _, b in merged]
    gaps: dict[str, float] = {}
    if starts:
        lo, hi = min(starts), max(ends)
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        holes = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        # sweep the gaps' midpoints in order with the host events open there
        host.sort(key=lambda h: h[0][0])
        open_: list[tuple[float, float, str]] = []    # heap of (end, dur, name)
        i = 0
        for a, b in sorted(holes, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while i < len(host) and host[i][0][0] <= mid:
                (s, e), name = host[i]
                heapq.heappush(open_, (e, e - s, name))
                i += 1
            while open_ and open_[0][0] < mid:
                heapq.heappop(open_)
            name = (min(open_, key=lambda h: h[1])[2] if open_
                    else "host: Python between ops")
            gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": window_s, "busy_s": busy, "kernel_s": by_name,
            "device_ops": [[k[:160], v] for k, v in top],
            "idle_gaps": [[k[:160], v] for k, v in idle]}


def kernel_seconds(summary: dict | None, needle: str) -> float:
    """Device seconds of every kernel whose name holds ``needle``."""
    if not summary:
        return 0.0
    return sum(s for name, s in summary["kernel_s"].items() if needle in name)


def idle_share(summary: dict | None) -> float | None:
    """Percent of the slice with nothing running on the device; None when
    the slice saw no device activity (nothing to read)."""
    if not summary or summary["busy_s"] <= 0 or not summary["window_s"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def per_second(ends: list[float]) -> list[int]:
    """How many of the given times (s into the window) fall in each second:
    the window's progress, to tell a slow process from a slow stretch."""
    out = [0] * (int(max(ends, default=0)) + 1)
    for e in ends:
        out[int(e)] += 1
    return out
