"""The program's own spans in a cell's traced slice, read beside the
benchmark:

    python3 -m tmbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell once as ``python3 -m tmbench.run ... --trace 1`` does and
prints its result line, then one more line: ``{"spans": {name: totals},
"readings": {...}}``, each ``tm.*`` span's totals over the traced slice
(:func:`program_spans`) and what :func:`readings` makes of them.

The benchmark's result line does not carry the spans: ``trace.Slice``
reduces its events with ``trace.reduce_events`` alone. This tool reduces
the same events a second time, in its own process (:func:`recording`), and
changes nothing in the result line.
"""
from __future__ import annotations

import contextlib
import json
import re
import sys
import time

from tmbench import trace

SPAN_PREFIX = "tm."
# host calls that put work on the device: kernel launches, async copies and fills
LAUNCH = re.compile(r"^(cudaLaunch|cuLaunch|cudaMemcpy\w*Async|cudaMemset\w*Async)")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
FIELDS = ("n", "host_s", "self_s", "launches", "device_s")


class _Span:
    __slots__ = ("name", "a", "b", "child", "launches", "corrs")

    def __init__(self, name: str, a: float, b: float):
        self.name, self.a, self.b = name, a, b
        self.child, self.launches, self.corrs = 0.0, 0, []


def program_spans(events: list[dict]) -> dict:
    """The program's spans (``user_annotation`` events named ``tm.*``) in
    Chrome-trace events (µs), by name: ``{"n", "host_s", "self_s",
    "launches", "device_s"}``.

    ``self_s`` is ``host_s`` less what the span's ``tm.`` children cover;
    ``launches`` counts the host calls on the span's thread, inside its
    interval (its children's included), that put work on the device
    (kernel launches, async copies and fills); ``device_s`` sums the
    device time of the work those calls put there, matched by the trace's
    ``correlation`` id, so work that runs after its span closed still
    counts toward it."""
    spans: dict[tuple, list[_Span]] = {}
    calls: dict[tuple, list[tuple[float, object]]] = {}
    dev_s: dict[object, float] = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e["dur"])
        thread = (e.get("pid"), e.get("tid"))
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.setdefault(thread, []).append(_Span(name, a, b))
        elif cat in LAUNCH_CATS and LAUNCH.match(name):
            calls.setdefault(thread, []).append((a, corr))
        elif cat in trace.DEVICE_CATS and corr is not None:
            dev_s[corr] = dev_s.get(corr, 0.0) + (b - a) * 1e-6
    out: dict[str, dict] = {}
    for thread, group in spans.items():
        group.sort(key=lambda s: (s.a, -s.b))
        stack: list[_Span] = []
        for s in group:                  # nesting: a child's cover of its parent
            while stack and stack[-1].b <= s.a:
                stack.pop()
            if stack:
                stack[-1].child += min(s.b, stack[-1].b) - s.a
            stack.append(s)
        stack, i = [], 0
        for t, corr in sorted(calls.get(thread, []), key=lambda c: c[0]):
            while i < len(group) and group[i].a <= t:
                while stack and stack[-1].b <= group[i].a:
                    stack.pop()
                stack.append(group[i])
                i += 1
            while stack and stack[-1].b < t:
                stack.pop()
            for s in stack:              # every span open at the call holds it
                s.launches += 1
                s.corrs.append(corr)
        for s in group:
            o = out.setdefault(s.name, dict.fromkeys(FIELDS, 0))
            o["n"] += 1
            o["host_s"] += (s.b - s.a) * 1e-6
            o["self_s"] += (s.b - s.a - s.child) * 1e-6
            o["launches"] += s.launches
            o["device_s"] += sum(dev_s.get(c, 0.0) for c in s.corrs)
    return out


def readings(spans: dict) -> dict:
    """Per-step and per-batch readings of the spans, each None where its
    spans are absent: ``train.round_host_us`` (host µs of a class round),
    ``train.launches_per_round`` (device launches of a class round; None
    when the rounds launched nothing, as on the CPU),
    ``train.index_sync_ms`` (host ms of a step's index sync: the diff and
    the caches' update, over the steps) and ``score.input_ms`` (host ms of
    a scored batch's input path, over the batches)."""
    rnd, step = spans.get("tm.round"), spans.get("tm.train_step")
    diff, apply = spans.get("tm.index_sync.diff"), spans.get("tm.index_sync.apply")
    scores, inp = spans.get("tm.scores"), spans.get("tm.scores.input")
    return {
        "train.round_host_us": 1e6 * rnd["host_s"] / rnd["n"] if rnd else None,
        "train.launches_per_round": (rnd["launches"] / rnd["n"]
                                     if rnd and rnd["launches"] else None),
        "train.index_sync_ms": (1e3 * (diff["host_s"] + apply["host_s"]) / step["n"]
                                if step and diff and apply else None),
        "score.input_ms": 1e3 * inp["host_s"] / scores["n"] if scores and inp else None,
    }


@contextlib.contextmanager
def recording():
    """Inside, every traced slice's events are also reduced to
    :func:`program_spans`; yields the list of those reductions, one per
    slice (a cell's run traces one). ``reduce_events`` itself, and what
    it returns, are untouched."""
    seen: list[dict] = []
    plain = trace.reduce_events

    def reduce_events(events, window_s):
        seen.append(program_spans(events))
        return plain(events, window_s)

    trace.reduce_events = reduce_events
    try:
        yield seen
    finally:
        trace.reduce_events = plain


def main(argv=None) -> int:
    """``--workload <cell> --seed <n> --seconds <s>``: one traced run of
    the cell (see the module docstring)."""
    from tmbench import harness

    now, age = time.perf_counter(), harness.process_age_s()
    started = now - age if age is not None else now
    argv = list(sys.argv[1:] if argv is None else argv)
    with recording() as seen:
        rc = harness.main(argv + ["--trace", "1"], started=started)
    if rc == 0:
        spans = seen[-1] if seen else {}
        print(json.dumps({"spans": spans, "readings": readings(spans)}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
