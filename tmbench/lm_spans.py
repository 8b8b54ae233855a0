"""Device time of an LM step by the program's ``lm.*`` span, read from a
traced slice (``LMSlice``, a ``trace.Slice`` whose summary adds ``"lm"``).

Forward work is the span's own: the kernels, copies and fills launched
inside it on its thread (matched by the trace's ``correlation`` id), its
innermost ``lm.*`` span taking each. Backward kernels run on autograd's
thread under no span; each is given to the forward operator that made its
node: a backward operator (``autograd::engine::evaluate_function: …``)
carries the ``Sequence number`` of that forward operator, on the thread
that ran the step (``lm.train_step``), and goes to the innermost span
around it. A block recomputed in the backward pass (``remat``) records its
spans again on autograd's thread, and its kernels are the span's there.
"""
from __future__ import annotations

import json
import re
import tempfile
from pathlib import Path

from tmbench import trace

PREFIX = "lm."
STEP = "lm.train_step"
BACKWARD = "autograd::engine::evaluate_function:"
LAUNCH = re.compile(r"^(cudaLaunch|cuLaunch|cudaMemcpy\w*Async|cudaMemset\w*Async)")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class LMSlice(trace.Slice):
    """A ``trace.Slice`` whose summary also holds ``"lm"``:
    :func:`device_by_span` of its events."""

    def summary(self) -> dict:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            self._prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text()).get("traceEvents", [])
        out = trace.reduce_events(events, self.window_s)
        out["lm"] = device_by_span(events)
        return out


def _innermost(intervals, points):
    """For sorted ``points`` (t, payload) on one thread: ``[(label,
    payload)]`` of the innermost interval ``(a, b, label)`` holding each
    (intervals properly nested, as one thread's are); unheld points left
    out."""
    out, stack, i = [], [], 0
    intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    for t, payload in points:
        while i < len(intervals) and intervals[i][0] <= t:
            while stack and stack[-1][1] < intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out.append((stack[-1][2], payload))
    return out


def device_by_span(events: list[dict]) -> dict:
    """``{"device_s": {span: s}, "launches": {span: n}}``: the device time
    and launches each ``lm.*`` span took (innermost; forward, backward and
    recompute, as the module's docstring says)."""
    spans, ops, launches, dev_s = {}, {}, {}, {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e["dur"])
        thread = (e.get("pid"), e.get("tid"))
        args = e.get("args") or {}
        if cat == "user_annotation" and name.startswith(PREFIX):
            spans.setdefault(thread, []).append((a, b, name))
        elif cat == "cpu_op" and args.get("Sequence number") is not None:
            ops.setdefault(thread, []).append(
                (a, b, name, args["Sequence number"], args.get("Fwd thread id", 0)))
        elif cat in LAUNCH_CATS and LAUNCH.match(name):
            launches.setdefault(thread, []).append((a, args.get("correlation")))
        elif cat in trace.DEVICE_CATS and args.get("correlation") is not None:
            c = args["correlation"]
            dev_s[c] = dev_s.get(c, 0.0) + (b - a) * 1e-6
    # forward operators of the step's thread, by sequence number → span
    by_seq = {}
    for thread, group in spans.items():
        if not any(n == STEP for _, _, n in group):
            continue
        fwd = sorted((a, s) for a, _, n, s, f in ops.get(thread, [])
                     if not f and not n.startswith(BACKWARD))
        by_seq.update({s: label for label, s in _innermost(group, fwd)})
    device, count = {}, {}
    for thread in set(spans) | set(ops) | set(launches):
        intervals = list(spans.get(thread, []))
        intervals += [(a, b, by_seq[s]) for a, b, n, s, f in ops.get(thread, [])
                      if f and n.startswith(BACKWARD) and s in by_seq]
        for label, corr in _innermost(intervals, sorted(launches.get(thread, []),
                                                       key=lambda p: p[0])):
            device[label] = device.get(label, 0.0) + dev_s.get(corr, 0.0)
            count[label] = count.get(label, 0) + 1
    return {"device_s": device, "launches": count}


def inclusive(summary: dict | None, span: str) -> float:
    """Device seconds of ``span`` and the spans inside it (names that start
    with ``span + "."``) in a slice's summary; 0 without one."""
    if not summary or "lm" not in summary:
        return 0.0
    return sum(s for name, s in summary["lm"]["device_s"].items()
               if name == span or name.startswith(span + "."))
