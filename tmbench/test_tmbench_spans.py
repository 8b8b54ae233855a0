"""``tmbench.spans`` on a fixed, hand-made trace: ``program_spans`` gives
each program span's count, host and self time, launches, and the device
time of what it launched, matched by correlation id; the readings are None
where no span was recorded; and recording the spans leaves what
``trace.reduce_events`` returns as it was (a literal golden). On the CPU,
a traced run of each cell records the program's spans."""
import contextlib
import time

import pytest
import torch

from tmbench import harness, spans, testing
from tmbench import trace as trace_mod

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 0 if cat in DEVICE else 1,
         "tid": 7, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# µs. Two class rounds inside one step; the vote of the second launches a
# kernel (correlation 4) that runs from 600 to 800, after the vote (460-560)
# and its round (450-700) have closed. Correlation 9 launches outside every
# tm. span; the stream sync (7) puts no work on the device.
EVENTS = [
    _x("user_annotation", "tmbench.partial_fit", 0, 1000),
    _x("user_annotation", "tm.train_step", 10, 890),
    _x("user_annotation", "tm.round", 100, 300),
    _x("user_annotation", "tm.round.vote", 110, 90),
    _x("cpu_op", "aten::gt", 120, 30),
    _x("cuda_runtime", "cudaLaunchKernel", 130, 10, 1),
    _x("user_annotation", "tm.round.feedback", 210, 180),
    _x("cuda_runtime", "cudaLaunchKernel", 220, 10, 2),
    _x("cuda_runtime", "cudaMemcpyAsync", 300, 10, 3),
    _x("cuda_runtime", "cudaStreamSynchronize", 320, 60, 7),
    _x("user_annotation", "tm.round", 450, 250),
    _x("user_annotation", "tm.round.vote", 460, 100),
    _x("cuda_runtime", "cudaLaunchKernel", 470, 10, 4),
    _x("user_annotation", "tm.round.feedback", 570, 120),
    _x("cuda_runtime", "cudaMemsetAsync", 580, 5, 5),
    _x("cpu_op", "aten::mul", 720, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 750, 10, 6),
    _x("cuda_runtime", "cudaLaunchKernel", 950, 5, 9),
    _x("kernel", "k_gt", 150, 100, 1),
    _x("kernel", "k_upd", 240, 60, 2),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 310, 8, 3),
    _x("kernel", "k_vote", 600, 200, 4),
    _x("gpu_memset", "Memset (Device)", 800, 10, 5),
    _x("kernel", "k_tail", 905, 40, 6),
    _x("kernel", "k_tail", 960, 30, 9),
    {"ph": "i", "cat": "cpu_instant_event", "name": "marker", "pid": 1,
     "tid": 7, "ts": 500},
]
WINDOW_S = 1200e-6

# reduce_events(EVENTS, WINDOW_S): every per-layer metric reads these keys.
GOLDEN = {
    "window_s": 0.0012,
    "busy_s": 0.00043799999999999997,
    "kernel_s": {"k_gt": 9.999999999999999e-05, "k_upd": 5.9999999999999995e-05,
                 "Memcpy DtoH (Device -> Pageable)": 8e-06,
                 "k_vote": 0.00019999999999999998,
                 "Memset (Device)": 9.999999999999999e-06, "k_tail": 7e-05},
    "device_ops": [["k_vote", 0.00019999999999999998],
                   ["k_gt", 9.999999999999999e-05], ["k_tail", 7e-05],
                   ["k_upd", 5.9999999999999995e-05],
                   ["Memset (Device)", 9.999999999999999e-06],
                   ["Memcpy DtoH (Device -> Pageable)", 8e-06]],
    "idle_gaps": [["tm.round", 0.00028199999999999997],
                  ["tm.train_step", 0.000245],
                  ["cudaLaunchKernel", 1.4999999999999999e-05],
                  ["cudaMemcpyAsync", 9.999999999999999e-06],
                  ["tmbench.partial_fit", 9.999999999999999e-06]],
}


@pytest.mark.parametrize("recorded", [False, True], ids=["plain", "recording"])
def test_recording_the_spans_leaves_the_reduced_trace_as_it_was(recorded):
    with spans.recording() if recorded else contextlib.nullcontext() as seen:
        got = trace_mod.reduce_events(EVENTS, WINDOW_S)
    assert got == GOLDEN
    if recorded:
        assert seen == [spans.program_spans(EVENTS)]
    assert trace_mod.reduce_events(EVENTS, WINDOW_S) == GOLDEN


@pytest.mark.parametrize("name, n, host_us, self_us, launches, device_us", [
    ("tm.train_step", 1, 890, 340, 6, 100 + 60 + 8 + 200 + 10 + 40),
    ("tm.round", 2, 550, 60, 5, 100 + 60 + 8 + 200 + 10),
    ("tm.round.vote", 2, 190, 190, 2, 100 + 200),
    ("tm.round.feedback", 2, 300, 300, 3, 60 + 8 + 10),
])
def test_spans_count_time_launches_and_device_time(name, n, host_us, self_us,
                                                   launches, device_us):
    got_all = spans.program_spans(EVENTS)
    assert set(got_all) == {"tm.train_step", "tm.round", "tm.round.vote",
                            "tm.round.feedback"}
    got = got_all[name]
    assert got["n"] == n and got["launches"] == launches
    assert got["host_s"] == pytest.approx(host_us * 1e-6)
    assert got["self_s"] == pytest.approx(self_us * 1e-6)
    assert got["device_s"] == pytest.approx(device_us * 1e-6)


def test_spans_on_another_thread_hold_no_launch_of_this_one():
    other = [dict(e, tid=8) if e["cat"] == "user_annotation" else e
             for e in EVENTS]
    got = spans.program_spans(other)
    assert all(s["launches"] == 0 and s["device_s"] == 0 for s in got.values())
    assert got["tm.round"]["self_s"] == pytest.approx(60e-6)


READINGS = ("train.round_host_us", "train.launches_per_round",
            "train.index_sync_ms", "score.input_ms")


def _totals(n, host_s, launches=0):
    return {"n": n, "host_s": host_s, "self_s": host_s, "launches": launches,
            "device_s": 0.0}


@pytest.mark.parametrize("reading", READINGS)
@pytest.mark.parametrize("recorded", [
    {}, {"tm.learn": _totals(1, 0.01), "tm.draws": _totals(9, 0.002)}],
    ids=["no_spans", "other_spans"])
def test_the_readings_read_nothing_without_their_spans(reading, recorded):
    assert spans.readings(recorded)[reading] is None


def test_the_readings_on_a_traced_step():
    recorded = {"tm.train_step": _totals(2, 0.1),
                "tm.round": _totals(128, 0.064, 2560),
                "tm.index_sync.diff": _totals(4, 0.003),
                "tm.index_sync.apply": _totals(2, 0.001),
                "tm.scores": _totals(4, 0.008),
                "tm.scores.input": _totals(4, 0.002)}
    assert spans.readings(recorded) == pytest.approx({
        "train.round_host_us": 500.0, "train.launches_per_round": 20.0,
        "train.index_sync_ms": 2.0, "score.input_ms": 0.5})
    recorded["tm.round"]["launches"] = 0      # a trace without the device
    assert spans.readings(recorded)["train.launches_per_round"] is None


TRAIN_SPANS = {"tm.train_step", "tm.train_step.input", "tm.learn", "tm.draws",
               "tm.round", "tm.round.vote", "tm.round.feedback",
               "tm.index_sync.diff", "tm.index_sync.apply"}


@pytest.mark.parametrize("name, want", [
    ("imdb_score", {"tm.scores", "tm.scores.input", "tm.scores.engine"}),
    ("imdb_train", TRAIN_SPANS), ("mnist_train", TRAIN_SPANS)])
def test_a_traced_cell_on_the_cpu_records_the_program_spans(name, want):
    cell = testing.tiny(harness.find_cell(name))
    plain = harness.run_cell(cell, 2**31 + 11, 0.3, True, torch.device("cpu"),
                             time.perf_counter())
    with spans.recording() as seen:
        line = harness.run_cell(cell, 2**31 + 11, 0.3, True, torch.device("cpu"),
                                time.perf_counter())
    assert line["correct"] is True and set(line) == set(plain)
    assert len(seen) == 1 and set(seen[0]) == want
    got = spans.readings(seen[0])
    train = name.endswith("_train")
    assert (got["train.round_host_us"] is not None) == train
    assert (got["train.index_sync_ms"] is not None) == train
    assert (got["score.input_ms"] is not None) != train
    assert got["train.launches_per_round"] is None       # no device here
