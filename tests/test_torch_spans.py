"""The program's spans (``repro_torch.spans``), on the CPU.

With no profiler ``span`` hands out one shared no-op context and never
builds a ``record_function``. Under ``torch.profiler.profile`` one
``partial_fit`` records its step, draws, class rounds and index sync in
the documented counts and nesting, and learns bit for bit what it learns
unprofiled; a ``scores`` call records its input and engine; a sharded
session records its step and rounds.
"""
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core import TMConfig
from repro_torch.core.session import Topology, TsetlinMachine

CFG = TMConfig(n_classes=3, n_clauses=8, n_features=6, n_states=50,
               s=3.0, threshold=4)
B = 5


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 2, (B, CFG.n_features), dtype=np.uint8)
    ys = rng.integers(0, CFG.n_classes, (B,))
    return xs, ys


def _machine(**kw):
    return TsetlinMachine(CFG, device="cpu", seed=3,
                          max_events_per_batch=4096, **kw).init()


def _spans(prof) -> dict[str, list[tuple[float, float]]]:
    """``{name: [(start, end), ...]}`` of the ``tm.`` spans a profile
    recorded, in start order."""
    out: dict[str, list] = {}
    for e in prof.events():
        if e.name.startswith("tm."):
            out.setdefault(e.name, []).append((e.time_range.start,
                                               e.time_range.end))
    return {k: sorted(v) for k, v in out.items()}


def _inside(child, parents) -> int:
    """Index of the one interval in ``parents`` that holds ``child``."""
    hits = [i for i, (a, b) in enumerate(parents)
            if a <= child[0] and child[1] <= b]
    assert len(hits) == 1, (child, parents)
    return hits[0]


def test_without_a_profiler_span_is_the_shared_no_op(monkeypatch):
    built = []
    monkeypatch.setattr(spans, "record_function",
                        lambda name: built.append(name))
    assert spans.span("tm.a") is spans.span("tm.b")
    assert isinstance(spans.span("tm.a"), contextlib.nullcontext)
    machine = _machine()
    machine.partial_fit(*_batch())
    machine.scores(_batch()[0])
    assert built == []


def test_under_a_profiler_span_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("tm.test"):
            torch.zeros(2).add_(1)
    assert len(_spans(prof)["tm.test"]) == 1


def test_one_partial_fit_records_its_spans_nested_and_learns_the_same():
    xs, ys = _batch()
    plain = _machine().partial_fit(xs, ys)
    machine = _machine()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        machine.partial_fit(xs, ys)
    assert torch.equal(machine.bundle.state.ta_state,
                       plain.bundle.state.ta_state)
    got = _spans(prof)
    want = {"tm.train_step": 1, "tm.train_step.input": 1, "tm.learn": 1,
            "tm.draws": 1 + B, "tm.round": 2 * B, "tm.round.vote": 2 * B,
            "tm.round.feedback": 2 * B, "tm.index_sync.diff": 2,
            "tm.index_sync.apply": 1}
    assert {k: len(v) for k, v in got.items()} == want
    step = got["tm.train_step"]
    for name in ("tm.train_step.input", "tm.learn", "tm.index_sync.diff",
                 "tm.index_sync.apply"):
        for iv in got[name]:
            _inside(iv, step)
    for name in ("tm.draws", "tm.round"):
        for iv in got[name]:
            _inside(iv, got["tm.learn"])
    for name in ("tm.round.vote", "tm.round.feedback"):
        owners = [_inside(iv, got["tm.round"]) for iv in got[name]]
        assert owners == list(range(2 * B))


def test_scores_records_its_input_and_engine():
    machine = _machine()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        machine.scores(_batch()[0])
    got = _spans(prof)
    assert set(got) == {"tm.scores", "tm.scores.input", "tm.scores.engine"}
    assert len(got["tm.scores"]) == 1
    for name in ("tm.scores.input", "tm.scores.engine"):
        assert len(got[name]) == 1
        _inside(got[name][0], got["tm.scores"])


@pytest.mark.parametrize("shards", [(2, 1), (2, 2)], ids=["c2d1", "c2d2"])
def test_a_sharded_step_records_its_step_and_rounds(shards):
    c, d = shards
    xs, ys = _batch()
    xs, ys = np.concatenate([xs, xs[:1]]), np.concatenate([ys, ys[:1]])
    machine = _machine(topology=Topology(clause_shards=c, data_shards=d))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        machine.partial_fit(xs, ys)
    got = _spans(prof)
    assert len(got["tm.train_step"]) == 1
    assert len(got["tm.round"]) == 2 * (B + 1)
    assert len(got["tm.round.vote"]) == 2 * (B + 1) * c * d
    for iv in got["tm.round"]:
        _inside(iv, got["tm.train_step"])
