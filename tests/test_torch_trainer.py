"""PyTorch port (``repro_torch``) fault-tolerant training, on the CPU.

Mirrors tests/test_tm_trainer.py: crash → restart from the newest committed
checkpoint → bit-exact continuation of the TA state and every engine cache;
the (seed, step) batch stream, which equals the JAX package's batch for
batch; and the step generator, a function of (seed, step) alone.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import TMConfig, registered_engines, validate
from repro_torch.core.api import bundle_scores
from repro_torch.core.bitpack import pack_bits
from repro_torch.data.pipeline import TMBatcher
from repro_torch.runtime import (
    SimulatedFailure, Trainer, TrainLoopConfig, make_tm_task, step_generator)

CFG = TMConfig(n_classes=3, n_clauses=8, n_features=6, n_states=50,
               s=3.0, threshold=4)
ALL_EVENTS = CFG.n_classes * CFG.n_clauses * CFG.n_literals


def build_trainer(tmp_path, total, failure_at=None, parallel=False):
    task = make_tm_task(CFG, batch=8, seed=2, data_seed=9, parallel=parallel,
                        max_events=ALL_EVENTS, metrics_every=2, device="cpu")
    return Trainer(
        step_fn=task.step_fn, state=task.state, batcher=task.batcher,
        checkpointer=Checkpointer(tmp_path, keep=10),
        loop=TrainLoopConfig(total_steps=total, ckpt_every=4, log_every=2,
                             failure_at=failure_at),
        to_ckpt=task.to_ckpt, from_ckpt=task.from_ckpt)


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_tm_failure_restart_bit_exact(tmp_path, parallel):
    ref = build_trainer(tmp_path / "ref", 10, parallel=parallel)
    ref.run()
    ref_ta = ref.state["bundle"].state.ta_state.clone()
    assert not torch.equal(ref_ta, torch.full_like(ref_ta, CFG.n_states))

    tr = build_trainer(tmp_path / "ft", 10, failure_at=6, parallel=parallel)
    with pytest.raises(SimulatedFailure):
        tr.run()
    tr2 = build_trainer(tmp_path / "ft", 10, parallel=parallel)  # a new process
    resumed = tr2.restore_if_available()
    assert resumed == 4
    tr2.run(start_step=resumed)

    bundle = tr2.state["bundle"]
    assert torch.equal(bundle.state.ta_state, ref_ta)
    assert tr2.state["step"] == ref.state["step"] == 10
    assert int(bundle.event_overflow) == 0
    # caches were rebuilt on restore, then event-synced over steps 4..10:
    # they still mirror the state
    for name, ok in validate(CFG, bundle.state, bundle.index).items():
        assert bool(ok), name
    assert torch.equal(bundle.caches["bitpack"],
                       pack_bits(bundle.state.ta_state > CFG.n_states))
    xs = torch.from_numpy(np.random.default_rng(5).integers(0, 2, (7, 6)).astype(
        np.uint8))
    want = bundle_scores(bundle, xs, engine="dense")
    for name in registered_engines():
        assert torch.equal(bundle_scores(bundle, xs, engine=name), want), name
    assert [s for s, _ in tr2.metrics_log] == [6, 8, 10]
    assert all(0.0 <= m["acc"] <= 1.0 for _, m in tr2.metrics_log)


def test_tm_batcher_stream_equals_the_reference():
    pipeline = pytest.importorskip("repro.data.pipeline")
    ours = TMBatcher(6, 3, 8, seed=1)
    theirs = pipeline.TMBatcher(6, 3, 8, seed=1)
    for step in (0, 4, 5):
        a, b = ours(step), theirs(step)
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])
        assert a["x"].dtype == np.uint8 and a["x"].shape == (8, 6)
    assert not np.array_equal(ours(4)["x"], ours(5)["x"])


def test_step_generator_is_a_function_of_seed_and_step():
    draw = lambda seed, step: torch.rand(4, generator=step_generator(
        seed, step, "cpu"))
    assert torch.equal(draw(2, 7), draw(2, 7))
    assert not torch.equal(draw(2, 7), draw(2, 8))
    assert not torch.equal(draw(2, 7), draw(3, 7))
