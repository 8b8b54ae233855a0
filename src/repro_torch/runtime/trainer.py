"""Fault-tolerant training loop — port of ``repro.runtime.trainer``.

  * checkpoint/restart — periodic asynchronous checkpoints; on (re)start the
    loop restores the newest committed step and the data stream resumes
    the exact batch sequence (deterministic (seed, step) batches);
  * failure injection — ``failure_at`` raises mid-run to simulate a node
    loss, so a test can restart the loop and check bit-exact continuation
    against an uninterrupted run;
  * straggler detection — a per-step wall-time EWMA; steps slower than
    ``straggler_factor`` × the watermark fire a callback;
  * checkpoint views — ``to_ckpt`` / ``from_ckpt`` let the train state
    carry derived data that is rebuilt, not persisted (a TM bundle
    checkpoints only its TA state; ``runtime/tm_task.py``). A view is a
    flat dict of arrays, as the schema-v1 TM payload is.

A step's time is taken after ``torch.cuda.synchronize()`` when CUDA is in
use, so it charges the device work and not only its launch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer


@dataclasses.dataclass
class TrainLoopConfig:
    """Loop length and the cadences of logging, checkpoints and failures."""

    total_steps: int
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_warmup: int = 8
    failure_at: Optional[int] = None     # simulate a crash after this step


class SimulatedFailure(RuntimeError):
    """The injected crash of ``TrainLoopConfig.failure_at``."""


def _wait_for_device() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Trainer:
    """Runs ``step_fn(state, batch) -> (state, metrics)`` over
    ``batcher(step)`` with checkpoints, restarts and straggler detection."""

    def __init__(self, *, step_fn, state, batcher, checkpointer: Checkpointer,
                 loop: TrainLoopConfig,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 to_ckpt: Optional[Callable] = None,
                 from_ckpt: Optional[Callable] = None):
        self.step_fn = step_fn
        self.state = state
        self.batcher = batcher
        self.ckpt = checkpointer
        self.loop = loop
        self.on_straggler = on_straggler or (lambda s, t: None)
        self.to_ckpt = to_ckpt or (lambda state: state)
        self.from_ckpt = from_ckpt or (lambda loaded, state: loaded)
        self.metrics_log: list = []
        self.stragglers: list = []

    def restore_if_available(self) -> int:
        """Restore the newest committed step; returns it (0 if none)."""
        step = self.ckpt.latest_step()
        if step is None:
            return 0
        loaded = self.ckpt.restore(step, tuple(self.to_ckpt(self.state)))
        self.state = self.from_ckpt(loaded, self.state)
        return step

    def run(self, start_step: Optional[int] = None) -> int:
        """Train up to ``total_steps`` (from the newest checkpoint unless
        ``start_step`` is given); returns the final step."""
        step = self.restore_if_available() if start_step is None else start_step
        ewma = None
        while step < self.loop.total_steps:
            batch = self.batcher(step)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            _wait_for_device()
            dt = time.perf_counter() - t0
            if ewma is None:
                ewma = dt
            if step > self.loop.straggler_warmup and \
                    dt > self.loop.straggler_factor * ewma:
                self.stragglers.append((step, dt, ewma))
                self.on_straggler(step, dt)
            ewma = 0.9 * ewma + 0.1 * dt
            step += 1
            if step % self.loop.log_every == 0:
                self.metrics_log.append(
                    (step, {k: float(v) for k, v in metrics.items()}))
            if step % self.loop.ckpt_every == 0:
                self.ckpt.save(step, self.to_ckpt(self.state))
            if self.loop.failure_at is not None and step == self.loop.failure_at:
                self.ckpt.wait()
                raise SimulatedFailure(f"injected failure at step {step}")
        self.ckpt.save(step, self.to_ckpt(self.state), blocking=True)
        return step
