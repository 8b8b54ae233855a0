"""TM training task for the fault-tolerant ``Trainer`` — port of
``repro.runtime.tm_task`` (any placement).

``make_tm_task`` turns a ``TMConfig`` into what ``runtime/trainer.py``
consumes, all driven through one ``TMSession``:

  * ``step_fn(state, batch)`` — one session ``train_step`` over a TM bundle.
    The step's randomness comes from :func:`step_generator`, a generator
    seeded from (seed, step) alone (the counterpart of the reference's
    ``fold_in(root, step)``), so a restarted run draws identical numbers;
  * ``state`` — ``{"bundle": TMBundle, "step": int}``;
  * ``batcher`` — the deterministic (seed, step) ``TMBatcher`` stream;
  * ``to_ckpt`` / ``from_ckpt`` — the schema-v1 checkpoint view: the
    unpadded global TA state, step and config fingerprint persist; every
    engine cache is rebuilt on restore, on the restoring task's topology.

Metrics per logged step: batch accuracy *before* the update, through
``metrics_engine`` (by default ``DEFAULT_ENGINE`` when the session keeps
its cache, else the session's first engine).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import tm_store
from repro_torch.core.api import DEFAULT_ENGINE
from repro_torch.core.session import TMSession, Topology
from repro_torch.core.types import TMConfig, TMState
from repro_torch.data.pipeline import TMBatcher


@dataclasses.dataclass
class TMTask:
    """Everything a ``Trainer`` needs to run a TM, plus the restore hooks."""

    step_fn: Callable
    state: dict[str, Any]
    batcher: TMBatcher
    to_ckpt: Callable
    from_ckpt: Callable
    session: TMSession


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from (seed, step) alone
    (numpy's ``SeedSequence`` mixes the pair into 64 bits)."""
    hi, lo = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(hi) << 32 | int(lo)) & (2**63 - 1))


def make_tm_task(cfg: TMConfig, *, topology: Topology | None = None,
                 mesh=None, engines=None, batch: int = 32, seed: int = 0,
                 data_seed: int = 7, parallel: bool = False,
                 max_events: int = 4096, metrics_engine: str | None = None,
                 metrics_every: int = 1, device="cuda") -> TMTask:
    """Build a TM training task on one session (``topology`` / ``mesh`` /
    ``engines`` as ``TMSession`` takes them: the task itself is
    placement-transparent; ``engines=None`` maintains every registered
    engine's cache).

    ``metrics_engine`` defaults to ``DEFAULT_ENGINE`` when the session
    keeps it, else to the session's first engine. An explicit one is used
    as given: on one device an engine whose cache the session does not keep
    is prepared on the fly for each metrics pass (warned once per cache
    slot, as ``TMSession.scores`` does). ``metrics_every`` skips the
    pre-update accuracy pass on the other steps: set it to the trainer's
    ``log_every``.
    """
    session = TMSession(cfg, topology, mesh=mesh, engines=engines,
                        device=device, parallel=parallel,
                        max_events=max_events)
    if metrics_engine is None:
        metrics_engine = (DEFAULT_ENGINE if DEFAULT_ENGINE in session.engines
                          else session.engines[0])
    batcher = TMBatcher(cfg.n_features, cfg.n_classes, batch, seed=data_seed)

    def step_fn(state: dict, batch_: dict):
        b, step = state["bundle"], state["step"]
        metrics = {}
        if (step + 1) % metrics_every == 0:  # logged steps only
            pred = session.predict(b, batch_["x"], engine=metrics_engine).cpu()
            metrics = {"acc": float((pred.numpy() == batch_["y"]).mean())}
        nb = session.train_step(b, batch_["x"], batch_["y"],
                                step_generator(seed, step, session.device))
        return {"bundle": nb, "step": step + 1}, metrics

    def to_ckpt(state: dict) -> dict:
        ta = session.unpad_state(state["bundle"].state).ta_state
        return tm_store.checkpoint_tree(cfg, ta, step=int(state["step"]))

    def from_ckpt(loaded: dict, state: dict) -> dict:
        tm_store.validate_meta(loaded, cfg, where="trainer checkpoint")
        ta = torch.from_numpy(np.asarray(loaded["ta_state"])).to(
            device=session.device, dtype=cfg.state_dtype)
        # every cache is rebuilt from the restored state, on this topology
        return {"bundle": session.prepare(TMState(ta_state=ta)),
                "step": int(loaded["step"])}

    state = {"bundle": session.init_bundle(), "step": 0}
    return TMTask(step_fn=step_fn, state=state, batcher=batcher,
                  to_ckpt=to_ckpt, from_ckpt=from_ckpt, session=session)
