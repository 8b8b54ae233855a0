"""Named spans around the steps of learning and scoring.

``span(name)`` is the one way the program marks a stretch of its work:
``with span("tm.round"): ...``. While a profiler records (the autograd
profiler is on), it returns ``torch.profiler.record_function(name)``;
otherwise it returns one shared no-op context, so an unprofiled step pays
a flag test per span and nothing more.

Operator note: the spans show in any ``torch.profiler.profile`` trace as
``user_annotation`` events, on the same clock as the operators, the CUDA
runtime calls and the device's kernels and copies. The names:

* ``tm.train_step`` (``TMSession.train_step``), holding
  ``tm.train_step.input`` (the batch to the device), ``tm.learn``
  (``tm.learn_batch``), ``tm.index_sync.diff`` (the include masks and
  their event buffer) and ``tm.index_sync.apply`` (each cache absorbing
  the events);
* inside ``tm.learn``: ``tm.draws`` (the batch's negative classes, then
  each sample's round draws) and ``tm.round`` (one class round over every
  rank), holding one ``tm.round.vote`` and one ``tm.round.feedback`` per
  rank;
* ``tm.scores`` (``TMSession.scores``), holding ``tm.scores.input`` (the
  rows to the device) and ``tm.scores.engine`` (the engine's scores);
* the LM's single-device train step (``steps.make_train_step``):
  ``lm.train_step`` holding one ``lm.microbatch`` per microbatch (its
  forward and backward) and then ``lm.optimizer`` (compression and the
  AdamW update); inside a microbatch ``lm.embed``, per block ``lm.mla``
  (latent attention, holding ``lm.mla.core``: scores, softmax and values),
  ``lm.moe`` (holding ``lm.moe.route``) or ``lm.mlp``, and ``lm.head_loss``
  (the final norm, the logits and the loss). A block recomputed in the
  backward pass (``remat``) records its spans again there; the backward
  kernels themselves run under no span.

Counters (``counting()`` / ``count(name, n)``): device tensors summed over
the calls of a block, not read back until the caller reads them, so they
cost no host sync inside a step. ``count`` does nothing unless a
``counting()`` block is open, and nothing in the backward pass, so a block
recomputed there is counted once. The MoE layer counts its (token, k)
assignments: ``lm.moe.kept`` (computed by the experts this layer holds),
``lm.moe.dropped`` (to a held expert, past its capacity) and
``lm.moe.absent`` (to an expert held elsewhere); their sum is tokens ×
top_k per MoE layer.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that records ``name`` as a span while a profiler records;
    the shared no-op context otherwise."""
    if _profiling():
        return record_function(name)
    return _OFF


_counts: dict | None = None       # the open counter block's counters


@contextlib.contextmanager
def counting():
    """Open a counter block: yields the ``{name: device tensor}`` dict that
    ``count`` adds to while the block is open (read it after the work). An
    inner block counts alone until it closes."""
    global _counts
    outer, _counts = _counts, {}
    try:
        yield _counts
    finally:
        _counts = outer


def counters_open() -> bool:
    """Whether ``count`` would count here (a block open, not in backward)."""
    return _counts is not None and torch._C._current_graph_task_id() == -1


def count(name: str, n: torch.Tensor) -> None:
    """Add ``n`` (a device scalar) to counter ``name`` of the open counter
    block; nothing without one, or in the backward pass."""
    if counters_open():
        _counts[name] = _counts[name] + n if name in _counts else n.clone()
