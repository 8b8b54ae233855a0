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
  rows to the device) and ``tm.scores.engine`` (the engine's scores).
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
