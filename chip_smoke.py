#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each of which must pass (the script exits non-zero at the first
failure, and at once when no CUDA device is present):

1. **Build** every CUDA kernel under ``src/repro_torch/csrc`` with ``nvcc``
   for ``sm_90a`` (one process per source, in parallel) into ``build/``,
   and print each kernel's registers, shared memory and spills as
   ``ptxas -v`` reported them.
2. **Kernels vs plain**, on the card, at the width of the paper's MNIST
   configuration (``tm_mnist``: m=10 classes, n=2000 clauses, o=784
   features). The served state has about 58 literals per clause (the
   paper's MNIST clause length) and no clause includes both x_k and ¬x_k.
   Each request satisfies one randomly chosen clause and is random
   elsewhere, so the scores are not all equal. For B ∈ {1, 32} each kernel
   must equal its plain PyTorch version bit for bit (tolerance 0) and the
   dense engine's scores; ``indexed_votes`` (the walk of the false
   literals' inclusion lists) equals the plain walk and the position form
   ``indexed_votes_ref`` too. Device times come from CUDA graphs replayed
   between CUDA events (no host launch work in them): kernel, plain version
   (the plain walk syncs in ``nonzero``: its time is per call), and one
   PyTorch call as yardstick (the float32 ``torch.matmul`` that the dense /
   XLA form of the same votes is built on). ``call_ms`` is the kernel's
   time per call from Python, wrapper included. The walk's bound counts the
   list bytes these requests need; the bound of a stream of ``pos`` (what
   a dense kernel reads) is printed beside it. The launch plan of
   ``clause_votes_packed`` (thread tile, block, grid and its waves on the
   card's SMs) is printed beside its times. Then the walk's own cases
   (``walk_cases``): an overflowing index and one replayed until lists
   shrink back under the capacity with holes; more than one clause window
   (forced, and n = 2 · MAX_WINDOW + MAX_WINDOW / 16); clusters of 8 and
   16 blocks.
3. **Serve** the same state through ``TMSession`` + ``AsyncTMServer``
   (``max_batch=32``, 2 tenants), first with ``engine="indexed"``, then
   ``engine="bitpack"``. Every result must be a ``ScoreResult`` equal to the
   dense engine's scores on the card; the bucket cache must not miss or
   prepare anything new; and each engine's kernel must have launched at
   least once per served batch. Launch counts are set to 0 just before each
   serve and read just after.
4. **Learning kernels vs plain**, on the card: ``clause_outputs_packed`` at
   (B, m) = (1, 1) and (32, 10); ``round_vote`` (the learning round's vote
   half, from the states) on one class row, for a request row and with
   every literal true (every clause read to its end), timed against the
   bytes those inputs need and against a read of the whole row; ``ta_update``
   on one (2000, 1568) class row for a target and a negative round, with a
   mix of update gates and a quarter of the uniforms exactly at a float32
   threshold or one ulp from it. Each must equal its plain version bit for
   bit, in place too. Device ms (CUDA-graph replay), plain ms, bound and
   ``call_ms`` as in phase 2; no single PyTorch call computes either
   function, so ``library_ms`` is null.
5. **Train** at the ``tm_mnist`` width from a trained-like state: phase 2's
   include pattern with include depths uniform on [N+1, 2N] and exclude
   depths on [1, N], so only cells one step from the boundary can cross it.
   A probe step counts the crossings and sizes ``max_events_per_batch``.
   Launch counts are set to 0, then ``TsetlinMachine.partial_fit`` runs
   ``SEQ_STEPS`` sequential steps of B=32 and one with ``parallel=True``,
   and ``evaluate(..., engine="indexed")`` scores held-out rows; the counts
   are read just after. Required: each learning kernel launched 2·B times
   per step, ``event_overflow == 0``, ``validate`` true, the bitpack cache
   equal to a fresh pack, and the indexed and bitpack scores equal to the
   dense ones. Then samples/s and a step's split (feedback rounds, event
   diff, cache sync) for both modes, and one B=4 step at full width on the
   card and on the CPU with the same draws: states and caches must be equal.
7. **Sharded** (runs before phase 6's report), at the ``tm_mnist`` width
   with every shard placed on ``cuda:0`` by an explicit device list (k
   shards share one card; its times are never a multi-card figure).
   First each kernel against its plain version at the shard widths n = 334,
   500 and 667 with the trailing rows padding (polarity 0, inactive), bit
   for bit.
   Scores of 1020 rows (a multiple of every data-shard count) through the
   indexed and bitpack engines at (clause, data) shards (4, 1), (3, 1)
   and (2, 3) (even, ragged with one padding row, ``composed_ragged`` with
   334-row sub-slices) must equal phase 2's dense scores, with each
   engine's kernel launched on every rank and one reduction per call.
   Two ``partial_fit`` steps of B=32 from phase 5's state under injected
   draws at (4, 1), (3, 1), (2, 3) and (2, 2) batch-parallel must equal the
   same steps at ``Topology(1)``: state, every rank's caches against the
   global ones, ``event_overflow == 0``, ``validate``; each learning kernel
   launches 2·B times per step on every rank that holds clause rows.
   ``Topology(clause_shards=4, async_votes=4)`` takes 8 steps with no
   reduction inside them and 2 refreshes, and ``async_votes=0`` equals
   synchronous learning. ``AsyncTMServer`` over (2, 2) serves 256
   requests equal to the dense scores. Launch counts are set to 0 before
   each part and read after it; sharded ms are printed beside
   ``Topology(1)``'s.
8. **Compact, open loop, tm_imdb** (runs before phase 6's report; launch
   counts are set to 0 just before each run of the entry points and read
   just after; the comparisons of kernels with their plain versions fall
   outside those windows).
   (a) Phase 3's requests through the ``compact`` engine at the tm_mnist
   width, directly and through a bucket cache of 32, equal to the dense
   scores; the device ms and peak memory of one bucket; two ``partial_fit``
   steps of B=32 with ``engines=("indexed", "bitpack", "compact")`` from
   phase 5's trained-like state, after which every cache equals a rebuild
   (the compact rows as sets) and ``validate_compact`` is clean; the ms of
   one ``compact_apply_events`` per step.
   (b) ``tm_serve.run_sustained`` for ``indexed`` and ``bitpack``
   (``max_batch=32``, steps of 0.5 s): each engine's sync baseline, knee
   (offered, submitted, achieved), ``speedup_at_knee`` and
   ``hot_loop_compiles``, which must be 0; ``run_batch_axis_scaling`` for
   ``indexed`` at 1, 2, 4 shards on ``cuda:0`` (k shards on one card).
   (c) The paper's IMDb configuration (``tm_imdb``: m=2, n=2000, o=5000;
   2o=10000 literals, W=313 words) at full width, about 116 literals per
   clause, requests from ``bow_documents``: the four kernels against their
   plain versions (votes at B=32 on the tiled route in more than one staged
   chunk, clause outputs at (1, 1) and (32, 2), ``ta_update`` on a (2000,
   10000) row), bit for bit and timed; scores through ``indexed``,
   ``bitpack`` and ``compact`` equal to ``dense``; the work ratio
   ``indexed_work / dense_work`` on the requests (printed, not gated); two
   sequential ``partial_fit`` steps of B=32 from a trained-like state with
   no event-buffer overflow and every cache equal to a rebuild.
   Each kernel must have launched in phase 8.
9. **Oracles, wrappers, examples** (runs before phase 6's report; launch
   counts are set to 0 just before each part and read just after).
   (a) The ``kernels/ops.py`` wrappers on the card at the tm_mnist width
   (B=32): ``tm_votes``, ``tm_votes_packed`` and ``tm_predict`` equal
   ``kernels/ref.clause_votes_ref`` on the unpacked include mask, the
   dense scores and their argmax; ``tm_clause_outputs`` equals
   ``clause_outputs_ref``; ``tm_ta_update`` equals ``ta_update_ref`` on
   random and edge uniforms in both rounds; each launches its kernel;
   ``call_ms`` per wrapper.
   (b) The numpy oracle ``core/ref.py`` at (m, n, o) = (3, 32, 45) (a
   partial last literal word, empty clauses): the class round on the card
   (``_round_vote`` / ``_round_feedback`` with injected uniforms) equals
   ``class_round_ref`` in both polarities, ``boost_true_positive`` off and
   on; ``indexed_scores`` and the indexed engine equal
   ``indexed_scores_ref``; ``dense_clause_outputs`` (empty output 0 and 1)
   and ``clause_votes`` equal ``clause_outputs_ref`` / ``votes_ref``.
   (c) ``examples/torch_quickstart.py`` and ``examples/torch_tm_mnist.py``
   (the reference's widths, one epoch, checkpoints in a temporary
   directory) through their ``main`` in this process on the card: no
   overflow, every engine equal to dense, the checkpoint round-trip ok;
   samples/s, µs/sample per engine, the work ratio, peak memory.
   (d) ``make_tm_task(engines=("indexed",))`` against the default four
   caches: ``TASK_STEPS`` ``Trainer`` steps of B=32 each from phase 5's
   trained-like state, the kept caches exactly the named ones, equal
   states and metrics, step ms of both; and the two shards of
   ``TMBatcher(..., shard_count=2)`` concatenate to the global batch.
   Each kernel must have launched in phase 9.
10. **LM serving** (runs before phase 6's report; the four kernels' counts
   are set to 0 just before it and read just after: the LM path reaches no
   Pallas kernel of the reference, so they must stay 0). Random weights
   from a seeded generator; tolerances are relative to max |logit|:
   ``LM_F32_TOL`` for float32 against float32, ``LM_BF16_TOL`` for bf16
   against float32 or against bf16 summed in another order, with greedy
   tokens equal wherever the top-2 margin exceeds twice the tolerance.
   (a) ``launch.serve.main`` on ``qwen3-1.7b`` at full width, B=4, prompt
   128, 32 generated (twice; the second is reported, and both must
   generate the same tokens): prefill and decode ms and tok/s beside their
   bounds (weight bytes over 3.35 TB/s, matrix-product FLOPs over 989
   TFLOP/s), parameter bytes, peak memory. On the same weights and
   prompts, the bf16 prefill against a float32 one, and against 128
   single decode steps from an empty cache; its argmax is the CLI's first
   token. (b) The same for ``minitron-4b`` (untied ``lm_head``, squared-ReLU
   MLP, vocab 256000), prompt 32, 16 generated. (c) ``qwen3-1.7b`` decode
   steps against a cache of ``decode_32k``'s length at B=4, filled from the
   generator: ms per step against its byte bound (cache plus weights), and
   one layer's float32-accumulated bf16 products against the upcast form.
   (d) One row of 9216 tokens through the blockwise prefill (above
   ``dense_attn_max``) and the dense one: logits and caches agree; ms and
   peak memory of each. (e) ``granite-8b``, ``qwen2-72b`` (qkv bias) and
   ``llava-next-mistral-7b`` (vision prefix) at ``reduce_config`` width:
   float32 on the card against the CPU, prefill then a decode step against
   a longer prefill, bf16 against float32.
11. **LM serving, the MoE and recurrent families** (after phase 10; the
   four kernels' counts are set to 0 just before it and must read 0 just
   after; earlier phases may leave at most ``LM_RESIDENT_GB`` on the card).
   Phase 10's helpers and tolerances. (a) ``qwen2-moe-a2.7b`` at full width
   (60 experts, top-4, 4 shared; 28.6 GB in bf16), B=4, prompt 128, 32
   generated, through ``launch.serve.main`` twice: the numbers of phase 10
   (a), with the float32 model (57.3 GB) drawn and run first and cast in
   place, and 32 single decode steps after a prefill of 96 tokens held
   against the prefill; the bounds read and multiply every expert, as the
   dropless algorithm does, and the routed-only bound is printed beside
   them; the first layer's MoE block with the ``einsum`` dispatch against
   the default ``sort`` one at B=4 x 128, and the ms of each. (b)
   ``rwkv6-3b`` at full width, B=4, prompt 100 (not a multiple of
   ``rwkv_chunk``), 32 generated, the same checks, except where its
   full-depth logits are too ill-conditioned for them (``LM_LAYERWISE``):
   both are held block by block on the float32 stream's input (bf16
   against float32 from the second token on; a block's prefill then 32
   decode steps against its prefill, in float32 at ``LM_F32_TOL`` and in
   bf16), and the full-depth gaps are printed beside what a 1e-3
   perturbation of the embedding does. (c)
   ``recurrentgemma-9b`` at full width, the same as (b) (100 is not a
   multiple of ``rnn_chunk`` either), and one row of ``LM_LONG_SEQ`` =
   2600 tokens, past ``local_window`` over 11 RG-LRU chunks: prefill(S)
   against prefill(S-1) and one decode step, logits and every cache
   tensor (rolling positions exactly). (d) ``mixtral-8x7b`` at
   ``reduce_config`` width: phase 10 (e)'s checks and the ``einsum``
   dispatch against ``sort`` in float32.
12. **Whisper and LM training** (after phase 11; the four kernels' counts
   are set to 0 just before it and must read 0 just after; at most
   ``LM_RESIDENT_GB`` resident before it). (a) ``whisper-medium`` at full
   width through the ``Model`` facade (the serve CLI refuses encdec, as
   the reference's does): B=4, frames (4, 1500, 1024) =
   ``default_rng(0).normal x 0.02`` in bf16, prompt 32, 16 generated,
   cache length 48, twice (the second reported): prefill and decode ms
   and tok/s beside ``whisper_work``'s bounds (the encoder's FLOPs and
   the cross K/V bytes counted), peak memory, the pad columns at
   ``-2**30``, bf16 against float32 and a prefill of the first token plus
   31 decode steps against the prefill (over the real vocabulary, at
   ``LM_BF16_TOL``), a profile of a decode step. (b) Whisper at
   ``reduce_config`` width: phase 10 (e)'s checks. (c) ``qwen3-1.7b``
   training through ``steps.make_train_step`` at full width: B=8 x 512,
   M=2, remat on, no compression, peak lr 1e-3 after 5 warmup steps, 20
   steps: step ms and tok/s beside ``train_work``'s bound, peak memory,
   the train state's checkpoint size, finite metrics, the NLL of the last
   step at least 0.1 below the first's, a profile of one step. (d)
   ``train_4k``'s sequence (4096) with its **global batch cut from 256 to
   2**, M=2, 2 steps. (e) ``whisper-medium`` training, B=2 x 64, M=1, 2
   steps: finite loss, ``grad_norm`` > 0, peak. (f) At ``reduce_config``
   width in float32: qwen3 and qwen2-moe M=1 against M=4 NLL (1e-5
   relative), one step's gradients on the card against the CPU (1e-4 of
   max|g|); ``launch.train.main(["--reduced", …])`` for 20 steps against
   10 steps plus a second ``main`` that resumes from the checkpoint, with
   default and with deterministic algorithms: bit-equal, or the differing
   tensors printed and held at ``TRAIN_RESTART_TOL``.
13. **The sharded LM path** (after phase 12; single-controller meshes whose
   every rank is ``cuda:0``: k shards on one card, never a scaling figure;
   the four kernels' counts set to 0 just before each part and read 0
   just after; no CPU path). (a) ``qwen3-1.7b`` at full width in bf16 on
   a (2, 4) mesh through ``steps.make_prefill_step`` /
   ``make_decode_step``: prefill B=4 x 128, then 32 decode steps fed the
   unsharded run's greedy tokens, cache 160 (40 slots per model rank);
   every step's logits against the unsharded run's at ``SHARD_LM_TOL`` of
   max|logit| (greedy tokens equal where the top-2 margin exceeds twice
   that), the gathered caches too (positions exactly). (b) The same for
   ``qwen2-moe-a2.7b`` with 16 decode steps (the MoE's shard_map engine).
   (c) One ``qwen3-1.7b`` train step at full width, B=8 x 512, M=2, remat,
   on (2, 2), its NLL, loss and grad norm against an unsharded step run
   first and freed first. (d) ``gpipe_apply`` over 4 stages of
   qwen3-1.7b's layer groups (7 layers each), 8 microbatches of 2 x 128,
   against the sequential stack. For each: per-rank resident bytes
   required equal to what the specs predict, collective calls and payload
   bytes by kind per step, ms per step beside the unsharded run's.
14. **The sharded RWKV-6, hybrid and whisper paths** (after phase 13, the
   same rules): ``SHARD_FAMILY_SERVE`` at full width on (2, 4) against
   their unsharded runs, one train step each on (2, 2)
   (``SHARD_FAMILY_TRAIN``).
15. **The dry-run and roofline tools** (after phase 14). (a)
   ``launch.dryrun.run_tm_checks`` with k ranks on ``cuda:0``, the even
   (2, 4) / 256 and the ragged (2, 3) / 128 cells, the four kernels'
   counts set to 0 just before and read just after: no failure, every
   kernel launched, the launches equal to those the records hold; then
   ``run_tm_async_checks``. (b) ``launch.trace`` on fake CUDA tensors
   against a real run on the card of ``qwen3-1.7b``'s decode (B=4, cache
   160), prefill (B=4 x 128) and (2, 4) decode steps, bf16 at full
   width: FLOPs (``trace.flop_counter()``), collective calls, payloads and
   per-device bytes, and argument bytes per rank exactly; the peak of new
   bytes (the (2, 4) mesh: over all ranks) within ``TRACE_PEAK_TOL`` of
   the measured rise of ``max_memory_allocated`` or ``TRACE_PEAK_FLOOR``.
   (c) Phase 12's train step (B=8 x 512, M=2, remat): the traced peak
   within ``TRACE_PEAK_TOL`` of the measured one, FLOPs exactly. (d)
   ``lower_cell`` + ``analyze_cell`` of ``decode_32k`` on the 16 x 16
   production mesh, depth cut to ``TRACE_PRODUCTION_LAYERS``, printed,
   not gated. The LM parts launch no TM kernel.
16. **The MLA attention core** (after phase 15; ``csrc/mla_attention.cu``):
   at the training cell's microbatch (B=2, S=4,096, H=16, q/k 192, v 128)
   the kernel's output and gradients against float32 ``_sdpa``, each error
   at most 1.25x bf16 ``_sdpa``'s; device ms of the forward and the
   backward beside their bounds, ``_sdpa``'s and a PyTorch yardstick's;
   ``ptxas``'s registers and spills; one train step of the cell's model
   launching the forward twice and the backward once a layer a microbatch.
6. Print ``{"lm": {...}}`` (the numbers of phases 10–16, each beside its bound),
   ``{"kernels": [...]}`` (all five kernels; ``launches`` from
   phases 3 and 5, ``sharded_launches`` from phase 7, ``phase8_launches``
   from phase 8, ``phase9_launches`` from phase 9, and ``tm_imdb`` with the
   kernel's shape, error and times at the IMDb width), the card's name and
   power limit as ``nvidia-smi`` reports them, and, last, the
   ``{"ok": true, ...}`` line.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

SEED = 0
BATCHES = (1, 32)
N_REQUESTS = 1024
TRAIN_BATCH = 32
SEQ_STEPS = 4
CARD_VS_CPU_BATCH = 4
# phase 7: (clause_shards, data_shards) of the sharded runs, all on cuda:0
SHARD_ROWS = 1020            # scored rows: a multiple of every data-shard count
SHARD_SCORES = ((4, 1), (3, 1), (2, 3))
SHARD_TRAIN = ((4, 1, False), (3, 1, False), (2, 3, False), (2, 2, True))
SHARD_STEPS = 2
ASYNC_K, ASYNC_STEPS = 4, 8
SHARD_SERVE, SHARD_REQUESTS = (2, 2), 256
# clause rows of the kernels' direct checks at shard widths: n_sub of (2, 3),
# n_local of (4, 1) and of (3, 1); the last rows of each are padding
SHARD_WIDTHS, SHARD_PAD_ROWS = (334, 500, 667), 3
# phase 8: compact at tm_mnist, the open loop, tm_imdb
COMPACT_BUCKET, COMPACT_STEPS = 32, 2
OPEN_LOOP_STEP_S = 0.5
SCALING_RPS = 200_000.0
IMDB_STEPS = 2
# phase 9: the numpy oracle's (m, n, o), 2o = 90 so the last literal word is
# partial; Trainer steps of each make_tm_task
ORACLE_SHAPE = (3, 32, 45)
TASK_STEPS = 3
# phase 10: (arch, batch, prompt, gen) served at full width; decode_32k's
# cache length at B=4 (cut from 128 so that the cache fits: 15.0 GB); one
# prefill row past dense_attn_max (8192); the other dense / vlm configs at
# reduce_config width
LM_SERVE = (("qwen3-1.7b", 4, 128, 32), ("minitron-4b", 4, 32, 16))
LM_DECODE_BATCH, LM_DECODE_STEPS = 4, 8
LM_BLOCKWISE_SEQ = 9216
LM_REDUCED = ("granite-8b", "qwen2-72b", "llava-next-mistral-7b")
# phase 11: (arch, batch, prompt, gen, decode steps held against the prefill)
# at full width; the recurrent prompts are multiples of neither rwkv_chunk
# (32) nor rnn_chunk (256), and 32 single steps follow a prefill of the
# rest (phase 10 takes 128 from an empty cache). One recurrentgemma row
# past local_window (2048) over 11 RG-LRU chunks; mixtral-8x7b (93.4 GB in
# bf16) at reduce_config width. Earlier phases may leave at most
# LM_RESIDENT_GB on the card: the float32 qwen2-moe (57.3 GB) comes next.
LM_FAMILIES = (("qwen2-moe-a2.7b", 4, 128, 32, 32), ("rwkv6-3b", 4, 100, 32, 32),
               ("recurrentgemma-9b", 4, 100, 32, 32))
LM_LONG_SEQ = 2600
LM_FAMILIES_REDUCED = ("mixtral-8x7b",)
# rwkv6-3b's logits at full depth are ill-conditioned under its random
# init (the reference draws the same distributions): float32 rounding
# differences of ~1e-6 between the chunked prefill and the step decode grow
# layer by layer to ~1.7e-2 of max|logit|, and a relative 1e-3
# perturbation of the embedding rows moves the logits by ~10% (both
# measured and printed by lm_layerwise). No computation in another order
# or precision can hold a tolerance there, so for it both checks are held
# block by block, each block on the float32 stream's input, and the
# full-depth gaps are printed. Within a block the first token is
# ill-conditioned too: from a zero state each head's output is (r·u·k)·v,
# and the per-head norm after it keeps only the sign of the scalar r·u·k,
# which rounding can flip; so bf16 against float32 is held from the
# second token on, and the first token's gap is printed.
LM_LAYERWISE = ("rwkv6-3b",)
LM_PERTURBATION = 1e-3
LM_RESIDENT_GB = 15.0
# phase 12: whisper-medium served at full width, (batch, prompt, generated,
# cache length), frames (B, 1500, 1024); training rows (key, arch, global
# batch, seq, microbatches, steps, cell): qwen3-1.7b at B=8 x 512 for 20
# steps, train_4k's sequence with its global batch cut from 256 to 2, and
# whisper-medium at B=2 x 64; qwen3 and one MoE at reduce_config width for
# the float32 checks; the train CLI's restart at reduced width
WHISPER_SERVE = (4, 32, 16, 48)
TRAIN_ROWS = (("train_qwen3", "qwen3-1.7b", 8, 512, 2, 20, "B8xS512"),
              ("train_4k", "qwen3-1.7b", 2, 4096, 2, 2, "train_4k cut to B=2"),
              ("train_whisper", "whisper-medium", 2, 64, 1, 2, "B2xS64"))
TRAIN_REDUCED = ("qwen3-1.7b", "qwen2-moe-a2.7b")
TRAIN_RESTART_STEPS = 20
# a resumed run on the card may differ from the uninterrupted one where an
# op accumulates in an order of its own (atomics); it is held at this
# relative tolerance and the differing tensors are printed
TRAIN_RESTART_TOL = 1e-3
# Float32 against float32 (TF32 off) differs only in summation order: 1e-4
# of max|logit|. bf16 against float32, or against bf16 summed in another
# order, at full depth: 5e-2 of max|logit|. The CPU tests measured 0.3-0.9%
# for XLA's bf16 against PyTorch's at two layers; 28-32 layers compound it.
LM_F32_TOL, LM_BF16_TOL = 1e-4, 5e-2
# phase 13: the sharded LM path, every rank on cuda:0 (k shards on one
# card, never a scaling figure). Serving rows (arch, mesh, batch, prompt,
# decode steps, cache length: 40 slots per model rank); one train step of
# qwen3-1.7b at B=8 x 512, M=2, remat, on (2, 2); gpipe over 4 stages of
# qwen3-1.7b's 28 layers (7 each), 8 microbatches of 2 x 128 tokens.
# Sharded bf16 against unsharded bf16 differs in reduction order: 2e-2 of
# max|logit| (greedy tokens held where the top-2 margin exceeds twice that),
# the gathered caches at the same bound; the train step's NLL and grad
# norm at 2e-2 relative.
SHARD_LM_SERVE = (("qwen3-1.7b", (2, 4), 4, 128, 32, 160),
                  ("qwen2-moe-a2.7b", (2, 4), 4, 128, 16, 160))
SHARD_LM_TRAIN = ("qwen3-1.7b", (2, 2), 8, 512, 2, None)
SHARD_LM_PIPE = ("qwen3-1.7b", 4, 8, 2, 128)
SHARD_LM_TOL = 2e-2
# phase 14: the sharded RWKV-6, hybrid and whisper paths, every rank on
# cuda:0, against their unsharded runs in the same call at SHARD_LM_TOL.
# Serving rows as phase 13's, at full width in bf16: rwkv6-3b and
# recurrentgemma-9b prompts of 128 (144-slot caches: 36 per model rank),
# whisper-medium B=4 x 32 tokens over 1500 frames (split over model = 4).
# rwkv6-3b is held block by block (LM_LAYERWISE: its full-depth logit and
# state gaps are printed, not gated); recurrentgemma-9b's caches in
# float32 (SHARD_SERVE_F32_TWIN). Train rows (arch, mesh, batch, seq,
# microbatches, layers) on (2, 2), remat on: whisper-medium whole;
# rwkv6-3b and recurrentgemma-9b at full width with the depth cut (4 of
# 32 layers; 5 of 38 = one (rec, rec, attn) group and the 2-block tail),
# because their float32 train state (about 11 and 36 GB at the cut) is
# made twice, unsharded and sharded.
# recurrentgemma-9b's bf16 caches cannot meet SHARD_LM_TOL against any
# other bf16 run summed in another order: bf16 itself puts the unsharded
# run's caches 2.73e-2 of max|leaf| from float32 at its 38 layers (1 ulp
# at layer 0, growing with depth; measured on an H100 80GB HBM3 at
# 700 W). Its logits are held in bf16; its caches in a float32 twin of the
# row (sharded against unsharded at LM_F32_TOL: 5.1e-6 on that card), the
# bf16 gap printed. rwkv6-3b's gradient norm is ill-conditioned at a zero
# state: the first token's per-head norm divides by |r·u·k|, so bf16 puts
# the unsharded step's grad norm 38% from float32 (the NLL 7.6e-5) and two
# float32 runs summed in other orders differ by 5.2e-4 (same card). Its
# bf16 NLL and loss are held; its grad norm at SHARD_LM_TOL in a float32
# twin of the step, the bf16 one printed.
# Payload gathered over ``data`` per decode step of each serving row by the
# FSDP-gather decode that preceded the weight-stationary one (every weight
# gathered each step; GB, measured by this script's phases 13-14 on an H100
# 80GB HBM3 at 700 W), printed beside what a step moves now.
FSDP_DECODE_GATHER_GB = {"qwen3-1.7b": 4.06, "qwen2-moe-a2.7b": 28.6,
                         "rwkv6-3b": 6.12, "recurrentgemma-9b": 21.04,
                         "whisper-medium": 1.05}
SHARD_SERVE_F32_TWIN = ("recurrentgemma-9b",)
SHARD_TRAIN_F32_TWIN = ("rwkv6-3b",)
SHARD_FAMILY_SERVE = (("rwkv6-3b", (2, 4), 4, 128, 16, 144),
                      ("recurrentgemma-9b", (2, 4), 4, 128, 16, 144),
                      ("whisper-medium", (2, 4), 4, 32, 16, 48))
SHARD_FAMILY_TRAIN = (("whisper-medium", (2, 2), 2, 64, 2, None),
                      ("rwkv6-3b", (2, 2), 4, 128, 2, 4),
                      ("recurrentgemma-9b", (2, 2), 4, 128, 2, 5))
# Phase 15: the dry-run's trace (launch/trace.py) against the card. The
# served arch at full width: B=4, prefill of 128, decode against phase 13's
# 160-slot cache, unsharded and on phase 13's (2, 4) mesh; phase 12's train
# row (B=8 x 512, M=2, remat). A traced peak is held at TRACE_PEAK_TOL of
# the measured one or TRACE_PEAK_FLOOR bytes, whichever is larger: the
# allocator rounds blocks, and cuBLAS workspaces come through it.
TRACE_ARCH = "qwen3-1.7b"
TRACE_SERVE = (4, 128, 160)
TRACE_MESH = (2, 4)
TRACE_TRAIN = (8, 512, 2)
TRACE_PEAK_TOL = 0.10
TRACE_PEAK_FLOOR = 256 * 2 ** 20
# the production cell printed (not gated) on the 16 x 16 trace mesh, its
# depth cut to TRACE_PRODUCTION_LAYERS: 256 ranks in one process take
# ~0.3 ms of host per fake op, and the full depth (1.37M ops) took 402.7 s
# on the host of an H100 80GB HBM3 machine
TRACE_PRODUCTION = ("qwen3-1.7b", "decode_32k")
TRACE_PRODUCTION_LAYERS = 1
# phase 16: the MLA attention core at dsv2lite_train_s4k's microbatch (B, S,
# H), and one step of that cell's model: (rows, microbatches)
MLA_CORE_SHAPE = (2, 4096, 16)
MLA_CORE_STEP = (8, 4)
# Peak rates of one H100 SXM. Memory: 3.35 TB/s (NVIDIA data sheet). The
# votes are 32-bit compare and logic instructions, not FLOPs: the CUDA C++
# Programming Guide's arithmetic-throughput table gives compute capability
# 9.0 64 such results per clock per SM, half its 128 float32 FMAs, and the
# data sheet's 67 TFLOP/s float32 counts each FMA as two FLOPs, so the
# logic rate is 67e12 / 4 (132 SMs x 64 x 1.98 GHz).
PEAK_BYTES_PER_S = 3.35e12
PEAK_LOGIC_OPS_PER_S = 67e12 / 4
PEAK_BF16_FLOPS_PER_S = 989.4e12    # dense bf16 tensor-core rate (data sheet)


def require(cond, msg: str) -> None:
    """Fail the run (an exception, so the exit code is non-zero)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    """``name, power.limit`` exactly as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, reps: int) -> float:
    """Time per call of ``fn`` over ``reps`` back-to-back calls, between
    CUDA events: what a caller pays, host-side launch work included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed between CUDA events, so no host launch work is in
    the reading."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_device_ms(fn, arg_sets, reps: int) -> float:
    """Device time per call of ``fn(*args)`` cycling over ``arg_sets``: one
    CUDA graph of ``reps`` calls, each on the set least recently touched.
    With sets that together exceed the 50 MB L2, every call reads its
    inputs from device memory, as a byte bound assumes."""
    k = len(arg_sets)
    return device_ms(_Cycle(fn, arg_sets), reps * k) if k else 0.0


class _Cycle:
    """Callable that calls ``fn`` on the next argument set each time."""

    def __init__(self, fn, arg_sets):
        self.fn, self.arg_sets, self.i = fn, arg_sets, 0

    def __call__(self):
        args = self.arg_sets[self.i % len(self.arg_sets)]
        self.i += 1
        return self.fn(*args)


def _wall_ms(fn, sync: bool = False) -> float:
    """Host wall time of one call of ``fn`` (ms); ``sync`` waits for the
    device afterwards, outside the reading."""
    t0 = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t0) * 1e3
    if sync:
        torch.cuda.synchronize()
    return ms


def ptxas_lines(report: str) -> list[str]:
    """One line per kernel of a ``ptxas -v`` report: registers, shared
    memory, spills (names demangled where ``c++filt`` exists)."""
    out, name, spills = [], None, ""
    for line in report.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                            line):
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append([name, f"{m.group(1)} registers, "
                        f"{smem.group(1) if smem else 0} B static smem, {spills}"])
            name, spills = None, ""
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in out),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(out):
            for row, full in zip(out, names):
                row[0] = full
    return [f"{n}: {info}" for n, info in out]


def plan_line(plan, sms: int) -> str:
    """A clause_eval launch plan in a few words."""
    blocks = plan.grid[0] * plan.grid[1]
    if plan.route == "direct":
        shape = (f"direct route, {plan.ks} lanes per clause row, "
                 f"{plan.threads} threads, {plan.ct} clauses x {plan.bt} "
                 f"sample(s) per block")
    else:
        shape = (f"tiled route, thread tile 1x{plan.sb} (clauses x "
                 f"samples), {plan.threads} threads, tile {plan.ct}x{plan.bt}, "
                 f"{plan.n_chunks} chunk(s) of {plan.wc} words")
    return (f"plan: {shape}, grid {plan.grid[0]}x{plan.grid[1]} = {blocks} "
            f"blocks ({blocks / sms:.2f} per SM), {plan.smem_bytes} B "
            f"dynamic shared")


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time (ms) for the work and what sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_LOGIC_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def served_state(cfg, avg_len: int, gen, dev):
    """TA state whose clauses include about ``avg_len`` literals each (the
    lengths are uniform on [avg_len/2, 3·avg_len/2]), never x_k with ¬x_k."""
    m, n, o = cfg.n_classes, cfg.n_clauses, cfg.n_features
    lengths = torch.randint(avg_len // 2, avg_len + avg_len // 2 + 1,
                            (m, n, 1), generator=gen, device=dev)
    rank = torch.rand((m, n, o), generator=gen, device=dev).argsort(-1).argsort(-1)
    chosen = rank < lengths
    negated = torch.rand((m, n, o), generator=gen, device=dev) < 0.5
    inc = torch.cat([chosen & ~negated, chosen & negated], dim=-1)
    ta = torch.where(inc, cfg.n_states + 1, cfg.n_states).to(cfg.state_dtype)
    return ta, inc


def requests(inc, count: int, gen, dev, base=None) -> torch.Tensor:
    """(count, o) uint8 rows, each satisfying one random (class, clause):
    random bits, or the first ``count`` rows of ``base`` (bag-of-words
    documents), with the chosen clause's literals made true."""
    m, n, two_o = inc.shape
    o = two_o // 2
    if base is None:
        x = torch.randint(0, 2, (count, o), generator=gen, device=dev,
                          dtype=torch.uint8)
    else:
        x = torch.as_tensor(np.ascontiguousarray(base[:count]), device=dev)
    ci = torch.randint(0, m, (count,), generator=gen, device=dev)
    cj = torch.randint(0, n, (count,), generator=gen, device=dev)
    rows = inc[ci, cj]
    x = torch.where(rows[:, :o], 1, x)
    return torch.where(rows[:, o:], 0, x).to(torch.uint8)


def trained_like_state(cfg, inc, gen, dev):
    """TA states with ``inc``'s include pattern at trained depths: include
    states uniform on [N+1, 2N], exclude states on [1, N]. Only the cells at
    N or N+1 can cross the boundary in one step."""
    n_states = cfg.n_states
    deep = torch.randint(n_states + 1, 2 * n_states + 1, inc.shape,
                         generator=gen, device=dev)
    shallow = torch.randint(1, n_states + 1, inc.shape, generator=gen, device=dev)
    return torch.where(inc, deep, shallow).to(cfg.state_dtype)


def edge_uniforms(shape, thresholds, gen, dev):
    """Uniforms with a quarter of the cells exactly at a float32 threshold
    or one ulp either side of it."""
    u = torch.rand(shape, generator=gen, device=dev)
    edges = []
    for thr in thresholds:
        t = np.float32(thr)
        edges += [t, np.nextafter(t, np.float32(0)), np.nextafter(t, np.float32(1))]
    edges = torch.tensor([e for e in edges if e < 1], device=dev)
    pick = torch.rand(shape, generator=gen, device=dev) < 0.25
    which = torch.randint(0, len(edges), shape, generator=gen, device=dev)
    return torch.where(pick, edges[which], u)


def to_device(tree, dev):
    """Tensors, NamedTuples of them, bundles and dicts, moved to ``dev``."""
    from repro_torch.core.api import TMBundle
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, TMBundle):
        return TMBundle(cfg=tree.cfg, state=to_device(tree.state, dev),
                        caches=to_device(tree.caches, dev),
                        event_overflow=to_device(tree.event_overflow, dev))
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(to_device(v, dev) for v in tree))
    return tree


def index_from_include(cfg, include, capacity: int):
    """The falsification index of an include mask: ``build_index`` of a
    state that includes exactly there (it reads only ``cfg.n_states`` of
    the config, so any clause count goes)."""
    from repro_torch.core import indexing
    from repro_torch.core.types import TMState

    ta = torch.where(include, cfg.n_states + 1, cfg.n_states).to(cfg.state_dtype)
    return indexing.build_index(cfg, TMState(ta_state=ta), capacity)


def walk_work(index, lit) -> tuple[int, int]:
    """``(bytes, ids)``: the least traffic of the list walk on these inputs,
    and the clause ids it visits. For every list of a literal false in some
    sample, its count and its used prefix (or, for a list it cannot walk,
    its column of ``pos``), then ``lit``, ``pol`` and ``out`` (4 bytes per
    id, count, polarity and vote)."""
    from repro_torch.kernels import indexed

    m, L, cap = index.lists.shape
    n = index.pos.shape[1]
    false_any = (lit == 0).any(0)[None, :]                         # (1, L)
    ok = indexed.walkable(index.lists, index.counts, n)
    prefix = index.counts.clamp(max=cap).to(torch.int64)
    ids = int((prefix * (ok & false_any)).sum()) + n * int((~ok & false_any).sum())
    lists_read = m * int(false_any.sum())
    b = lit.shape[0]
    return 4 * (ids + lists_read) + lit.numel() + 4 * n + 4 * b * m, ids


def vote_kernels(cfg, state, index, words, x, card, sms) -> dict:
    """Phase 2 (and phase 8 at the tm_imdb width): ``indexed_votes`` and
    ``clause_votes_packed`` on the requests ``x`` against their plain
    versions and the dense scores, bit for bit, timed (device ms from CUDA
    graph replay; the float32 matmul yardstick; bound; ms per call from
    Python). ``indexed_votes`` is held against the plain list walk and the
    position form (``indexed_votes_ref``) too. The walk's ``nonzero``
    waits for the device, so no graph can hold it: its time is per call
    from Python. Beside the walk's own bound (the list bytes these
    requests need) stands the bound of a stream of ``pos``, what a dense
    form of the same votes reads."""
    from repro_torch.core import tm
    from repro_torch.core.bitpack import packed_literals, unpack_bits
    from repro_torch.core.types import clause_polarity, literals_from_input
    from repro_torch.kernels import clause_eval, indexed

    m, n, L = cfg.n_classes, cfg.n_clauses, cfg.n_literals
    b = x.shape[0]
    pol = clause_polarity(cfg, x.device)
    lit, lw = literals_from_input(x), packed_literals(x)
    dense = tm.scores(cfg, state, x)
    pos = index.pos
    cases = {
        "indexed_votes": (indexed.indexed_votes, indexed.indexed_votes_walk_ref,
                          (*index, lit, pol), lambda: (pos != -1)),
        "clause_votes_packed": (clause_eval.clause_votes_packed,
                                clause_eval.clause_votes_ref,
                                (words, lw, pol),
                                lambda: unpack_bits(words, L)),
    }
    false_f32 = (lit == 0).to(torch.float32)
    rows = {}
    for kname, (kernel, plain, args, mask) in cases.items():
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        require(torch.equal(got, want),
                f"{kname} B={b}: kernel != plain (max |diff| {err})")
        require(torch.equal(got, dense),
                f"{kname} B={b}: kernel != dense engine scores")
        require(want.unique().numel() > 1,
                f"{kname} B={b}: scores are all equal; the check is void")
        ms = device_ms(lambda: kernel(*args), 50)
        mask_f32 = mask().reshape(m * n, L).to(torch.float32)
        yard_ms = device_ms(lambda: torch.matmul(false_f32, mask_f32.T), 20)
        del mask_f32
        wrapper_ms = call_ms(lambda: kernel(*args), 50)
        row = {}
        if kname == "indexed_votes":
            ref = indexed.indexed_votes_ref(pos, lit, pol)
            require(torch.equal(got, ref), f"{kname} B={b}: kernel != the "
                    f"position form (max |diff| {int((got - ref).abs().max())})")
            plain_ms = call_ms(lambda: plain(*args), 5)
            row["pos_form_ms"] = device_ms(
                lambda: indexed.indexed_votes_ref(pos, lit, pol), 10)
            # an OR of the false-literal word into a clause per id visited
            nbytes, ids = walk_work(index, lit)
            ops = ids * math.ceil(b / 32)
            stream_bytes = pos.numel() * 4 + lit.numel() + 4 * n + 4 * b * m
            row["pos_stream_bound_ms"], _ = bound(
                stream_bytes, 2 * m * n * L * math.ceil(b / 32))
        else:
            plain_ms = device_ms(lambda: plain(*args), 10)
            print(f"{kname} B={b} " + plan_line(clause_eval.launch_plan(
                b, m, n, words.shape[-1]), sms))
            nbytes = sum(a.numel() * a.element_size() for a in args) + b * m * 4
            # one and-not-or (LOP3) per include word per sample (its
            # shuffles are one way of sharing a word, and not the work)
            ops = m * n * words.shape[-1] * b
        bound_ms, bound_by = bound(nbytes, ops)
        rows[(kname, b)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                yardstick_ms=yard_ms, bound_ms=bound_ms,
                                bound_by=bound_by, call_ms=wrapper_ms, **row)
        if kname == "indexed_votes":
            plan = indexed.walk_plan(b, m, n)
            print(f"{kname} B={b} (m, n, 2o, cap)=({m}, {n}, {L}, "
                  f"{index.capacity}): equal to the plain walk, the position "
                  f"form and dense (max |diff| {err}); device ms: kernel "
                  f"{ms:.4f}, position form {row['pos_form_ms']:.4f}, matmul "
                  f"yardstick {yard_ms:.4f}, bound {bound_ms:.5f} ({bound_by}: "
                  f"{nbytes / 1e6:.3f} MB of lists, counts, lit, pol, out), "
                  f"pos-stream bound {row['pos_stream_bound_ms']:.4f}; plain "
                  f"walk per call {plain_ms:.4f} ms; kernel per call from "
                  f"Python {wrapper_ms:.4f} ms; grid {plan.grid}, clusters of "
                  f"{plan.cluster}, window {plan.window} [{card}]")
        else:
            print(f"{kname} B={b} (m, n, 2o)=({m}, {n}, {L}): equal to plain and "
                  f"dense (max |diff| {err}); device ms: kernel {ms:.4f}, plain "
                  f"{plain_ms:.4f}, matmul yardstick {yard_ms:.4f}, bound "
                  f"{bound_ms:.4f} ({bound_by}); kernel per call from Python "
                  f"{wrapper_ms:.4f} ms [{card}]")
    return rows


def walk_cases(cfg, inc, x, gen, dev, card) -> None:
    """Phase 2's list-walk cases, each against the plain walk and the
    position form, bit for bit: (a) an overflowing index (capacity 16
    against lists of about 74 ids: the ids past it live only in ``pos``),
    then after a batched replay that deletes 80% of the includes (lists
    that shrank back under the capacity with holes in their prefixes);
    (b) more than one clause window: the tm_mnist index with a forced
    window of 512 clauses, and a state of 2 · MAX_WINDOW + MAX_WINDOW / 16
    clauses at the tm_mnist literal width (three windows by default), each
    at B=1 and B=32, clusters of 8 and 16."""
    from repro_torch.core import indexing
    from repro_torch.core.types import clause_polarity, literals_from_input
    from repro_torch.kernels import indexed

    lit = literals_from_input(x)
    pol = clause_polarity(cfg, dev)

    def check(what, index, p, **plan):
        got = indexed.indexed_votes(*index, lit, p, **plan)
        want = indexed.indexed_votes_walk_ref(*index, lit, p)
        ref = indexed.indexed_votes_ref(index.pos, lit, p)
        torch.cuda.synchronize()
        err = max(int((got - want).abs().max()), int((got - ref).abs().max()))
        require(torch.equal(got, want) and torch.equal(got, ref),
                f"indexed_votes {what}: kernel != plain walk / position form "
                f"(max |diff| {err})")
        require(want.unique().numel() > 1, f"indexed_votes {what}: all equal")
        return err

    cap = 16
    index = index_from_include(cfg, inc, cap)
    over = int((index.counts > cap).sum())
    require(over > 0, "walk case (a): no list overflows")
    errs = [check(f"capacity {cap}", index, pol)]
    dropped = inc & (torch.rand(inc.shape, generator=gen, device=dev) < 0.8)
    buf = indexing.events_from_transition(inc, inc ^ dropped, 1 << 21)
    require(int(buf.overflow) == 0, "walk case (a): the event buffer overflowed")
    shrunk = indexing.index_update(index, buf.events)
    n = cfg.n_clauses
    holes = int((~indexed.walkable(shrunk.lists, shrunk.counts, n)
                 & (shrunk.counts <= cap)).sum())
    require(holes > 0, "walk case (a): no list shrank back with a hole")
    errs.append(check(f"capacity {cap} after the replay", shrunk, pol))
    ref = indexed.indexed_votes_ref(index_from_include(cfg, inc ^ dropped, n).pos,
                                    lit, pol)
    require(torch.equal(indexed.indexed_votes(*shrunk, lit, pol), ref),
            "walk case (a): the replayed index != a rebuild")
    print(f"walk (a): tm_mnist at capacity {cap}, {over} of "
          f"{index.counts.numel()} lists overflowing; after a replay of "
          f"{int(dropped.sum())} deletions {holes} lists within the capacity "
          f"hold holes: equal to the plain walk, the position form and a "
          f"rebuild at B={x.shape[0]} (max |diff| {max(errs)}) [{card}]")

    full = index_from_include(cfg, inc, n)
    for b in (1, x.shape[0]):
        lb = lit[:b].contiguous()
        for cluster in (8, 16):
            for window in (512, None):
                got = indexed.indexed_votes(*full, lb, pol, window=window,
                                            cluster=cluster)
                require(torch.equal(got, indexed.indexed_votes_walk_ref(
                    *full, lb, pol)), f"indexed_votes window {window} "
                    f"cluster {cluster} B={b}: kernel != plain walk")
    big_n = 2 * indexed.MAX_WINDOW + indexed.MAX_WINDOW // 16
    m2, L = 2, cfg.n_literals
    big = torch.rand((m2, big_n, L), generator=gen, device=dev) < 58 / L
    big_index = index_from_include(cfg, big, big_n)
    big_pol = torch.where(torch.arange(big_n, device=dev) < big_n // 2, 1,
                          -1).to(torch.int32)
    plan = indexed.walk_plan(x.shape[0], m2, big_n)
    require(plan.n_windows == 3, f"walk case (b): {plan}")
    for b in (1, x.shape[0]):
        lb = lit[:b].contiguous()
        for cluster in (8, 16):
            got = indexed.indexed_votes(*big_index, lb, big_pol, cluster=cluster)
            require(torch.equal(got, indexed.indexed_votes_walk_ref(
                *big_index, lb, big_pol)) and torch.equal(
                got, indexed.indexed_votes_ref(big_index.pos, lb, big_pol)),
                f"indexed_votes n={big_n} cluster {cluster} B={b}: kernel != "
                f"plain walk / position form")
    big_ms = device_ms(lambda: indexed.indexed_votes(*big_index, lit, big_pol), 20)
    print(f"walk (b): tm_mnist with windows of 512 clauses (4 windows) and "
          f"(m, n, 2o)=({m2}, {big_n}, {L}) in {plan.n_windows} windows of "
          f"{plan.window}, clusters of 8 and 16, B=1 and {x.shape[0]}: equal to "
          f"the plain walk and the position form; kernel at ({m2}, {big_n}), "
          f"B={x.shape[0]}: {big_ms:.4f} ms device [{card}]")


def learning_kernels(cfg, ta, inc, gen, dev, card, sms, docs=None) -> dict:
    """Phase 4 (and phase 8 at the tm_imdb width, with ``docs`` as the
    request rows): each learning kernel against its plain version, timed."""
    from repro_torch.core.bitpack import pack_bits, packed_literals
    from repro_torch.core.types import clause_polarity, literals_from_input
    from repro_torch.kernels import clause_eval, ta_update

    n, L = cfg.n_clauses, cfg.n_literals
    words_all = pack_bits(ta > cfg.n_states)                  # (m, n, W)
    w = words_all.shape[-1]
    rows = {}
    kernel, plain = clause_eval.clause_outputs_packed, clause_eval.clause_outputs_ref
    for b, m in ((1, 1), (32, cfg.n_classes)):
        words = words_all[:m].contiguous()
        lw = packed_literals(requests(inc[:m], b, gen, dev, docs))
        got, want = kernel(words, lw), plain(words, lw)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        require(torch.equal(got, want),
                f"clause_outputs_packed (B, m)=({b}, {m}): kernel != plain "
                f"(max |diff| {err})")
        require(0 < int(got.sum()) < got.numel(),
                f"clause_outputs_packed (B, m)=({b}, {m}): outputs all equal")
        reps = 200 if b == 1 else 50
        ms = device_ms(lambda: kernel(words, lw), reps)
        plain_ms = device_ms(lambda: plain(words, lw), 10)
        wrapper_ms = call_ms(lambda: kernel(words, lw), reps)
        nbytes = words.numel() * 4 + lw.numel() * 4 + b * m * n
        ops = m * n * w * b               # one LOP3 per include word per sample
        bound_ms, bound_by = bound(nbytes, ops)
        rows[("clause_outputs_packed", b)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, call_ms=wrapper_ms)
        print(f"clause_outputs_packed (B, m, n, W)=({b}, {m}, {n}, {w}): equal "
              f"to plain; device ms: kernel {ms:.4f}, plain {plain_ms:.4f}, "
              f"bound {bound_ms:.5f} ({bound_by}); per call from Python "
              f"{wrapper_ms:.4f} ms; " + plan_line(clause_eval.launch_plan(
                  b, m, n, w), sms) + f" [{card}]")

    row = ta[0]
    x = requests(inc[:1], 1, gen, dev, docs)
    lit = literals_from_input(x)[0]
    cout = kernel(words_all[:1], packed_literals(x))[0, 0]
    pol = clause_polarity(cfg, dev)
    rows.update(round_vote_rows(cfg, row, packed_literals(x)[0], pol, card))
    active = torch.rand(n, generator=gen, device=dev) < 0.5
    kw = dict(n_states=cfg.n_states, s=cfg.s,
              boost_true_positive=cfg.boost_true_positive)
    u = edge_uniforms((n, L), ta_update.thresholds(cfg.s, cfg.boost_true_positive),
                      gen, dev)
    kernel, plain = ta_update.ta_update, ta_update.ta_update_ref
    for positive in (True, False):
        t1 = (pol > 0) if positive else (pol <= 0)
        args = (row, lit, cout, t1, active, u)
        got, want = kernel(*args, **kw), plain(*args, **kw)
        in_place = row.clone()
        kernel(in_place, *args[1:], **kw, out=in_place)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        name = "target" if positive else "negative"
        require(torch.equal(got, want) and torch.equal(in_place, want),
                f"ta_update {name} round: kernel != plain (max |diff| {err})")
        require(not torch.equal(got, row), f"ta_update {name} round: no change")
        # eight copies of the row and its uniforms (~19 MB a set) outrun the
        # L2, so each timed call reads them from device memory
        sets = [(row.clone(), lit, cout, t1, active, u.clone())
                for _ in range(8)]
        ms = cold_device_ms(lambda *a: kernel(*a, **kw), sets, 8)
        hot_ms = device_ms(lambda: kernel(*args, **kw), 50)
        plain_ms = cold_device_ms(lambda *a: plain(*a, **kw), sets, 2)
        wrapper_ms = call_ms(lambda: kernel(*args, **kw), 50)
        del sets
        # states read and written, the literals and gates, and the uniforms
        # of the rows that take Type I feedback: no other row needs its own
        type_i_rows = int((active & t1).sum())
        nbytes = 2 * n * L * 2 + type_i_rows * L * 4 + L + 3 * n
        dense_bytes = 2 * n * L * 2 + n * L * 4 + L + 3 * n
        ops = 4 * n * L      # two threshold compares, an add and a clamp per cell
        bound_ms, bound_by = bound(nbytes, ops)
        rows[("ta_update", positive)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, call_ms=wrapper_ms)
        print(f"ta_update {name} round ({n}, {L}), {type_i_rows} Type I rows "
              f"active: equal to plain, in place too; device ms (inputs cold "
              f"in L2): kernel {ms:.4f}, plain {plain_ms:.4f}; kernel with "
              f"inputs hot in L2 {hot_ms:.4f}; bound {bound_ms:.5f} "
              f"({bound_by}; {nbytes / 1e6:.2f} MB; all uniforms read: "
              f"{dense_bytes / 1e6:.2f} MB, {dense_bytes / PEAK_BYTES_PER_S * 1e3:.5f} "
              f"ms); per call from Python {wrapper_ms:.4f} ms [{card}]")
    return rows


def round_vote_rows(cfg, row, words, pol, card) -> dict:
    """``round_vote`` on one class row against its plain body, for the
    request row's literal ``words`` (a clause or so true: most clauses are
    left at their first falsifier) and with every literal true (no
    falsifier: every clause read to its end). Bounds: the bytes these
    inputs need (each clause's states up to its first falsifier, the
    literal words, pol, the outputs and the vote) and those of a whole
    row's read, ``n·2o·2 + 4W + 5n + 4``. Device ms with the row cold (eight
    copies cycled) and hot in L2."""
    from repro_torch.core.bitpack import unpack_bits
    from repro_torch.kernels import clause_eval

    n, L, w = row.shape[0], row.shape[1], words.shape[0]
    kw = dict(n_states=cfg.n_states)
    kernel, plain = clause_eval.round_vote, clause_eval.round_vote_ref
    full = n * L * 2 + 4 * w + 5 * n + 4
    rows, req = {}, {}
    for case, lw in (("request", words), ("full", torch.full_like(words, -1))):
        (got, vote), (want, want_vote) = kernel(row, lw, pol, **kw), plain(
            row, lw, pol, **kw)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        require(torch.equal(got, want) and torch.equal(vote, want_vote),
                f"round_vote ({case}): kernel != plain (max |diff| {err}, "
                f"vote {int(vote)} against {int(want_vote)})")
        falsifier = (row > cfg.n_states) & ~unpack_bits(lw, L).bool()
        read = torch.where(falsifier.any(1), falsifier.int().argmax(1) + 1, L)
        states = int(read.sum())
        need = states * 2 + 4 * w + 5 * n + 4
        sets = [(row.clone(), lw, pol) for _ in range(8)]
        ms = cold_device_ms(lambda *a: kernel(*a, **kw), sets, 8)
        del sets
        hot_ms = device_ms(lambda: kernel(row, lw, pol, **kw), 50)
        plain_ms = device_ms(lambda: plain(row, lw, pol, **kw), 10)
        wrapper_ms = call_ms(lambda: kernel(row, lw, pol, **kw), 50)
        bound_ms, bound_by = bound(need, 2 * states)  # a compare and an AND a state
        full_ms, _ = bound(full, 2 * n * L)
        true = int(want.sum())
        plan = clause_eval.round_vote_plan(
            n, L, L % 8 == 0 and row.data_ptr() % 16 == 0)
        rows[("round_vote", case)] = dict(
            max_abs_err=err, ms=ms, hot_ms=hot_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, full_bound_ms=full_ms,
            call_ms=wrapper_ms, true_clauses=true, states_needed=states)
        if case == "request":
            req = dict(request_ms=ms, request_bound_ms=bound_ms)
        print(f"round_vote ({n}, {L}), {case}: {true} of {n} clauses true, "
              f"{states} of {n * L} states needed; equal to plain; device ms: "
              f"kernel {ms:.4f} cold, {hot_ms:.4f} hot, plain {plain_ms:.4f}; "
              f"bound {bound_ms:.5f} ({bound_by}, {need / 1e6:.3f} MB; whole "
              f"row {full_ms:.5f}, {full / 1e6:.3f} MB); per call from Python "
              f"{wrapper_ms:.4f} ms; {plan} [{card}]")
    rows[("round_vote", "full")].update(req)
    return rows


def profile_step(session, bundle, xb, yb, dev, card) -> None:
    """Trace one sequential train step with ``torch.profiler``: the device's
    busy share of the step (kernel-level events only), device time by
    PyTorch op, and the port's own kernels, which no op launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import api

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.train_step(bundle, xb, yb, g, max_events=session.max_events)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    events = prof.key_averages()
    on_device = [e for e in events
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(dev_ms(e) for e in on_device)
    if busy == 0:
        print("profile: the profiler recorded no device time (not measured)")
        return
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=dev_ms, reverse=True)[:6]
    ours = {k: sum(dev_ms(e) for e in on_device if k in e.key)
            for k in ("clause_eval", "ta_update_kernel")}
    print(f"profile [sequential, B={len(yb)}]: step wall {wall_ms:.3f} ms "
          f"under the profiler, device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f}%) in "
          f"{sum(e.count for e in on_device)} device events; device ms by op: "
          + ", ".join(f"{e.key} {dev_ms(e):.3f}/{e.count} calls" for e in ops)
          + "; the port's kernels: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ours.items()) + f" [{card}]")


class Counts:
    """The five kernels' launch counters: ``reset`` sets them to 0 just
    before a run of the main path, ``read`` takes them just after (and adds
    them to the phase's totals)."""

    def __init__(self):
        from repro_torch.kernels import clause_eval, indexed, ta_update
        self.kernels = (indexed.indexed_votes, clause_eval.clause_votes_packed,
                        clause_eval.clause_outputs_packed, clause_eval.round_vote,
                        ta_update.ta_update)
        self.total = {k.__name__: 0 for k in self.kernels}

    def reset(self) -> None:
        for k in self.kernels:
            k.launches = 0

    def read(self) -> dict:
        got = {k.__name__: k.launches for k in self.kernels}
        for name, v in got.items():
            self.total[name] += v
        return got


def require_launched(launched: dict, where: str,
                     unused=("clause_outputs_packed",)) -> None:
    """Every kernel in ``launched`` launched but those ``unused``, which
    launched none: no learning round packs include words for
    ``clause_outputs_packed`` (the kernel of ``ops.tm_clause_outputs``)."""
    for name, n in launched.items():
        require((n == 0) if name in unused else (n > 0),
                f"{where} launched {name} {n} times")


def train(cfg, inc, gen, dev, card) -> dict:
    """Phase 5: train at the tm_mnist width through the estimator."""
    from repro_torch.core import api, indexing, tm
    from repro_torch.core.bitpack import pack_bits
    from repro_torch.core.session import TsetlinMachine
    from repro_torch.core.types import TMState, include_mask
    from repro_torch.data.synthetic import templated_images
    from repro_torch.kernels import clause_eval, ta_update

    b_size, engines = TRAIN_BATCH, ("indexed", "bitpack", "dense")
    ta0 = trained_like_state(cfg, inc, gen, dev)
    rng = np.random.default_rng(SEED)
    templates = rng.uniform(size=(cfg.n_classes, cfg.n_features)) < 0.3
    xs, ys = templated_images(templates, b_size * (SEQ_STEPS + 3), rng=rng)
    batches = [(xs[i:i + b_size], ys[i:i + b_size])
               for i in range(0, len(xs), b_size)]
    x_test, y_test = templated_images(templates, 256, rng=rng)

    # size the event buffer from a probe step's boundary crossings
    probe = tm.update_batch_sequential(
        cfg, TMState(ta0), *batches[0],
        torch.Generator(device=dev).manual_seed(SEED + 1))
    crossings = int((include_mask(cfg, probe) != (ta0 > cfg.n_states)).sum())
    max_events = max(1024, 1 << (4 * crossings - 1).bit_length())
    print(f"train: probe step of B={b_size} crossed the boundary in "
          f"{crossings} cells; max_events_per_batch={max_events}")

    machine = TsetlinMachine(cfg, engines=engines, device=dev, seed=SEED,
                             max_events_per_batch=max_events)
    machine.bundle = machine.session.prepare(TMState(ta_state=ta0))
    batch_parallel = TsetlinMachine(cfg, engines=engines, device=dev,
                                    seed=SEED + 2, parallel=True,
                                    max_events_per_batch=max_events)
    counts = Counts()
    counts.reset()
    seq_s, events = [], []
    for xb, yb in batches[1:1 + SEQ_STEPS]:
        before = include_mask(cfg, machine.state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        machine.partial_fit(xb, yb)
        torch.cuda.synchronize()
        seq_s.append(time.perf_counter() - t0)
        events.append(int((include_mask(cfg, machine.state) != before).sum()))
    require(clause_eval.round_vote.launches == ta_update.ta_update.launches
            == 2 * b_size * SEQ_STEPS
            and clause_eval.clause_outputs_packed.launches == 0,
            f"sequential steps: {clause_eval.round_vote.launches} round_vote, "
            f"{ta_update.ta_update.launches} ta_update and "
            f"{clause_eval.clause_outputs_packed.launches} clause_outputs "
            f"launches, want {2 * b_size * SEQ_STEPS}, as many and 0")
    batch_parallel.bundle = machine.bundle
    before = include_mask(cfg, machine.state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch_parallel.partial_fit(*batches[1 + SEQ_STEPS])
    torch.cuda.synchronize()
    par_s = time.perf_counter() - t0
    events.append(int((include_mask(cfg, batch_parallel.state) != before).sum()))
    accuracy = batch_parallel.evaluate(x_test, y_test, engine="indexed")
    launches = counts.read()
    require(launches["round_vote"] == launches["ta_update"]
            == 2 * b_size * (SEQ_STEPS + 1)
            and launches["clause_outputs_packed"] == 0,
            f"training launches {launches}: want 2·B per step")
    require(launches["indexed_votes"] >= 1,
            f"evaluate(engine='indexed') launched no indexed_votes: {launches}")

    bundle = batch_parallel.bundle
    require(batch_parallel.event_overflow == 0,
            f"event_overflow {batch_parallel.event_overflow} after training")
    checks = indexing.validate(cfg, bundle.state, bundle.index)
    require(all(bool(v) for v in checks.values()), f"validate: {checks}")
    require(torch.equal(bundle.caches["bitpack"],
                        pack_bits(include_mask(cfg, bundle.state))),
            "bitpack cache != a fresh pack of the trained state")
    dense = batch_parallel.scores(x_test, engine="dense")
    for engine in ("indexed", "bitpack"):
        require(torch.equal(batch_parallel.scores(x_test, engine=engine), dense),
                f"{engine} scores != dense scores after training")
    # the first step pays the caches' first event sync (allocator growth)
    seq_rate = b_size * (SEQ_STEPS - 1) / sum(seq_s[1:])
    print(f"train: {SEQ_STEPS} sequential steps of B={b_size} in "
          f"{[round(t * 1e3, 3) for t in seq_s]} ms ({seq_rate:.1f} samples/s "
          f"after the first), "
          f"one parallel step in {par_s * 1e3:.3f} ms ({b_size / par_s:.1f} "
          f"samples/s); boundary crossings per step {events}; launches "
          f"{launches}; overflow 0, validate clean, caches equal a rebuild, "
          f"indexed and bitpack scores equal dense; held-out accuracy "
          f"{accuracy:.4f} [{card}]")

    # where a step's time goes: the three stages of api.train_step, timed apart
    split = {}
    xb, yb = batches[-1]
    for mode, update in (("sequential", tm.update_batch_sequential),
                         ("parallel", tm.update_batch_parallel)):
        g = torch.Generator(device=dev).manual_seed(SEED + 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_state = update(cfg, bundle.state, xb, yb, g)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        buf = indexing.events_from_transition(
            include_mask(cfg, bundle.state), include_mask(cfg, new_state),
            max_events)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        api.sync_caches(bundle, new_state, buf)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        split[mode] = dict(feedback_ms=(t1 - t0) * 1e3, diff_ms=(t2 - t1) * 1e3,
                           sync_ms=(t3 - t2) * 1e3,
                           events=int(buf.events.valid.sum()))
        print(f"step split [{mode}, B={b_size}]: feedback rounds "
              f"{split[mode]['feedback_ms']:.3f} ms, event diff "
              f"{split[mode]['diff_ms']:.3f} ms, cache sync "
              f"{split[mode]['sync_ms']:.3f} ms, {split[mode]['events']} events "
              f"[{card}]")

    # the device's share of a sequential step, by op, from the profiler
    profile_step(batch_parallel.session, bundle, xb, yb, dev, card)

    # one step at full width on the card and on the CPU, same draws
    b4 = CARD_VS_CPU_BATCH
    draws = tm.draw_sample_draws(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 4), b4)
    xb, yb = batches[0][0][:b4], batches[0][1][:b4]
    on_card = api.train_step(bundle, xb, yb, draws, max_events=max_events)
    t0 = time.perf_counter()
    on_cpu = api.train_step(to_device(bundle, "cpu"), xb, yb,
                            to_device(draws, "cpu"), max_events=max_events)
    cpu_s = time.perf_counter() - t0
    require(torch.equal(on_card.state.ta_state.cpu(), on_cpu.state.ta_state),
            "card step != CPU step: TA states differ")
    require(not torch.equal(on_cpu.state.ta_state, bundle.state.ta_state.cpu()),
            "card-vs-CPU step changed nothing")
    require(torch.equal(on_card.caches["bitpack"].cpu(), on_cpu.caches["bitpack"]),
            "card step != CPU step: bitpack caches differ")
    for name, a, c in zip(("lists", "counts", "pos"), on_card.index, on_cpu.index):
        require(torch.equal(a.cpu(), c), f"card step != CPU step: index {name}")
    require(int(on_card.event_overflow) == int(on_cpu.event_overflow),
            "card step != CPU step: event_overflow")
    print(f"card vs CPU: one B={b4} sequential step at full width gives equal "
          f"states and caches on both (CPU step {cpu_s:.2f} s)")
    return dict(launches=launches, seq_rate=seq_rate, par_rate=b_size / par_s,
                split=split, ta0=ta0, batches=batches, max_events=max_events,
                test=(x_test, y_test))


def _shard_caches_match(cfg, sharded, one, where: str) -> None:
    """Every rank's caches against ``Topology(1)``'s: the bitpack rows equal
    the rank's rows of the global words (padding rows empty); the index
    passes ``validate`` and its membership equals the global one's rows."""
    from repro_torch.core import indexing

    g = sharded.geometry
    words1, member1 = one.caches["bitpack"], one.index.pos != -1
    for d, row in enumerate(sharded.ranks):
        for c, rank in enumerate(row):
            lo = c * g.n_local
            real = min(g.n_local, cfg.n_clauses - lo)
            words = rank.caches["bitpack"]
            require(torch.equal(words[:, :real], words1[:, lo:lo + real])
                    and not words[:, real:].any(),
                    f"{where}: rank ({d}, {c}) bitpack cache != Topology(1)'s")
            checks = indexing.validate(cfg, rank.state, rank.index)
            require(all(bool(v) for v in checks.values()),
                    f"{where}: rank ({d}, {c}) validate: {checks}")
            require(torch.equal(rank.index.pos[:, :real] != -1,
                                member1[:, lo:lo + real]),
                    f"{where}: rank ({d}, {c}) index membership != Topology(1)'s")


def shard_kernels(cfg, bundle1, ta0, x, gen, dev, card) -> None:
    """Phase 7's first part: each of the four kernels against its plain
    version at the shard widths, on the trailing clause rows of phase 2's
    caches and phase 5's state whose last ``SHARD_PAD_ROWS`` rows are
    padding as a ragged shard's are (excluded everywhere, polarity 0,
    inactive in ``ta_update``). The vote kernels see a data rank's rows of
    ``x`` for D = 3 and D = 1. Tolerance 0. These launches are made before
    any launch count is read, and no count includes them."""
    from repro_torch.core.bitpack import pack_bits, packed_literals
    from repro_torch.core.types import clause_polarity, literals_from_input
    from repro_torch.kernels import clause_eval, indexed, ta_update

    n_all, L = cfg.n_clauses, cfg.n_literals
    lit, lw = literals_from_input(x), packed_literals(x)
    kw = dict(n_states=cfg.n_states, s=cfg.s,
              boost_true_positive=cfg.boost_true_positive)
    thresholds = ta_update.thresholds(cfg.s, cfg.boost_true_positive)
    for n in SHARD_WIDTHS:
        rows = slice(n_all - n, n_all)
        pad = torch.arange(n, device=dev) >= n - SHARD_PAD_ROWS
        cells = pad[None, :, None]
        index = index_from_include(
            cfg, (bundle1.index.pos[:, rows] != -1) & ~cells, n)
        words = torch.where(cells, 0, bundle1.caches["bitpack"][:, rows]).contiguous()
        pol = torch.where(pad, 0, clause_polarity(cfg, dev)[rows]).contiguous()
        ta = torch.where(cells, cfg.n_states, ta0[:, rows]).to(torch.int16)
        errs = {}

        def check(name, got, want, what):
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            errs[name] = max(errs.get(name, 0), err)
            require(torch.equal(got, want), f"{name} at n={n} {what}: kernel "
                    f"!= plain (max |diff| {err})")

        for b in (1, SHARD_ROWS // 3, SHARD_ROWS):
            lb, wb = lit[:b].contiguous(), lw[:b].contiguous()
            got = indexed.indexed_votes(*index, lb, pol)
            check("indexed_votes", got,
                  indexed.indexed_votes_walk_ref(*index, lb, pol), f"B={b}")
            check("indexed_votes", got,
                  indexed.indexed_votes_ref(index.pos, lb, pol),
                  f"B={b} (position form)")
            votes = clause_eval.clause_votes_ref(words, wb, pol)
            check("clause_votes_packed",
                  clause_eval.clause_votes_packed(words, wb, pol), votes, f"B={b}")
        require(votes.unique().numel() > 1, f"votes at n={n} all equal")
        learn_words = pack_bits(ta > cfg.n_states)             # (m, n, W)
        for b, mm in ((1, 1), (32, cfg.n_classes)):
            w = learn_words[:mm].contiguous()
            check("clause_outputs_packed",
                  clause_eval.clause_outputs_packed(w, lw[:b].contiguous()),
                  clause_eval.clause_outputs_ref(w, lw[:b]), f"(B, m)=({b}, {mm})")
        row = ta[0].contiguous()
        cout = clause_eval.clause_outputs_packed(learn_words[:1], lw[:1])[0, 0]
        out, vote = clause_eval.round_vote(row, lw[0], pol, n_states=cfg.n_states)
        want_out, want_vote = clause_eval.round_vote_ref(row, lw[0], pol,
                                                         n_states=cfg.n_states)
        check("round_vote", out, want_out, "outputs")
        check("round_vote", vote, want_vote, "vote")
        check("round_vote", out, cout, "outputs against clause_outputs_packed")
        active = (torch.rand(n, generator=gen, device=dev) < 0.5) & ~pad
        u = edge_uniforms((n, L), thresholds, gen, dev)
        changed = 0
        for positive in (True, False):
            t1 = (pol > 0) if positive else (pol <= 0)
            got = ta_update.ta_update(row, lit[0], cout, t1, active, u, **kw)
            check("ta_update", got,
                  ta_update.ta_update_ref(row, lit[0], cout, t1, active, u, **kw),
                  "target round" if positive else "negative round")
            require(torch.equal(got[pad], row[pad]),
                    f"ta_update at n={n}: a padding row changed")
            changed += int((got != row).sum())
        require(changed > 0, f"ta_update at n={n}: neither round changed a cell")
        print(f"shard kernels n={n} ({SHARD_PAD_ROWS} padding rows: polarity "
              f"0, inactive): all five equal to plain, max |diff| {errs}; "
              f"votes at B=1, {SHARD_ROWS // 3}, {SHARD_ROWS}; clause outputs "
              f"at (B, m)=(1, 1), (32, {cfg.n_classes}); ta_update on "
              f"({n}, {L}), padding rows unchanged [{card}]")


def sharded(cfg, state, inc, trained, gen, dev, card) -> dict:
    """Phase 7: clause- and data-sharded topologies, k shards on one card."""
    from repro_torch.core import tm
    from repro_torch.core.session import TMSession, Topology, TsetlinMachine
    from repro_torch.core.types import TMState
    from repro_torch.kernels import clause_eval, indexed
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import AsyncTMServer, ScoreResult

    counts = Counts()
    reset, read = counts.reset, counts.read

    def mesh(c, d):
        return make_mesh(d, c, devices=["cuda:0"] * (c * d))

    print(f"sharded: torch.cuda.device_count() = {torch.cuda.device_count()}; "
          f"every shard below is placed on cuda:0 by an explicit device list, "
          f"so k shards share one card (times are k shards on one card, not "
          f"a multi-card scaling figure) [{card}]")
    engines = ("indexed", "bitpack", "dense")
    one = TMSession(cfg, engines=engines, device=dev)
    bundle1 = one.prepare(state)
    x = requests(inc, SHARD_ROWS, gen, dev)
    dense = one.scores(bundle1, x, engine="dense")
    shard_kernels(cfg, bundle1, trained["ta0"], x, gen, dev, card)
    kernel_of = {"indexed": indexed.indexed_votes,
                 "bitpack": clause_eval.clause_votes_packed}

    # -- scores ---------------------------------------------------------------
    for c, d in SHARD_SCORES:
        s = TMSession(cfg, Topology(clause_shards=c, data_shards=d),
                      mesh=mesh(c, d), engines=("indexed", "bitpack"))
        b = s.prepare(state)
        g = s.geometry
        for engine, kernel in kernel_of.items():
            fn = s._sharded_scores_fn(engine)
            before = fn.reductions
            reset()
            got = s.scores(b, x, engine=engine)
            torch.cuda.synchronize()
            n_launch = read()[kernel.__name__]
            require(torch.equal(got, dense),
                    f"scores ({c}, {d}) {engine}: sharded != Topology(1) dense")
            require(n_launch >= c * d, f"scores ({c}, {d}) {engine}: "
                    f"{n_launch} launches for {c * d} ranks")
            require(fn.reductions == before + 1,
                    f"scores ({c}, {d}) {engine}: {fn.reductions - before} "
                    "reductions in one call, want 1")
            ms = call_ms(lambda: s.scores(b, x, engine=engine), 10)
            ms1 = call_ms(lambda: one.scores(bundle1, x, engine=engine), 10)
            dev_ms = device_ms(lambda: s.scores(b, x, engine=engine), 5)
            dev_ms1 = device_ms(lambda: one.scores(bundle1, x, engine=engine), 5)
            print(f"sharded scores ({c} clause x {d} data shards, "
                  f"{g.composition}, n_local={g.n_local}, pad rows "
                  f"{g.n_padded - g.n_clauses}) {engine} B={SHARD_ROWS}: equal "
                  f"to Topology(1) dense, {n_launch} kernel launches, 1 "
                  f"reduction; {ms:.4f} ms per call vs Topology(1) {ms1:.4f} "
                  f"ms; device ms (CUDA-graph replay) {dev_ms:.4f} vs "
                  f"Topology(1) {dev_ms1:.4f} ({c * d} shards on one card) "
                  f"[{card}]")

    # -- training ----------------------------------------------------------------
    ta0, batches, max_events = (trained["ta0"], trained["batches"],
                                trained["max_events"])
    b_size = TRAIN_BATCH
    draws = [tm.draw_sample_draws(cfg, torch.Generator(device=dev)
                                  .manual_seed(SEED + 10 + i), b_size)
             for i in range(SHARD_STEPS)]

    def fit(machine):
        machine.bundle = machine.session.prepare(TMState(ta_state=ta0))
        times = []
        for (xb, yb), dr in zip(batches[1:1 + SHARD_STEPS], draws):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            machine.partial_fit(xb, yb, dr)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    reference = {}
    for parallel in (False, True):
        m1 = TsetlinMachine(cfg, engines=engines, device=dev, parallel=parallel,
                            max_events_per_batch=max_events)
        reference[parallel] = (m1, fit(m1))
    for c, d, parallel in SHARD_TRAIN:
        machine = TsetlinMachine(
            cfg, topology=Topology(clause_shards=c, data_shards=d),
            mesh=mesh(c, d), engines=engines, parallel=parallel,
            max_events_per_batch=max_events)
        s = machine.session
        reset()
        times = fit(machine)
        got = read()
        m1, times1 = reference[parallel]
        where = f"train ({c}, {d}{', parallel' if parallel else ''})"
        require(torch.equal(machine.state.ta_state, m1.state.ta_state),
                f"{where}: state != Topology(1)'s after {SHARD_STEPS} steps")
        require(machine.event_overflow == 0 == m1.event_overflow,
                f"{where}: event_overflow {machine.event_overflow}")
        _shard_caches_match(cfg, machine.bundle, m1.bundle, where)
        ranks = c if parallel or not s.geometry.composes else c * d
        want = 2 * b_size * ranks * SHARD_STEPS
        require(got["round_vote"] == got["ta_update"] == want
                and got["clause_outputs_packed"] == 0,
                f"{where}: launches {got}, want {want} of each learning kernel "
                f"(2·B per step on each of {ranks} ranks)")
        comp = "batch_parallel" if parallel else s.geometry.composition
        print(f"sharded train ({c} clause x {d} data shards, {comp}): "
              f"{SHARD_STEPS} steps of B={b_size} equal Topology(1) (state, "
              f"every cache, overflow 0, validate clean); learning kernels "
              f"{want} launches each (2·B per step on {ranks} ranks); "
              f"{s._step.reductions} reductions; step ms "
              f"{[round(t, 3) for t in times]} vs Topology(1) "
              f"{[round(t, 3) for t in times1]} ({c * d} shards on one card) "
              f"[{card}]")

    # -- asynchronous votes --------------------------------------------------------
    sync_machine = reference[False][0]
    zero = TsetlinMachine(cfg, topology=Topology(clause_shards=4,
                                                 async_votes=0),
                          mesh=mesh(4, 1), engines=engines,
                          max_events_per_batch=max_events)
    fit(zero)
    require(torch.equal(zero.state.ta_state, sync_machine.state.ta_state),
            "async_votes=0 != synchronous Topology(1)")
    k = ASYNC_K
    machine = TsetlinMachine(cfg, topology=Topology(clause_shards=4,
                                                    async_votes=k),
                             mesh=mesh(4, 1), engines=engines, seed=SEED,
                             max_events_per_batch=max_events)
    machine.bundle = machine.session.prepare(TMState(ta_state=ta0))
    s = machine.session
    reset()
    times = []
    for i in range(ASYNC_STEPS):
        xb, yb = batches[i % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        machine.partial_fit(xb, yb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    got = read()
    require(s._step.reductions == 0,
            f"async: {s._step.reductions} reductions inside the steps, want 0")
    require(s._refresh.reductions == ASYNC_STEPS // k,
            f"async: {s._refresh.reductions} refreshes in {ASYNC_STEPS} "
            f"steps, want {ASYNC_STEPS // k}")
    require(got["ta_update"] == 2 * b_size * 4 * ASYNC_STEPS,
            f"async: launches {got}")
    require(machine.event_overflow == 0, "async: event_overflow")
    accuracy = machine.evaluate(*trained["test"], engine="indexed")
    print(f"async votes (4 clause shards, K={k}): {ASYNC_STEPS} steps with 0 "
          f"reductions inside them and {s._refresh.reductions} refreshes; "
          f"async_votes=0 equals synchronous Topology(1); step ms "
          f"{[round(t, 3) for t in times]}; held-out accuracy {accuracy:.4f} "
          f"(4 shards on one card) [{card}]")

    # -- serving -------------------------------------------------------------------
    c, d = SHARD_SERVE
    s = TMSession(cfg, Topology(clause_shards=c, data_shards=d),
                  mesh=mesh(c, d), engines=("indexed", "bitpack"))
    b = s.prepare(state)
    xs = requests(inc, SHARD_REQUESTS, gen, dev)
    want_rows = one.scores(bundle1, xs, engine="dense").cpu().numpy()
    xs_host = xs.cpu().numpy()
    for engine, kernel in kernel_of.items():
        server = AsyncTMServer(s, b, engine=engine, max_batch=32)
        reset()
        server.start()
        try:
            results = [p.wait(120) for p in [server.submit(row, tenant=f"t{i % 2}")
                                             for i, row in enumerate(xs_host)]]
        finally:
            server.stop()
        n_launch = read()[kernel.__name__]
        stats = server.stats()
        require(all(isinstance(r, ScoreResult) for r in results),
                f"sharded serve {engine}: a request was not served")
        require(np.array_equal(np.stack([r.scores for r in results]), want_rows),
                f"sharded serve {engine}: scores != Topology(1) dense")
        require(n_launch >= c * d * stats["batches"],
                f"sharded serve {engine}: {n_launch} launches for "
                f"{stats['batches']} batches on {c * d} ranks")
        top = server.sizes[-1]
        fn = s.lower_scores(b, top, engine=engine)
        fn1 = one.lower_scores(bundle1, top, engine=engine)
        xb = xs[:top].contiguous()
        ms, ms1 = call_ms(lambda: fn(xb), 20), call_ms(lambda: fn1(xb), 20)
        print(f"sharded serve ({c} clause x {d} data shards) {engine}: "
              f"{len(results)} requests in {stats['batches']} batches, all "
              f"equal to Topology(1) dense, {n_launch} kernel launches; bucket "
              f"B={top} {ms:.4f} ms per call vs Topology(1) {ms1:.4f} ms "
              f"({c * d} shards on one card) [{card}]")
    require_launched(counts.total, "phase 7")
    return counts.total


def same_sets(a, b) -> bool:
    """Two ``CompactClauses`` hold the same literal set in every row."""
    def rows(c):
        return torch.sort(torch.where(c.lit_idx < 0, 1 << 30, c.lit_idx),
                          dim=-1).values
    return torch.equal(a.lengths, b.lengths) and torch.equal(rows(a), rows(b))


def caches_match(cfg, bundle, where: str) -> None:
    """Every cache of a trained bundle equals a rebuild from its state: the
    index passes ``validate``, the bitpack words equal a fresh pack, the
    compact rows equal a fresh ``compact()`` as sets and pass
    ``validate_compact``."""
    from repro_torch.core import indexing
    from repro_torch.core.bitpack import pack_bits
    from repro_torch.core.types import include_mask

    state = bundle.state
    checks = indexing.validate(cfg, state, bundle.index)
    require(all(bool(v) for v in checks.values()), f"{where}: validate: {checks}")
    require(torch.equal(bundle.caches["bitpack"],
                        pack_bits(include_mask(cfg, state))),
            f"{where}: bitpack cache != a fresh pack")
    comp = bundle.caches["compact"]
    require(same_sets(comp, indexing.compact(cfg, state,
                                             cfg.resolved_clause_capacity)),
            f"{where}: compact cache != a fresh compact() as sets")
    checks = indexing.validate_compact(cfg, state, comp)
    require(all(bool(v) for v in checks.values()),
            f"{where}: validate_compact: {checks}")


def replay_ms(cfg, before, inc_before, inc_after, max_events) -> tuple[float, int]:
    """Wall ms of one ``compact_apply_events`` of a step's event buffer
    (median of 3; it waits for the device on its own) and the events."""
    from repro_torch.core import indexing
    buf = indexing.events_from_transition(inc_before, inc_after, max_events)
    times = [_wall_ms(lambda: indexing.compact_apply_events(before, buf.events),
                      sync=True) for _ in range(3)]
    return float(np.median(times)), int(buf.events.valid.sum())


def train_steps(cfg, ta0, batches, max_events, counts, seed, dev):
    """``partial_fit`` steps of B=32 with the three caches maintained, from
    ``ta0``; launch counts set to 0 just before and read just after.
    Returns (machine, step ms, launches, per-step replay inputs)."""
    from repro_torch.core.session import TsetlinMachine
    from repro_torch.core.types import TMState, include_mask

    machine = TsetlinMachine(cfg, engines=("indexed", "bitpack", "compact"),
                             device=dev, seed=seed,
                             max_events_per_batch=max_events)
    machine.bundle = machine.session.prepare(TMState(ta_state=ta0))
    steps, times = [], []
    counts.reset()
    for xb, yb in batches:
        before = (machine.bundle.caches["compact"], include_mask(cfg, machine.state))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        machine.partial_fit(xb, yb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        require(machine.event_overflow == 0,
                f"event buffer overflowed at step {len(times)} "
                f"(max_events_per_batch={max_events})")
        steps.append(before + (include_mask(cfg, machine.state),))
    launched = counts.read()
    want = 2 * TRAIN_BATCH * len(batches)
    require(launched["round_vote"] == launched["ta_update"] == want
            and launched["clause_outputs_packed"] == 0,
            f"training launches {launched}: want {want} of each learning kernel")
    return machine, times, launched, steps


def compact_mnist(cfg, state, x32, xs_host, dense_rows, trained, counts, dev,
                  card):
    """Phase 8 (a): the compact engine at the tm_mnist width."""
    from repro_torch.core import indexing
    from repro_torch.core.session import TMSession
    from repro_torch.serving import AOTBucketCache

    session = TMSession(cfg, engines=("compact", "dense"), device=dev)
    bundle = session.prepare(state)
    checks = indexing.validate_compact(cfg, state, bundle.caches["compact"])
    require(all(bool(v) for v in checks.values()), f"compact: {checks}")
    require(torch.equal(session.scores(bundle, x32, engine="compact"),
                        session.scores(bundle, x32, engine="dense")),
            "compact scores != dense at B=32")
    top = COMPACT_BUCKET
    aot = AOTBucketCache(session, bundle, engines=("compact",),
                         bucket_sizes=(top,))
    served = np.concatenate([
        aot(xs_host[i:i + top], engine="compact", bucket=top).cpu().numpy()
        for i in range(0, len(xs_host), top)])
    require(np.array_equal(served, dense_rows),
            "compact bucket scores != dense for phase 3's requests")
    require(aot.counters()["misses"] == 0, f"compact bucket cache: {aot.counters()}")
    fn = session.lower_scores(bundle, top, engine="compact")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(x32)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = device_ms(lambda: fn(x32), 5)
    wrapper_ms = call_ms(lambda: fn(x32), 5)
    lit_mb = bundle.caches["compact"].lit_idx.numel() * 4 / 1e6
    print(f"compact (tm_mnist, l_max={cfg.resolved_clause_capacity}, lit_idx "
          f"{lit_mb:.1f} MB): B={len(x32)} and {len(xs_host)} requests through "
          f"a bucket of {top} equal dense; bucket device ms {ms:.4f}, per call "
          f"{wrapper_ms:.4f} ms; peak device memory of one bucket "
          f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB "
          f"resident ({peak / 1e9:.3f} GB max_memory_allocated) [{card}]")

    batches = trained["batches"][1:1 + COMPACT_STEPS]
    machine, times, launched, steps = train_steps(
        cfg, trained["ta0"], batches, trained["max_events"], counts, SEED + 20,
        dev)
    caches_match(cfg, machine.bundle, "compact training (tm_mnist)")
    replays = [replay_ms(cfg, *st, trained["max_events"]) for st in steps]
    print(f"compact training (tm_mnist): {len(batches)} sequential steps of "
          f"B={TRAIN_BATCH} with engines (indexed, bitpack, compact) in "
          f"{[round(t, 3) for t in times]} ms; launches {launched}; overflow "
          f"0; every cache equals a rebuild (compact as sets); "
          f"compact_apply_events per step "
          f"{[f'{r:.3f} ms ({e} events)' for r, e in replays]} [{card}]")


def open_loop(cfg, counts, dev, card) -> None:
    """Phase 8 (b): the open-loop sync-vs-async sweep and the batch-axis
    sweep at the tm_mnist width."""
    from repro_torch.launch.tm_serve import run_batch_axis_scaling, run_sustained

    counts.reset()
    t0 = time.perf_counter()
    rec = run_sustained(cfg, engines=("indexed", "bitpack"), max_batch=32,
                        step_duration_s=OPEN_LOOP_STEP_S, seed=SEED,
                        device=dev)
    wall = time.perf_counter() - t0
    launched = counts.read()
    require(launched["indexed_votes"] > 0 and launched["clause_votes_packed"] > 0,
            f"open loop: launches {launched}")
    for engine, r in rec["engines"].items():
        aot, knee = r["aot"], r["knee"]
        require(aot["hot_loop_compiles"] == 0 and aot["misses"] == 0,
                f"open loop {engine}: bucket cache in the hot loop {aot}")
        at = r["steps"][knee["index"]]
        base = r["sync_baseline"]
        print(f"open loop[{engine}] (tm_mnist, max_batch=32, steps of "
              f"{OPEN_LOOP_STEP_S} s): sync baseline {base['achieved_rps']} "
              f"rows/s; async knee offered {knee['offered_rps']} (submitted "
              f"{at['submitted_rps']}) achieved {knee['achieved_rps']} rows/s, "
              f"p50 {at['latency_ms']['p50']} p99 {at['latency_ms']['p99']} ms "
              f"at the knee; speedup_at_knee {r['speedup_at_knee']}; "
              f"hot_loop_compiles {aot['hot_loop_compiles']} [{card}]")
        print(f"open loop[{engine}] sync ramp (offered / submitted / achieved "
              f"rows/s, rejected): " + "; ".join(
                  f"{s['offered_rps']} / {s['submitted_rps']} / "
                  f"{s['achieved_rps']}, {s['rejection_rate']}"
                  for s in base["ramp"]))
        print(f"open loop[{engine}] async (offered / submitted / achieved "
              f"rows/s, rejected, mean batch): " + "; ".join(
                  f"{s['offered_rps']} / {s['submitted_rps']} / "
                  f"{s['achieved_rps']}, {s['rejection_rate']}, {s['mean_batch']}"
                  for s in r["steps"]))
    print(f"open loop: {wall:.1f} s wall; launches {launched}")

    counts.reset()
    # offered far past capacity, so each row's closed-loop throughput is
    # what its shards can serve (the rows are saturated)
    rows = run_batch_axis_scaling(cfg, engine="indexed", rps=SCALING_RPS,
                                  devices=["cuda:0"] * 4, device=dev)
    launched = counts.read()
    require([r["data_shards"] for r in rows] == [1, 2, 4], f"scaling rows {rows}")
    require(all(r["devices"] == 1 and (" shards on one " in r["placement"]
                                       or r["data_shards"] == 1) for r in rows),
            f"scaling rows must read as shards on one card: {rows}")
    require(launched["indexed_votes"] > 0, f"scaling: launches {launched}")
    for r in rows:
        print(f"batch-axis rows[indexed] data_shards={r['data_shards']} "
              f"({r['placement']}; k shards on one card, not scaling): "
              f"closed-loop {r['throughput_rps']:.1f} rows/s at {SCALING_RPS} "
              f"offered (saturated {r['saturated']}), p50 {r['p50_ms']:.3f} "
              f"p95 {r['p95_ms']:.3f} ms [{card}]")


def imdb(gen, counts, dev, card, sms) -> dict:
    """Phase 8 (c): the paper's IMDb configuration at full width."""
    from repro_torch.configs.tm import PAPER_TM_CONFIGS
    from repro_torch.core import indexing, tm
    from repro_torch.core.session import TMSession
    from repro_torch.core.types import TMState, include_mask
    from repro_torch.data.synthetic import bow_documents
    from repro_torch.kernels import clause_eval

    exp = PAPER_TM_CONFIGS["tm_imdb"]
    cfg = exp.tm
    m, n, L = cfg.n_classes, cfg.n_clauses, cfg.n_literals
    ta, inc = served_state(cfg, int(exp.avg_clause_len), gen, dev)
    state = TMState(ta_state=ta)
    docs, labels = bow_documents(TRAIN_BATCH * (IMDB_STEPS + 2), cfg.n_features,
                                 cfg.n_classes, seed=SEED)
    x = requests(inc, TRAIN_BATCH, gen, dev, base=docs)
    session = TMSession(cfg, engines=("indexed", "bitpack", "compact", "dense"),
                        device=dev)
    bundle = session.prepare(state)
    words = bundle.caches["bitpack"]
    print(f"tm_imdb: m={m} n={n} 2o={L} W={words.shape[-1]}, mean clause "
          f"length {float(inc.sum(-1).float().mean()):.2f} literals, "
          f"bag-of-words requests with {float(x.float().sum(1).mean()):.1f} "
          f"of {cfg.n_features} terms present")

    # the four kernels against their plain versions at the IMDb shapes
    plan = clause_eval.launch_plan(TRAIN_BATCH, m, n, words.shape[-1])
    require(plan.route == "tiled" and plan.n_chunks > 1,
            f"tm_imdb votes plan is not the multi-chunk tiled route: {plan}")
    rows = vote_kernels(cfg, state, bundle.index, words, x, card, sms)
    rows.update(learning_kernels(cfg, ta, inc, gen, dev, card, sms, docs=docs))
    w = words.shape[-1]
    for key, shape in ((("indexed_votes", TRAIN_BATCH), f"B={TRAIN_BATCH}, lists ({m}, {L}, {bundle.index.capacity}), pos ({m}, {n}, {L})"),
                       (("clause_votes_packed", TRAIN_BATCH), f"B={TRAIN_BATCH}, words ({m}, {n}, {w}), {plan.n_chunks} chunks"),
                       (("clause_outputs_packed", 1), f"(1, 1, {n}, {w})"),
                       (("round_vote", "full"), f"({n}, {L}), every literal true"),
                       (("ta_update", True), f"({n}, {L}), target round")):
        rows[key]["shape"] = shape

    # scores through every engine, and the work ratio
    counts.reset()
    dense = session.scores(bundle, x, engine="dense")
    for engine in ("indexed", "bitpack", "compact"):
        require(torch.equal(session.scores(bundle, x, engine=engine), dense),
                f"tm_imdb {engine} scores != dense")
    launched = counts.read()
    require(dense.unique().numel() > 1, "tm_imdb scores all equal")
    work = indexing.indexed_work(bundle.index, x).double()
    ratio = float(work.mean()) / indexing.dense_work(cfg)
    print(f"tm_imdb scores: indexed, bitpack and compact equal dense at "
          f"B={TRAIN_BATCH}; launches {launched}; work ratio indexed_work / "
          f"dense_work on the requests {ratio:.6f} (mean of {len(x)}; "
          f"min {float(work.min()) / indexing.dense_work(cfg):.6f}, max "
          f"{float(work.max()) / indexing.dense_work(cfg):.6f}; the paper "
          f"reports about 0.006 on IMDb)")

    # two sequential steps from a trained-like state, every cache in step
    ta0 = trained_like_state(cfg, inc, gen, dev)
    batches = [(docs[i:i + TRAIN_BATCH], labels[i:i + TRAIN_BATCH])
               for i in range(0, len(docs), TRAIN_BATCH)]
    probe = tm.update_batch_sequential(
        cfg, TMState(ta0), *batches[0],
        torch.Generator(device=dev).manual_seed(SEED + 31))
    crossings = int((include_mask(cfg, probe) != (ta0 > cfg.n_states)).sum())
    max_events = max(1024, 1 << (4 * crossings - 1).bit_length())
    machine, times, launched, steps = train_steps(
        cfg, ta0, batches[1:1 + IMDB_STEPS], max_events, counts, SEED + 30, dev)
    caches_match(cfg, machine.bundle, "tm_imdb training")
    xt = session.scores(machine.bundle, x, engine="dense")
    for engine in ("indexed", "bitpack", "compact"):
        require(torch.equal(machine.scores(x, engine=engine), xt),
                f"tm_imdb {engine} scores != dense after training")
    replays = [replay_ms(cfg, *st, max_events) for st in steps]
    print(f"tm_imdb training: probe step crossed {crossings} cells, "
          f"max_events_per_batch={max_events}; {IMDB_STEPS} sequential steps "
          f"of B={TRAIN_BATCH} in {[round(t, 3) for t in times]} ms; launches "
          f"{launched}; the event buffer never overflowed; every cache equals "
          f"a rebuild; compact_apply_events per step "
          f"{[f'{r:.3f} ms ({e} events)' for r, e in replays]} [{card}]")
    return rows


def wrappers_vs_oracles(cfg, state, inc, trained, counts, gen, dev,
                        card) -> None:
    """Phase 9 (a): the ``kernels/ops.py`` wrappers on the card against the
    unpacked oracles of ``kernels/ref.py`` and the dense scores, at the
    tm_mnist width, bit for bit; each must launch its kernel."""
    from repro_torch.core import tm
    from repro_torch.core.types import clause_polarity, literals_from_input
    from repro_torch.kernels import ops, ref, ta_update

    n, L, b = cfg.n_clauses, cfg.n_literals, TRAIN_BATCH
    x = requests(inc, b, gen, dev)
    lit = literals_from_input(x)
    votes = ref.clause_votes_ref(inc, lit)
    require(torch.equal(votes, tm.scores(cfg, state, x)),
            "kernels/ref.clause_votes_ref != the dense scores")
    require(votes.unique().numel() > 1, "oracle votes all equal")
    outputs = ref.clause_outputs_ref(inc, lit)
    row = trained["ta0"][0]
    cout = ref.clause_outputs_ref(row[None] > cfg.n_states, lit[:1])[0, 0]
    active = torch.rand(n, generator=gen, device=dev) < 0.5
    pol = clause_polarity(cfg, dev)
    kw = dict(n_states=cfg.n_states, s=cfg.s,
              boost_true_positive=cfg.boost_true_positive)
    uniforms = {"random": torch.rand((n, L), generator=gen, device=dev),
                "edge": edge_uniforms((n, L), ta_update.thresholds(
                    cfg.s, cfg.boost_true_positive), gen, dev)}
    words = ops.pack_include(cfg, state)
    calls = {
        "tm_votes": (lambda: ops.tm_votes(cfg, state, x), votes),
        "tm_votes_packed": (lambda: ops.tm_votes_packed(words, x), votes),
        "tm_predict": (lambda: ops.tm_predict(cfg, state, x), votes.argmax(-1)),
        "tm_clause_outputs": (lambda: ops.tm_clause_outputs(cfg, state, x),
                              outputs),
    }
    for name, u in uniforms.items():
        for positive in (True, False):
            t1 = (pol > 0) if positive else (pol <= 0)
            calls[f"tm_ta_update[{name}, {'target' if positive else 'negative'}]"] = (
                lambda t1=t1, u=u: ops.tm_ta_update(cfg, row, lit[0], cout, t1,
                                                    active, u),
                ref.ta_update_ref(row, lit[0], cout, t1, active, u, **kw))
    counts.reset()
    got = {name: fn() for name, (fn, _) in calls.items()}
    torch.cuda.synchronize()
    launched = counts.read()
    for name, (_, want) in calls.items():
        err = int((got[name].long() - want.long()).abs().max())
        require(torch.equal(got[name], want),
                f"{name}: wrapper != unpacked oracle (max |diff| {err})")
    for kname in ("clause_votes_packed", "clause_outputs_packed", "ta_update"):
        require(launched[kname] > 0, f"phase 9 wrappers never launched {kname}")
    require(launched["clause_votes_packed"] == 3
            and launched["clause_outputs_packed"] == 1
            and launched["ta_update"] == 4,
            f"phase 9 wrapper launches {launched}: want 3, 1 and 4")
    times = {}
    for name, (fn, _) in calls.items():     # one variant of tm_ta_update
        key = name.split("[")[0]
        if key not in times:
            times[key] = call_ms(fn, 20)
    print(f"wrappers (tm_mnist, B={b}, m={cfg.n_classes}, n={n}, 2o={L}): "
          f"tm_votes, tm_votes_packed, tm_predict equal clause_votes_ref, the "
          f"dense scores and their argmax; tm_clause_outputs equals "
          f"clause_outputs_ref; tm_ta_update equals ta_update_ref on random "
          f"and edge uniforms, both rounds (max |diff| 0); launches {launched}; "
          f"call ms " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f" [{card}]")


def round_vs_numpy_oracle(counts, dev, card) -> None:
    """Phase 9 (b): the card's class round, ``indexed_scores`` (and the
    indexed engine) and ``dense_clause_outputs`` against the numpy oracle
    of ``core/ref.py`` at a small size whose last literal word is partial."""
    from repro_torch.core import bitpack, indexing, ref, tm
    from repro_torch.core.engines import get_engine
    from repro_torch.core.types import TMConfig, TMState, clause_polarity

    m, n, o = ORACLE_SHAPE
    rng = np.random.default_rng(SEED + 90)
    base = TMConfig(n_classes=m, n_clauses=n, n_features=o, n_states=127,
                    s=3.9, threshold=6)
    ta = np.where(rng.uniform(size=(m, n, 2 * o)) < 0.08,
                  rng.integers(128, 255, (m, n, 2 * o)),
                  rng.integers(1, 128, (m, n, 2 * o))).astype(np.int16)
    ta[:, :2] = 127                                   # empty clauses
    x = rng.integers(0, 2, (8, o)).astype(np.uint8)
    counts.reset()
    changed = 0
    for boost in (False, True):
        cfg = dataclasses.replace(base, boost_true_positive=boost)
        pol = clause_polarity(cfg, dev)
        for positive in (True, False):
            for cls in range(m):
                lit = np.concatenate([x[cls], 1 - x[cls]]).astype(np.uint8)
                gate = rng.uniform(size=n).astype(np.float32)
                type_i = rng.uniform(size=(n, 2 * o)).astype(np.float32)
                row = torch.from_numpy(ta[cls]).to(dev)
                tlit = torch.from_numpy(lit).to(dev)
                cout, vote = tm._round_vote(cfg, row,
                                            bitpack.pack_bits(tlit), pol)
                got = tm._round_feedback(
                    cfg, row, tlit, cout, vote,
                    tm.FeedbackRands(torch.from_numpy(gate).to(dev),
                                     torch.from_numpy(type_i).to(dev)),
                    positive, pol)
                want = ref.class_round_ref(
                    ta[cls], lit, gate, type_i, n_states=cfg.n_states, s=cfg.s,
                    threshold=cfg.threshold, half=n // 2,
                    positive_round=positive, boost_true_positive=boost)
                require(np.array_equal(got.cpu().numpy().astype(np.int64), want),
                        f"class round (boost {boost}, "
                        f"{'target' if positive else 'negative'}, class {cls}) "
                        "!= class_round_ref")
                changed += int((want != ta[cls]).sum())
    require(changed > 0, "the class rounds changed nothing")
    cfg = base
    state = TMState(ta_state=torch.from_numpy(ta).to(dev))
    xs = torch.from_numpy(x).to(dev)
    index = indexing.build_index(cfg, state, cfg.resolved_index_capacity)
    scores = indexing.indexed_scores(cfg, index, xs).cpu().numpy()
    engine = get_engine("indexed").scores(cfg, index, xs).cpu().numpy()
    lists, cnts = index.lists.cpu().numpy(), index.counts.cpu().numpy()
    outs = {e: tm.dense_clause_outputs(cfg, state, xs, empty_output=e)
            for e in (0, 1)}
    votes = tm.clause_votes(cfg, outs[1]).cpu().numpy()
    outs = {e: out.cpu().numpy() for e, out in outs.items()}
    launched = counts.read()
    for i in range(len(x)):
        want = ref.indexed_scores_ref(lists, cnts, x[i], n)
        require(np.array_equal(scores[i], want) and np.array_equal(engine[i], want),
                f"indexed_scores / the indexed engine != indexed_scores_ref "
                f"(sample {i})")
        for e, out in outs.items():
            want = ref.clause_outputs_ref(ta, x[i], cfg.n_states, e)
            require(np.array_equal(out[i], want),
                    f"dense_clause_outputs(empty_output={e}) != "
                    f"clause_outputs_ref (sample {i})")
        require(np.array_equal(votes[i], ref.votes_ref(outs[1][i])),
                f"clause_votes != votes_ref (sample {i})")
    require(np.unique(scores).size > 1, "oracle scores all equal")
    for kname in ("indexed_votes", "round_vote", "ta_update"):
        require(launched[kname] > 0, f"phase 9 (b) never launched {kname}")
    n_empty = int((~(ta > cfg.n_states).any(-1)).sum())
    print(f"numpy oracle (m, n, o)=({m}, {n}, {o}), 2o={2 * o} (partial last "
          f"word), {n_empty} empty clauses: class rounds on the card equal class_round_ref in "
          f"both polarities with boost_true_positive off and on ({changed} "
          f"cells changed); indexed_scores and the indexed engine equal "
          f"indexed_scores_ref, dense_clause_outputs (empty 0 and 1) and "
          f"clause_votes equal clause_outputs_ref / votes_ref on {len(x)} "
          f"samples; launches {launched} [{card}]")


def load_example(name: str):
    """``examples/<name>.py`` of this checkout, as a module."""
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    require(spec is not None and path.exists(), f"{path} is missing")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples(counts, card) -> None:
    """Phase 9 (c): the two examples' ``main`` in this process, on the card."""
    out = {}
    for name, argv in (("torch_quickstart", ["--device", "cuda"]),
                       ("torch_tm_mnist", ["--device", "cuda", "--epochs", "1"])):
        main_fn = load_example(name).main
        with tempfile.TemporaryDirectory() as tmp:
            if name == "torch_tm_mnist":
                argv = argv + ["--ckpt-dir", tmp]
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            counts.reset()
            t0 = time.perf_counter()
            out[name] = main_fn(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = counts.read()
            peak = torch.cuda.max_memory_allocated() - resident
        for kname in ("round_vote", "ta_update", "indexed_votes"):
            require(launched[kname] > 0, f"{name} never launched {kname}")
        require(launched["clause_outputs_packed"] == 0,
                f"{name} packed include words: {launched}")
        out[name].update(wall_s=wall, peak_gb=peak / 1e9, launches=launched)
    q, t = out["torch_quickstart"], out["torch_tm_mnist"]
    require(q["event_overflow"] == 0, "quickstart: event buffer overflowed")
    require(t["roundtrip_ok"], "torch_tm_mnist: checkpoint round-trip mismatch")
    require(0 < t["work_ratio"] < 1, f"torch_tm_mnist work ratio {t['work_ratio']}")
    print(f"example torch_quickstart (cuda): accuracy per epoch "
          f"{[round(a, 4) for a in q['accuracy']]}, all engines agree, work "
          f"ratio {q['work_ratio']:.4f}; {q['wall_s']:.2f} s wall, peak "
          f"{q['peak_gb']:.3f} GB above resident; launches {q['launches']} "
          f"[{card}]")
    e = t["epochs"][0]
    print(f"example torch_tm_mnist (cuda, reference widths, 1 epoch): "
          f"{e['samples_per_s']:.1f} samples/s over {t['train']} rows in one "
          f"partial_fit step, {e['events']} cache events of {t['max_events']} "
          f"(no overflow), accuracy {e['acc']:.4f}; us/sample "
          + ", ".join(f"{k} {v:.3f}" for k, v in t["us_per_sample"].items())
          + f"; work ratio {t['work_ratio']:.4f}; checkpoint round-trip "
          f"{'ok' if t['roundtrip_ok'] else 'MISMATCH'}; {t['wall_s']:.2f} s "
          f"wall, peak {t['peak_gb']:.3f} GB above resident; launches "
          f"{t['launches']} [{card}]")


def task_engines(cfg, trained, counts, dev, card) -> None:
    """Phase 9 (d): ``make_tm_task(engines=("indexed",))`` against the
    default four caches, a few ``Trainer`` steps of B=32 each from phase
    5's trained-like state; and ``TMBatcher`` shards."""
    from repro_torch.checkpoint import tm_store
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core import indexing, tm
    from repro_torch.core.engines import cache_provider
    from repro_torch.core.types import include_mask
    from repro_torch.data.pipeline import TMBatcher
    from repro_torch.runtime import Trainer, TrainLoopConfig, make_tm_task

    tree = tm_store.checkpoint_tree(cfg, trained["ta0"].cpu().numpy(), step=0)
    runs = {}
    for label, engines in (("indexed only", ("indexed",)),
                           ("default four", None)):
        task = make_tm_task(cfg, engines=engines, batch=TRAIN_BATCH, seed=SEED,
                            max_events=trained["max_events"], device=dev)
        keys = set(task.state["bundle"].caches)
        # the dense engine scores from the state: it keeps no cache
        want = {"indexed"} if engines else {"bitpack", "indexed", "compact"}
        require(keys == want, f"task {label}: caches {sorted(keys)}")
        step_ms = []

        def timed(state, batch, fn=task.step_fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(
                step_fn=timed, state=task.from_ckpt(tree, task.state),
                batcher=task.batcher, checkpointer=Checkpointer(tmp, keep=1),
                loop=TrainLoopConfig(total_steps=TASK_STEPS,
                                     ckpt_every=TASK_STEPS + 1, log_every=1),
                to_ckpt=task.to_ckpt, from_ckpt=task.from_ckpt)
            counts.reset()
            trainer.run(start_step=0)
            launched = counts.read()
        bundle = trainer.state["bundle"]
        require(int(bundle.event_overflow) == 0, f"task {label}: overflow")
        require(launched["ta_update"] == 2 * TRAIN_BATCH * TASK_STEPS,
                f"task {label}: launches {launched}")
        checks = indexing.validate(cfg, bundle.state, bundle.index)
        require(all(bool(v) for v in checks.values()),
                f"task {label}: validate {checks}")
        runs[label] = (bundle, step_ms, trainer.metrics_log, launched)
    (one, ms1, log1, _), (four, ms4, log4, _) = runs.values()
    require(torch.equal(one.state.ta_state, four.state.ta_state),
            "make_tm_task: the cache set changed the learning")
    require(log1 == log4, f"make_tm_task metrics differ: {log1} vs {log4}")
    caches_match(cfg, four, "make_tm_task, default engines")
    # where the difference goes: one more step's event buffer replayed
    # into each maintained cache alone (median of 3 each)
    batch = TMBatcher(cfg.n_features, cfg.n_classes, TRAIN_BATCH,
                      seed=7)(TASK_STEPS)
    new_state = tm.update_batch_sequential(
        cfg, four.state, batch["x"], batch["y"],
        torch.Generator(device=dev).manual_seed(SEED + 40))
    buf = indexing.events_from_transition(
        include_mask(cfg, four.state), include_mask(cfg, new_state),
        trained["max_events"])
    sync_ms = {key: float(np.median([_wall_ms(
        lambda: cache_provider(key).update_cache(cfg, cache, new_state,
                                                 buf.events), sync=True)
        for _ in range(3)])) for key, cache in four.caches.items()}
    print(f"make_tm_task at tm_mnist, {TASK_STEPS} Trainer steps of "
          f"B={TRAIN_BATCH} from a trained-like state (equal states and "
          f"metrics): engines=('indexed',) {[round(t, 3) for t in ms1]} ms, "
          f"default four caches {[round(t, 3) for t in ms4]} ms per step; "
          f"one step's {int(buf.events.valid.sum())} events replayed into "
          f"each cache alone: " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in sync_ms.items()) + f" [{card}]")

    full = TMBatcher(cfg.n_features, cfg.n_classes, TRAIN_BATCH, seed=7)
    for step in (0, 5):
        shards = [TMBatcher(cfg.n_features, cfg.n_classes, TRAIN_BATCH, seed=7,
                            shard_index=i, shard_count=2)(step) for i in (0, 1)]
        for key in ("x", "y"):
            require(np.array_equal(np.concatenate([s[key] for s in shards]),
                                   full(step)[key]),
                    f"TMBatcher shards of step {step} != the global batch")
    print("TMBatcher: the two shards of shard_count=2 concatenate to the "
          "global batch")


def phase9(cfg, state, inc, trained, gen, dev, card) -> dict:
    """Phase 9: oracles, wrappers, examples. Returns the launch totals."""
    counts = Counts()
    wrappers_vs_oracles(cfg, state, inc, trained, counts, gen, dev, card)
    round_vs_numpy_oracle(counts, dev, card)
    examples(counts, card)
    task_engines(cfg, trained, counts, dev, card)
    require_launched(counts.total, "phase 9", unused=())
    print(f"phase 9 launches: {counts.total}")
    return counts.total


# ---------------------------------------------------------------------------
# Phases 10 and 11: LM serving (dense and vlm; moe, ssm and hybrid)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def lm_compute_dtype(dtype):
    """Run the port's LM in ``dtype`` (the module constants both packages'
    tests patch: the decoder stack's, whisper's and the train step's),
    restoring bf16 after."""
    from repro_torch import steps
    from repro_torch.models import transformer, whisper
    mods = (transformer, whisper, steps)
    old = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        for m, o in zip(mods, old):
            m.COMPUTE_DTYPE = o


def lm_compare(got, want, tol: float, what: str) -> tuple[float, int]:
    """Require max |got - want| <= tol · max |want| and equal argmax in every
    row whose top-2 margin exceeds 2 · tol · max |want|. Returns the
    relative error and the number of rows whose argmax was held."""
    got, want = got.double(), want.double()
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / scale
    require(rel <= tol, f"{what}: max|diff| {rel:.3e} of max|ref| {scale:.3f} "
            f"> {tol}")
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * tol * scale
    require(torch.equal(got.argmax(-1)[sure], want.argmax(-1)[sure]),
            f"{what}: greedy tokens differ where the margin exceeds 2 x tol")
    return rel, int(sure.sum())


def synced_ms(fn):
    """(result, wall ms) of ``fn()`` between two device synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def lm_profile(fn, what: str, card) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall ms, the device's busy
    ms (kernel-level events), how many device events, the top ops."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = synced_ms(fn)

    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    events = prof.key_averages()
    on_device = [e for e in events
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(dev_ms(e) for e in on_device)
    n_dev = sum(e.count for e in on_device)
    if busy == 0:
        print(f"profile {what}: the profiler recorded no device time (not measured)")
        return {"wall_ms": wall, "device_busy_ms": None, "device_events": n_dev}
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=dev_ms, reverse=True)[:5]
    print(f"profile {what}: wall {wall:.3f} ms under the profiler, device "
          f"busy {busy:.3f} ms ({100 * busy / wall:.1f}%) in {n_dev} device "
          f"events; device ms by op: "
          + ", ".join(f"{e.key} {dev_ms(e):.3f}/{e.count} calls" for e in ops)
          + f" [{card}]")
    return {"wall_ms": wall, "device_busy_ms": busy, "device_events": n_dev}


def lm_work(cfg, params, batch: int, seq: int, cache_tokens: int) -> dict:
    """Least time (ms) of a prefill of ``batch`` x ``seq`` tokens and of one
    decode step over ``cache_tokens`` cached tokens per row: each weight
    read once (the embedding as rows gathered, unless tied, when the
    unembedding reads it whole), each cached K/V read once, each recurrent
    state (RWKV's shifts and ``wkv``, Griffin's conv tail and ``h``) read
    and written once per step; matrix-product FLOPs at the bf16 tensor rate
    (logits at the last position only). Attention and its cache are counted
    on the attention blocks only (none in RWKV, every third block of a
    hybrid), over the causal pairs its window allows. A MoE's experts are
    all read and multiplied, as the reference's dropless algorithm does (at
    decode every expert runs its one capacity slot, at prefill each is
    padded to T_g rows); ``routed_*`` bounds the routed experts only: top-k
    products per token, and at most min(E, tokens·k) distinct experts
    read per layer."""
    from repro_torch.models import transformer

    elt = next(params.parameters()).element_size()
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    table = cfg.vocab * cfg.d_model
    n_params = sum(p.numel() for p in params.parameters())
    body = n_params - table * (1 if cfg.tie_embeddings else 2)
    read = w_bytes - (0 if cfg.tie_embeddings else table * elt)
    kinds, n_groups, tail = transformer._plan(cfg)
    n_attn = sum(k.startswith("attn") for k in kinds * n_groups + tail)
    window = transformer._window_for(cfg, "attn_mlp")
    w = min(window or seq, seq)
    pairs = w * (w + 1) / 2 + (seq - w) * w        # causal, windowed
    kv_tokens = min(cache_tokens, window) if window else cache_tokens
    hd = cfg.head_dim_
    attn = 2 * 2 * batch * cfg.n_heads * hd * pairs * n_attn
    prefill_flops = 2 * body * batch * seq + 2 * table * batch + attn
    kv_bytes = 2 * batch * cfg.n_kv_heads * hd * 2 * kv_tokens * n_attn
    shapes = transformer.cache_shapes(cfg, batch, cache_tokens)
    state_bytes = 2 * sum(
        math.prod(shape) * torch.empty((), dtype=dt).element_size()
        for block in list(shapes["layers"].values()) + shapes.get("tail", [])
        for name, (shape, dt) in block.items() if name not in ("k", "v", "pos"))
    decode_flops = (2 * (body + table) * batch
                    + 4 * batch * cfg.n_heads * hd * kv_tokens * n_attn)

    def t(nbytes, flops):
        return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS_PER_S) * 1e3

    def by(nbytes, flops):
        return ("bytes" if nbytes / PEAK_BYTES_PER_S
                >= flops / PEAK_BF16_FLOPS_PER_S else "operations")

    out = {"prefill_bound_ms": t(read, prefill_flops),
           "prefill_bound_by": by(read, prefill_flops),
           "decode_bound_ms": t(read + kv_bytes + state_bytes, decode_flops),
           "weight_bytes_read": read, "kv_bytes": kv_bytes,
           "state_bytes": state_bytes}
    if cfg.family == "moe":
        expert = 3 * cfg.d_model * (cfg.d_ff_expert or cfg.d_ff)
        experts = cfg.n_layers * cfg.n_experts * expert

        def routed_read(tokens):
            distinct = min(cfg.n_experts, tokens * cfg.top_k)
            return read - (experts - cfg.n_layers * distinct * expert) * elt

        routed = 2 * (experts - cfg.n_layers * cfg.top_k * expert)
        out.update(
            routed_prefill_bound_ms=t(routed_read(batch * seq),
                                      prefill_flops - routed * batch * seq),
            routed_decode_bound_ms=t(routed_read(batch) + kv_bytes,
                                     decode_flops - routed * batch))
    return out


def lm_serve(arch: str, batch: int, prompt: int, gen: int, dev, card,
             steps=None, extra=None) -> dict:
    """Phase 10 (a), (b) and 11 (a)-(c): ``launch.serve.main`` at full
    width; then, on the same weights and prompts, the bf16 prefill against
    a float32 one and against ``steps`` single decode steps (default
    ``prompt``: from an empty cache; else after a prefill of the first
    ``prompt - steps`` tokens). ``extra(cfg, model, params, dev, card)``
    runs further checks on the bf16 weights; its dict joins the record."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build

    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt),
            "--gen", str(gen)]
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    first = serve.main(argv)     # pays cuBLAS's first use of these shapes
    res = serve.main(argv)
    require(np.array_equal(first["generations"], res["generations"]),
            f"{arch}: two serve runs generated different tokens")
    cfg = get_config(arch)
    m = build(cfg)
    prompts = serve.make_prompts(cfg, batch, prompt, dev)
    params = m.init(torch.Generator(device=dev).manual_seed(serve.SEED))
    steps = prompt if steps is None else steps
    layerwise = {}
    with lm_compute_dtype(torch.float32):
        l32, _ = m.prefill(params, prompt + gen, tokens=prompts)
        if arch in LM_LAYERWISE:
            layerwise = lm_layerwise(cfg, m, params, prompts, steps,
                                     prompt + gen, l32, card)
    params = params.to(torch.bfloat16)
    l16, _ = m.prefill(params, prompt + gen, tokens=prompts)
    require(np.array_equal(l16.argmax(-1).cpu().numpy(), res["generations"][:, 0]),
            f"{arch}: the serve CLI's first token is not this prefill's")
    tol = math.inf if layerwise else LM_BF16_TOL    # held block by block
    rel32, rows32 = lm_compare(l16, l32, tol, f"{arch} bf16 vs float32")
    del l32
    rel_dec, rows_dec, logits, cache = decode_vs_prefill(
        m, params, prompts, steps, prompt + gen, l16, tol, f"{arch} bf16")
    pos = torch.full((batch,), prompt, dtype=torch.int32, device=dev)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    prof = {"decode_profile": lm_profile(
        lambda: m.decode_step(params, tok, cache, pos),
        f"{arch} decode step B={batch}", card),
        "prefill_profile": lm_profile(
        lambda: m.prefill(params, prompt + gen, tokens=prompts),
        f"{arch} prefill B={batch} S={prompt}", card)}
    out = {k: res[k] for k in ("batch", "prompt_len", "gen", "param_count",
                               "param_bytes", "prefill_ms", "prefill_tok_s",
                               "decode_ms_per_step", "decode_tok_s")}
    out.update(lm_work(cfg, params, batch, prompt, prompt + gen // 2))
    out.update(peak_gb_above_resident=(res["peak_bytes"] - resident) / 1e9,
               first_prefill_ms=first["prefill_ms"],
               first_decode_ms_per_step=first["decode_ms_per_step"],
               bf16_vs_f32_rel=rel32, bf16_vs_f32_rows=rows32,
               decode_vs_prefill_steps=steps,
               decode_vs_prefill_rel=rel_dec, decode_vs_prefill_rows=rows_dec,
               **layerwise, **prof)
    routed = ("" if "routed_decode_bound_ms" not in out else
              f"; routed experts only: prefill bound "
              f"{out['routed_prefill_bound_ms']:.3f} ms, decode "
              f"{out['routed_decode_bound_ms']:.3f} ms")
    print(f"lm serve {arch} (full width, {res['param_count']} params, "
          f"{res['param_bytes'] / 1e9:.3f} GB bf16) B={batch} prompt={prompt} "
          f"gen={gen}: prefill {res['prefill_ms']:.3f} ms ({res['prefill_tok_s']:.0f} "
          f"tok/s; bound {out['prefill_bound_ms']:.3f} ms, {out['prefill_bound_by']}),"
          f" decode {res['decode_ms_per_step']:.3f} ms/step ({res['decode_tok_s']:.0f} "
          f"tok/s; bound {out['decode_bound_ms']:.3f} ms); first run "
          f"{first['prefill_ms']:.3f} / {first['decode_ms_per_step']:.3f}; peak "
          f"{out['peak_gb_above_resident']:.3f} GB above resident; bf16 vs "
          f"float32 prefill {rel32:.3e} of max|logit| ({rows32} of {batch} "
          f"argmax held), {steps} decode steps vs prefill {rel_dec:.3e} "
          f"({rows_dec} held), tolerance "
          f"{'(printed; held block by block)' if layerwise else LM_BF16_TOL}"
          f"{routed} [{card}]")
    if extra is not None:
        out.update(extra(cfg, m, params, dev, card))
    return out


def decode_vs_prefill(m, params, prompts, steps: int, cache_len: int, want,
                      tol: float, what: str):
    """``steps`` single decode steps over the end of ``prompts`` (from an
    empty cache when ``steps`` is the whole prompt, else after a prefill of
    the rest) against the full prefill's logits ``want``. Returns (relative
    error, rows whose argmax was held, the last logits, the cache)."""
    batch, prompt = prompts.shape
    if steps == prompt:
        cache = m.init_cache(batch, cache_len, device=prompts.device)
    else:
        _, cache = m.prefill(params, cache_len, tokens=prompts[:, :prompt - steps])
    for i in range(prompt - steps, prompt):
        pos = torch.full((batch,), i, dtype=torch.int32, device=prompts.device)
        logits, cache = m.decode_step(params, prompts[:, i:i + 1], cache, pos)
    rel, rows = lm_compare(logits, want, tol, f"{what} {steps} decode steps vs prefill")
    return rel, rows, logits, cache


def block_decode_vs_prefill(cfg, blk, kind: str, x, steps: int) -> float:
    """One recurrent block on ``x`` (B, S, d): its prefill of the first
    S - ``steps`` tokens then ``steps`` decode steps against its prefill of
    all S, from a zero state in x's dtype; the relative error of the last
    ``steps`` outputs and of the final state, whichever is larger."""
    from repro_torch.models import rwkv6, transformer

    batch, seq = x.shape[:2]
    require(kind == "rwkv", f"no block-level decode check for {kind}")

    def zero():
        return rwkv6.init_rwkv_state(batch, cfg.d_model, cfg.rwkv_heads,
                                     cfg.rwkv_head_dim, x.dtype, x.device)

    positions = torch.arange(seq, device=x.device)[None]
    want, want_state, _ = transformer._apply_block(blk, cfg, kind, x, positions,
                                                   zero(), False)
    _, state, _ = transformer._apply_block(
        blk, cfg, kind, x[:, :seq - steps], positions[:, :seq - steps], zero(),
        False)
    ys = []
    for i in range(seq - steps, seq):
        y, state, _ = transformer._apply_block(blk, cfg, kind, x[:, i:i + 1],
                                               positions[:, i:i + 1], state, True)
        ys.append(y)
    pairs = [(torch.cat(ys, 1), want[:, seq - steps:])]
    pairs += [(state[name], want_state[name]) for name in want_state]
    return max(float((g.float() - w.float()).abs().max() / w.float().abs().max())
               for g, w in pairs)


@torch.no_grad()
def lm_layerwise(cfg, m, params, prompts, steps: int, cache_len: int, l32,
                 card) -> dict:
    """Phase 11 (b), on the float32 weights under float32 compute. Printed,
    at full depth: how far a relative ``LM_PERTURBATION`` of the embedding
    rows moves the prefill's logits ``l32``, and ``steps`` float32 decode
    steps against the prefill. Held, block by block on the float32 stream's
    input: the block in bf16 against float32 from the second token on
    (LM_BF16_TOL of its output; the first token's gap printed), and its
    prefill then ``steps`` decode steps against its prefill, in float32
    (LM_F32_TOL) and in bf16 (LM_BF16_TOL)."""
    from repro_torch.models import transformer

    rel_dec, _, _, cache = decode_vs_prefill(
        m, params, prompts, steps, cache_len, l32, math.inf, f"{cfg.name} float32")
    _, want = m.prefill(params, cache_len, tokens=prompts)
    n_groups = len(params.layers)
    growth = {j: max(float((t[j] - want["layers"][key][name][j]).abs().max()
                           / want["layers"][key][name][j].abs().max())
                     for key, block in cache["layers"].items()
                     for name, t in block.items())
              for j in sorted({*range(0, n_groups, 8), n_groups - 1})}
    del cache, want
    table = params.embed.tokens
    kept = table.clone()
    gen = torch.Generator(device=table.device).manual_seed(SEED + 3)
    table.mul_(1 + LM_PERTURBATION * torch.randn(
        table.shape, generator=gen, device=table.device))
    moved, _ = m.prefill(params, cache_len, tokens=prompts)
    table.copy_(kept)
    del kept
    sens = float((moved.double() - l32.double()).abs().max() / l32.double().abs().max())
    kinds, _, tail = transformer._plan(cfg)
    blocks = [(g[f"b{i}_{k}"], k) for g in params.layers
              for i, k in enumerate(kinds)] + list(zip(params.tail, tail))
    x = transformer.embed(params.embed, prompts, torch.float32)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    worst = {"bf16_vs_f32": 0.0, "bf16_vs_f32_first_token": 0.0,
             "f32_decode": 0.0, "bf16_decode": 0.0}
    for blk, kind in blocks:
        y32, _, _ = transformer._apply_block(blk, cfg, kind, x, positions, None,
                                             False)
        b16 = copy.deepcopy(blk).to(torch.bfloat16)
        x16 = x.to(torch.bfloat16)
        y16, _, _ = transformer._apply_block(b16, cfg, kind, x16, positions, None,
                                             False)
        err = (y16.float() - y32).abs() / y32.abs().max()
        got = {"bf16_vs_f32": float(err[:, 1:].max()),
               "bf16_vs_f32_first_token": float(err[:, 0].max()),
               "f32_decode": block_decode_vs_prefill(cfg, blk, kind, x, steps),
               "bf16_decode": block_decode_vs_prefill(cfg, b16, kind, x16, steps)}
        worst = {k: max(v, got[k]) for k, v in worst.items()}
        x = y32
        del b16, x16, y16
    require(worst["bf16_vs_f32"] <= LM_BF16_TOL and worst["bf16_decode"] <= LM_BF16_TOL
            and worst["f32_decode"] <= LM_F32_TOL,
            f"{cfg.name} block by block: {worst}")
    print(f"lm {cfg.name} conditioning (float32, full depth): a {LM_PERTURBATION} "
          f"relative perturbation of the embedding rows moves the logits by "
          f"{sens:.3e} of max|logit|; {steps} float32 decode steps vs prefill "
          f"{rel_dec:.3e}, their states' gap by layer "
          + ", ".join(f"{j}: {g:.2e}" for j, g in growth.items())
          + f" (printed). Held block by block ({len(blocks)} blocks, "
          f"each on the float32 stream's input): bf16 vs float32 worst "
          f"{worst['bf16_vs_f32']:.3e} of max|out| from the second token on "
          f"(the first token: {worst['bf16_vs_f32_first_token']:.3e}, printed) "
          f"and bf16 prefill + {steps} "
          f"decode steps vs prefill {worst['bf16_decode']:.3e} (tolerance "
          f"{LM_BF16_TOL}); float32 prefill + {steps} decode steps vs prefill "
          f"{worst['f32_decode']:.3e} (tolerance {LM_F32_TOL}) [{card}]")
    return {"perturbation_moves_logits_rel": sens,
            "full_depth_f32_decode_vs_prefill_rel": rel_dec,
            "full_depth_f32_state_gap_by_layer": growth,
            "blockwise_bf16_vs_f32_rel": worst["bf16_vs_f32"],
            "blockwise_bf16_vs_f32_first_token_rel": worst["bf16_vs_f32_first_token"],
            "blockwise_bf16_decode_vs_prefill_rel": worst["bf16_decode"],
            "blockwise_f32_decode_vs_prefill_rel": worst["f32_decode"]}


def lm_decode_32k(dev, card) -> dict:
    """Phase 10 (c): qwen3-1.7b decode steps against a cache of decode_32k's
    length (B cut from 128 to fit), filled from the generator."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import serve
    from repro_torch.models import attention
    from repro_torch.models.model import build

    cfg = get_config("qwen3-1.7b")
    clen = get_shape("decode_32k").seq_len
    m = build(cfg)
    params = serve.init_bf16(m, dev)
    cache = m.init_cache(LM_DECODE_BATCH, clen)
    layer = cache["layers"]["b0_attn_mlp"]
    filled = clen - LM_DECODE_STEPS - 2
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for j in range(cfg.n_layers):
        layer["k"][j, :, :, :filled].normal_(generator=gen)
        layer["v"][j, :, :, :filled].normal_(generator=gen)
    layer["pos"][:, :, :filled] = torch.arange(filled, dtype=torch.int32,
                                               device=dev)
    cache_gb = sum(t.numel() * t.element_size() for t in layer.values()) / 1e9
    # the two bf16 products accumulate in float32 without an upcast of the
    # cache (bmm's out_dtype): layer 0's against the upcast operands
    g = cfg.n_heads // cfg.n_kv_heads
    qg = torch.randn(LM_DECODE_BATCH, cfg.n_kv_heads, g, cfg.head_dim_,
                     generator=gen, device=dev, dtype=torch.bfloat16)
    k0, v0 = layer["k"][0], layer["v"][0]
    s16 = attention._dot_f32(qg, k0.transpose(-1, -2))
    s32 = torch.matmul(qg.float(), k0.float().transpose(-1, -2))
    p16 = torch.softmax(s32, dim=-1).to(torch.bfloat16)
    a16 = attention._dot_f32(p16, v0)
    a32 = torch.matmul(p16.float(), v0.float())
    rel_dot = max(float((x - y).abs().max() / y.abs().max())
                  for x, y in ((s16, s32), (a16, a32)))
    require(s16.dtype == a16.dtype == torch.float32 and rel_dot <= LM_F32_TOL,
            f"decode_32k: out_dtype products differ from the upcast form by "
            f"{rel_dot:.3e}")
    del s16, s32, p16, a16, a32
    tok = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_DECODE_BATCH, 1))).to(dev)
    times = []
    for i in range(LM_DECODE_STEPS + 2):
        pos = torch.full((LM_DECODE_BATCH,), filled + i, dtype=torch.int32,
                         device=dev)
        (logits, cache), ms = synced_ms(lambda: m.decode_step(params, tok, cache,
                                                              pos))
        require(bool(torch.isfinite(logits).all()), "decode_32k: non-finite logits")
        tok = logits.argmax(-1)[:, None]
        times.append(ms)
    steady = times[2:]
    step_prof = lm_profile(lambda: m.decode_step(params, tok, cache, pos),
                           f"decode_32k step B={LM_DECODE_BATCH}", card)
    out = {"batch": LM_DECODE_BATCH, "cache_len": clen, "cache_gb": cache_gb,
           "ms_per_step": float(np.median(steady)),
           "ms_per_step_all": steady, "out_dtype_vs_upcast_rel": rel_dot,
           "decode_profile": step_prof}
    work = lm_work(cfg, params, LM_DECODE_BATCH, 1, filled + LM_DECODE_STEPS)
    out.update(bound_ms=work["decode_bound_ms"], kv_bytes=work["kv_bytes"])
    print(f"lm decode_32k qwen3-1.7b B={LM_DECODE_BATCH} (cut from 128) cache "
          f"{clen} ({cache_gb:.3f} GB, {filled} slots filled from the "
          f"generator): {out['ms_per_step']:.3f} ms/step (median of "
          f"{len(steady)}: {', '.join(f'{t:.3f}' for t in steady)}; bound "
          f"{out['bound_ms']:.3f} ms, bytes); out_dtype products vs upcast "
          f"{rel_dot:.3e} [{card}]")
    del cache, layer, params
    return out


def lm_blockwise(dev, card) -> dict:
    """Phase 10 (d): qwen3-1.7b prefill of one row of LM_BLOCKWISE_SEQ tokens
    through the blockwise path (above dense_attn_max) and the dense one."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build

    cfg = get_config("qwen3-1.7b")
    require(LM_BLOCKWISE_SEQ > cfg.dense_attn_max, "the blockwise path is not taken")
    dense_cfg = dataclasses.replace(cfg, dense_attn_max=LM_BLOCKWISE_SEQ)
    params = serve.init_bf16(build(cfg), dev)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, (1, LM_BLOCKWISE_SEQ))).to(dev)
    res = {}
    for name, c in (("blockwise", cfg), ("dense", dense_cfg)):
        m = build(c)
        m.prefill(params, LM_BLOCKWISE_SEQ, tokens=tokens[:, :256])   # warm
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        res[name], ms = synced_ms(lambda: m.prefill(params, LM_BLOCKWISE_SEQ,
                                                    tokens=tokens))
        res[name + "_ms"] = ms
        res[name + "_peak_gb"] = (torch.cuda.max_memory_allocated() - resident) / 1e9
    (lb, cb), (ld, cd) = res["blockwise"], res["dense"]
    rel, rows = lm_compare(lb, ld, LM_BF16_TOL, "blockwise vs dense prefill")
    kb, kd = cb["layers"]["b0_attn_mlp"], cd["layers"]["b0_attn_mlp"]
    require(torch.equal(kb["pos"], kd["pos"]), "blockwise vs dense: cache positions")
    rel_kv = max(float((kb[n].float() - kd[n].float()).abs().max()
                       / kd[n].float().abs().max()) for n in ("k", "v"))
    require(rel_kv <= LM_BF16_TOL, f"blockwise vs dense caches: {rel_kv:.3e}")
    work = lm_work(cfg, params, 1, LM_BLOCKWISE_SEQ, LM_BLOCKWISE_SEQ)
    out = {"seq": LM_BLOCKWISE_SEQ, "kv_block": cfg.kv_block,
           "logits_rel": rel, "cache_rel": rel_kv,
           "blockwise_ms": res["blockwise_ms"], "dense_ms": res["dense_ms"],
           "blockwise_peak_gb": res["blockwise_peak_gb"],
           "dense_peak_gb": res["dense_peak_gb"],
           "bound_ms": work["prefill_bound_ms"], "bound_by": work["prefill_bound_by"]}
    print(f"lm blockwise vs dense prefill qwen3-1.7b B=1 S={LM_BLOCKWISE_SEQ} "
          f"(kv_block {cfg.kv_block}): logits {rel:.3e} of max|logit| ({rows} "
          f"argmax held), caches {rel_kv:.3e}, tolerance {LM_BF16_TOL}; "
          f"blockwise {res['blockwise_ms']:.3f} ms (peak "
          f"{res['blockwise_peak_gb']:.3f} GB above resident), dense "
          f"{res['dense_ms']:.3f} ms (peak {res['dense_peak_gb']:.3f} GB); "
          f"bound {out['bound_ms']:.3f} ms ({out['bound_by']}) [{card}]")
    return out


def lm_reduced(dev, card, archs=LM_REDUCED) -> dict:
    """Phase 10 (e), 11 (d) and 12 (b): configs at reduce_config width:
    float32 on the card against float32 on the CPU (same weights), prefill
    then one decode step against a longer prefill, and bf16 on the card
    against float32; a MoE's prefill with the ``einsum`` dispatch against
    its default ``sort`` one (float32)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models.model import build

    out = {}
    for arch in archs:
        cfg = reduce_config(get_config(arch))
        m = build(cfg)
        cpu_params = m.init(torch.Generator().manual_seed(SEED))
        params = copy.deepcopy(cpu_params).to(dev)
        rng = np.random.default_rng(SEED)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)))
        extra, n_vis = {}, 0
        if cfg.family == "vlm":
            n_vis = cfg.n_vision_tokens
            extra["vision_embeds"] = torch.from_numpy(
                rng.normal(size=(2, n_vis, cfg.d_model)).astype(np.float32))
        if cfg.family == "encdec":
            extra["frames"] = torch.from_numpy(
                rng.normal(size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
        card_extra = {k: v.to(dev) for k, v in extra.items()}
        with lm_compute_dtype(torch.float32):
            host, _ = m.prefill(cpu_params, 16, tokens=tokens, **extra)
            full, _ = m.prefill(params, 16, tokens=tokens.to(dev), **card_extra)
            part, cache = m.prefill(params, 16, tokens=tokens[:, :8].to(dev),
                                    **card_extra)
            pos = torch.full((2,), n_vis + 8, dtype=torch.int32, device=dev)
            step, _ = m.decode_step(params, tokens[:, 8:].to(dev), cache, pos)
            if cfg.family == "moe":
                me = build(dataclasses.replace(cfg, moe_dispatch="einsum"))
                le, _ = me.prefill(params, 16, tokens=tokens.to(dev))
        r_host, _ = lm_compare(full.cpu(), host, LM_F32_TOL, f"{arch} card vs CPU")
        r_step, _ = lm_compare(step, full, LM_F32_TOL, f"{arch} prefill+decode")
        l16, _ = m.prefill(params.to(torch.bfloat16), 16, tokens=tokens.to(dev),
                           **card_extra)
        r16, _ = lm_compare(l16, full, LM_BF16_TOL, f"{arch} bf16 vs float32")
        out[arch] = {"card_vs_cpu_f32_rel": r_host, "decode_vs_prefill_f32_rel":
                     r_step, "bf16_vs_f32_rel": r16}
        moe = ""
        if cfg.family == "moe":
            r_moe, _ = lm_compare(le, full, LM_F32_TOL, f"{arch} einsum vs sort")
            out[arch]["einsum_vs_sort_f32_rel"] = r_moe
            moe = f"; einsum vs sort dispatch float32 {r_moe:.3e}"
        what = {"vlm": ", vision prefix", "encdec": ", frames"}.get(cfg.family, "")
        print(f"lm {arch} (reduced{what}): card "
              f"vs CPU float32 {r_host:.3e}, prefill+decode vs prefill "
              f"{r_step:.3e} (tolerance {LM_F32_TOL}); bf16 vs float32 "
              f"{r16:.3e} (tolerance {LM_BF16_TOL}){moe} [{card}]")
    return out


def lm_moe_dispatch(cfg, m, params, dev, card) -> dict:
    """Phase 11 (a): the first layer's MoE block at full width, dropless
    (as served), on a B x S input from the generator: ``einsum`` against
    the default ``sort`` dispatch, and the ms of each (median of 5)."""
    from repro_torch.models.moe import moe_block

    batch, seq = LM_FAMILIES[0][1:3]
    p = params.layers[0]["b0_attn_moe"].moe
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = torch.randn(batch, seq, cfg.d_model, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    res = {}
    for dispatch in ("sort", "einsum"):
        def run():
            return moe_block(p, h, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor, act=cfg.act,
                             dispatch=dispatch, normalize=cfg.normalize_topk,
                             dropless=True)
        with torch.no_grad():
            res[dispatch] = run()[0]
            res[dispatch + "_ms"] = float(np.median([synced_ms(run)[1]
                                                     for _ in range(5)]))
    rel = float((res["einsum"].float() - res["sort"].float()).abs().max()
                / res["sort"].float().abs().max())
    require(bool(torch.isfinite(res["sort"]).all()) and rel <= LM_BF16_TOL,
            f"{cfg.name} layer 0 MoE: einsum vs sort {rel:.3e}")
    print(f"lm {cfg.name} layer 0 MoE block, dropless B={batch} S={seq} (E="
          f"{cfg.n_experts}, k={cfg.top_k}, capacity {seq}): einsum vs sort "
          f"dispatch {rel:.3e} of max|out| (tolerance {LM_BF16_TOL}); sort "
          f"{res['sort_ms']:.3f} ms, einsum {res['einsum_ms']:.3f} ms [{card}]")
    return {"moe_einsum_vs_sort_rel": rel, "moe_sort_ms": res["sort_ms"],
            "moe_einsum_ms": res["einsum_ms"]}


def lm_long_row(cfg, m, params, dev, card) -> dict:
    """Phase 11 (c): one row of LM_LONG_SEQ tokens, past the hybrid's local
    window and over several RG-LRU chunks: prefill(S) against prefill(S-1)
    and one decode step, logits and every cache tensor (the rolling
    buffers' positions exactly)."""
    seq = LM_LONG_SEQ
    require(seq > cfg.local_window and seq > 2 * cfg.rnn_chunk,
            "the long row does not pass the window and two chunks")
    tokens = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab, (1, seq))).to(dev)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    (full, cache_full), ms = synced_ms(lambda: m.prefill(params, seq,
                                                         tokens=tokens))
    peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
    _, cache = m.prefill(params, seq, tokens=tokens[:, :-1])
    pos = torch.full((1,), seq - 1, dtype=torch.int32, device=dev)
    step, cache = m.decode_step(params, tokens[:, -1:], cache, pos)
    rel, rows = lm_compare(step, full, LM_BF16_TOL,
                           f"{cfg.name} prefill({seq - 1}) + decode vs prefill({seq})")
    blocks = [(f"layers/{key}", block, cache_full["layers"][key])
              for key, block in cache["layers"].items()]
    blocks += [(f"tail/{i}", block, cache_full["tail"][i])
               for i, block in enumerate(cache.get("tail", []))]
    rel_cache = 0.0
    for where, block, want in blocks:
        for name, got in block.items():
            if name == "pos":
                require(torch.equal(got, want[name]),
                        f"{cfg.name} long row: {where} positions differ")
            else:
                w = want[name].float()
                rel_cache = max(rel_cache, float((got.float() - w).abs().max()
                                                 / w.abs().max()))
    require(rel_cache <= LM_BF16_TOL, f"{cfg.name} long row caches: {rel_cache:.3e}")
    work = lm_work(cfg, params, 1, seq, seq)
    print(f"lm {cfg.name} long row B=1 S={seq} (local window "
          f"{cfg.local_window}, {-(-seq // cfg.rnn_chunk)} RG-LRU chunks): "
          f"prefill {ms:.3f} ms (bound {work['prefill_bound_ms']:.3f} ms, "
          f"{work['prefill_bound_by']}; peak {peak:.3f} GB above resident); "
          f"prefill({seq - 1}) + 1 decode step vs prefill({seq}): logits "
          f"{rel:.3e} of max|logit| ({rows} argmax held), caches {rel_cache:.3e}, "
          f"positions equal, tolerance {LM_BF16_TOL} [{card}]")
    return {"long_seq": seq, "long_prefill_ms": ms, "long_peak_gb": peak,
            "long_prefill_bound_ms": work["prefill_bound_ms"],
            "long_prefill_bound_by": work["prefill_bound_by"],
            "long_step_vs_prefill_rel": rel, "long_cache_rel": rel_cache}


def phase11(dev, card) -> dict:
    """Phase 11: LM serving for the MoE and recurrent families. Returns its
    part of the ``lm`` record."""
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    require(resident <= LM_RESIDENT_GB,
            f"earlier phases leave {resident:.3f} GB on the card")
    counts = Counts()
    counts.reset()
    from repro_torch.configs import get_config

    extras = {"moe": lm_moe_dispatch, "hybrid": lm_long_row}
    lm = {}
    for arch, batch, prompt, gen, steps in LM_FAMILIES:
        lm[arch] = lm_serve(arch, batch, prompt, gen, dev, card, steps=steps,
                            extra=extras.get(get_config(arch).family))
        torch.cuda.empty_cache()
    lm["reduced_families"] = lm_reduced(dev, card, LM_FAMILIES_REDUCED)
    launched = counts.read()
    require(not any(launched.values()),
            f"the LM path launched a TM kernel: {launched}")
    lm["phase11_tm_kernel_launches"] = launched
    print(f"phase 11 launches: {launched} (the MoE, RWKV and Griffin paths "
          f"reach no Pallas kernel of the reference, so none of the five; "
          f"{resident:.3f} GB resident before it)")
    return lm


# ---------------------------------------------------------------------------
# Phase 12: the encoder-decoder family and LM training
# ---------------------------------------------------------------------------


def whisper_work(cfg, params, batch: int, prompt: int, cache_tokens: int) -> dict:
    """Least time (ms) of whisper's prefill of ``batch`` x ``prompt``
    decoder tokens over ``cfg.enc_seq`` frames, and of one decode step
    over ``cache_tokens`` cached tokens per row. Prefill: every weight
    read once, the frames read and the cross K/V written; FLOPs of the
    encoder (products and full attention), the cross K/V projections, the
    decoder (products, causal and cross attention) and the logits at the
    last position. Decode: the decoder's weights but the cross-attention's
    ``wk`` / ``wv``, the tied table whole (the unembedding), the cross K/V
    and the self-attention cache read; FLOPs of the products and both
    attentions. bf16 weights and activations."""
    elt = next(params.parameters()).element_size()
    d, h, hd, s_enc = cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.enc_seq
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers

    def count(prefix):
        return sum(p.numel() for n, p in params.named_parameters()
                   if n.startswith(prefix))

    enc, dec = count("enc_layers."), count("layers.")
    table = params.embed.tokens.numel()
    xkv = n_dec * 2 * d * h * hd                  # cross wk, wv
    cross_bytes = n_dec * 2 * batch * s_enc * h * hd * elt
    pairs = prompt * (prompt + 1) / 2
    enc_flops = 2 * enc * batch * s_enc + 4 * batch * h * hd * s_enc ** 2 * n_enc
    prefill_flops = (enc_flops + 2 * xkv * batch * s_enc
                     + 2 * (dec - xkv) * batch * prompt
                     + 4 * batch * h * hd * (pairs + prompt * s_enc) * n_dec
                     + 2 * table * batch)
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    prefill_bytes = w_bytes + batch * s_enc * d * elt + cross_bytes
    kv_bytes = n_dec * 2 * batch * cfg.n_kv_heads * hd * cache_tokens * elt
    decode_bytes = (dec - xkv + table) * elt + cross_bytes + kv_bytes
    decode_flops = (2 * (dec - xkv + table) * batch
                    + 4 * batch * h * hd * (cache_tokens + s_enc) * n_dec)

    def t(nbytes, flops):
        return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS_PER_S) * 1e3

    def by(nbytes, flops):
        return ("bytes" if nbytes / PEAK_BYTES_PER_S
                >= flops / PEAK_BF16_FLOPS_PER_S else "operations")

    return {"prefill_bound_ms": t(prefill_bytes, prefill_flops),
            "prefill_bound_by": by(prefill_bytes, prefill_flops),
            "decode_bound_ms": t(decode_bytes, decode_flops),
            "decode_bound_by": by(decode_bytes, decode_flops),
            "encoder_flops": enc_flops, "cross_kv_bytes": cross_bytes,
            "weight_bytes_read": w_bytes, "kv_bytes": kv_bytes}


def train_work(cfg, params, batch: int, seq: int) -> dict:
    """Least time (ms) of one training step of ``batch`` x ``seq`` tokens:
    6 FLOPs per matrix parameter per token it sees (a table's gather is no
    product), 2 more per block parameter per token for the recomputed
    forward with ``cfg.remat``, and attention (forward 4·B·H·Dh per pair
    per layer, backward twice that, the recomputation once more) over the
    bf16 rate; against the optimizer's float32 traffic (parameters,
    gradients and both moments read; the parameters and moments written)
    over the memory rate; the larger. An LM's blocks and unembedding see
    the ``batch·seq`` tokens over causal pairs. Whisper's encoder blocks
    see ``batch·enc_seq`` frames over full pairs, as do the cross K/V
    projections (outside the recomputed block); the rest of the decoder
    and the tied unembedding see the tokens, over causal and cross pairs."""
    names = dict(params.named_parameters())
    n_all = sum(p.numel() for p in names.values())
    table = names["embed.tokens"].numel()

    def count(*prefixes, has=""):
        return sum(p.numel() for n, p in names.items()
                   if n.startswith(prefixes) and has in n)

    tokens = batch * seq
    pairs = seq * (seq + 1) / 2
    per_pair = 4 * batch * cfg.n_heads * cfg.head_dim_
    if cfg.family == "encdec":
        frames = batch * cfg.enc_seq
        enc = count("enc_layers.")
        xkv = count("layers.", has=".xattn.wk.") + count("layers.",
                                                         has=".xattn.wv.")
        dec = count("layers.") - xkv
        products = enc * frames + xkv * frames + (dec + table) * tokens
        recomputed = enc * frames + dec * tokens
        attn_fwd = per_pair * (cfg.enc_seq ** 2 * cfg.n_enc_layers
                               + (pairs + seq * cfg.enc_seq) * cfg.n_layers)
    else:
        blocks = count("layers.", "tail.")
        head = table if cfg.tie_embeddings else names["lm_head.weight"].numel()
        products = (blocks + head) * tokens
        recomputed = blocks * tokens
        attn_fwd = per_pair * pairs * cfg.n_layers
    flops = (6 * products + 3 * attn_fwd
             + ((2 * recomputed + attn_fwd) if cfg.remat else 0))
    nbytes = 7 * 4 * n_all
    t_ops = flops / PEAK_BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"step_bound_ms": max(t_ops, t_bytes),
            "step_bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "step_flops": flops, "optimizer_bytes": nbytes}


def whisper_frames(cfg, batch: int, dev) -> torch.Tensor:
    """Stub frame embeddings: ``default_rng(0).normal x 0.02`` in bf16."""
    rng = np.random.default_rng(SEED)
    return torch.from_numpy((rng.normal(size=(batch, cfg.enc_seq, cfg.d_model))
                             * 0.02).astype(np.float32)).to(
        device=dev, dtype=torch.bfloat16)


def whisper_serve(dev, card) -> dict:
    """Phase 12 (a): whisper-medium at full width through the ``Model``
    facade (the serve CLI refuses encdec, as the reference's does): prefill
    of ``WHISPER_SERVE`` prompts over the frames and greedy decode, twice
    (the second reported, both must generate the same tokens); the bf16
    prefill against a float32 one, and a prefill of the first token plus
    the remaining prompt tokens as decode steps against the full prefill;
    logits compared over the real vocabulary (the pad columns read
    -2**30)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build

    batch, prompt, gen, cache_len = WHISPER_SERVE
    cfg = get_config("whisper-medium")
    m = build(cfg)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    params = m.init(torch.Generator(device=dev).manual_seed(serve.SEED))
    n_params = sum(p.numel() for p in params.parameters())
    frames = whisper_frames(cfg, batch, dev)
    prompts = serve.make_prompts(cfg, batch, prompt, dev)
    with lm_compute_dtype(torch.float32):
        l32, _ = m.prefill(params, cache_len, tokens=prompts, frames=frames)
    params = params.to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()

    def serve_once():
        (logits, cache), t_pre = synced_ms(lambda: m.prefill(
            params, cache_len, tokens=prompts, frames=frames))
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        out = [tok]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(gen - 1):
            pos = torch.full((batch,), prompt + i, dtype=torch.int32, device=dev)
            logits, cache = m.decode_step(params, tok, cache, pos)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            out.append(tok)
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) * 1e3 / (gen - 1)
        return torch.cat(out, 1).cpu().numpy(), t_pre, t_dec, logits, cache

    first = serve_once()[:3]
    gens, t_pre, t_dec, logits, cache = serve_once()
    peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
    require(np.array_equal(first[0], gens), "whisper: two runs generated "
            "different tokens")
    require(bool((logits[:, cfg.vocab:] == -2.0 ** 30).all()),
            "whisper: pad columns are not masked")
    v = cfg.vocab
    l16, _ = m.prefill(params, cache_len, tokens=prompts, frames=frames)
    require(np.array_equal(l16.argmax(-1).cpu().numpy(), gens[:, 0]),
            "whisper: the first token is not the prefill's argmax")
    rel32, rows32 = lm_compare(l16[:, :v], l32[:, :v], LM_BF16_TOL,
                               "whisper-medium bf16 vs float32")
    del l32
    step, dcache = m.prefill(params, cache_len, tokens=prompts[:, :1],
                             frames=frames)
    for i in range(1, prompt):
        pos = torch.full((batch,), i, dtype=torch.int32, device=dev)
        step, dcache = m.decode_step(params, prompts[:, i:i + 1], dcache, pos)
    rel_dec, rows_dec = lm_compare(step[:, :v], l16[:, :v], LM_BF16_TOL,
                                   f"whisper-medium prefill(1) + {prompt - 1} "
                                   "decode steps vs prefill")
    shapes = {part: {k: (tuple(x.shape), str(x.dtype)) for k, x in block.items()}
              for part, block in cache.items()}
    require(shapes["cross"]["k"][0] == (cfg.n_layers, batch, cfg.enc_seq,
                                        cfg.n_heads, cfg.head_dim_),
            f"whisper cross cache {shapes['cross']}")
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    pos = torch.full((batch,), prompt + gen - 1, dtype=torch.int32, device=dev)
    prof = lm_profile(lambda: m.decode_step(params, tok, cache, pos),
                      f"whisper-medium decode step B={batch}", card)
    work = whisper_work(cfg, params, batch, prompt, prompt + gen // 2)
    out = {"param_count": n_params, "param_bytes": 2 * n_params,
           "batch": batch, "prompt_len": prompt, "gen": gen,
           "cache_len": cache_len, "cache": shapes,
           "prefill_ms": t_pre, "prefill_tok_s": batch * prompt / t_pre * 1e3,
           "decode_ms_per_step": t_dec, "decode_tok_s": batch / t_dec * 1e3,
           "first_prefill_ms": first[1], "first_decode_ms_per_step": first[2],
           "peak_gb_above_resident": peak, "bf16_vs_f32_rel": rel32,
           "bf16_vs_f32_rows": rows32, "decode_vs_prefill_rel": rel_dec,
           "decode_vs_prefill_rows": rows_dec, "decode_profile": prof, **work}
    print(f"lm whisper-medium (full width, {n_params} params, "
          f"{2 * n_params / 1e9:.3f} GB bf16; cross K/V "
          f"{work['cross_kv_bytes'] / 1e9:.3f} GB) B={batch} frames="
          f"{cfg.enc_seq} prompt={prompt} gen={gen}: prefill {t_pre:.3f} ms "
          f"({out['prefill_tok_s']:.0f} tok/s; bound "
          f"{work['prefill_bound_ms']:.3f} ms, {work['prefill_bound_by']}), "
          f"decode {t_dec:.3f} ms/step ({out['decode_tok_s']:.0f} tok/s; bound "
          f"{work['decode_bound_ms']:.3f} ms, {work['decode_bound_by']}); first "
          f"run {first[1]:.3f} / {first[2]:.3f}; peak {peak:.3f} GB above "
          f"resident; bf16 vs float32 prefill {rel32:.3e} of max|logit| "
          f"({rows32} of {batch} argmax held), prefill(1) + {prompt - 1} decode "
          f"steps vs prefill {rel_dec:.3e} ({rows_dec} held), tolerance "
          f"{LM_BF16_TOL} [{card}]")
    return out


def train_batches(cfg, batch: int, seq: int, steps: int, dev, frames=None):
    """``TokenBatcher(seed=0)`` batches 0 … steps-1 on the card (made
    before the timed steps), with ``frames`` for encdec."""
    from repro_torch.data.pipeline import TokenBatcher

    batcher = TokenBatcher(cfg.vocab, batch, seq, seed=SEED)
    out = []
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batcher(i).items()}
        if frames is not None:
            b["frames"] = frames
        out.append(b)
    return out


def lm_train_row(arch: str, batch: int, seq: int, micro: int, steps: int, dev,
                 card, what: str, profile: bool = False) -> dict:
    """Phase 12 (c)-(e): ``steps`` steps of ``make_train_step`` at full
    width (``cfg.remat`` as published: on), ``compress="none"``, peak lr
    1e-3 after 5 warmup steps: step ms (each step ends in a device sync;
    the median of the steps after the first two, or the last one), tok/s,
    peak memory above what was resident, the metrics of every step."""
    from repro_torch import steps as steps_mod
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.model import build

    cfg = get_config(arch)
    require(cfg.remat, f"{arch}: remat is off in the published config")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step = steps_mod.make_train_step(
        cfg, ShapeSpec(what, "train", seq, batch), microbatches=micro,
        compress="none", peak_lr=1e-3, warmup_steps=5, total_steps=1000)
    params = steps_mod._init_for(build(cfg), cfg, torch.Generator(
        device=dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in params.parameters())
    state = steps_mod.init_train_state(params)
    frames = whisper_frames(cfg, batch, dev) if cfg.family == "encdec" else None
    batches = train_batches(cfg, batch, seq, steps, dev, frames)
    log, ms = [], []
    for i, b in enumerate(batches):
        (state, met), t = synced_ms(lambda: step.fn(state, b))
        log.append({k: float(v) for k, v in met.items()})
        ms.append(t)
        require(all(math.isfinite(x) for x in log[-1].values()),
                f"{arch} {what} step {i}: non-finite metrics {log[-1]}")
    peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
    step_ms = float(np.median(ms[2:])) if len(ms) > 2 else ms[-1]
    ckpt_gb = sum(t.numel() * t.element_size() for t in
                  steps_mod.train_state_to_ckpt(state).values()) / 1e9
    out = {"arch": arch, "batch": batch, "seq": seq, "microbatches": micro,
           "steps": steps, "param_count": n_params, "remat": cfg.remat,
           "step_ms": step_ms, "step_ms_all": ms,
           "tok_s": batch * seq / step_ms * 1e3, "peak_gb_above_resident": peak,
           "train_state_ckpt_gb": ckpt_gb, "metrics": log}
    out.update(train_work(cfg, params, batch, seq))
    if profile:
        b = batches[-1]
        out["step_profile"] = lm_profile(lambda: step.fn(state, b),
                                         f"{arch} train step B={batch} S={seq} "
                                         f"M={micro}", card)
    bound = f" (bound {out['step_bound_ms']:.3f} ms, {out['step_bound_by']})"
    print(f"lm train {arch} {what} (full width, {n_params} params, remat on) "
          f"B={batch} S={seq} M={micro}, {steps} steps: step {step_ms:.3f} ms"
          f"{bound}, {out['tok_s']:.0f} tok/s, first step {ms[0]:.3f} ms; peak "
          f"{peak:.3f} GB above resident; train-state checkpoint {ckpt_gb:.3f} "
          f"GB; nll {log[0]['nll']:.4f} -> {log[-1]['nll']:.4f}, loss "
          f"{log[-1]['loss']:.4f}, grad_norm {log[-1]['grad_norm']:.4f}, lr "
          f"{log[-1]['lr']:.2e} [{card}]")
    del state, params
    torch.cuda.empty_cache()
    return out


def reduced_train_checks(dev, card) -> dict:
    """Phase 12 (f): at ``reduce_config`` width in float32 (TF32 off): M=1
    against M=4 NLL; one step on the card against the CPU (``peak_lr=0``,
    so the first moment holds the clipped gradients); and
    ``launch.train.main(["--reduced", …])`` uninterrupted against a run of
    half the steps resumed from its checkpoint by a second ``main``, on the
    card, with and without ``torch.use_deterministic_algorithms``."""
    from repro_torch import steps as steps_mod
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import train
    from repro_torch.models.model import build

    out = {}
    shape = ShapeSpec("reduced", "train", 32, 8)
    with lm_compute_dtype(torch.float32):
        for arch in TRAIN_REDUCED:
            cfg = reduce_config(get_config(arch))
            host = steps_mod.init_train_state(
                build(cfg).init(torch.Generator().manual_seed(SEED)))
            b_host = train_batches(cfg, 8, 32, 1, torch.device("cpu"))[0]
            b_card = {k: v.to(dev) for k, v in b_host.items()}
            nll = {}
            for micro in (1, 4):
                card_state = steps_mod.init_train_state(
                    copy.deepcopy(host["params"]).to(dev))
                st = steps_mod.make_train_step(cfg, shape, microbatches=micro,
                                               peak_lr=0.0, warmup_steps=0)
                card_state, met = st.fn(card_state, dict(b_card))
                nll[micro] = float(met["nll"])
            rel_m = abs(nll[1] - nll[4]) / abs(nll[1])
            require(rel_m <= 1e-5, f"{arch}: M=1 vs M=4 nll {nll}")
            host, met_h = st.fn(host, dict(b_host))        # M=4 on the CPU
            scale = max(float(t.abs().max()) for t in host["opt"].mu.values())
            err = max(float((card_state["opt"].mu[n].cpu() - t).abs().max())
                      for n, t in host["opt"].mu.items())
            require(err <= 1e-4 * scale, f"{arch}: card vs CPU gradients "
                    f"{err:.3e} of {scale:.3e}")
            out[arch] = {"micro_1_vs_4_nll_rel": rel_m,
                         "card_vs_cpu_grad_rel": err / scale}
            print(f"lm train {arch} (reduced, float32): M=1 vs M=4 nll "
                  f"{rel_m:.3e} (tolerance 1e-5); one step card vs CPU gradients "
                  f"{err / scale:.3e} of max|g| (tolerance 1e-4) [{card}]")
    argv = ["--reduced", "--steps", str(TRAIN_RESTART_STEPS), "--batch", "8",
            "--seq", "64"]
    half = argv[:2] + [str(TRAIN_RESTART_STEPS // 2)] + argv[3:]
    for deterministic in (False, True):
        # warn_only: an op with no deterministic form warns (named below)
        # instead of raising, and the run goes on
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            try:
                with tempfile.TemporaryDirectory() as tmp:
                    whole = train.main(argv + ["--ckpt-dir", f"{tmp}/whole"])
                    train.main(half + ["--ckpt-dir", f"{tmp}/resumed"])
                    resumed = train.main(argv + ["--ckpt-dir", f"{tmp}/resumed"])
            finally:
                torch.use_deterministic_algorithms(False)
        notes = sorted({str(w.message).splitlines()[0][:200] for w in caught
                        if "determinis" in str(w.message)})
        want = steps_mod.train_state_to_ckpt(whole["state"])
        got = steps_mod.train_state_to_ckpt(resumed["state"])
        differ = sorted(k for k in want if not torch.equal(got[k], want[k]))
        rel = max((float((got[k].float() - want[k].float()).abs().max()
                         / want[k].float().abs().max().clamp(min=1e-30))
                   for k in differ), default=0.0)
        key = "deterministic" if deterministic else "default"
        out[f"restart_{key}"] = {"bit_equal": not differ, "tensors_differ":
                                 len(differ), "first_differ": differ[:3],
                                 "max_rel": rel, "warnings": notes,
                                 "end_step": resumed["end_step"]}
        require(resumed["end_step"] == TRAIN_RESTART_STEPS,
                f"restart ended at {resumed['end_step']}")
        require(rel <= TRAIN_RESTART_TOL, f"restart ({key}): resumed train "
                f"state {rel:.3e} from the uninterrupted one")
        print(f"lm train CLI qwen3-1.7b (reduced) {TRAIN_RESTART_STEPS} steps "
              f"against {TRAIN_RESTART_STEPS // 2} + a restart from the "
              f"checkpoint ({key} algorithms): "
              + ("bit-equal" if not differ else
                 f"{len(differ)} of {len(want)} tensors differ (first "
                 f"{differ[:3]}), max {rel:.3e} relative, tolerance "
                 f"{TRAIN_RESTART_TOL}") + f"; warnings: {notes or 'none'} [{card}]")
    return out


def phase12(dev, card) -> dict:
    """Phase 12: whisper serving and LM training. Returns its part of the
    ``lm`` record."""
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    require(resident <= LM_RESIDENT_GB,
            f"earlier phases leave {resident:.3f} GB on the card")
    counts = Counts()
    counts.reset()
    lm = {"whisper-medium": whisper_serve(dev, card)}
    torch.cuda.empty_cache()
    lm["whisper_reduced"] = lm_reduced(dev, card, ("whisper-medium",))
    for key, arch, batch, seq, micro, n, what in TRAIN_ROWS:
        lm[key] = lm_train_row(arch, batch, seq, micro, n, dev, card, what,
                               profile=key == "train_qwen3")
    first, last = (lm["train_qwen3"]["metrics"][i]["nll"] for i in (0, -1))
    require(last <= first - 0.1, f"qwen3 training: nll {first} -> {last}")
    whisper_train = lm["train_whisper"]["metrics"]
    require(all(m["grad_norm"] > 0 for m in whisper_train),
            f"whisper training: zero gradient {whisper_train}")
    lm["reduced_train"] = reduced_train_checks(dev, card)
    launched = counts.read()
    require(not any(launched.values()),
            f"the LM path launched a TM kernel: {launched}")
    lm["phase12_tm_kernel_launches"] = launched
    print(f"phase 12 launches: {launched} (whisper and LM training reach no "
          f"Pallas kernel of the reference, so none of the five; "
          f"{resident:.3f} GB resident before it)")
    return lm


def k_shards(shape) -> str:
    d, c = shape
    return f"{d * c} shards on one card (cuda:0), mesh {d}x{c}"


def shard_collectives(mesh, steps: int = 1) -> dict:
    """The mesh's collective calls and payload bytes since its last reset,
    per step, by kind/axes."""
    snap = mesh.collectives.snapshot()
    return {part: {k: v / steps for k, v in sorted(d.items())}
            for part, d in snap.items()}


def decode_moved(coll: dict, mesh) -> dict:
    """A step's collective calls, payload bytes (every rank's input), the
    per-device result bytes (``trace.counter_stats``) and the payload
    all-gathered over ``data``, from ``shard_collectives``' per-step
    record."""
    from repro_torch.launch import trace

    stats = trace.counter_stats({"calls": coll["calls"], "bytes": {
        k: round(v) for k, v in coll["bytes"].items()}}, mesh)
    return {"calls": sum(coll["calls"].values()),
            "payload_bytes": sum(coll["bytes"].values()),
            "per_device_bytes": stats.total_bytes,
            "gather_data_bytes": coll["bytes"].get("all_gather/data", 0)}


def coll_line(coll: dict) -> str:
    return ", ".join(f"{k} {coll['calls'][k]:g} ({coll['bytes'][k] / 1e6:.3f} MB)"
                     for k in coll["calls"])


def shard_resident(what: str, tree, structs, specs, mesh) -> dict:
    """Require each rank's bytes of ``tree`` to be what ``specs`` predict."""
    from repro_torch import sharding

    got = sharding.tree_bytes(tree)
    want = sharding.predicted_bytes(structs, specs, mesh)
    require(got == [want] * mesh.size,
            f"{what}: per-rank bytes {got[:2]}… against {want} predicted")
    return {"per_rank_bytes": got[0], "predicted_per_rank_bytes": want,
            "ranks": mesh.size}


def cache_leaves(tree, path=""):
    """(path, tensor) of every leaf of a cache tree (dicts and lists)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from cache_leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from cache_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def cache_gaps(got, want, what: str) -> dict:
    """Every leaf of the gathered sharded cache against the unsharded one:
    positions required equal; for the others max|diff| over max|leaf|,
    over the whole leaf (the gated figure, as phase 13 has held it) and,
    printed, by layer where the leaf is stacked. Returns {path: (whole,
    [by layer])}."""
    got = dict(cache_leaves(got))
    out = {}
    for path, w in cache_leaves(want):
        g = got[path]
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"{what} cache {path}: {tuple(g.shape)} {g.dtype} against "
                f"{tuple(w.shape)} {w.dtype}")
        if path.endswith("/pos"):
            require(torch.equal(g, w), f"{what}: sharded cache positions "
                    f"{path} differ")
            continue
        w = w.double()
        d = (g.double() - w).abs()
        whole = float(d.max() / w.abs().max().clamp_min(1e-30))
        stacked = path.split("/")[1] in ("layers", "cross")
        out[path] = (whole, [float(a.max() / b.abs().max().clamp_min(1e-30))
                             for a, b in zip(d, w)] if stacked else [whole])
    return out


@torch.no_grad()
def rwkv_block_records(cfg, params, prompts, toks) -> dict:
    """The unsharded bf16 stream of an RWKV-6 model block by block: each
    block's input, output and state over the prompt (from a zero state),
    then each block's input and output for every decode token, and the
    final states."""
    from repro_torch.models import rwkv6, transformer

    batch, prompt = prompts.shape
    blocks = [g["b0_rwkv"] for g in params.layers]
    x = transformer.embed(params.embed, prompts, torch.bfloat16)
    positions = torch.arange(prompt, device=x.device)[None]
    pre, states = [], []
    for blk in blocks:
        zero = rwkv6.init_rwkv_state(batch, cfg.d_model, cfg.rwkv_heads,
                                     cfg.rwkv_head_dim, x.dtype, x.device)
        y, st, _ = transformer._apply_block(blk, cfg, "rwkv", x, positions,
                                            zero, False)
        pre.append((x, y, st))
        states.append(st)
        x = y
    dec = []
    for i, tok in enumerate(toks):
        x = transformer.embed(params.embed, tok, torch.bfloat16)
        pos = torch.full((batch, 1), prompt + i, dtype=torch.int32,
                         device=x.device)
        step = []
        for j, blk in enumerate(blocks):
            y, states[j], _ = transformer._apply_block(blk, cfg, "rwkv", x, pos,
                                                       states[j], True)
            step.append((x, y))
            x = y
        dec.append(step)
    return {"prefill": pre, "decode": dec, "states": states}


@torch.no_grad()
def rwkv_blockwise_sharded(cfg, sp, mesh, batch: int, cache_len: int,
                           records: dict, specs_out) -> dict:
    """Each RWKV-6 block of the sharded model (``transformer._block_sharded``)
    on the unsharded stream's input to that block, as ``rwkv_block_records``
    kept it: the prompt from a zero sharded state (sequence-split where the
    prefill step splits it), then every decode token (weight-stationary,
    the residual's d on ``data``, as the decode step lays it); outputs and states
    gathered and held against the unsharded block's at SHARD_LM_TOL of
    their max. Returns the worst gaps."""
    import dataclasses

    from repro_torch import sharding
    from repro_torch.models import transformer
    from repro_torch.steps import batch_axes_for

    policy = dataclasses.replace(sharding.Policy.for_mesh(mesh),
                                 batch_axes=batch_axes_for(batch, mesh))
    bspec = sharding.P(policy.batch_axes)
    # a decode step's residual: d on data, rows on the other batch axes
    rows = tuple(a for a in policy.batch_axes if a != sharding.DATA)
    dspec = sharding.P(rows or None, None, sharding.DATA)
    views = transformer.rank_views(sp)
    caches = transformer.init_cache_sharded(cfg, policy, batch, cache_len)
    key = "b0_rwkv"

    def block(j, x, positions, decode, seq_split):
        spec = dspec if decode else bspec
        xs = sharding.shard(x, spec, mesh)
        if seq_split:
            xs = transformer._seq_chunk(xs, mesh)
        c = [{n: t[r][j] for n, t in caches["layers"][key].items()}
             for r in range(mesh.size)]
        ys, _ = transformer._block_sharded(
            cfg, dataclasses.replace(policy, decode_mode=decode), sp.specs,
            [v.layers[j][key] for v in views], f"layers.{j}.{key}.", "rwkv",
            xs, positions, c, decode, seq_split)
        if seq_split:
            ys = sharding.all_gather(ys, mesh, sharding.MODEL, 1)
        return sharding.gather(ys, spec, mesh)

    def gap(g, w):
        return float((g.double() - w.double()).abs().max()
                     / w.double().abs().max())

    def state_gap(states):
        whole = sharding.gather_tree(caches, specs_out, mesh)["layers"][key]
        return max(gap(whole[n][j], st[n]) for j, st in enumerate(states)
                   for n in st)

    prompt = records["prefill"][0][0].shape[1]
    seq_split = policy.sequence_split(prompt)
    positions = torch.arange(prompt, device=records["prefill"][0][0].device)[None]
    worst = {"prefill": 0.0, "decode": 0.0}
    for j, (x, y, _) in enumerate(records["prefill"]):
        worst["prefill"] = max(worst["prefill"], gap(block(j, x, positions,
                                                           False, seq_split), y))
    worst["prefill_state"] = state_gap([st for _, _, st in records["prefill"]])
    for i, step in enumerate(records["decode"]):
        pos = torch.full((batch,), prompt + i, dtype=torch.int32,
                         device=step[0][0].device)
        pos_s = sharding.shard(pos, bspec, mesh)
        for j, (x, y) in enumerate(step):
            worst["decode"] = max(worst["decode"], gap(block(j, x, pos_s, True,
                                                             False), y))
    worst["decode_state"] = state_gap(records["states"])
    for what, g in worst.items():
        require(g <= SHARD_LM_TOL, f"{cfg.name} sharded block by block, "
                f"{what}: {g:.3e} of max|out| > {SHARD_LM_TOL}")
    return worst


@torch.no_grad()
def unsharded_serve(m, params, prompts, extra: dict, cache_len: int,
                    n_steps: int, vocab: int, toks=None):
    """Prefill then ``n_steps`` decode steps, greedy over the real
    vocabulary (or fed ``toks``). Returns (float32 logits per step, the
    tokens, the cache, prefill ms, decode ms per step)."""
    batch, prompt = prompts.shape
    (logits, cache), pre_ms = synced_ms(
        lambda: m.prefill(params, cache_len, tokens=prompts, **extra))
    want, fed, dec_ms = [logits.float()], [], []
    for i in range(n_steps):
        fed.append(logits[:, :vocab].argmax(-1)[:, None].to(torch.int32)
                   if toks is None else toks[i])
        pos = torch.full((batch,), prompt + i, dtype=torch.int32,
                         device=prompts.device)
        (logits, cache), t = synced_ms(
            lambda: m.decode_step(params, fed[-1], cache, pos))
        want.append(logits.float())
        dec_ms.append(t)
    return want, fed, cache, pre_ms, dec_ms


def sharded_serve(cfg, sp, mesh, prompts, extra: dict, cache_len: int, toks,
                  counts) -> dict:
    """The sharded prefill and decode steps (``make_*_step(cfg, shape,
    mesh)``) fed ``toks``, the four TM kernels' counts set to 0 just before
    and read just after: logits gathered per step, the cache, ms, the
    collectives of the prefill and per decode step."""
    from repro_torch import sharding, steps as steps_mod
    from repro_torch.configs.base import ShapeSpec

    batch, prompt = prompts.shape
    pstep = steps_mod.make_prefill_step(
        cfg, ShapeSpec("phase13", "prefill", cache_len, batch), mesh)
    dstep = steps_mod.make_decode_step(
        cfg, ShapeSpec("phase13", "decode", cache_len, batch), mesh)
    batch_s = sharding.shard_tree({"tokens": prompts, **extra},
                                  pstep.in_specs[1], mesh)
    counts.reset()
    mesh.collectives.reset()
    (lg, scache), pre_ms = synced_ms(lambda: pstep.fn(sp, batch_s))
    pre_coll = shard_collectives(mesh)
    got = [sharding.gather(lg, pstep.out_specs[0], mesh)]
    mesh.collectives.reset()
    dec_ms = []
    for i, tok in enumerate(toks):
        tok = sharding.shard(tok, dstep.in_specs[2], mesh)
        pos = sharding.shard(torch.full((batch,), prompt + i, dtype=torch.int32,
                                        device=prompts.device),
                             dstep.in_specs[3], mesh)
        (lg, scache), t = synced_ms(lambda: dstep.fn(sp, scache, tok, pos))
        got.append(sharding.gather(lg, dstep.out_specs[0], mesh))
        dec_ms.append(t)
    dec_coll = shard_collectives(mesh, len(toks))
    launched = counts.read()
    require(not any(launched.values()), f"{cfg.name} sharded: a TM kernel "
            f"launched: {launched}")
    return {"logits": got, "cache": scache, "pre_ms": pre_ms, "dec_ms": dec_ms,
            "pre_coll": pre_coll, "dec_coll": dec_coll, "launched": launched,
            "pstep": pstep, "dstep": dstep}


def decode_turns(cfg, sp, mesh, dstep, scache, tok, pos, rounds: int = 2):
    """ms of one decode step with the weights stationary (``dstep``, whose
    policy has ``decode_mode``) and of the same step with every weight
    gathered over ``data`` (that policy without ``decode_mode``), in turns
    (stationary, gathered, gathered, stationary per round) in one call on
    one card. The steps write into ``scache`` in place: timing only."""
    import dataclasses

    from repro_torch import sharding
    from repro_torch.models.model import build
    from repro_torch.steps import batch_axes_for

    m = build(cfg)
    gathered = dataclasses.replace(sharding.Policy.for_mesh(mesh),
                                   batch_axes=batch_axes_for(len(pos), mesh))
    steps_ = {"stationary": dstep.fn,
              "gathered": lambda p, c, t, q: m.decode_step(p, t, c, q,
                                                           policy=gathered)}
    tok = sharding.shard(tok, dstep.in_specs[2], mesh)
    pos = sharding.shard(pos, dstep.in_specs[3], mesh)
    ms = {"stationary": [], "gathered": []}
    for _ in range(rounds):
        for kind in ("stationary", "gathered", "gathered", "stationary"):
            _, t = synced_ms(lambda: steps_[kind](sp, scache, tok, pos))
            ms[kind].append(t)
    return ms


def logit_gap(got, want, vocab: int) -> float:
    """max |got - want| over max |want|, over the real vocabulary."""
    g, w = got[:, :vocab].double(), want[:, :vocab].double()
    return float((g - w).abs().max() / w.abs().max())


def float32_twin(cfg, m, params32, mesh, prompts, extra, cache_len, toks,
                 want16, cache16, counts) -> dict:
    """The same row in float32 (TF32 off), unsharded then sharded on
    ``params32`` (consumed), fed the bf16 run's tokens: logits and every
    cache leaf held at LM_F32_TOL. Also printed, not gated: how far bf16
    puts the unsharded run from float32 (logits and caches), the floor
    that bf16 rounding sets for any two bf16 runs summed in other orders."""
    from repro_torch import convert, sharding

    v = cfg.vocab
    with lm_compute_dtype(torch.float32):
        want32, _, cache32, _, _ = unsharded_serve(
            m, params32, prompts, extra, cache_len, len(toks), v, toks)
        sp32 = convert.shard_lm(params32, mesh, consume=True)
        run = sharded_serve(cfg, sp32, mesh, prompts, extra, cache_len, toks,
                            counts)
    whole = sharding.gather_tree(run["cache"], run["dstep"].out_specs[1], mesh)
    del sp32, run["cache"]
    rel = max(logit_gap(g, w, v) for g, w in zip(run["logits"], want32))
    gaps = cache_gaps(whole, cache32, f"{cfg.name} float32 sharded")
    cache_rel = max(g for g, _ in gaps.values())
    require(rel <= LM_F32_TOL and cache_rel <= LM_F32_TOL,
            f"{cfg.name} float32 sharded against unsharded: logits {rel:.3e}, "
            f"caches {cache_rel:.3e} > {LM_F32_TOL}")
    floor_logits = max(logit_gap(a, b, v) for a, b in zip(want16, want32))
    floor = {}
    w32 = dict(cache_leaves(cache32))
    for path, t in cache_leaves(cache16):
        if not path.endswith("/pos"):
            a, b = t.double(), w32[path].double()
            floor[path] = float((a - b).abs().max() / b.abs().max())
    del cache32, whole
    torch.cuda.empty_cache()
    return {"f32_sharded_vs_unsharded_logits_rel": rel,
            "f32_sharded_vs_unsharded_cache_rel": cache_rel,
            "bf16_vs_f32_unsharded_logits_rel": floor_logits,
            "bf16_vs_f32_unsharded_cache_rel": max(floor.values()),
            "bf16_vs_f32_unsharded_cache_rel_by_leaf": floor}


def shard_serve(arch: str, shape, batch: int, prompt: int, n_steps: int,
                cache_len: int, counts, dev, card) -> dict:
    """Phases 13 (a), (b) and 14 (a)-(c): bf16 at full width, unsharded
    first (prefill, then greedy decode), then the sharded prefill and
    decode steps on the same weights fed the same tokens; logits (over the
    real vocabulary, whisper's pad columns required masked and never an
    argmax) and every cache leaf held against the unsharded ones, or for
    an arch of LM_LAYERWISE printed and held block by block instead. An
    arch of SHARD_SERVE_F32_TWIN also runs ``float32_twin``."""
    from repro_torch import convert, sharding, steps as steps_mod
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build, cache_specs

    cfg = get_config(arch)
    by_block = arch in LM_LAYERWISE
    m = build(cfg)
    params32 = m.init(torch.Generator(device=dev).manual_seed(SEED))
    if arch in SHARD_SERVE_F32_TWIN:     # a bf16 copy beside the float32 one
        params = sharding.meta_copy(params32).to(torch.bfloat16).to_empty(
            device=dev)
        with torch.no_grad():
            for p, q in zip(params.parameters(), params32.parameters()):
                p.copy_(q)
    else:
        params = params32.to(torch.bfloat16)        # in place: one copy
        del params32
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (batch, prompt)).astype(np.int32)).to(dev)
    extra = ({"frames": whisper_frames(cfg, batch, dev)}
             if cfg.family == "encdec" else {})
    v = cfg.vocab
    want, toks, cache, pre_ms, dec_ms = unsharded_serve(
        m, params, prompts, extra, cache_len, n_steps, v)
    records = rwkv_block_records(cfg, params, prompts, toks) if by_block else None
    k = shape[0] * shape[1]
    mesh = make_mesh(*shape, devices=["cuda:0"] * k)
    twin = None
    if arch in SHARD_SERVE_F32_TWIN:
        twin = float32_twin(cfg, m, params32, mesh, prompts, extra, cache_len,
                            toks, want, cache, counts)
        del params32
    sp = convert.shard_lm(params, mesh, consume=True)
    del params
    torch.cuda.empty_cache()
    pshape = ShapeSpec("phase13", "prefill", cache_len, batch)
    run = sharded_serve(cfg, sp, mesh, prompts, extra, cache_len, toks, counts)
    pstep, dstep, scache, got = (run["pstep"], run["dstep"], run["cache"],
                                 run["logits"])
    s_pre_ms, s_dec_ms = run["pre_ms"], run["dec_ms"]
    pre_coll, dec_coll, launched = (run["pre_coll"], run["dec_coll"],
                                    run["launched"])
    for g in got:
        require(bool((g[:, v:] == -2.0 ** 30).all()) and
                int(g[:, :v].argmax(-1).max()) < v and
                int(g.argmax(-1).max()) < v,
                f"{arch} sharded: pad columns unmasked or an argmax among them")
    whole = sharding.gather_tree(scache, dstep.out_specs[1], mesh)
    gaps = cache_gaps(whole, cache, f"{arch} sharded")
    cache_rel = max(g for g, _ in gaps.values())
    print(f"lm sharded {arch} cache max|diff| of max|leaf| (whole leaf: by "
          f"layer): " + "; ".join(f"{p} {g:.2e}: " + " ".join(
              f"{x:.2e}" for x in by) for p, (g, by) in gaps.items()))
    rels, held = [], 0
    for i, (g, w) in enumerate(zip(got, want)):
        if by_block:
            rels.append(logit_gap(g, w, v))
            continue
        rel, rows = lm_compare(g[:, :v], w[:, :v], SHARD_LM_TOL,
                               f"{arch} sharded step {i}")
        rels.append(rel)
        held += rows
    blockwise = None
    if by_block:
        blockwise = rwkv_blockwise_sharded(cfg, sp, mesh, batch, cache_len,
                                           records, dstep.out_specs[1])
        del records
    elif twin is None:
        require(cache_rel <= SHARD_LM_TOL, f"{arch}: caches {cache_rel:.3e} of "
                f"max|leaf| against the unsharded run's")
    turns = decode_turns(cfg, sp, mesh, dstep, scache, toks[-1], torch.full(
        (batch,), prompt + n_steps, dtype=torch.int32, device=dev))
    res = {"params": shard_resident(f"{arch} params", sp, steps_mod
                                    ._serve_params_struct(cfg, pshape),
                                    pstep.in_specs[0], mesh),
           "cache": shard_resident(f"{arch} cache", scache,
                                   cache_specs(cfg, pshape), dstep.out_specs[1],
                                   mesh)}
    out = {"mesh": list(shape), "layout": k_shards(shape), "batch": batch,
           "prompt": prompt, "decode_steps": n_steps, "cache_len": cache_len,
           "prefill_ms": s_pre_ms, "decode_ms_per_step": float(np.median(s_dec_ms)),
           "unsharded_prefill_ms": pre_ms,
           "unsharded_decode_ms_per_step": float(np.median(dec_ms)),
           "max_rel": max(rels), "argmax_rows_held": held,
           "logits_gated": not by_block, "blockwise": blockwise,
           "float32_twin": twin,
           "cache_max_rel": cache_rel,
           "cache_rel_by_leaf": {p: g for p, (g, _) in gaps.items()},
           "cache_rel_by_layer": {p: by for p, (_, by) in gaps.items()},
           "resident": res,
           "decode_ms_turns": turns,
           "prefill_collectives": pre_coll, "decode_collectives_per_step": dec_coll,
           "tm_kernel_launches": launched}
    if by_block:
        held_line = (f"full depth (printed, not gated) logits {max(rels):.3e} of "
                     f"max|logit|, caches {cache_rel:.3e}; held block by block "
                     f"at {SHARD_LM_TOL}: prefill outputs "
                     f"{blockwise['prefill']:.3e}, states "
                     f"{blockwise['prefill_state']:.3e}, {n_steps} decode "
                     f"steps' outputs {blockwise['decode']:.3e}, states "
                     f"{blockwise['decode_state']:.3e}")
    elif twin is not None:
        held_line = (f"against unsharded max {max(rels):.3e} of max|logit| "
                     f"({held} argmax rows held, tolerance {SHARD_LM_TOL}), "
                     f"caches {cache_rel:.3e} (printed: bf16 itself puts the "
                     f"unsharded caches "
                     f"{twin['bf16_vs_f32_unsharded_cache_rel']:.3e} from "
                     f"float32; held in the float32 twin)")
    else:
        held_line = (f"against unsharded max {max(rels):.3e} of max|logit| "
                     f"({held} argmax rows held), caches {cache_rel:.3e}, "
                     f"tolerance {SHARD_LM_TOL}")
    print(f"lm sharded {arch} bf16 full width, {k_shards(shape)}: B={batch} "
          f"prefill {prompt} in {s_pre_ms:.3f} ms (unsharded {pre_ms:.3f}), "
          f"{n_steps} decode steps {out['decode_ms_per_step']:.3f} ms/step "
          f"(unsharded {out['unsharded_decode_ms_per_step']:.3f}); {held_line}; "
          f"per rank {res['params']['per_rank_bytes'] / 1e9:.4f} GB params and "
          f"{res['cache']['per_rank_bytes'] / 1e6:.3f} MB cache, as the specs "
          f"predict [{card}]")
    if twin is not None:
        print(f"lm sharded {arch} float32 twin (TF32 off), {k_shards(shape)}: "
              f"sharded against unsharded logits "
              f"{twin['f32_sharded_vs_unsharded_logits_rel']:.3e} of max|logit|, "
              f"caches {twin['f32_sharded_vs_unsharded_cache_rel']:.3e} "
              f"(tolerance {LM_F32_TOL}); bf16 against float32, both "
              f"unsharded (printed): logits "
              f"{twin['bf16_vs_f32_unsharded_logits_rel']:.3e}, caches "
              f"{twin['bf16_vs_f32_unsharded_cache_rel']:.3e} [{card}]")
    print(f"lm sharded {arch} collectives, prefill: {coll_line(pre_coll)}")
    print(f"lm sharded {arch} collectives per decode step: {coll_line(dec_coll)}")
    moved = decode_moved(dec_coll, mesh)
    out["decode_moved"] = moved
    print(f"lm sharded {arch} weight-stationary decode step moves "
          f"{moved['payload_bytes'] / 1e6:.3f} MB of payload in "
          f"{moved['calls']:g} calls ({moved['per_device_bytes'] / 1e6:.3f} MB "
          f"per device), {moved['gather_data_bytes'] / 1e6:.3f} MB of it "
          f"all-gathered over data; every weight gathered over data each step "
          f"moved {FSDP_DECODE_GATHER_GB[arch]} GB before; in turns in "
          f"this call, a decode step "
          f"{' '.join(f'{t:.3f}' for t in turns['stationary'])} ms stationary, "
          f"{' '.join(f'{t:.3f}' for t in turns['gathered'])} ms with every "
          f"weight gathered [{card}]")
    del sp, scache, cache
    torch.cuda.empty_cache()
    return out


def shard_train(row, counts, dev, card) -> dict:
    """Phases 13 (c) and 14 (d): one train step at full width (``row``'s
    last entry, when set, cuts the depth to that many layers), unsharded
    first (then freed), then sharded on the same initial weights and
    batch."""
    import dataclasses

    from repro_torch import convert, sharding, steps as steps_mod
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build

    arch, shape, batch, seq, micro, layers = row
    cfg = get_config(arch)
    depth = f"{cfg.n_layers} layers (published)"
    if layers is not None:
        depth = f"{layers} of {cfg.n_layers} layers (depth cut)"
        cfg = dataclasses.replace(cfg, n_layers=layers)
    require(cfg.remat, f"{arch}: remat is off in the published config")
    m = build(cfg)
    tshape = ShapeSpec("phase13", "train", seq, batch)
    kw = dict(microbatches=micro, compress="none", peak_lr=1e-3,
              warmup_steps=5, total_steps=1000)
    frames = whisper_frames(cfg, batch, dev) if cfg.family == "encdec" else None
    b = train_batches(cfg, batch, seq, 1, dev, frames)[0]

    def init():
        return m.init(torch.Generator(device=dev).manual_seed(SEED))

    def metrics(met):
        return {k_: float(v) for k_, v in met.items()}

    def unsharded():
        state = steps_mod.init_train_state(init())
        step = steps_mod.make_train_step(cfg, tshape, **kw)
        (state, met), ms = synced_ms(lambda: step.fn(state, dict(b)))
        del state
        torch.cuda.empty_cache()
        return metrics(met), ms

    k = shape[0] * shape[1]
    mesh = make_mesh(*shape, devices=["cuda:0"] * k)
    tstep = steps_mod.make_train_step(cfg, tshape, mesh, **kw)
    batch_s = sharding.shard_tree(b, tstep.in_specs[1], mesh)
    keys = ("nll", "grad_norm", "loss")

    def rel_to(got, want):
        return {key: abs(got[key] - want[key]) / abs(want[key]) for key in keys}

    twin = None
    if arch in SHARD_TRAIN_F32_TWIN:
        with lm_compute_dtype(torch.float32):
            want32, _ = unsharded()
            state = steps_mod.init_train_state(convert.shard_lm(
                init(), mesh, consume=True))
            state, met = tstep.fn(state, batch_s)
            got32 = metrics(met)
            del state, met
            torch.cuda.empty_cache()
        twin = {"f32_sharded_vs_unsharded": rel_to(got32, want32),
                "f32_unsharded": want32}
    want, ms_u = unsharded()
    if twin is not None:
        twin["bf16_vs_f32_unsharded"] = rel_to(want, twin["f32_unsharded"])
        for key, r in twin["f32_sharded_vs_unsharded"].items():
            require(r <= SHARD_LM_TOL, f"float32 sharded train step {key}: "
                    f"{r:.3e} relative")
    state = steps_mod.init_train_state(convert.shard_lm(init(), mesh,
                                                        consume=True))
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    mesh.collectives.reset()
    (state, met), ms_s = synced_ms(lambda: tstep.fn(state, batch_s))
    coll = shard_collectives(mesh)
    launched = counts.read()
    require(not any(launched.values()), f"sharded training: a TM kernel "
            f"launched: {launched}")
    peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
    got = metrics(met)
    rel = rel_to(got, want)
    for key, r in rel.items():
        if twin is not None and key == "grad_norm":
            continue                    # held in the float32 twin
        require(math.isfinite(got[key]) and r <= SHARD_LM_TOL,
                f"sharded train step {key}: {got[key]} against {want[key]}")
    res = shard_resident("train state", state, tstep.arg_structs[0],
                         tstep.in_specs[0], mesh)
    out = {"mesh": list(shape), "layout": k_shards(shape), "batch": batch,
           "seq": seq, "microbatches": micro, "remat": cfg.remat,
           "depth": depth, "step_ms": ms_s, "unsharded_step_ms": ms_u, "metrics": got,
           "unsharded_metrics": want, "rel": rel, "float32_twin": twin,
           "resident": res,
           "peak_gb_above_resident": peak, "collectives_per_step": coll,
           "tm_kernel_launches": launched}
    print(f"lm sharded train {arch} full width, {depth}, {k_shards(shape)}: B={batch} "
          f"S={seq} M={micro} remat, one step {ms_s:.3f} ms (unsharded "
          f"{ms_u:.3f}); nll {got['nll']:.5f} against {want['nll']:.5f} "
          f"({rel['nll']:.3e}), grad_norm {got['grad_norm']:.5f} against "
          f"{want['grad_norm']:.5f} ({rel['grad_norm']:.3e}), tolerance "
          f"{SHARD_LM_TOL}; train state {res['per_rank_bytes'] / 1e9:.4f} GB "
          f"per rank as the specs predict; peak {peak:.3f} GB above resident "
          f"[{card}]")
    if twin is not None:
        r32, floor = twin["f32_sharded_vs_unsharded"], twin["bf16_vs_f32_unsharded"]
        print(f"lm sharded train {arch} float32 twin (TF32 off): sharded against "
              f"unsharded nll {r32['nll']:.3e}, grad_norm {r32['grad_norm']:.3e} "
              f"relative (tolerance {SHARD_LM_TOL}; the bf16 grad_norm above is "
              f"printed, not gated); bf16 against float32, both "
              f"unsharded (printed): nll {floor['nll']:.3e}, grad_norm "
              f"{floor['grad_norm']:.3e} [{card}]")
    print(f"lm sharded train {arch} collectives per step: {coll_line(coll)}")
    del state
    torch.cuda.empty_cache()
    return out


def shard_pipeline(counts, dev, card) -> dict:
    """Phase 13 (d): ``gpipe_apply`` over qwen3-1.7b's layer groups against
    the sequential stack, bf16, forward."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.models.common import embed
    from repro_torch.models.model import build
    from repro_torch.models.pipeline import gpipe_apply

    arch, n_stages, n_micro, rows, seq = SHARD_LM_PIPE
    cfg = get_config(arch)
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(SEED)).to(
        torch.bfloat16)
    per = cfg.n_layers // n_stages
    require(per * n_stages == cfg.n_layers, f"{n_stages} stages of {arch}")
    blocks = [g["b0_attn_mlp"] for g in params.layers]
    stages = [blocks[s * per:(s + 1) * per] for s in range(n_stages)]
    positions = torch.arange(seq, device=dev)[None]

    def stage_fn(group, x):
        for blk in group:
            x, _, _ = transformer._attn_block_seq(blk, cfg, x, positions, None,
                                                  window=None)
        return x

    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (n_micro * rows, seq))).to(dev)
    x_micro = embed(params.embed, toks, torch.bfloat16).reshape(
        n_micro, rows, seq, cfg.d_model)
    mesh = make_mesh(n_stages, 1, devices=["cuda:0"] * n_stages)
    with torch.no_grad():
        want, seq_ms = synced_ms(lambda: torch.stack(
            [stage_fn(blocks, x) for x in x_micro]))
        counts.reset()
        mesh.collectives.reset()
        outs, pipe_ms = synced_ms(lambda: gpipe_apply(
            stage_fn, stages, x_micro, mesh=mesh, axis="data"))
        coll = shard_collectives(mesh)
        launched = counts.read()
    require(not any(launched.values()), f"gpipe: a TM kernel launched: {launched}")
    ticks = n_micro + n_stages - 1
    require(coll["calls"].get("ppermute/data") == ticks,
            f"gpipe: {coll['calls']} for {ticks} ticks")
    rel = max(float((o.double() - want.double()).abs().max()
                    / want.double().abs().max()) for o in outs)
    require(rel <= SHARD_LM_TOL, f"gpipe against the sequential stack: {rel:.3e}")
    stage_bytes = [sum(p.numel() * p.element_size() for blk in st
                       for p in blk.parameters()) for st in stages]
    layer_bytes = sum(p.numel() * p.element_size() for blk in blocks
                      for p in blk.parameters())
    require(stage_bytes == [layer_bytes // n_stages] * n_stages,
            f"gpipe: stage bytes {stage_bytes}")
    out = {"mesh": [n_stages, 1], "layout": k_shards((n_stages, 1)),
           "stages": n_stages, "layers_per_stage": per, "microbatches": n_micro,
           "rows": rows, "seq": seq, "ticks": ticks, "ms": pipe_ms,
           "sequential_ms": seq_ms, "max_rel": rel,
           "stage_bytes": stage_bytes[0], "predicted_stage_bytes":
           layer_bytes // n_stages, "collectives": coll,
           "tm_kernel_launches": launched}
    print(f"lm gpipe {arch} bf16, {n_stages} stages of {per} layers, "
          f"{k_shards((n_stages, 1))}: {n_micro} microbatches of {rows} x {seq} "
          f"in {ticks} ticks, {pipe_ms:.3f} ms (sequential {seq_ms:.3f}); "
          f"against the sequential stack {rel:.3e} (tolerance {SHARD_LM_TOL}); "
          f"{stage_bytes[0] / 1e9:.4f} GB of layers per stage as predicted; "
          f"collectives {coll_line(coll)} [{card}]")
    del params, outs, want
    torch.cuda.empty_cache()
    return out


def phase13(dev, card) -> dict:
    """Phase 13: the sharded LM path, k shards on ``cuda:0``. Returns its
    part of the ``lm`` record."""
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    require(resident <= LM_RESIDENT_GB,
            f"earlier phases leave {resident:.3f} GB on the card")
    counts = Counts()
    out = {}
    for arch, shape, batch, prompt, n_steps, clen in SHARD_LM_SERVE:
        out[f"sharded_{arch}"] = shard_serve(arch, shape, batch, prompt,
                                             n_steps, clen, counts, dev, card)
    out["sharded_train"] = shard_train(SHARD_LM_TRAIN, counts, dev, card)
    out["sharded_gpipe"] = shard_pipeline(counts, dev, card)
    require(not any(counts.total.values()),
            f"the sharded LM path launched a TM kernel: {counts.total}")
    print(f"phase 13 launches: {counts.total} (the sharded LM path reaches no "
          f"Pallas kernel of the reference, so none of the five; "
          f"{resident:.3f} GB resident before it)")
    return {"phase13": out}


def phase14(dev, card) -> dict:
    """Phase 14: the sharded RWKV-6, hybrid and whisper paths, k shards on
    ``cuda:0``. Returns its part of the ``lm`` record."""
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 1e9
    require(resident <= LM_RESIDENT_GB,
            f"earlier phases leave {resident:.3f} GB on the card")
    counts = Counts()
    counts.reset()
    out = {}
    for arch, shape, batch, prompt, n_steps, clen in SHARD_FAMILY_SERVE:
        t0 = time.perf_counter()
        out[f"sharded_{arch}"] = shard_serve(arch, shape, batch, prompt,
                                             n_steps, clen, counts, dev, card)
        out[f"sharded_{arch}"]["row_s"] = time.perf_counter() - t0
    for row in SHARD_FAMILY_TRAIN:
        t0 = time.perf_counter()
        out[f"sharded_train_{row[0]}"] = shard_train(row, counts, dev, card)
        out[f"sharded_train_{row[0]}"]["row_s"] = time.perf_counter() - t0
    counts.read()
    require(not any(counts.total.values()),
            f"phase 14 launched a TM kernel: {counts.total}")
    print(f"phase 14 launches: {counts.total} (the sharded RWKV-6, hybrid and "
          f"whisper paths reach no Pallas kernel of the reference, so none of "
          f"the four; {resident:.3f} GB resident before it)")
    return {"phase14": out}


def trace_tm_routes(counts, dev, card) -> dict:
    """Phase 15 (a): ``dryrun.run_tm_checks`` on the card, k ranks on
    ``cuda:0``: the even (2, 4) / 256 cell and the ragged (2, 3) / 128
    one, the four kernels' counts set to 0 just before and read just
    after, then the asynchronous checks."""
    from repro_torch.launch import dryrun

    counts.reset()
    recs = [dryrun.run_tm_checks(expect_composition="composed_even",
                                 device=dev.type, save=False),
            dryrun.run_tm_checks(data=2, model=3, n_clauses=128,
                                 expect_composition="composed_ragged",
                                 device=dev.type, save=False)]
    launched = counts.read()
    recorded = {k: 0 for k in launched}
    for r in recs:
        require(not r["failures"], f"dry-run TM checks on the card: "
                f"{r['failures']}")
        for part in [e["kernel_launches"] for e in r["engines"].values()] + [
                r["train_kernel_launches"]]:
            for k, v in part.items():
                recorded[k] += v
    require(launched == recorded, f"TM kernel launches {launched} against "
            f"the records' {recorded}")
    require_launched(launched, "the dry-run checks")
    counts.reset()
    arec = dryrun.run_tm_async_checks(device=dev.type, save=False)
    async_launched = counts.read()
    require(not arec["failures"], f"dry-run async checks on the card: "
            f"{arec['failures']}")
    for r in recs:
        print(f"trace tm {r['mesh']} / {r['n_clauses']} on {r['device']} "
              f"(k ranks on one card): one int32 reduction per scores call "
              f"for {sorted(r['engines'])}; kernel routes "
              f"{ {k: v['launches'] for k, v in r['backend_routes'].items()} }; "
              f"composition {r['train_step_sequential']['composition']} "
              f"[{card}]")
    print(f"trace tm: launches {launched}, equal to the records; async "
          + "; ".join(f"{k} sync {c['sync_count']} async {c['async_count']} "
                      f"refresh {c['refresh_count']}"
                      for k, c in arec["cells"].items()))
    return {"checks": recs, "async": arec, "launches": launched,
            "async_launches": async_launched}


def peak_ok(traced: int, measured: int) -> bool:
    return abs(traced - measured) <= max(TRACE_PEAK_TOL * measured,
                                         TRACE_PEAK_FLOOR)


def trace_vs_card(dev, card) -> dict:
    """Phase 15 (b): the trace of qwen3-1.7b's unsharded decode and
    prefill steps and of its (2, 4) decode step against a real run of
    each on the card: FLOPs (``FlopCounterMode``) and collective calls,
    payload and per-device bytes exactly, argument bytes per rank
    exactly, the peak of new bytes within the stated margin (a second
    run, after a warm-up)."""
    from repro_torch import sharding, steps as steps_mod
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, trace
    from repro_torch.launch.mesh import make_mesh

    cfg = get_config(TRACE_ARCH)
    batch, prompt, clen = TRACE_SERVE
    cases = (("decode", ShapeSpec("phase15", "decode", clen, batch), None),
             ("prefill", ShapeSpec("phase15", "prefill", prompt, batch), None),
             (f"decode_{TRACE_MESH[0]}x{TRACE_MESH[1]}",
              ShapeSpec("phase15", "decode", clen, batch), TRACE_MESH))
    out = {}
    for name, shape, mshape in cases:
        tmesh = (None if mshape is None else
                 dryrun.trace_mesh(mshape, device=dev.type))
        acct = trace.trace_step(steps_mod.make_step(cfg, shape, tmesh), cfg,
                                tmesh, device=dev)
        mesh = (None if mshape is None else
                make_mesh(*mshape, devices=[dev] * (mshape[0] * mshape[1])))
        step = steps_mod.make_step(cfg, shape, mesh)
        torch.cuda.empty_cache()
        args = trace.real_step_args(step, cfg, mesh, dev, seed=SEED)
        ranks = 1 if mesh is None else mesh.size
        resident = trace.tree_rank_bytes(args, ranks)
        params_rank = (sharding.tree_bytes(args[0])[0] if mesh is not None
                       else sum(trace.nbytes(p) for p in args[0].parameters()))
        if mesh is not None:
            mesh.collectives.reset()
        with trace.flop_counter() as fc:
            first = step.fn(*args)
        del first
        flops = fc.get_total_flops()
        counter = (mesh.collectives.snapshot() if mesh is not None
                   else {"calls": {}, "bytes": {}})
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        again = step.fn(*args)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - base
        del again, args
        cost, mem, coll = acct["cost"], acct["memory"], acct["collectives"]
        peak = (mem["peak_new_bytes_all_ranks"] if mesh is not None
                else mem["peak_new_bytes_per_device"])
        require(cost["flops_all_ranks_trace"] == flops,
                f"trace {name}: {cost['flops_all_ranks_trace']} FLOPs traced, "
                f"{flops} counted on the card")
        require(coll["counter"] == counter, f"trace {name}: collectives "
                f"{coll['counter']} traced, {counter} on the card")
        if mesh is not None:
            stats = trace.counter_stats(counter, mesh)
            require(stats.by_kind == coll["by_kind"], f"trace {name}: per-device "
                    f"collective bytes {coll['by_kind']} against {stats.by_kind}")
        require(mem["argument_bytes_per_device"] == max(resident),
                f"trace {name}: {mem['argument_bytes_per_device']} argument "
                f"bytes per device traced, {max(resident)} resident per rank")
        require(peak_ok(peak, rise), f"trace {name}: peak of new bytes "
                f"{peak} traced, {rise} measured")
        out[name] = {"flops": flops, "collectives": counter,
                     "argument_bytes_per_device": mem["argument_bytes_per_device"],
                     "params_bytes_per_rank": params_rank,
                     "peak_new_traced": peak, "peak_new_measured": rise,
                     "trace_s": acct["trace_s"], "ops": acct["ops"],
                     "by_kind": coll["by_kind"],
                     "collective_bytes_per_device": coll["total_bytes"]}
        print(f"trace {TRACE_ARCH} {name} bf16 full width"
              f"{'' if mesh is None else ', ' + k_shards(mshape)}: FLOPs "
              f"{flops} traced = card; collectives "
              f"{coll_line(counter) if counter['calls'] else 'none'} traced = "
              f"card ({coll['total_bytes']} bytes per device); arguments "
              f"{mem['argument_bytes_per_device'] / 1e9:.4f} GB per rank "
              f"traced = resident (params {params_rank / 1e9:.4f} GB); "
              f"peak of new bytes traced {peak / 2**20:.1f} MiB, measured "
              f"{rise / 2**20:.1f} MiB (margin {TRACE_PEAK_TOL:.0%} or "
              f"{TRACE_PEAK_FLOOR // 2**20} MiB); trace {acct['trace_s']:.2f} s "
              f"for {acct['ops']} ops [{card}]")
        torch.cuda.empty_cache()
    return out


def trace_train_peak(dev, card) -> dict:
    """Phase 15 (c): the traced peak of phase 12's qwen3-1.7b train step
    (``peak_estimate_per_device``: arguments + outputs + temporaries −
    aliases) against the card's peak over the state's allocation and one
    step, within ``TRACE_PEAK_TOL``; the FLOPs equal to
    ``trace.flop_counter()``'s over the real step."""
    from repro_torch import steps as steps_mod
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import trace

    cfg = get_config(TRACE_ARCH)
    require(cfg.remat, f"{TRACE_ARCH}: remat is off in the published config")
    batch, seq, micro = TRACE_TRAIN
    shape = ShapeSpec("phase15", "train", seq, batch)
    kw = dict(microbatches=micro, compress="none")
    acct = trace.trace_step(steps_mod.make_train_step(cfg, shape, **kw), cfg,
                            device=dev)
    step = steps_mod.make_train_step(cfg, shape, **kw)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    args = trace.real_step_args(step, cfg, None, dev, seed=SEED)
    with trace.flop_counter() as fc:
        state, met = step.fn(*args)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    flops = fc.get_total_flops()
    del state, met, args
    torch.cuda.empty_cache()
    traced = acct["memory"]["peak_estimate_per_device"]
    require(abs(traced - measured) <= TRACE_PEAK_TOL * measured,
            f"trace train peak {traced} against {measured} measured")
    require(acct["cost"]["flops_per_device_trace"] == flops,
            f"trace train: {acct['cost']['flops_per_device_trace']} FLOPs "
            f"traced, {flops} counted on the card")
    print(f"trace {TRACE_ARCH} train B={batch} x {seq} M={micro} remat, full "
          f"width: peak traced {traced / 1e9:.3f} GB (arguments "
          f"{acct['memory']['argument_bytes_per_device'] / 1e9:.3f} + temporaries "
          f"{acct['memory']['temp_bytes_per_device'] / 1e9:.3f}), measured "
          f"{measured / 1e9:.3f} GB (tolerance {TRACE_PEAK_TOL:.0%}); FLOPs "
          f"{flops} traced = card; trace {acct['trace_s']:.2f} s for {acct['ops']} ops "
          f"[{card}]")
    return {"peak_traced": traced, "peak_measured": measured,
            "memory": acct["memory"], "flops_traced":
            acct["cost"]["flops_per_device_trace"], "flops_card": flops,
            "trace_s": acct["trace_s"], "ops": acct["ops"]}


def trace_production(dev, card) -> dict:
    """Phase 15 (d), printed, not gated: ``lower_cell`` and ``analyze_cell``
    of TRACE_PRODUCTION on the 16 x 16 production mesh (fake CUDA tensors,
    256 ranks), its depth cut to TRACE_PRODUCTION_LAYERS (the roofline
    from the dry-run's record); the full depth's argument bytes per device
    from the specs."""
    from repro_torch import sharding, steps as steps_mod
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun, roofline

    arch, shape = TRACE_PRODUCTION
    over = {"n_layers": TRACE_PRODUCTION_LAYERS}
    t0 = time.perf_counter()
    rec = dryrun.lower_cell(arch, shape, cfg_override=over, save=False,
                            device=dev.type)
    roof = roofline.analyze_cell(arch, shape, cfg_override=over, record=rec,
                                 save=False, device=dev.type)
    wall = time.perf_counter() - t0
    mesh = dryrun.trace_mesh(device=dev.type)
    step = steps_mod.make_step(get_config(arch), get_shape(shape), mesh)
    full_args = sharding.predicted_bytes(step.arg_structs, step.in_specs, mesh)
    mem, t = rec["memory"], roof["terms"]
    share = t["collective_s"] / (t["compute_s"] + t["memory_s"]
                                 + t["collective_s"])
    print(f"trace production {arch} x {shape} on {rec['mesh']} "
          f"({rec['devices']} ranks, fake {rec['trace_device']} tensors), "
          f"{TRACE_PRODUCTION_LAYERS} of {get_config(arch).n_layers} layers "
          f"(depth cut): peak {mem['peak_estimate_per_device'] / 2**30:.3f} GiB "
          f"per device (arguments {mem['argument_bytes_per_device'] / 2**30:.3f}, "
          f"temporaries {mem['temp_bytes_per_device'] / 2**30:.3f}); "
          f"{rec['cost']['flops_per_device_trace']:.4g} FLOPs and "
          f"{rec['cost']['bytes_accessed_per_device_trace']:.4g} unfused bytes "
          f"per device; collectives {rec['collectives']['count']} calls, "
          f"{rec['collectives']['total_bytes'] / 2**20:.1f} MiB per device "
          f"{rec['collectives']['by_kind']}; roofline compute "
          f"{t['compute_s'] * 1e3:.3f} ms, memory {t['memory_s'] * 1e3:.3f} ms, "
          f"collective {t['collective_s'] * 1e3:.3f} ms ({t['dominant']}; "
          f"collectives {share:.1%} of the three terms); "
          f"trace {rec['times']['trace_s']} s for {rec['ops']} ops, "
          f"{wall:.1f} s in all; at full depth the arguments take "
          f"{full_args / 2**30:.3f} GiB per device (the specs) (printed, not "
          f"gated) [{card}]")
    return {"record": rec, "roofline": roof, "wall_s": wall,
            "collective_share": share,
            "layers": TRACE_PRODUCTION_LAYERS,
            "full_depth_argument_bytes_per_device": full_args}


def phase15(dev, card) -> dict:
    """Phase 15: the dry-run and roofline tools on the card. Returns its
    part of the ``lm`` record."""
    torch.cuda.empty_cache()
    counts = Counts()
    out = {"tm": trace_tm_routes(counts, dev, card)}
    counts.reset()
    t0 = time.perf_counter()
    out["vs_card"] = trace_vs_card(dev, card)
    out["train_peak"] = trace_train_peak(dev, card)
    launched = counts.read()
    require(not any(launched.values()),
            f"the traced LM steps launched a TM kernel: {launched}")
    out["lm_s"] = time.perf_counter() - t0
    out["production"] = trace_production(dev, card)
    return {"phase15": out}


def mla_core_errors(q, k, v, dout, pos, scale) -> dict:
    """The kernel's and bf16 ``_sdpa``'s max |Δ| against float32 ``_sdpa``
    (output, dq, dk, dv), each over the largest value of that truth; the
    kernel must stay within 1.25x of bf16 ``_sdpa`` (or under 2**-10 of the
    largest truth)."""
    from repro_torch.kernels import mla_attention
    from repro_torch.models import attention

    mask = attention._mask(pos, pos, "causal", None)

    def run(fn, dtype):
        ts = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        out = fn(*ts)
        out.backward(dout.to(out.dtype))
        return [out.detach().float()] + [t.grad.float() for t in ts]

    def sdpa(q_, k_, v_):
        return attention._sdpa(q_, k_, v_, mask, scale)
    truth = run(sdpa, torch.float32)
    ref16 = run(sdpa, torch.bfloat16)
    got = run(lambda q_, k_, v_: mla_attention.mla_attention(q_, k_, v_, pos, scale),
              torch.bfloat16)
    floor = 2 ** -10 * max(float(t.abs().max()) for t in truth)
    out = {}
    for name, t, r, g in zip(("out", "dq", "dk", "dv"), truth, ref16, got):
        e_ref, e_got = float((r - t).abs().max()), float((g - t).abs().max())
        require(e_got <= max(1.25 * e_ref, floor),
                f"mla core {name}: kernel error {e_got:.3e} > 1.25 x bf16 "
                f"_sdpa's {e_ref:.3e}")
        scale_t = float(t.abs().max())
        out[name] = {"kernel": e_got / scale_t, "sdpa_bf16": e_ref / scale_t}
    del truth, ref16, got
    torch.cuda.empty_cache()
    return out


def phase16(dev, card) -> dict:
    """Phase 16: the MLA attention core kernel (``csrc/mla_attention.cu``)
    at the training cell's microbatch (``MLA_CORE_SHAPE``, v a column slice
    of ``wkv_b``'s output as ``mla_attend`` hands it over): errors against
    float32 ``_sdpa`` beside bf16 ``_sdpa``'s; device ms of the forward and
    the backward (CUDA graphs) beside their bound (causal FLOPs at
    ``PEAK_BF16_FLOPS_PER_S``), bf16 ``_sdpa``'s ms and one PyTorch call that
    computes the same function (``library_ms``: the port never calls it);
    ``ptxas``'s registers and spills; then one train step of the cell's
    model (27 layers, 4 microbatches of 2 x 4,096, remat) whose launch
    counts must be 2 forward and 1 backward a layer a microbatch."""
    import torch.nn.functional as F

    from repro_torch import steps
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import _build, mla_attention
    from repro_torch.models import attention, transformer

    torch.cuda.empty_cache()
    b, s, h = MLA_CORE_SHAPE
    cfg = get_config("deepseek-v2-lite")
    scale = attention.mla_scale(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
    q, k, dout = rnd(b, s, h, 192), rnd(b, s, h, 192), rnd(b, s, h, 128)
    v = rnd(b, s, h, 256)[..., 128:]
    pos = torch.arange(s, device=dev, dtype=torch.int32)[None].expand(b, s).contiguous()
    errors = mla_core_errors(q, k, v, dout, pos, scale)

    out, lse, stats = mla_attention.attention_fwd(q, k, v, pos, scale)
    fwd_ms = device_ms(lambda: mla_attention.attention_fwd(q, k, v, pos, scale), 20)
    bwd_ms = device_ms(lambda: mla_attention.attention_bwd(
        q, k, v, pos, stats, out, lse, dout, scale), 10)
    flops = {d: 2.0 * b * h * d * s * (s + 1) / 2 for d in (320, 832)}
    mask = attention._mask(pos, pos, "causal", None)
    sdpa_fwd_ms = device_ms(lambda: attention._sdpa(q, k, v, mask, scale), 3)

    def train_ms(fn, reps):
        ts = [t.detach().requires_grad_() for t in (q, k, v)]
        return call_ms(lambda: fn(*ts).backward(dout), reps)
    sdpa_fb_ms = train_ms(lambda q_, k_, v_: attention._sdpa(q_, k_, v_, mask, scale), 3)
    kern_fb_ms = train_ms(lambda q_, k_, v_: mla_attention.mla_attention(
        q_, k_, v_, pos, scale), 10)
    library = {}
    try:   # a yardstick only: the port never calls it
        def lib(q_, k_, v_):
            return F.scaled_dot_product_attention(
                q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
                is_causal=True, scale=scale).transpose(1, 2)
        library = {"fwd_ms": device_ms(lambda: lib(q, k, v), 10),
                   "fwd_bwd_ms": train_ms(lib, 10)}
    except RuntimeError as exc:   # no PyTorch call takes these head dims
        library = {"fwd_ms": None, "fwd_bwd_ms": None, "error": repr(exc)[:200]}
    del out, lse, stats, mask
    torch.cuda.empty_cache()
    row = {"shape": [b, s, h, 192, 128], "errors": errors,
           "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
           "fwd_bound_ms": flops[320] / PEAK_BF16_FLOPS_PER_S * 1e3,
           "bwd_bound_ms": flops[832] / PEAK_BF16_FLOPS_PER_S * 1e3,
           "fwd_tflops": flops[320] / fwd_ms / 1e9, "bwd_tflops": flops[832] / bwd_ms / 1e9,
           "fwd_bwd_call_ms": kern_fb_ms, "sdpa_fwd_ms": sdpa_fwd_ms,
           "sdpa_fwd_bwd_ms": sdpa_fb_ms, "library_ms": library,
           "ptxas": ptxas_lines(_build.ptxas_report("mla_attention"))}
    print(f"mla core {row['shape']}: forward {fwd_ms:.4f} ms (bound "
          f"{row['fwd_bound_ms']:.4f}, {row['fwd_tflops']:.1f} TFLOP/s), backward "
          f"{bwd_ms:.4f} ms (bound {row['bwd_bound_ms']:.4f}, {row['bwd_tflops']:.1f} "
          f"TFLOP/s); forward + backward per call {kern_fb_ms:.3f} ms; bf16 _sdpa "
          f"forward {sdpa_fwd_ms:.3f} ms, forward + backward {sdpa_fb_ms:.3f} ms; "
          f"library {library}; errors {errors} [{card}]")
    for line in row["ptxas"]:
        print(f"ptxas [mla_attention.cu] {line}")

    # one step of the training cell's model: the kernels in every layer
    step_cfg = dataclasses.replace(cfg, experts_held=8, vocab=12800, remat=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    state = steps.init_train_state(transformer.init_params(gen, step_cfg))
    rows, micro = MLA_CORE_STEP
    step = steps.make_step(step_cfg, ShapeSpec("t", "train", s, rows),
                           microbatches=micro).fn
    ids = torch.randint(0, step_cfg.vocab, (rows, s + 1), generator=gen, device=dev)
    batch = {"tokens": ids[:, :-1].to(torch.int32), "labels": ids[:, 1:].to(torch.int32)}
    f0, b0 = mla_attention.attention_fwd.launches, mla_attention.attention_bwd.launches
    (state, metrics), step_ms = synced_ms(lambda: step(state, batch))
    launched = {"fwd": mla_attention.attention_fwd.launches - f0,
                "bwd": mla_attention.attention_bwd.launches - b0}
    layers = step_cfg.n_layers
    require(launched == {"fwd": 2 * layers * micro, "bwd": layers * micro},
            f"mla core launches in one step {launched}: want {2 * layers * micro} "
            f"forward and {layers * micro} backward")
    loss = float(metrics["loss"])
    require(math.isfinite(loss), f"mla step loss {loss}")
    row["step"] = {"launches": launched, "ms": step_ms, "loss": loss,
                   "peak_bytes": int(torch.cuda.max_memory_allocated())}
    print(f"mla step (27 layers, {micro} microbatches of {rows // micro} x {s}): "
          f"launches {launched}, {step_ms:.1f} ms (the first, cold), loss {loss:.4f}")
    del state, step, batch
    torch.cuda.empty_cache()
    return {"phase16": row}


def phase10(dev, card) -> dict:
    """Phase 10: LM serving. Returns the ``lm`` record."""
    torch.cuda.empty_cache()
    counts = Counts()
    counts.reset()
    lm = {}
    for arch, batch, prompt, gen in LM_SERVE:
        lm[arch] = lm_serve(arch, batch, prompt, gen, dev, card)
        torch.cuda.empty_cache()
    lm["decode_32k"] = lm_decode_32k(dev, card)
    torch.cuda.empty_cache()
    lm["blockwise_vs_dense"] = lm_blockwise(dev, card)
    torch.cuda.empty_cache()
    lm["reduced"] = lm_reduced(dev, card)
    launched = counts.read()
    require(not any(launched.values()),
            f"the LM path launched a TM kernel: {launched}")
    lm["tm_kernel_launches"] = launched
    print(f"phase 10 launches: {launched} (the LM path reaches no Pallas "
          f"kernel of the reference, so none of the five)")
    return lm


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.tm import PAPER_TM_CONFIGS
    from repro_torch.core.session import TMSession
    from repro_torch.core.types import TMState
    from repro_torch.kernels import _build, clause_eval, indexed
    from repro_torch.serving import AsyncTMServer, ScoreResult

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {sorted(libs)} with nvcc (one process per source, in "
          f"parallel) in {build_s:.2f} s")
    for src in sorted(libs):
        for line in ptxas_lines(_build.ptxas_report(src)):
            print(f"ptxas [{src}.cu] {line}")
    print(f"card: {card}")

    # -- 2. kernels vs plain at the tm_mnist width ----------------------------
    exp = PAPER_TM_CONFIGS["tm_mnist"]
    cfg = exp.tm
    m, n, L = cfg.n_classes, cfg.n_clauses, cfg.n_literals
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ta, inc = served_state(cfg, int(exp.avg_clause_len), gen, dev)
    state = TMState(ta_state=ta)
    session = TMSession(cfg, engines=("indexed", "bitpack", "dense"), device=dev)
    bundle = session.prepare(state)
    pos, words = bundle.index.pos, bundle.caches["bitpack"]
    print(f"state: m={m} n={n} 2o={L}, mean clause length "
          f"{float(inc.sum(-1).float().mean()):.2f} literals; pos "
          f"{pos.numel() * 4 / 1e6:.1f} MB, include words "
          f"{words.numel() * 4 / 1e6:.2f} MB")

    rows, x32 = {}, None
    for b in BATCHES:
        x = requests(inc, b, gen, dev)
        rows.update(vote_kernels(cfg, state, bundle.index, words, x, card, sms))
        x32 = x
    walk_cases(cfg, inc, x32, gen, dev, card)

    # -- 3. serve through the entry points ------------------------------------
    xs = requests(inc, N_REQUESTS, gen, dev)
    dense_rows = session.scores(bundle, xs, engine="dense").cpu().numpy()
    xs_host = xs.cpu().numpy()
    launches = {}
    counters = {"indexed": indexed.indexed_votes,
                "bitpack": clause_eval.clause_votes_packed}
    for engine, counter in counters.items():
        server = AsyncTMServer(session, bundle, engine=engine, max_batch=32)
        warm = server.aot.counters()
        indexed.indexed_votes.launches = 0
        clause_eval.clause_votes_packed.launches = 0
        server.start()
        try:
            t0 = time.perf_counter()
            promises = [server.submit(row, tenant=f"tenant{i % 2}")
                        for i, row in enumerate(xs_host)]
            submit_s = time.perf_counter() - t0
            results = [p.wait(120) for p in promises]
            wall = time.perf_counter() - t0
        finally:
            server.stop()
        launched = counter.launches
        launches[engine] = launched
        stats = server.stats()
        require(all(isinstance(r, ScoreResult) for r in results),
                f"{engine}: a request was not served: "
                f"{[r for r in results if not isinstance(r, ScoreResult)][:1]}")
        served = np.stack([r.scores for r in results])
        require(np.array_equal(served, dense_rows),
                f"{engine}: served scores differ from the dense engine's")
        aot = server.aot.counters()
        require(aot["misses"] == 0, f"{engine}: bucket cache missed: {aot}")
        require(aot["lowerings"] == warm["lowerings"],
                f"{engine}: bucket entries prepared while serving: {aot}")
        require(launched >= stats["batches"] > 0,
                f"{engine}: kernel launched {launched} times for "
                f"{stats['batches']} batches")
        lat = np.asarray([r.latency_s for r in results]) * 1e3
        p50, p99 = np.percentile(lat, [50, 99])
        print(f"serve[{engine}]: {len(results)} requests from 2 tenants in "
              f"{stats['batches']} batches (mean {stats['rows_real'] / stats['batches']:.1f} "
              f"rows), {launched} kernel launches, latency p50 {p50:.3f} ms "
              f"p99 {p99:.3f} ms, {len(results) / wall:.1f} rows/s (submitting "
              f"took {submit_s * 1e3:.1f} of {wall * 1e3:.1f} ms), all equal to "
              f"dense [{card}]")

        # one full bucket, three ways: the device work of the engine's scores
        # (graph replay), a dispatch through the bucket cache from a host
        # array (returns before the device finishes), and the round trip to
        # host scores — device busy share = device / round trip
        top = server.sizes[-1]
        fn = session.lower_scores(bundle, top, engine=engine)
        xb_dev, xb_host = xs[:top].contiguous(), xs_host[:top]
        busy_ms = device_ms(lambda: fn(xb_dev), 20)
        disp_ms = np.median([_wall_ms(lambda: server.aot(
            xb_host, engine=engine, bucket=top), sync=True) for _ in range(50)])
        trip_ms = np.median([_wall_ms(lambda: server.aot(
            xb_host, engine=engine, bucket=top).cpu()) for _ in range(50)])
        print(f"batch[{engine}] B={top}: device {busy_ms:.4f} ms, dispatch "
              f"{disp_ms:.4f} ms, round trip {trip_ms:.4f} ms (medians of 50), "
              f"device busy {100 * busy_ms / trip_ms:.1f}% of the round trip "
              f"[{card}]")

    # -- 4. learning kernels vs plain ------------------------------------------
    rows.update(learning_kernels(cfg, ta, inc, gen, dev, card, sms))

    # -- 5. train through the entry points --------------------------------------
    trained = train(cfg, inc, gen, dev, card)

    # -- 7. sharded topologies, k shards on one card -------------------------
    shard_launches = sharded(cfg, state, inc, trained, gen, dev, card)

    # -- 8. compact, the open loop, tm_imdb ------------------------------------
    counts = Counts()
    compact_mnist(cfg, state, x32, xs_host, dense_rows, trained, counts, dev,
                  card)
    open_loop(cfg, counts, dev, card)
    imdb_rows = imdb(gen, counts, dev, card, sms)
    require_launched(counts.total, "phase 8")
    print(f"phase 8 launches: {counts.total}")

    # -- 9. oracles, wrappers, examples ------------------------------------------
    t0 = time.perf_counter()
    phase9_launches = phase9(cfg, state, inc, trained, gen, dev, card)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s wall")

    # -- 10. LM serving --------------------------------------------------------
    t0 = time.perf_counter()
    lm = phase10(dev, card)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s wall")

    # -- 11. LM serving: the MoE and recurrent families -------------------------
    t0 = time.perf_counter()
    lm.update(phase11(dev, card))
    print(f"phase 11: {time.perf_counter() - t0:.1f} s wall")

    # -- 12. whisper serving and LM training --------------------------------------
    t0 = time.perf_counter()
    lm.update(phase12(dev, card))
    print(f"phase 12: {time.perf_counter() - t0:.1f} s wall")

    # -- 13. the sharded LM path, k shards on one card ---------------------------
    t0 = time.perf_counter()
    lm.update(phase13(dev, card))
    print(f"phase 13: {time.perf_counter() - t0:.1f} s wall")

    # -- 14. the sharded RWKV-6, hybrid and whisper paths, k shards on one card
    t0 = time.perf_counter()
    lm.update(phase14(dev, card))
    print(f"phase 14: {time.perf_counter() - t0:.1f} s wall")

    # -- 15. the dry-run and roofline tools against the card -------------------
    t0 = time.perf_counter()
    lm.update(phase15(dev, card))
    print(f"phase 15: {time.perf_counter() - t0:.1f} s wall")

    # -- 16. the MLA attention core kernel -------------------------------------
    t0 = time.perf_counter()
    lm.update(phase16(dev, card))
    print(f"phase 16: {time.perf_counter() - t0:.1f} s wall")

    # -- 6. report ----------------------------------------------------------
    top = BATCHES[-1]

    def imdb_row(key):
        r = imdb_rows[key]
        return {k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "call_ms",
                                  "yardstick_ms", "pos_form_ms",
                                  "pos_stream_bound_ms", "hot_ms",
                                  "request_ms", "request_bound_ms") if k in r}

    kernels = []
    for kname, engine, src, replaces in (
            ("indexed_votes", "indexed", "src/repro_torch/csrc/indexed_votes.cu",
             "src/repro/kernels/indexed.py:103"),
            ("clause_votes_packed", "bitpack", "src/repro_torch/csrc/clause_eval.cu",
             "src/repro/kernels/clause_eval.py:45")):
        r = rows[(kname, top)]
        extra = {k: r[k] for k in ("pos_form_ms", "pos_stream_bound_ms")
                 if k in r}
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[engine],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        # the float32 matmul of the false literals with the
                        # include mask, which the dense (XLA) form of the
                        # votes is built on, is the one-call yardstick: the
                        # library time of indexed_votes, whose function it
                        # computes up to a threshold and a sum over clauses
                        "library_ms": (r["yardstick_ms"]
                                       if kname == "indexed_votes" else None),
                        "yardstick_ms": r["yardstick_ms"],
                        "call_ms": r["call_ms"], **extra,
                        "sharded_launches": shard_launches[kname],
                        "phase8_launches": counts.total[kname],
                        "phase9_launches": phase9_launches[kname],
                        "tm_imdb": imdb_row((kname, top))})
    # the learning kernels at the training round's shapes
    for kname, key, src, replaces in (
            # the counterpart of _outputs_kernel on ops.tm_clause_outputs only
            ("clause_outputs_packed", ("clause_outputs_packed", 1),
             "src/repro_torch/csrc/clause_eval.cu",
             "src/repro/kernels/clause_eval.py:121"),
            # the learning round's pack + _outputs_kernel + vote
            ("round_vote", ("round_vote", "full"),
             "src/repro_torch/csrc/clause_eval.cu",
             "src/repro/kernels/clause_eval.py:121"),
            ("ta_update", ("ta_update", True), "src/repro_torch/csrc/ta_update.cu",
             "src/repro/kernels/ta_update.py:35")):
        r = rows[key]
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": trained["launches"][kname],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        # no single PyTorch call computes either function
                        "library_ms": None, "call_ms": r["call_ms"],
                        "sharded_launches": shard_launches[kname],
                        "phase8_launches": counts.total[kname],
                        "phase9_launches": phase9_launches[kname],
                        "tm_imdb": imdb_row(key)})
    print(json.dumps({"lm": lm}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
