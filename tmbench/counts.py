"""The yardstick's arithmetic, frozen: peak rates of one H100 and the work
and bytes of each counted piece of the Tsetlin Machine's hot path.

Everything here is computed from shapes and from the benchmark's own
inputs (its include mask, its request rows, its reference replay), never
from the program's counters. The formulas are copies of the chip smoke's
(``bound``, ``walk_work``, the ``ta_update`` count) and of the paper's work
metric (``indexed_work`` / ``dense_work``, §3 "Remarks"), frozen here so
that a change to the program cannot move the yardstick.
"""
from __future__ import annotations

import math

import torch

# One H100 SXM. Memory: 3.35 TB/s (NVIDIA data sheet). The TM's work is
# 32-bit compare and logic instructions, not FLOPs: the CUDA C++
# Programming Guide's throughput table gives compute capability 9.0 64
# such results per clock per SM, half its 128 float32 FMAs, and the data
# sheet's 67 TFLOP/s float32 counts an FMA as two FLOPs, so the logic
# rate is 67e12 / 4 per second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_LOGIC_OPS_PER_S = 67e12 / 4


def bound_s(nbytes: float, ops: float) -> float:
    """Least time (s) for ``nbytes`` of memory traffic and ``ops`` logic
    instructions: the larger of the two."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_LOGIC_OPS_PER_S)


def dense_work(m: int, n: int, o: int) -> int:
    """Exhaustive evaluation's work per row: m·n·2o literal inspections."""
    return m * n * 2 * o


def literals(x: torch.Tensor) -> torch.Tensor:
    """(B, o) {0,1} rows → (B, 2o) uint8 literal truth values [x, ¬x]."""
    x = x.to(torch.uint8)
    return torch.cat([x, 1 - x], dim=-1)


def list_lengths(include: torch.Tensor) -> torch.Tensor:
    """(m, n, 2o) bool include mask → (m, 2o) int64 inclusion-list lengths."""
    return include.sum(1, dtype=torch.int64)


def falsifying_inclusions(include: torch.Tensor, x: torch.Tensor,
                          block: int = 4096) -> torch.Tensor:
    """(B,) int64: per row, the (clause, included literal) pairs whose
    literal is false on the row, the paper's work metric
    ``Σ_i Σ_{k false} |L[i,k]|``. Exact (float64 products of counts below
    2**53), in blocks of rows."""
    per_literal = list_lengths(include).sum(0).to(torch.float64)      # (2o,)
    out = []
    for start in range(0, x.shape[0], block):
        false_lit = (literals(x[start:start + block]) == 0).to(torch.float64)
        out.append(torch.mv(false_lit, per_literal).round().to(torch.int64))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64)


def work_ratio(include: torch.Tensor, x: torch.Tensor) -> float:
    """Mean falsifying inclusions per row over the dense work: the paper's
    §3 ratio (about 0.02 on MNIST, 0.006 on IMDb)."""
    m, n, two_o = include.shape
    mean = float(falsifying_inclusions(include, x).double().mean())
    return mean / dense_work(m, n, two_o // 2)


def walk_work(lengths: torch.Tensor, x: torch.Tensor,
              n_clauses: int) -> tuple[int, int, int]:
    """``(bytes, ops, ids)`` of the list walk over one batch ``x`` (B, o),
    on an index whose lists hold every member within their capacity (a
    fresh build at capacity n). For every list of a literal false in some
    row, its count and its ids (4 bytes each), then the literals (1 byte
    each), the polarities (4 bytes per clause) and the votes (4 bytes per
    row and class); one OR of a 32-row word per id and batch word."""
    m, two_o = lengths.shape
    b = x.shape[0]
    false_any = (literals(x) == 0).any(0)                             # (2o,)
    ids = int(lengths[:, false_any].sum())
    lists_read = m * int(false_any.sum())
    nbytes = 4 * (ids + lists_read) + b * two_o + 4 * n_clauses + 4 * b * m
    return nbytes, ids * math.ceil(b / 32), ids


def score_batch_work(falsifying: int, rows: int, o: int, m: int,
                     ids: int) -> tuple[int, int]:
    """``(bytes, ops)`` of scoring one batch, whatever implements it: one
    logic operation per falsifying inclusion of each row; the rows in
    (o bytes each), the scores out (4 bytes per row and class) and the
    list entries the batch needs once (4 bytes each)."""
    return rows * o + 4 * rows * m + 4 * ids, falsifying


def ta_update_work(n: int, two_o: int, type_i_rows: int) -> tuple[int, int]:
    """``(bytes, ops)`` of one ``ta_update`` call on an (n, 2o) class row:
    the int16 states read and written, the float32 uniforms of the rows
    that take Type I feedback (no other row reads its own), the literals,
    and three bytes of routing per clause; two threshold compares, an add
    and a clamp per cell."""
    return 2 * n * two_o * 2 + type_i_rows * two_o * 4 + two_o + 3 * n, 4 * n * two_o


def round_bytes(n: int, two_o: int, read_clauses: int, changed: int) -> int:
    """Least bytes of one class round of learning: the row's include bits
    read once, the int16 states of the clauses whose feedback reads them
    read once, and the states that change written once."""
    return n * two_o // 8 + read_clauses * two_o * 2 + changed * 2
