"""Pure-numpy oracle for TM semantics — the paper's pseudocode, literally
(the port's own copy of ``repro.core.ref``: numpy only, so it is copied,
never imported).

Slow loops over classes/clauses/literals; used only at small sizes to pin
the port's vectorised path (its class round, ``dense_clause_outputs`` and
``indexed_scores``, on the CPU and on the card). Feedback consumes
*injected* uniforms so it can be replayed bit-exactly against the
vectorised path. The comparisons are in double precision; the port's are
float32, so inputs that a double and a float32 threshold would split (a
uniform exactly at ``1/s``, say) are outside this oracle's reach.
"""
from __future__ import annotations

import numpy as np


def clause_outputs_ref(ta_state, x, n_states, empty_output=1):
    """ta_state: (m, n, 2o) ints; x: (o,) {0,1} → (m, n) uint8."""
    m, n, L = ta_state.shape
    o = L // 2
    lit = np.concatenate([x, 1 - x]).astype(np.uint8)
    out = np.zeros((m, n), np.uint8)
    for i in range(m):
        for j in range(n):
            include = ta_state[i, j] > n_states
            if not include.any():
                out[i, j] = empty_output
                continue
            out[i, j] = 1
            for k in range(L):
                if include[k] and lit[k] == 0:
                    out[i, j] = 0
                    break
    return out


def votes_ref(clause_out):
    """(m, n) clause outputs → (m,) vote sums (first half positive)."""
    m, n = clause_out.shape
    half = n // 2
    return (
        clause_out[:, :half].astype(np.int64).sum(-1)
        - clause_out[:, half:].astype(np.int64).sum(-1)
    )


def class_round_ref(ta_row, lit, clause_gate_u, type_i_u, *,
                    n_states, s, threshold, half, positive_round,
                    boost_true_positive=False):
    """Numpy replica of tm._class_round for one class. Returns new (n, 2o)."""
    n, L = ta_row.shape
    ta = ta_row.astype(np.int64).copy()
    include = ta_row > n_states
    clause_out = np.ones(n, np.uint8)
    for j in range(n):
        for k in range(L):
            if include[j, k] and lit[k] == 0:
                clause_out[j] = 0
                break
    votes = 0
    for j in range(n):
        votes += int(clause_out[j]) * (1 if j < half else -1)
    t = float(threshold)
    votes = max(-t, min(t, votes))
    p = (t - votes) / (2 * t) if positive_round else (t + votes) / (2 * t)
    inv_s = 1.0 / s
    p_reward = 1.0 if boost_true_positive else 1.0 - inv_s
    for j in range(n):
        if not (clause_gate_u[j] < p):
            continue
        gets_type_i = (j < half) if positive_round else (j >= half)
        if gets_type_i:
            for k in range(L):
                u = type_i_u[j, k]
                if clause_out[j] == 1 and lit[k] == 1:
                    if u < p_reward:
                        ta[j, k] += 1
                elif u < inv_s:
                    ta[j, k] -= 1
        else:  # Type II
            if clause_out[j] == 1:
                for k in range(L):
                    if lit[k] == 0 and not include[j, k]:
                        ta[j, k] += 1
    return np.clip(ta, 1, 2 * n_states)


def indexed_scores_ref(lists, counts, x, n_clauses):
    """Paper §3 inference with literal→clause lists (numpy loops).

    lists: (m, 2o, cap); counts: (m, 2o); x: (o,) → (m,) scores (Eq. 4).
    """
    m, L, _ = lists.shape
    o = L // 2
    lit = np.concatenate([x, 1 - x]).astype(np.uint8)
    half = n_clauses // 2
    scores = np.zeros(m, np.int64)
    for i in range(m):
        falsified = np.zeros(n_clauses, bool)
        for k in range(L):
            if lit[k] == 0:
                for c in range(counts[i, k]):
                    falsified[lists[i, k, c]] = True
        fp = falsified[:half].sum()
        fn = falsified[half:].sum()
        scores[i] = fn - fp
    return scores
