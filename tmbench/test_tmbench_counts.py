"""``tmbench/counts.py`` against hand-worked values: the dense work at the
paper's widths, the work ratio of the generated states and rows, the
falsifying-inclusion count (a row that falsifies every clause too), the
walk's and ``ta_update``'s counts, and the bound."""
import pytest
import torch

from tmbench import counts
from tmbench import gen as G


def test_dense_work_at_the_papers_widths():
    assert counts.dense_work(10, 2000, 784) == 31_360_000
    assert counts.dense_work(2, 2000, 5000) == 40_000_000


@pytest.mark.parametrize("m, o, avg_len, base, want", [
    (10, 784, 58, "bits", 0.0185),      # tm_mnist: half a clause's literals false
    (2, 5000, 116, "bow", 0.0058),      # tm_imdb: ~99% of positive literals false
], ids=["tm_mnist", "tm_imdb"])
def test_work_ratio_of_the_generated_state(m, o, avg_len, base, want):
    # the ratio does not depend on the clause count: 200 clauses stand for 2000
    g = torch.Generator().manual_seed(0)
    _, include = G.served_state(m, 200, o, 127, avg_len, g)
    if base == "bow":
        rows, _ = G.bow_documents(256, o, m, g)
    else:
        rows = G.random_bits(256, o, g)
    x = G.requests(include, rows, g)
    assert counts.work_ratio(include, x) == pytest.approx(want, rel=0.05)


def test_falsifying_inclusions_by_hand():
    # 1 class, 3 clauses over o = 2 (literals x0, x1, ¬x0, ¬x1)
    include = torch.tensor([[[1, 0, 0, 1],     # x0 ∧ ¬x1
                             [1, 1, 0, 0],     # x0 ∧ x1
                             [0, 0, 1, 0]]],   # ¬x0
                           dtype=torch.bool)
    x = torch.tensor([[1, 0],      # false: x1, ¬x0 → clauses 2 (x1) and 3 (¬x0)
                      [0, 1],      # false: x0, ¬x1 → 1 twice, 2 once: every clause
                      [1, 1]])     # false: ¬x0, ¬x1 → clause 1 (¬x1), clause 3 (¬x0)
    assert counts.falsifying_inclusions(include, x).tolist() == [2, 3, 2]
    assert counts.falsifying_inclusions(include, x, block=1).tolist() == [2, 3, 2]
    assert counts.work_ratio(include, x) == pytest.approx((7 / 3) / 12)


def test_walk_work_by_hand():
    include = torch.tensor([[[1, 0, 0, 1], [1, 1, 0, 0], [0, 0, 1, 0]]],
                           dtype=torch.bool)
    lengths = counts.list_lengths(include)                 # [[2, 1, 1, 1]]
    assert lengths.tolist() == [[2, 1, 1, 1]]
    x = torch.tensor([[1, 0], [1, 1]])       # false somewhere: x1, ¬x0, ¬x1
    nbytes, ops, ids = counts.walk_work(lengths, x, n_clauses=3)
    assert ids == 3
    assert ops == 3                           # one batch word of 32 rows
    assert nbytes == 4 * (3 + 3) + 2 * 4 + 4 * 3 + 4 * 2 * 1


def test_score_and_update_work_and_the_bound():
    assert counts.score_batch_work(1000, 4, 5000, 2, 10) == (
        4 * 5000 + 4 * 4 * 2 + 40, 1000)
    assert counts.ta_update_work(2000, 1568, 500) == (
        2 * 2000 * 1568 * 2 + 500 * 1568 * 4 + 1568 + 6000, 4 * 2000 * 1568)
    assert counts.round_bytes(2000, 1568, 10, 7) == 2000 * 1568 // 8 + 10 * 1568 * 2 + 14
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 67e12 / 4) == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 67e12 / 2) == pytest.approx(2.0)
