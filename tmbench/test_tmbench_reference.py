"""The benchmark's plain reference against ``repro_torch`` on the CPU at
tiny widths: Eq. 4 scores through the port's engines, the draw order, and
a few sequential learning steps cell for cell; its controls differ."""
import numpy as np
import pytest
import torch

from repro_torch.core import tm
from repro_torch.core.session import TMSession, TsetlinMachine
from repro_torch.core.types import TMConfig, TMState

from tmbench import gen as G
from tmbench.reference import tm as ref

SHAPES = [(3, 16, 12, 4), (2, 32, 40, 6), (10, 20, 9, 3)]


def _state(m, n, o, avg, seed):
    g = torch.Generator().manual_seed(seed)
    ta, include = G.served_state(m, n, o, 127, avg, g)
    x = G.requests(include, G.random_bits(50, o, g), g)
    return ta, include, x


@pytest.mark.parametrize("engine", ["indexed", "dense", "bitpack"])
@pytest.mark.parametrize("m, n, o, avg", SHAPES)
def test_reference_scores_equal_the_port(m, n, o, avg, engine):
    ta, include, x = _state(m, n, o, avg, seed=m + n)
    cfg = TMConfig(n_classes=m, n_clauses=n, n_features=o)
    session = TMSession(cfg, engines=(engine,), device="cpu")
    got = session.scores(session.prepare(TMState(ta_state=ta)), x, engine=engine)
    want = ref.scores(include, x, block=7)
    assert torch.equal(got, want)
    assert want.unique().numel() > 1


def test_an_empty_clause_is_true():
    include = torch.zeros((1, 4, 6), dtype=torch.bool)
    include[0, 0, 0] = True                      # clause 0 needs x0
    x = torch.tensor([[0, 1, 1]])
    assert ref.scores(include, x).tolist() == [[1 - 2]]   # clause 1 true, 2 and 3 true


def test_the_draw_order_is_the_ports():
    cfg = TMConfig(n_classes=4, n_clauses=6, n_features=5)
    a = tm.draw_sample_draws(cfg, torch.Generator().manual_seed(9), 3)
    d = ref.Draws(4, 6, 10, 9, "cpu")
    assert d.negatives(3) == a.neg_raw.tolist()
    for b in range(3):
        for which in (a.target, a.other):
            gate, u = d.round()
            assert torch.equal(gate, which.clause_gate[b])
            assert torch.equal(u, which.type_i[b])


@pytest.mark.parametrize("steps", [0, 1, 3])
def test_skipping_steps_leaves_the_draws_where_drawing_them_would(steps):
    drawn, skipped = ref.Draws(4, 6, 10, 9, "cpu"), ref.Draws(4, 6, 10, 9, "cpu")
    for _ in range(steps):
        drawn.negatives(5)
        for _ in range(2 * 5):
            drawn.round()
    skipped.skip(steps, 5)
    assert skipped.negatives(5) == drawn.negatives(5)
    for a, b in zip(skipped.round(), drawn.round()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m, n, o, s, t", [(3, 16, 12, 3.9, 5), (2, 32, 40, 27.0, 40),
                                           (10, 20, 30, 10.0, 50)])
def test_reference_learning_equals_the_port(m, n, o, s, t):
    cfg = TMConfig(n_classes=m, n_clauses=n, n_features=o, s=s, threshold=t)
    g = torch.Generator().manual_seed(m * n)
    _, include = G.served_state(m, n, o, 127, 4, g)
    ta0 = G.trained_like_state(include, 127, g)
    x, y = G.binarized_images(24, o, m, g)
    machine = TsetlinMachine(cfg, engines=("indexed",), device="cpu", seed=77,
                             max_events_per_batch=m * n * 2 * o)
    machine.bundle = machine.session.prepare(TMState(ta_state=ta0.clone()))
    ta = ta0.clone()
    draws = ref.Draws(m, n, 2 * o, 77, "cpu")
    hp = {"n_states": 127, "s": s, "threshold": t, "boost_true_positive": False}
    for step in range(3):
        xb, yb = x[8 * step:8 * step + 8], y[8 * step:8 * step + 8]
        machine.partial_fit(xb.numpy(), yb.numpy())
        ref.learn_step(ta, xb, yb.tolist(), draws, hp)
        assert torch.equal(machine.state.ta_state, ta)
    assert not torch.equal(ta, ta0)


def test_the_controls_differ_from_the_reference():
    ta, include, x = _state(3, 16, 12, 4, seed=1)
    assert not torch.equal(ref.include_of(ta, 127, control=True), include)
    cfg = dict(n_states=127, s=10.0, threshold=50, boost_true_positive=False)
    g = torch.Generator().manual_seed(4)
    _, inc = G.served_state(3, 64, 64, 127, 8, g)
    ta0 = G.trained_like_state(inc, 127, g)
    xs, ys = G.binarized_images(16, 64, 3, g)
    out = []
    for control in (False, True):
        t = ta0.clone()
        ref.learn_step(t, xs, ys.tolist(), ref.Draws(3, 64, 128, 5, "cpu"), cfg,
                       control=control)
        out.append(t)
    assert int((out[0] != out[1]).sum()) > 0
    assert np.isfinite(float(out[0].float().mean()))
