"""PyTorch port (``repro_torch``) clause-compact layout, the ``compact``
engine, the paper's work metric and the IMDb data generator vs the JAX
reference, on the CPU.

Same TA states, same inputs and the same event buffers (seeded numpy,
handed to both packages): ``compact``, ``compact_eval``, ``compact_scores``
and ``validate_compact`` agree array for array; the vectorised
``compact_apply_events`` agrees with the reference's sequential scan in
``lengths`` exactly and row by row as sets (rows are sets: the order
inside a row is free), with and without capacity overflow; the sequential
oracle is the reference's scan array for array; the engine trains through
``TMSession`` and through a clause-sharded composition. Integer results,
tolerance 0.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import engines as jengines  # noqa: E402
from repro.core import indexing as jindexing  # noqa: E402
from repro.core import tm as jtm  # noqa: E402
from repro.core.session import TMSession as JSession  # noqa: E402
from repro.core.types import TMConfig as JConfig  # noqa: E402
from repro.core.types import TMState as JState  # noqa: E402
from repro.configs.tm import PAPER_TM_CONFIGS as J_PAPER  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.tm import PAPER_TM_CONFIGS  # noqa: E402
from repro_torch.core import api, engines, indexing  # noqa: E402
from repro_torch.core.session import TMSession, Topology  # noqa: E402
from repro_torch.core.types import TMState  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

SMALL = dict(n_classes=3, n_clauses=8, n_features=6, n_states=10, s=3.0,
             threshold=4)
WIDER = dict(n_classes=2, n_clauses=66, n_features=40, n_states=20, s=3.9,
             threshold=8)


def configs(kw, **extra):
    jcfg = JConfig(**kw, **extra)
    return jcfg, convert.config_from_reference(dataclasses.asdict(jcfg))


def ta_from_include(jcfg, inc, rng):
    """TA states with ``inc``'s include pattern, a few steps either side."""
    return np.where(inc, jcfg.n_states + 1 + rng.integers(0, 3, inc.shape),
                    jcfg.n_states - rng.integers(0, 3, inc.shape)).astype(np.int16)


@functools.cache
def _draw_fn(jcfg, batch):
    def one(key):
        k_neg, k_a, k_b = jax.random.split(key, 3)
        neg = jax.random.randint(k_neg, (), 0, jcfg.n_classes - 1)
        a = jtm.draw_feedback_rands(jcfg, k_a)
        b = jtm.draw_feedback_rands(jcfg, k_b)
        return neg, a.clause_gate, a.type_i, b.clause_gate, b.type_i

    return jax.jit(lambda rng: jax.vmap(one)(jax.random.split(rng, batch)))


def port_draws(jcfg, key, batch):
    """The reference's draws of one batch step keyed by ``key`` (its own key
    discipline, replayed with its public functions), for the port."""
    return convert.draws_from_reference(
        *(np.array(t) for t in _draw_fn(jcfg, batch)(key)), device="cpu")


def both(jcfg, tcfg, ta):
    return (JState(ta_state=jnp.asarray(ta)),
            convert.state_from_reference(tcfg, ta, "cpu"))


def as_sets(comp) -> np.ndarray:
    """Each row's ids sorted (NA last): equal iff the rows are equal sets."""
    ids = np.asarray(comp.lit_idx)
    return np.sort(np.where(ids < 0, 1 << 30, ids), axis=-1)


def port_comp(jcomp) -> indexing.CompactClauses:
    return indexing.CompactClauses(*(torch.from_numpy(np.array(t))
                                     for t in jcomp))


def buffers(old, new, max_events=100_000):
    """The same diff as the reference's buffer and as the port's."""
    jbuf = jindexing.events_from_transition(jnp.asarray(old), jnp.asarray(new),
                                            max_events)
    tbuf = indexing.events_from_transition(torch.from_numpy(old),
                                           torch.from_numpy(new), max_events)
    return jbuf.events, tbuf.events


def verdicts(checks) -> dict:
    return {k: bool(v) for k, v in checks.items()}


# -- the layout -------------------------------------------------------------


@pytest.mark.parametrize("l_max", [None, 3], ids=["roomy", "overflowing"])
@pytest.mark.parametrize("kw", [SMALL, WIDER], ids=["small", "wider"])
def test_compact_layout_matches_reference(kw, l_max):
    jcfg, tcfg = configs(kw)
    rng = np.random.default_rng(1)
    inc = rng.uniform(size=(jcfg.n_classes, jcfg.n_clauses,
                            2 * jcfg.n_features)) < 0.15
    inc[:, 0] = False                                  # an empty clause
    jstate, tstate = both(jcfg, tcfg, ta_from_include(jcfg, inc, rng))
    cap = l_max or tcfg.resolved_clause_capacity
    want = jindexing.compact(jcfg, jstate, cap)
    got = indexing.compact(tcfg, tstate, cap)
    for name, g, w in zip(("lit_idx", "lengths"), got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert verdicts(indexing.validate_compact(tcfg, tstate, got)) == \
        verdicts(jindexing.validate_compact(jcfg, jstate, want))
    x = rng.integers(0, 2, (5, jcfg.n_features)).astype(np.uint8)
    np.testing.assert_array_equal(
        indexing.compact_eval(tcfg, got, torch.from_numpy(x)).numpy(),
        np.asarray(jindexing.compact_eval(jcfg, want, jnp.asarray(x))))
    np.testing.assert_array_equal(
        indexing.compact_scores(tcfg, got, torch.from_numpy(x)).numpy(),
        np.asarray(jindexing.compact_scores(jcfg, want, jnp.asarray(x))))


def test_validate_compact_flags_corruption_like_the_reference():
    jcfg, tcfg = configs(SMALL)
    rng = np.random.default_rng(2)
    inc = rng.uniform(size=(3, 8, 12)) < 0.3
    jstate, tstate = both(jcfg, tcfg, ta_from_include(jcfg, inc, rng))
    good = indexing.compact(tcfg, tstate, 12)
    i, j = np.argwhere(inc.sum(-1) > 0)[0]
    k_out = int(np.flatnonzero(~inc[i, j])[0])
    bad = [good._replace(lengths=good.lengths + 1),             # lengths
           good._replace(lit_idx=good.lit_idx.clone().index_put_(
               (torch.tensor(i), torch.tensor(j), torch.tensor(0)),
               torch.tensor(k_out, dtype=torch.int32))),        # membership
           good._replace(lit_idx=good.lit_idx.clone().fill_(0))]  # padding
    for comp in [good] + bad:
        jcomp = jindexing.CompactClauses(*(jnp.asarray(t.numpy()) for t in comp))
        assert verdicts(indexing.validate_compact(tcfg, tstate, comp)) == \
            verdicts(jindexing.validate_compact(jcfg, jstate, jcomp))
    assert all(verdicts(indexing.validate_compact(tcfg, tstate, good)).values())


# -- event replay ---------------------------------------------------------------


def transition(jcfg, rng, density, flip):
    inc = rng.uniform(size=(jcfg.n_classes, jcfg.n_clauses,
                            2 * jcfg.n_features)) < density
    return inc, inc ^ (rng.uniform(size=inc.shape) < flip)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kw", [SMALL, WIDER], ids=["small", "wider"])
def test_compact_apply_events_matches_reference(kw, seed):
    """No row passes ℓ_max: identical lengths, identical sets per row."""
    jcfg, tcfg = configs(kw)
    rng = np.random.default_rng(10 + seed)
    old, new = transition(jcfg, rng, 0.2, 0.1)
    jstate, tstate = both(jcfg, tcfg, ta_from_include(jcfg, old, rng))
    cap = tcfg.resolved_clause_capacity
    jcomp = jindexing.compact(jcfg, jstate, cap)
    jev, tev = buffers(old, new)
    want = jax.jit(jindexing.compact_apply_events)(jcomp, jev)
    got = indexing.compact_apply_events(port_comp(jcomp), tev)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(as_sets(got), as_sets(want))
    oracle = indexing.compact_apply_events_sequential(port_comp(jcomp), tev)
    for g, w in zip(oracle, want):           # the scan itself, slot for slot
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    final = convert.state_from_reference(tcfg, ta_from_include(jcfg, new, rng),
                                         "cpu")
    np.testing.assert_array_equal(as_sets(got),
                                  as_sets(indexing.compact(tcfg, final, cap)))
    assert all(verdicts(indexing.validate_compact(tcfg, final, got)).values())


@pytest.mark.parametrize("kw", [SMALL, WIDER], ids=["small", "wider"])
def test_compact_apply_events_at_overflow_keeps_the_invariants(kw):
    """ℓ_max = the longest clause before the step, and the step inserts:
    rows fill up. The reference's lengths and sets, ``lengths <= ℓ_max``,
    slots past a length ``NA``, no foreign entry, and ``lengths_ok`` False
    exactly where the reference's is."""
    jcfg, tcfg = configs(kw)
    rng = np.random.default_rng(20)
    old, new = transition(jcfg, rng, 0.2, 0.15)
    cap = int(old.sum(-1).max())
    ta_old, ta_new = (ta_from_include(jcfg, a, rng) for a in (old, new))
    jstate, tstate = both(jcfg, tcfg, ta_old)
    jcomp = jindexing.compact(jcfg, jstate, cap)
    jev, tev = buffers(old, new)
    want = jax.jit(jindexing.compact_apply_events)(jcomp, jev)
    got = indexing.compact_apply_events(port_comp(jcomp), tev)
    jfinal, tfinal = both(jcfg, tcfg, ta_new)
    jv = verdicts(jindexing.validate_compact(jcfg, jfinal, want))
    tv = verdicts(indexing.validate_compact(tcfg, tfinal, got))
    assert not jv["lengths_ok"], "the case must overflow"
    assert tv == jv
    assert tv["overflow_ok"] and tv["member_ok"] and tv["padding_ok"]
    assert int(got.lengths.max()) <= cap
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(as_sets(got), as_sets(want))
    oracle = indexing.compact_apply_events_sequential(port_comp(jcomp), tev)
    for g, w in zip(oracle, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_compact_apply_events_reduces_repeated_cells_to_net_events():
    """A buffer naming cells several times (alternating crossings, padding
    slots between them) ends where the sequential scan ends, as sets."""
    jcfg, tcfg = configs(WIDER)
    rng = np.random.default_rng(30)
    inc = rng.uniform(size=(2, 66, 80)) < 0.2
    start = inc.copy()
    cols = [[] for _ in range(5)]
    for _ in range(3):
        for i, j, k in np.argwhere(rng.uniform(size=inc.shape) < 0.05):
            for col, val in zip(cols, (i, j, k, not inc[i, j, k], True)):
                col.append(val)
            inc[i, j, k] = not inc[i, j, k]
        for col, val in zip(cols, (0, 0, 0, True, False)):
            col.append(val)
    dtypes = (np.int32, np.int32, np.int32, bool, bool)
    events = indexing.Event(*(torch.from_numpy(np.asarray(c, d))
                              for c, d in zip(cols, dtypes)))
    tstate = convert.state_from_reference(tcfg, ta_from_include(jcfg, start, rng),
                                          "cpu")
    comp = indexing.compact(tcfg, tstate, 80)
    got = indexing.compact_apply_events(comp, events)
    want = jax.jit(jindexing.compact_apply_events)(
        jindexing.CompactClauses(*(jnp.asarray(t.numpy()) for t in comp)),
        jindexing.Event(*(jnp.asarray(t.numpy()) for t in events)))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.lengths.numpy(), inc.sum(-1))
    np.testing.assert_array_equal(as_sets(got), as_sets(want))


def test_empty_and_all_invalid_buffers_change_nothing():
    _, tcfg = configs(SMALL)
    comp = indexing.compact(tcfg, TMState(torch.full((3, 8, 12), 11,
                                                     dtype=torch.int16)), 12)
    none = indexing.Event(*(torch.zeros(0, dtype=d) for d in
                            (torch.int32,) * 3 + (torch.bool,) * 2))
    masked = indexing.Event(*(torch.zeros(4, dtype=d) for d in
                              (torch.int32,) * 3 + (torch.bool,) * 2))
    for ev in (none, masked):
        got = indexing.compact_apply_events(comp, ev)
        assert all(torch.equal(g, w) for g, w in zip(got, comp))


# -- the engine -------------------------------------------------------------


def test_registry_holds_the_reference_engines_with_a_card_body():
    assert set(engines.registered_engines()) == \
        set(jengines.registered_engines()) - {"bitpack_xla"}
    eng = engines.get_engine("compact")
    assert eng.cache_key == "compact" and eng.needs_cache


@pytest.mark.parametrize("parallel", [False, True],
                         ids=["sequential", "parallel"])
def test_compact_engine_through_session_after_two_steps(parallel):
    jcfg, tcfg = configs(WIDER)
    rng = np.random.default_rng(40)
    ta = rng.integers(1, 2 * jcfg.n_states + 1,
                      (2, 66, 80)).astype(np.int16)
    jstate, tstate = both(jcfg, tcfg, ta)
    names = ("dense", "compact")
    js = JSession(jcfg, engines=names, parallel=parallel)
    ts = TMSession(tcfg, engines=names, device="cpu", parallel=parallel)
    jb, tb = js.prepare(jstate), ts.prepare(tstate)
    for s in range(2):
        xs = rng.integers(0, 2, (4, jcfg.n_features)).astype(np.uint8)
        ys = rng.integers(0, jcfg.n_classes, 4).astype(np.int32)
        key = jax.random.key(50 + s)
        jb = js.train_step(jb, jnp.asarray(xs), jnp.asarray(ys), key)
        tb = ts.train_step(tb, xs, ys, port_draws(jcfg, key, 4))
    np.testing.assert_array_equal(tb.state.ta_state.numpy(),
                                  np.asarray(jb.state.ta_state))
    got, want = tb.caches["compact"], jb.caches["compact"]
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(as_sets(got), as_sets(want))
    np.testing.assert_array_equal(
        as_sets(got), as_sets(indexing.compact(tcfg, tb.state, 80)))
    assert all(verdicts(indexing.validate_compact(tcfg, tb.state, got)).values())
    x = rng.integers(0, 2, (6, jcfg.n_features)).astype(np.uint8)
    scores = ts.scores(tb, x, engine="compact")
    np.testing.assert_array_equal(
        scores.numpy(), np.asarray(js.scores(jb, jnp.asarray(x), engine="compact")))
    assert torch.equal(scores, ts.scores(tb, x, engine="dense"))


def test_compact_engine_clause_sharded_equals_topology_one():
    """(2 clause × 2 data shards, composed) on CPU ranks: scores and two
    sequential steps equal ``Topology(1)``'s; every rank's compact cache
    equals a rebuild of its state slice as sets."""
    jcfg, tcfg = configs(WIDER)
    rng = np.random.default_rng(60)
    ta = rng.integers(1, 2 * jcfg.n_states + 1, (2, 66, 80)).astype(np.int16)
    names = ("dense", "compact")
    one = TMSession(tcfg, engines=names, device="cpu")
    sharded = TMSession(tcfg, Topology(clause_shards=2, data_shards=2),
                        mesh=make_mesh(2, 2, device="cpu"), engines=names)
    b1 = one.prepare(convert.state_from_reference(tcfg, ta, "cpu"))
    bs = sharded.prepare(convert.state_from_reference(tcfg, ta, "cpu"))
    x = rng.integers(0, 2, (8, jcfg.n_features)).astype(np.uint8)
    assert torch.equal(sharded.scores(bs, x, engine="compact"),
                       one.scores(b1, x, engine="dense"))
    for s in range(2):
        xs = rng.integers(0, 2, (4, jcfg.n_features)).astype(np.uint8)
        ys = rng.integers(0, jcfg.n_classes, 4).astype(np.int32)
        key = jax.random.key(70 + s)
        b1 = one.train_step(b1, xs, ys, port_draws(jcfg, key, 4))
        bs = sharded.train_step(bs, xs, ys, port_draws(jcfg, key, 4))
    assert torch.equal(sharded.unpad_state(bs.state).ta_state, b1.state.ta_state)
    for row in bs.ranks:
        for rank in row:
            comp = rank.caches["compact"]
            np.testing.assert_array_equal(
                as_sets(comp), as_sets(indexing.compact(tcfg, rank.state, 80)))
            assert all(verdicts(indexing.validate_compact(
                tcfg, rank.state, comp)).values())
    assert torch.equal(sharded.scores(bs, x, engine="compact"),
                       one.scores(b1, x, engine="compact"))


# -- the work metric and the indexed-score helpers ------------------------------


def test_indexed_work_and_scores_match_reference():
    jcfg, tcfg = configs(WIDER)
    rng = np.random.default_rng(80)
    inc = rng.uniform(size=(2, 66, 80)) < 0.1
    jstate, tstate = both(jcfg, tcfg, ta_from_include(jcfg, inc, rng))
    jindex = jindexing.build_index(jcfg, jstate, jcfg.resolved_index_capacity)
    tindex = indexing.build_index(tcfg, tstate, tcfg.resolved_index_capacity)
    x = rng.integers(0, 2, (7, jcfg.n_features)).astype(np.uint8)
    work = indexing.indexed_work(tindex, torch.from_numpy(x))
    assert work.dtype == torch.int32
    np.testing.assert_array_equal(
        work.numpy(), np.asarray(jindexing.indexed_work(jindex, jnp.asarray(x))))
    assert indexing.dense_work(tcfg) == jindexing.dense_work(jcfg) == 2 * 66 * 80
    np.testing.assert_array_equal(
        indexing.indexed_scores(tcfg, tindex, torch.from_numpy(x)).numpy(),
        np.asarray(jindexing.indexed_scores(jcfg, jindex, jnp.asarray(x))))
    pol = np.where(np.arange(66) % 3 == 0, 0, 1).astype(np.int32)
    np.testing.assert_array_equal(
        indexing.indexed_partial_scores(tindex, torch.from_numpy(x),
                                        torch.from_numpy(pol)).numpy(),
        np.asarray(jindexing.indexed_partial_scores(jindex, jnp.asarray(x),
                                                    jnp.asarray(pol))))


def test_bow_documents_match_reference_at_imdb_width():
    o = PAPER_TM_CONFIGS["tm_imdb"].tm.n_features
    assert o == J_PAPER["tm_imdb"].tm.n_features == 5000
    for seed in (0, 3):
        x, y = synthetic.bow_documents(24, o, seed=seed)
        jx, jy = jsynthetic.bow_documents(24, o, seed=seed)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.dtype == np.uint8 and y.dtype == np.int32
        assert 0 < x.sum(1).min() and x.sum(1).max() <= 60


def test_work_ratio_on_bow_documents_matches_reference():
    """The §3 work ratio on IMDb-like documents at o=5000, n=16 clauses."""
    jcfg, tcfg = configs(dict(n_classes=2, n_clauses=16, n_features=5000))
    rng = np.random.default_rng(90)
    inc = rng.uniform(size=(2, 16, 10000)) < 116 / 10000
    jstate, tstate = both(jcfg, tcfg, ta_from_include(jcfg, inc, rng))
    x, _ = synthetic.bow_documents(8, 5000, seed=4)
    tindex = api.init_bundle(tcfg, engines=("indexed",), state=tstate,
                             device="cpu").index
    jindex = jindexing.build_index(jcfg, jstate, jcfg.resolved_index_capacity)
    got = indexing.indexed_work(tindex, torch.from_numpy(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jindexing.indexed_work(jindex, jnp.asarray(x))))
    ratio = float(got.double().mean()) / indexing.dense_work(tcfg)
    assert 0 < ratio < 0.02
