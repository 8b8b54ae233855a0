"""PyTorch port (``repro_torch``) training vs the JAX reference, on the CPU.

The learning path, module by module, under injected draws: the plain
``clause_outputs`` and ``ta_update`` bodies against the reference's XLA
bodies and its Pallas kernels in interpret mode; one class round; both batch
learning modes, with and without a sample mask; the event buffer; the
batched index replay (array for array against the reference, set for set
against the port's sequential oracle); ``train_step`` with every cache; and
the README quickstart through ``partial_fit``.

``jax.random`` cannot be replayed in PyTorch, so every comparison replays
the reference's key discipline with its own public functions (the batch
``split(rng, B)``, each sample's ``split(key, 3)`` into the negative-class
key and the two rounds' keys, ``draw_feedback_rands``) and hands the
resulting arrays to the port through ``convert.draws_from_reference``. All
results are integers or exact bit patterns: tolerance 0.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import bitpack as jbitpack  # noqa: E402
from repro.core import indexing as jindexing  # noqa: E402
from repro.core import tm as jtm  # noqa: E402
from repro.core.session import Topology as JTopology  # noqa: E402
from repro.core.session import TsetlinMachine as JMachine  # noqa: E402
from repro.core.types import TMConfig as JConfig  # noqa: E402
from repro.core.types import TMState as JState  # noqa: E402
from repro.kernels import clause_eval as jclause_eval  # noqa: E402
from repro.kernels import indexed as jindexed  # noqa: E402
from repro.kernels import ta_update as jta_update  # noqa: E402
from repro.kernels.backend import _clause_outputs_xla, _ta_update_xla  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api, bitpack, indexing, tm  # noqa: E402
from repro_torch.core.session import TsetlinMachine  # noqa: E402
from repro_torch.core.types import TMState, clause_polarity  # noqa: E402
from repro_torch.kernels import clause_eval, ta_update  # noqa: E402

# two small widths: tiny, and one past a 32-bit word with n ≠ 2^k
SMALL = dict(n_classes=3, n_clauses=8, n_features=6, n_states=10, s=3.0,
             threshold=4)
WIDER = dict(n_classes=2, n_clauses=66, n_features=40, n_states=20, s=3.9,
             threshold=8)
ENGINES = ("dense", "bitpack", "indexed")


def configs(kw, **extra):
    jcfg = JConfig(**kw, **extra)
    return jcfg, convert.config_from_reference(dataclasses.asdict(jcfg))


def random_state(jcfg, rng):
    """TA states uniform on [1, 2N]: about half include, many one step from
    the boundary, both clip ends present."""
    shape = (jcfg.n_classes, jcfg.n_clauses, 2 * jcfg.n_features)
    return rng.integers(1, 2 * jcfg.n_states + 1, shape).astype(np.int16)


def both_states(jcfg, tcfg, ta):
    return (JState(ta_state=jnp.asarray(ta)),
            convert.state_from_reference(tcfg, ta, "cpu"))


@functools.cache
def _draw_fn(jcfg, batch):
    def one(key):
        k_neg, k_a, k_b = jax.random.split(key, 3)
        neg = jax.random.randint(k_neg, (), 0, jcfg.n_classes - 1)
        a = jtm.draw_feedback_rands(jcfg, k_a)
        b = jtm.draw_feedback_rands(jcfg, k_b)
        return neg, a.clause_gate, a.type_i, b.clause_gate, b.type_i

    return jax.jit(lambda rng: jax.vmap(one)(jax.random.split(rng, batch)))


def reference_draws(jcfg, rng, batch):
    """The reference's draws for one batch step keyed by ``rng``, exactly as
    ``update_batch_{sequential,parallel}`` derive them, as numpy arrays:
    (raw negative class, target gate, target Type I, other gate, other
    Type I), each with a leading batch axis."""
    return [np.array(t) for t in _draw_fn(jcfg, batch)(rng)]


def port_draws(jcfg, rng, batch):
    return convert.draws_from_reference(*reference_draws(jcfg, rng, batch),
                                        device="cpu")


def batch(jcfg, rng, size):
    xs = rng.integers(0, 2, (size, jcfg.n_features)).astype(np.uint8)
    ys = rng.integers(0, jcfg.n_classes, size).astype(np.int32)
    return xs, ys


# ---------------------------------------------------------------------------
# the learning round's two primitives: plain bodies vs XLA and Pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1, 3, 1), (2, 4, 5, 3), (3, 8, 17, 9),
                                   (10, 130, 50, 8), (1, 66, 2049, 2)])
def test_clause_outputs_ref_matches_reference(shape):
    m, n, o, b = shape
    rng = np.random.default_rng(sum(shape))
    include = rng.uniform(size=(m, n, 2 * o)) < 0.2
    include[:, 0] = False                               # an empty clause
    x = rng.integers(0, 2, (b, o)).astype(np.uint8)
    inc_words = jbitpack.pack_bits(jnp.asarray(include.astype(np.uint8)))
    lit_words = jbitpack.packed_literals(jnp.asarray(x))
    got = clause_eval.clause_outputs_ref(
        bitpack.pack_bits(torch.from_numpy(include)),
        bitpack.packed_literals(torch.from_numpy(x)))
    assert got.dtype == torch.int8 and tuple(got.shape) == (b, m, n)
    assert (got[:, :, 0] == 1).all()                    # empty clause → 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        _clause_outputs_xla(inc_words, lit_words)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jclause_eval.clause_outputs_packed(inc_words, lit_words,
                                           interpret=True)))


def threshold_uniforms(rng, n, L, s, boost):
    """Uniforms on [0, 1) with a quarter of the cells exactly at a float32
    threshold or one ulp either side of it — where a threshold computed in
    float32 arithmetic, or compared in float64, would decide differently."""
    u = rng.uniform(size=(n, L)).astype(np.float32)
    edges = []
    for thr in ta_update.thresholds(s, boost):
        t = np.float32(thr)
        edges += [t, np.nextafter(t, np.float32(0)), np.nextafter(t, np.float32(1))]
    edges = np.asarray([e for e in edges if e < 1], np.float32)
    pick = rng.uniform(size=(n, L)) < 0.25
    u[pick] = edges[rng.integers(0, len(edges), int(pick.sum()))]
    return u


@pytest.mark.parametrize("boost", [False, True])
@pytest.mark.parametrize("n,o,s", [(3, 5, 3.0), (8, 17, 3.9), (130, 50, 3.9),
                                   (66, 40, 3.0), (5, 4, 10.0)])
def test_ta_update_ref_matches_reference(n, o, s, boost):
    L, n_states = 2 * o, 12
    rng = np.random.default_rng(n * 1000 + o)
    ta = rng.integers(1, 2 * n_states + 1, (n, L)).astype(np.int16)
    lit = rng.integers(0, 2, L).astype(np.uint8)
    clause_out = rng.integers(0, 2, n).astype(np.int8)
    gets_type_i = rng.uniform(size=n) < 0.5
    active = rng.uniform(size=n) < 0.7
    u = threshold_uniforms(rng, n, L, s, boost)
    kw = dict(n_states=n_states, s=s, boost_true_positive=boost)
    got = ta_update.ta_update_ref(*(torch.from_numpy(a) for a in (
        ta, lit, clause_out, gets_type_i, active, u)), **kw)
    assert got.dtype == torch.int16 and tuple(got.shape) == (n, L)
    args = [jnp.asarray(a) for a in (ta, lit.astype(np.int8), clause_out,
                                     gets_type_i, active, u)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(_ta_update_xla(*args, **kw)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jta_update.ta_update(*args, **kw, interpret=True)))
    # out= writes the same values in place
    row = torch.from_numpy(ta.copy())
    back = ta_update.ta_update_ref(row, *(torch.from_numpy(a) for a in (
        lit, clause_out, gets_type_i, active, u)), **kw, out=row)
    assert back is row and torch.equal(row, got)


def test_thresholds_are_float32_roundings_of_the_doubles():
    # float32 arithmetic on s lands one ulp away at these two s values
    f = np.float32
    inv, _ = ta_update.thresholds(3.9, False)
    assert inv == f(1.0 / 3.9) and inv != f(1.0) / f(3.9)
    _, reward = ta_update.thresholds(3.0, False)
    assert reward == f(1.0 - 1.0 / 3.0) and reward != f(1.0) - f(1.0) / f(3.0)
    assert ta_update.thresholds(3.0, True)[1] == 1.0


# ---------------------------------------------------------------------------
# the class round and the batch updates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("boost", [False, True])
@pytest.mark.parametrize("kw", [SMALL, WIDER], ids=["small", "wider"])
def test_class_round_matches_reference(kw, boost):
    jcfg, tcfg = configs(kw, boost_true_positive=boost)
    rng = np.random.default_rng(3)
    ta = random_state(jcfg, rng)
    x = rng.integers(0, 2, jcfg.n_features).astype(np.uint8)
    lit = np.concatenate([x, 1 - x])
    _, gate, type_i, _, _ = reference_draws(jcfg, jax.random.key(4), 1)
    changed = 0
    round_ = jax.jit(jtm._class_round, static_argnums=0)
    for positive in (True, False):
        for cls in range(jcfg.n_classes):
            want = round_(
                jcfg, jnp.asarray(ta[cls]), jnp.asarray(lit),
                jtm.FeedbackRands(jnp.asarray(gate[0]), jnp.asarray(type_i[0])),
                jnp.asarray(positive))
            # the two halves of a round, called as tm.learn_batch calls them
            row, tlit = torch.from_numpy(ta[cls]), torch.from_numpy(lit)
            pol = clause_polarity(tcfg, "cpu")
            clause_out, vote = tm._round_vote(
                tcfg, row, bitpack.pack_bits(tlit), pol)
            got = tm._round_feedback(
                tcfg, row, tlit, clause_out, vote,
                tm.FeedbackRands(torch.from_numpy(gate[0]),
                                 torch.from_numpy(type_i[0])), positive, pol)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            changed += int((got.numpy() != ta[cls]).sum())
    assert changed > 0


def test_vote_probability_matches_the_reference_float32_arithmetic():
    """p = (T ∓ vote)/(2T): XLA multiplies by the float32 reciprocal of 2T;
    the port must produce the same float32 bits for every clamped vote."""
    for T in (3, 4, 7, 8, 13, 15, 40, 50, 100):
        t = float(T)

        @jax.jit
        def ref(vs, pos):
            votes = jnp.clip(vs, -t, t)
            return jnp.where(pos, (t - votes) / (2 * t), (t + votes) / (2 * t))

        vs = np.arange(-2 * T, 2 * T + 1, dtype=np.int32)
        votes = torch.from_numpy(vs).to(torch.float32).clamp(-t, t)
        for pos in (True, False):
            got = ((t - votes) if pos else (t + votes)) * tm._reciprocal_2t(t)
            np.testing.assert_array_equal(
                got.numpy().view(np.uint32),
                np.asarray(ref(jnp.asarray(vs), pos)).view(np.uint32))


@pytest.mark.parametrize("kw,parallel,masked", [
    (SMALL, False, False), (WIDER, False, True),
    (SMALL, True, True), (WIDER, True, False)],
    ids=["small-sequential-full", "wider-sequential-masked",
         "small-parallel-masked", "wider-parallel-full"])
def test_update_batch_matches_reference(kw, parallel, masked):
    jcfg, tcfg = configs(kw)
    rng = np.random.default_rng(5)
    ta = random_state(jcfg, rng)
    xs, ys = batch(jcfg, rng, 6)
    mask = np.array([1, 1, 0, 1, 0, 1], bool) if masked else None
    key = jax.random.key(6)
    jstate, tstate = both_states(jcfg, tcfg, ta)
    jfn = jtm.update_batch_parallel if parallel else jtm.update_batch_sequential
    want = jax.jit(jfn, static_argnums=0)(
        jcfg, jstate, jnp.asarray(xs), jnp.asarray(ys), key,
        mask=None if mask is None else jnp.asarray(mask))
    tfn = tm.update_batch_parallel if parallel else tm.update_batch_sequential
    got = tfn(tcfg, tstate, xs, ys, port_draws(jcfg, key, 6), mask=mask)
    np.testing.assert_array_equal(got.ta_state.numpy(), np.asarray(want.ta_state))
    np.testing.assert_array_equal(tstate.ta_state.numpy(), ta)   # input kept
    assert not np.array_equal(got.ta_state.numpy(), ta)


def test_update_sample_matches_reference():
    jcfg, tcfg = configs(WIDER)
    rng = np.random.default_rng(7)
    ta = random_state(jcfg, rng)
    x = rng.integers(0, 2, jcfg.n_features).astype(np.uint8)
    key = jax.random.key(8)
    jstate, tstate = both_states(jcfg, tcfg, ta)
    update = jax.jit(jtm.update_sample, static_argnums=0)
    for y in range(jcfg.n_classes):          # the shift past y both ways
        want = update(jcfg, jstate, jnp.asarray(x), jnp.asarray(y),
                                 jax.random.split(key, 1)[0])
        got = tm.update_sample(tcfg, tstate, torch.from_numpy(x), y,
                               port_draws(jcfg, key, 1).sample(0))
        np.testing.assert_array_equal(got.ta_state.numpy(),
                                      np.asarray(want.ta_state))


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_generator_draws_follow_the_documented_order(parallel):
    """A generator read by the update itself gives the same step as the
    batch drawn up front by ``draw_sample_draws`` from the same seed."""
    _, tcfg = configs(WIDER)
    rng = np.random.default_rng(9)
    ta = torch.from_numpy(random_state(JConfig(**WIDER), rng))
    xs, ys = batch(JConfig(**WIDER), rng, 5)
    mask = np.array([1, 0, 1, 1, 1], bool)
    fn = tm.update_batch_parallel if parallel else tm.update_batch_sequential
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    lazy = fn(tcfg, TMState(ta), xs, ys, g1, mask=mask)
    eager = fn(tcfg, TMState(ta), xs, ys, tm.draw_sample_draws(tcfg, g2, 5),
               mask=mask)
    assert torch.equal(lazy.ta_state, eager.ta_state)
    assert torch.equal(torch.rand(3, generator=g1), torch.rand(3, generator=g2))


# ---------------------------------------------------------------------------
# the event buffer and the index replay
# ---------------------------------------------------------------------------


def transition(jcfg, rng, flip):
    ta = random_state(jcfg, rng)
    inc = ta > jcfg.n_states
    new = inc ^ (rng.uniform(size=inc.shape) < flip)
    return inc, new


@pytest.mark.parametrize("max_events", [1, 7, 40, 10_000])
def test_events_from_transition_matches_reference(max_events):
    jcfg, _ = configs(SMALL)
    old, new = transition(jcfg, np.random.default_rng(max_events), 0.1)
    want = jindexing.events_from_transition(jnp.asarray(old), jnp.asarray(new),
                                            max_events)
    got = indexing.events_from_transition(torch.from_numpy(old),
                                          torch.from_numpy(new), max_events)
    for f in indexing.Event._fields:
        np.testing.assert_array_equal(getattr(got.events, f).numpy(),
                                      np.asarray(getattr(want.events, f)),
                                      err_msg=f)
    assert int(got.overflow) == int(want.overflow)
    assert got.events.cls.dtype == torch.int32
    assert (int(got.overflow) > 0) == (max_events < int((old != new).sum()))


def random_buffer(jcfg, ta, rng, steps):
    """A valid event buffer: ``steps`` rounds of random flips on the include
    mask, each cell's events alternating, plus invalid padding slots."""
    inc = ta > jcfg.n_states
    cls, clause, lit, ins, valid = [], [], [], [], []
    for _ in range(steps):
        cells = np.argwhere(rng.uniform(size=inc.shape) < 0.05)
        for i, j, k in cells:
            cls.append(i), clause.append(j), lit.append(k)
            ins.append(not inc[i, j, k]), valid.append(True)
            inc[i, j, k] = not inc[i, j, k]
        for _ in range(3):                    # padding: masked-out slots
            cls.append(0), clause.append(0), lit.append(0)
            ins.append(True), valid.append(False)
    return (np.asarray(cls, np.int32), np.asarray(clause, np.int32),
            np.asarray(lit, np.int32), np.asarray(ins, bool),
            np.asarray(valid, bool)), inc


@pytest.mark.parametrize("capacity", [None, 5], ids=["full", "overflowing"])
@pytest.mark.parametrize("kw", [SMALL, WIDER], ids=["small", "wider"])
def test_index_update_matches_reference_and_oracle(kw, capacity):
    jcfg, tcfg = configs(kw, index_capacity=capacity)
    rng = np.random.default_rng(12)
    ta = random_state(jcfg, rng)
    ta[ta > jcfg.n_states] -= rng.uniform(size=(ta > jcfg.n_states).sum()) < 0.6
    events, final_inc = random_buffer(jcfg, ta, rng, steps=3)
    jstate, tstate = both_states(jcfg, tcfg, ta)
    cap = jcfg.resolved_index_capacity
    jindex = jindexing.build_index(jcfg, jstate, cap)
    tindex = indexing.build_index(tcfg, tstate, cap)
    want = jax.jit(jindexed.index_update_batched)(
        *jindex, *(jnp.asarray(e) for e in events))
    got = indexing.index_update(tindex, indexing.Event(
        *(torch.from_numpy(e) for e in events)))
    for name, g, w in zip(("lists", "counts", "pos"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(got.counts.numpy(),
                                  final_inc.sum(1).astype(np.int32))
    if capacity is None:    # the sequential oracle needs lists within capacity
        oracle = indexing.apply_events(tindex, indexing.Event(
            *(torch.from_numpy(e) for e in events)))
        assert torch.equal(oracle.counts, got.counts)
        assert torch.equal(oracle.pos != -1, got.pos != -1)
        # list contents as sets: sort each row's live slots (NA sorts last)
        live = lambda ix: np.sort(np.where(ix.lists.numpy() < 0, 1 << 30,
                                           ix.lists.numpy()), axis=-1)
        np.testing.assert_array_equal(live(oracle), live(got))
        final = TMState(torch.from_numpy(np.where(
            final_inc, jcfg.n_states + 1, jcfg.n_states).astype(np.int16)))
        assert all(bool(v) for v in indexing.validate(tcfg, final, got).values())
        assert all(bool(v) for v in indexing.validate(tcfg, final, oracle).values())


def test_insert_and_delete_are_the_papers_pointer_algebra():
    _, tcfg = configs(SMALL)
    index = indexing.empty_index(tcfg, tcfg.n_clauses, "cpu")
    for j in (4, 1, 6):
        index = indexing.insert(index, 2, j, 5)
    assert index.lists[2, 5, :3].tolist() == [4, 1, 6]
    index = indexing.delete(index, 2, 4, 5)   # the last entry moves into slot 0
    assert index.lists[2, 5, :3].tolist() == [6, 1, -1]
    assert int(index.counts[2, 5]) == 2
    assert [int(index.pos[2, j, 5]) for j in (4, 1, 6)] == [-1, 1, 0]


# ---------------------------------------------------------------------------
# train_step with every cache, and the README quickstart
# ---------------------------------------------------------------------------


def assert_bundles_equal(tb, jb):
    np.testing.assert_array_equal(tb.state.ta_state.numpy(),
                                  np.asarray(jb.state.ta_state))
    for name, g, w in zip(("lists", "counts", "pos"), tb.caches["indexed"],
                          jb.caches["indexed"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(tb.caches["bitpack"].numpy().view(np.uint32),
                                  np.asarray(jb.caches["bitpack"]))
    assert int(tb.event_overflow) == int(jb.event_overflow)


@pytest.mark.parametrize("max_events", [4096, 12], ids=["roomy", "overflowing"])
@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_train_step_matches_reference(parallel, max_events):
    jcfg, tcfg = configs(WIDER)
    rng = np.random.default_rng(13)
    ta = random_state(jcfg, rng)
    jstate, tstate = both_states(jcfg, tcfg, ta)
    jb = japi.init_bundle(jcfg, engines=ENGINES, state=jstate)
    tb = api.init_bundle(tcfg, engines=ENGINES, state=tstate, device="cpu")
    step = jax.jit(japi.train_step, static_argnames=("parallel", "max_events"))
    for s in range(2):
        xs, ys = batch(jcfg, rng, 4)
        mask = np.array([1, 1, 1, s == 0], bool)
        key = jax.random.key(20 + s)
        jb = step(jb, jnp.asarray(xs), jnp.asarray(ys), key, jnp.asarray(mask),
                  parallel=parallel, max_events=max_events)
        tb = api.train_step(tb, torch.from_numpy(xs), ys,
                            port_draws(jcfg, key, 4), mask,
                            parallel=parallel, max_events=max_events)
        assert_bundles_equal(tb, jb)
    assert (int(tb.event_overflow) > 0) == (max_events == 12)
    if max_events == 4096:
        assert all(bool(v) for v in indexing.validate(
            tcfg, tb.state, tb.index).values())
        assert torch.equal(tb.caches["bitpack"], bitpack.pack_bits(
            tb.state.ta_state > tcfg.n_states))


def test_readme_quickstart_matches_reference():
    """README quickstart (n=32, o=16, 4 epochs of batch 64): the port's
    ``partial_fit`` fed the reference's key chain ends in the same state."""
    jcfg, tcfg = configs(dict(n_classes=2, n_clauses=32, n_features=16))
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 2, (256, jcfg.n_features)).astype("uint8")
    ys = (xs[:, 0] ^ xs[:, 1]).astype("int32")
    jm = JMachine(jcfg, topology=JTopology(), seed=0, max_events_per_batch=8192)
    jm.init().fit(xs, ys, epochs=4, batch_size=64)

    tmach = TsetlinMachine(tcfg, seed=0, max_events_per_batch=8192,
                           device="cpu").init()
    _, key = jax.random.split(jax.random.key(0))     # fit's _next_key
    for _ in range(4):
        for start in range(0, 256, 64):
            key, sub = jax.random.split(key)
            tmach.partial_fit(xs[start:start + 64], ys[start:start + 64],
                              draws=port_draws(jcfg, sub, 64))
    assert tmach.event_overflow == 0 == jm.event_overflow
    np.testing.assert_array_equal(tmach.state.ta_state.numpy(),
                                  np.asarray(jm.state.ta_state))
    np.testing.assert_array_equal(tmach.predict(xs).numpy(),
                                  np.asarray(jm.predict(xs)))
    assert tmach.evaluate(xs, ys, engine="indexed") == \
        jm.evaluate(xs, ys, engine="indexed")


def test_fit_pads_and_masks_the_trailing_batch():
    """``fit`` with a batch size that does not divide the data equals
    ``partial_fit`` over the same batches, the last one zero-padded and
    masked, from the same seed."""
    _, tcfg = configs(SMALL)
    rng = np.random.default_rng(14)
    xs, ys = batch(JConfig(**SMALL), rng, 11)
    a = TsetlinMachine(tcfg, seed=3, device="cpu", max_events_per_batch=600)
    a.init().fit(xs, ys, epochs=2, batch_size=4)
    b = TsetlinMachine(tcfg, seed=3, device="cpu", max_events_per_batch=600)
    b.init()
    pad_x = np.concatenate([xs[8:], np.zeros((1, 6), np.uint8)])
    pad_y = np.concatenate([ys[8:], np.zeros(1, ys.dtype)])
    for _ in range(2):
        b.partial_fit(xs[:4], ys[:4]).partial_fit(xs[4:8], ys[4:8])
        b.partial_fit(pad_x, pad_y, mask=np.arange(4) < 3)
    assert torch.equal(a.state.ta_state, b.state.ta_state)
    assert not torch.equal(a.state.ta_state,
                           torch.full_like(a.state.ta_state, tcfg.n_states))
    with pytest.raises(ValueError, match="exceeds dataset size"):
        a.fit(xs, ys, batch_size=12)
