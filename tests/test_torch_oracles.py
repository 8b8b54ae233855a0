"""The port's oracles and TM-native kernel wrappers against the reference,
on the CPU.

``repro_torch.core.ref`` (the numpy pseudocode) and
``repro_torch.kernels.ref`` (the unpacked oracles) give the reference's
``core/ref.py`` and ``kernels/ref.py`` outputs on the same seeded inputs;
the port's class round, ``dense_clause_outputs`` and ``indexed_scores``
equal the numpy oracle; and ``repro_torch.kernels.ops`` equals
``repro.kernels.ops`` (run with ``backend="xla"``, and once at a tiny size
with ``backend="pallas_interpret"``, the reference's kernel bodies in the
interpreter). Every comparison is exact (integer results, tolerance 0).
Shapes cover a partial last literal word (2o = 90) and full ones (2o = 64).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import ref as jref  # noqa: E402
from repro.core.types import TMConfig as JTMConfig, TMState as JTMState  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jkref  # noqa: E402

from repro_torch.core import ref  # noqa: E402
from repro_torch.core import bitpack, indexing, tm  # noqa: E402
from repro_torch.core.types import TMConfig, TMState, clause_polarity  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import ta_update  # noqa: E402

# (m, n, o): a partial last literal word (2o = 90) and two full ones
SHAPES = [(3, 8, 45), (2, 6, 32)]
BOOST = [False, True]


def config(m, n, o, boost=False, pkg=TMConfig):
    return pkg(n_classes=m, n_clauses=n, n_features=o, n_states=50, s=3.9,
               threshold=4, boost_true_positive=boost)


def case(m, n, o, seed, b=5):
    """TA states (about a tenth included, with empty clauses), inputs."""
    rng = np.random.default_rng(seed)
    ta = np.where(rng.uniform(size=(m, n, 2 * o)) < 0.1,
                  rng.integers(51, 101, (m, n, 2 * o)),
                  rng.integers(1, 51, (m, n, 2 * o))).astype(np.int16)
    ta[:, 0] = 50                                        # an empty clause
    x = rng.integers(0, 2, (b, o)).astype(np.uint8)
    x[0] = np.where(ta[0, 1, :o] > 50, 1,                # satisfy a clause
                    np.where(ta[0, 1, o:] > 50, 0, x[0]))
    return ta, x


def edge_uniforms(shape, s, boost, rng):
    """float32 uniforms, a quarter at a float32 threshold or an ulp off it."""
    u = rng.uniform(size=shape).astype(np.float32)
    edges = []
    for t in ta_update.thresholds(s, boost):
        t = np.float32(t)
        edges += [t, np.nextafter(t, np.float32(0)),
                  np.nextafter(t, np.float32(1))]
    edges = np.array([e for e in edges if e < 1], np.float32)
    pick = rng.uniform(size=shape) < 0.25
    return np.where(pick, edges[rng.integers(0, len(edges), shape)], u)


def round_operands(ta_row, x, positive, seed):
    """One class round's operands for the unpacked update: literals, clause
    outputs, routing, gates, uniforms (with edges)."""
    rng = np.random.default_rng(seed)
    n, L = ta_row.shape
    lit = np.concatenate([x, 1 - x]).astype(np.uint8)
    inc = ta_row > 50
    clause_out = (~(inc & (lit == 0)).any(-1)).astype(np.int8)
    half = np.arange(n) < n // 2
    t1 = half if positive else ~half
    active = rng.uniform(size=n) < 0.6
    return lit, clause_out, t1, active, edge_uniforms((n, L), 3.9, False, rng)


# -- core/ref: the port's copy gives the reference's outputs ------------------


@pytest.mark.parametrize("fn", ["clause_outputs_0", "clause_outputs_1",
                                "votes", "indexed_scores",
                                "class_round_pos", "class_round_neg"])
def test_core_ref_is_the_references(fn):
    m, n, o = SHAPES[0]
    ta, x = case(m, n, o, seed=1)
    rng = np.random.default_rng(2)
    if fn.startswith("clause_outputs"):
        empty = int(fn[-1])
        args = (ta, x[0], 50, empty)
        call = lambda mod: mod.clause_outputs_ref(*args)
    elif fn == "votes":
        out = jref.clause_outputs_ref(ta, x[1], 50)
        call = lambda mod: mod.votes_ref(out)
    elif fn == "indexed_scores":
        lists, counts = build_lists(ta > 50)
        call = lambda mod: mod.indexed_scores_ref(lists, counts, x[2], n)
    else:
        lit = np.concatenate([x[3], 1 - x[3]]).astype(np.uint8)
        gate = rng.uniform(size=n).astype(np.float32)
        type_i = rng.uniform(size=(n, 2 * o)).astype(np.float32)
        call = lambda mod: mod.class_round_ref(
            ta[1], lit, gate, type_i, n_states=50, s=3.9, threshold=4,
            half=n // 2, positive_round=fn.endswith("pos"))
    want, got = call(jref), call(ref)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def build_lists(include):
    """(m, 2o, n) literal → clause lists and (m, 2o) counts, in numpy."""
    m, n, L = include.shape
    lists = np.full((m, L, n), -1, np.int32)
    counts = include.sum(1).astype(np.int32)
    for i in range(m):
        for k in range(L):
            ids = np.flatnonzero(include[i, :, k])
            lists[i, k, :len(ids)] = ids
    return lists, counts


# -- kernels/ref: the unpacked oracles give the reference's outputs -----------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fn", ["clause_votes", "clause_outputs"])
def test_unpacked_clause_oracles_are_the_references(shape, fn):
    m, n, o = shape
    ta, x = case(m, n, o, seed=sum(shape))
    include = ta > 50
    lit = np.concatenate([x, 1 - x], axis=1)
    want = getattr(jkref, f"{fn}_ref")(jnp.asarray(include), jnp.asarray(lit))
    got = getattr(kref, f"{fn}_ref")(torch.from_numpy(include),
                                     torch.from_numpy(lit))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.unique(np.asarray(want)).size > 1


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("boost", BOOST)
@pytest.mark.parametrize("positive", [True, False], ids=["target", "negative"])
def test_unpacked_ta_update_is_the_references(shape, boost, positive):
    """Uniforms at the float32 thresholds included: the oracle's thresholds
    are the reference's once-rounded doubles."""
    m, n, o = shape
    ta, x = case(m, n, o, seed=3)
    ops_ = round_operands(ta[0], x[0], positive, seed=4)
    kw = dict(n_states=50, s=3.9, boost_true_positive=boost)
    want = jkref.ta_update_ref(jnp.asarray(ta[0]),
                               *(jnp.asarray(a) for a in ops_), **kw)
    got = kref.ta_update_ref(torch.from_numpy(ta[0]),
                             *(torch.from_numpy(a) for a in ops_), **kw)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != ta[0]).any()


# -- the port's vectorised path against the numpy oracle ------------------------


@pytest.mark.parametrize("boost", BOOST)
@pytest.mark.parametrize("positive", [True, False], ids=["target", "negative"])
def test_class_round_equals_numpy_oracle(positive, boost):
    m, n, o = SHAPES[0]
    cfg = config(m, n, o, boost)
    ta, x = case(m, n, o, seed=5)
    rng = np.random.default_rng(6)
    pol = clause_polarity(cfg, "cpu")
    changed = 0
    for cls in range(m):
        lit = np.concatenate([x[cls], 1 - x[cls]]).astype(np.uint8)
        gate = rng.uniform(size=n).astype(np.float32)
        type_i = rng.uniform(size=(n, 2 * o)).astype(np.float32)
        row, tlit = torch.from_numpy(ta[cls]), torch.from_numpy(lit)
        clause_out, vote = tm._round_vote(
            cfg, row, bitpack.pack_bits(tlit), pol)
        got = tm._round_feedback(
            cfg, row, tlit, clause_out, vote,
            tm.FeedbackRands(torch.from_numpy(gate), torch.from_numpy(type_i)),
            positive, pol)
        want = ref.class_round_ref(
            ta[cls], lit, gate, type_i, n_states=cfg.n_states, s=cfg.s,
            threshold=cfg.threshold, half=n // 2, positive_round=positive,
            boost_true_positive=boost)
        np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
        changed += int((want != ta[cls]).sum())
    assert changed > 0


@pytest.mark.parametrize("empty_output", [0, 1])
def test_dense_outputs_and_indexed_scores_equal_numpy_oracle(empty_output):
    m, n, o = SHAPES[0]
    cfg = config(m, n, o)
    ta, x = case(m, n, o, seed=7)
    state = TMState(ta_state=torch.from_numpy(ta))
    out = tm.dense_clause_outputs(cfg, state, torch.from_numpy(x),
                                  empty_output=empty_output).numpy()
    votes = tm.clause_votes(cfg, torch.from_numpy(out)).numpy()
    index = indexing.build_index(cfg, state, cfg.resolved_index_capacity)
    scores = indexing.indexed_scores(cfg, index, torch.from_numpy(x)).numpy()
    for b in range(len(x)):
        want = ref.clause_outputs_ref(ta, x[b], cfg.n_states, empty_output)
        np.testing.assert_array_equal(out[b], want)
        np.testing.assert_array_equal(votes[b], ref.votes_ref(want))
        np.testing.assert_array_equal(scores[b], ref.indexed_scores_ref(
            index.lists.numpy(), index.counts.numpy(), x[b], n))
    assert np.unique(scores).size > 1


# -- kernels/ops: the wrappers against the reference's ------------------------


WRAPPERS = ["pack_include", "tm_votes_packed", "tm_votes", "tm_predict",
            "tm_clause_outputs", "tm_ta_update"]


def call_wrapper(mod, name, cfg, ta, x, backend, extra):
    """``mod.<name>`` on the reference's or the port's tensors."""
    if mod is jops:
        state, xs = JTMState(ta_state=jnp.asarray(ta)), jnp.asarray(x)
        arr = jnp.asarray
    else:
        state, xs = TMState(ta_state=torch.from_numpy(ta)), torch.from_numpy(x)
        arr = torch.from_numpy
    if name == "pack_include":
        return mod.pack_include(cfg, state)
    if name == "tm_votes_packed":
        return mod.tm_votes_packed(mod.pack_include(cfg, state), xs,
                                   backend=backend)
    if name == "tm_ta_update":
        return mod.tm_ta_update(cfg, arr(ta[1]), *(arr(a) for a in extra),
                                backend=backend)
    return getattr(mod, name)(cfg, state, xs, backend=backend)


@pytest.mark.parametrize("shape,backend", [
    (SHAPES[0], "xla"), (SHAPES[1], "xla"), ((2, 4, 5), "pallas_interpret")],
    ids=["partial-word", "full-words", "tiny-interpret"])
@pytest.mark.parametrize("name", WRAPPERS)
def test_ops_equal_the_references(name, shape, backend):
    m, n, o = shape
    ta, x = case(m, n, o, seed=8 + o)
    extra = round_operands(ta[1], x[1], True, seed=9)
    want = call_wrapper(jops, name, config(*shape, pkg=JTMConfig), ta, x,
                        backend, extra)
    got = call_wrapper(ops, name, config(*shape), ta, x, None, extra)
    want = np.asarray(want)
    got = got.numpy()
    if name == "pack_include":            # int32 words, the same bits
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    assert got.shape == want.shape


@pytest.mark.parametrize("name", ["tm_votes", "tm_clause_outputs"])
def test_ops_equal_the_unpacked_oracles(name):
    m, n, o = SHAPES[0]
    cfg = config(m, n, o)
    ta, x = case(m, n, o, seed=10)
    include = torch.from_numpy(ta > 50)
    lit = torch.from_numpy(np.concatenate([x, 1 - x], axis=1))
    got = getattr(ops, name)(cfg, TMState(ta_state=torch.from_numpy(ta)),
                             torch.from_numpy(x))
    oracle = kref.clause_votes_ref if name == "tm_votes" else kref.clause_outputs_ref
    assert torch.equal(got, oracle(include, lit))


def test_tm_predict_breaks_ties_to_the_lowest_class():
    """Votes tie often (integers); like ``jnp.argmax``, the first maximal
    class wins."""
    m, n, o = 4, 4, 3
    cfg = config(m, n, o)
    ta = np.full((m, n, 2 * o), 50, np.int16)     # every clause empty (true)
    # including x_0 falsifies a clause where x_0 = 0: class 0 loses a
    # positive clause, classes 1 and 3 a negative one
    ta[0, 0, 0] = ta[1, 2, 0] = ta[3, 3, 0] = 60
    x = np.array([[0, 1, 1], [1, 1, 1]], np.uint8)
    state = TMState(ta_state=torch.from_numpy(ta))
    votes = ops.tm_votes(cfg, state, torch.from_numpy(x))
    assert votes.tolist() == [[-1, 1, 0, 1], [0, 0, 0, 0]]
    got = ops.tm_predict(cfg, state, torch.from_numpy(x)).numpy()
    want = np.asarray(jops.tm_predict(
        config(m, n, o, pkg=JTMConfig), JTMState(ta_state=jnp.asarray(ta)),
        jnp.asarray(x), backend="xla"))
    np.testing.assert_array_equal(got, [1, 0])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["pallas", "xla", "pallas_interpret", "cuda"])
def test_ops_refuse_a_backend_other_than_auto(backend):
    m, n, o = 2, 4, 5
    cfg = config(m, n, o)
    ta, x = case(m, n, o, seed=11)
    state, xs = TMState(ta_state=torch.from_numpy(ta)), torch.from_numpy(x)
    for auto in (None, "auto"):
        assert torch.equal(ops.tm_votes(cfg, state, xs, backend=auto),
                           ops.tm_votes(cfg, state, xs))
    for name in WRAPPERS[1:]:
        extra = round_operands(ta[1], x[1], True, seed=9)
        with pytest.raises(ValueError, match="not selectable"):
            call_wrapper(ops, name, cfg, ta, x, backend, extra)
