"""The falsification index's list walk (``repro_torch.kernels.indexed.
indexed_votes_walk_ref``, the ``indexed_votes`` primitive's plain body)
against the JAX package, on the CPU.

The walk visits the inclusion lists of the false literals (paper Eq. 4);
the reference scores the same index from its position matrix (the matmul
form ``indexed_votes_xla`` and the Pallas kernel in interpret mode). They
must agree on every index the port builds or replays:

  * fresh indexes of the unaligned shapes of ``tests/test_torch_kernels.py``
    at B ∈ {1, 31, 33, 70};
  * overflowing ones (``index_capacity`` below the longest list), whose ids
    past the capacity live only in ``pos``;
  * indexes after a batched event replay (unsorted lists), and a list that
    overflowed and shrank back under its capacity with a hole in its
    prefix;
  * clause-sharded ones, whose partials sum to the scores.

The CUDA kernel runs only on a card (``tests/test_torch_cuda.py``); here
its wrapper must refuse CPU tensors and its launch plan must cover every
clause and sample. Every comparison is integer and exact (tolerance 0);
inputs come from seeded numpy generators.
"""
import dataclasses
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import indexing as jindexing  # noqa: E402
from repro.core.types import TMConfig as JConfig  # noqa: E402
from repro.core.types import TMState as JState  # noqa: E402
from repro.kernels import indexed as jindexed  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed, indexing  # noqa: E402
from repro_torch.core.session import TMSession, Topology  # noqa: E402
from repro_torch.core.types import TMState, clause_polarity  # noqa: E402
from repro_torch.kernels import backend, indexed  # noqa: E402

# (m, n, o): the unaligned shapes of tests/test_torch_kernels.py
SHAPES = [(2, 4, 5), (3, 8, 17), (10, 130, 50), (2, 256, 196), (1, 2, 2049)]
BATCHES = [1, 31, 33, 70]


def configs(m, n, o, **extra):
    jcfg = JConfig(n_classes=m, n_clauses=n, n_features=o, n_states=10,
                   s=3.0, threshold=4, **extra)
    return jcfg, convert.config_from_reference(dataclasses.asdict(jcfg))


def random_state(jcfg, rng, per_clause=4.0):
    """TA states with about ``per_clause`` included literals per clause (at
    most 30% of them), at random depths on both sides of the boundary:
    some clauses are empty, some fire, some are falsified."""
    shape = (jcfg.n_classes, jcfg.n_clauses, 2 * jcfg.n_features)
    n = jcfg.n_states
    inc = rng.uniform(size=shape) < min(0.3, per_clause / shape[-1])
    return np.where(inc, rng.integers(n + 1, 2 * n + 1, shape),
                    rng.integers(1, n + 1, shape)).astype(np.int16)


def both_indexes(jcfg, tcfg, ta):
    """The JAX package's and the port's ``build_index`` of one state, which
    must be equal array for array."""
    cap = jcfg.resolved_index_capacity
    jindex = jindexing.build_index(jcfg, JState(ta_state=jnp.asarray(ta)), cap)
    tindex = indexing.build_index(tcfg, TMState(torch.from_numpy(ta)), cap)
    for name, j, t in zip(("lists", "counts", "pos"), jindex, tindex):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    return jindex, tindex


def inputs(o, n, b, rng):
    x = rng.integers(0, 2, (b, o)).astype(np.uint8)
    lit = np.concatenate([x, 1 - x], axis=-1)
    pol = np.where(np.arange(n) < n // 2, 1, -1).astype(np.int32)
    return x, lit, pol


def reference_votes(jpos, lit, pol) -> list[np.ndarray]:
    """The reference's two bodies on its own position matrix."""
    args = (jnp.asarray(jpos), jnp.asarray(lit), jnp.asarray(pol))
    return [np.asarray(jindexed.indexed_votes_xla(*args)),
            np.asarray(jindexed.indexed_votes(*args, interpret=True))]


def walk(index, lit, pol) -> np.ndarray:
    got = indexed.indexed_votes_walk_ref(
        index.lists, index.counts, index.pos, torch.from_numpy(lit),
        torch.from_numpy(pol))
    assert got.dtype == torch.int32
    return got.numpy()


def pos_form(index, lit, pol) -> np.ndarray:
    return indexed.indexed_votes_ref(index.pos, torch.from_numpy(lit),
                                     torch.from_numpy(pol)).numpy()


# ---------------------------------------------------------------------------
# fresh, overflowing and replayed indexes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("shape", SHAPES)
def test_walk_equals_the_references(shape, b):
    m, n, o = shape
    jcfg, tcfg = configs(m, n, o)
    rng = np.random.default_rng(sum(shape) + b)
    jindex, tindex = both_indexes(jcfg, tcfg, random_state(jcfg, rng))
    assert bool(indexed.walkable(tindex.lists, tindex.counts, n).all())
    _, lit, pol = inputs(o, n, b, rng)
    got = walk(tindex, lit, pol)
    assert got.shape == (b, m)
    np.testing.assert_array_equal(got, pos_form(tindex, lit, pol))
    for want in reference_votes(jindex.pos, lit, pol):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("capacity", [1, 2])
@pytest.mark.parametrize("shape", [(3, 8, 17), (10, 130, 50), (2, 256, 196)])
def test_walk_covers_overflowing_lists_from_pos(shape, capacity):
    m, n, o = shape
    jcfg, tcfg = configs(m, n, o, index_capacity=capacity)
    rng = np.random.default_rng(7 * capacity + n)
    ta = random_state(jcfg, rng, per_clause=5.0)
    jindex, tindex = both_indexes(jcfg, tcfg, ta)
    over = tindex.counts > capacity
    assert bool(over.any()), "no list overflows: the check is void"
    assert torch.equal(indexed.walkable(tindex.lists, tindex.counts, n), ~over)
    _, lit, pol = inputs(o, n, 33, rng)
    got = walk(tindex, lit, pol)
    np.testing.assert_array_equal(got, pos_form(tindex, lit, pol))
    for want in reference_votes(jindex.pos, lit, pol):
        np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1, "votes all equal: the check is void"


def random_buffer(ta, n_states, rng, steps=3):
    """A valid event buffer: ``steps`` rounds of random flips of the include
    mask, each cell's events alternating, plus masked-out padding slots."""
    inc = ta > n_states
    cols = [[] for _ in range(5)]
    for _ in range(steps):
        for i, j, k in np.argwhere(rng.uniform(size=inc.shape) < 0.05):
            for col, v in zip(cols, (i, j, k, not inc[i, j, k], True)):
                col.append(v)
            inc[i, j, k] = not inc[i, j, k]
        for _ in range(3):
            for col, v in zip(cols, (0, 0, 0, True, False)):
                col.append(v)
    dtypes = (np.int32, np.int32, np.int32, bool, bool)
    return [np.asarray(c, d) for c, d in zip(cols, dtypes)], inc


def unsorted_lists(index) -> int:
    """Lists whose live prefix is not ascending."""
    lists = index.lists
    used = torch.arange(lists.shape[-1]) < index.counts.clamp(
        max=lists.shape[-1])[..., None]
    steps = (lists[..., 1:] < lists[..., :-1]) & used[..., 1:]
    return int(steps.any(-1).sum())


@pytest.mark.parametrize("capacity", [None, 6, 2], ids=["full", "cap6", "cap2"])
def test_walk_after_an_event_replay(capacity):
    """After ``index_update`` replays a buffer the lists are unsorted (and,
    under a small capacity, overflowing or holed); the walk still equals
    the position form on the replayed index, on a rebuild from the final
    include mask, and the reference's replay."""
    m, n, o = 2, 66, 40
    jcfg, tcfg = configs(m, n, o, index_capacity=capacity)
    rng = np.random.default_rng(12)
    ta = random_state(jcfg, rng, per_clause=10.0)
    events, final_inc = random_buffer(ta, jcfg.n_states, rng)
    jindex, tindex = both_indexes(jcfg, tcfg, ta)
    jreplayed = jax.jit(jindexed.index_update_batched)(
        *jindex, *(jnp.asarray(e) for e in events))
    replayed = indexing.index_update(tindex, indexing.Event(
        *(torch.from_numpy(e) for e in events)))
    for name, t, j in zip(("lists", "counts", "pos"), replayed, jreplayed):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert unsorted_lists(replayed) > 0, "every list sorted: the check is void"
    final = np.where(final_inc, jcfg.n_states + 1, jcfg.n_states).astype(np.int16)
    _, rebuilt = both_indexes(jcfg, tcfg, final)
    _, lit, pol = inputs(o, n, 70, rng)
    got = walk(replayed, lit, pol)
    np.testing.assert_array_equal(got, pos_form(replayed, lit, pol))
    np.testing.assert_array_equal(got, pos_form(rebuilt, lit, pol))
    np.testing.assert_array_equal(got, walk(rebuilt, lit, pol))
    for want in reference_votes(jreplayed[2], lit, pol):
        np.testing.assert_array_equal(got, want)


def test_walk_covers_a_list_that_shrank_back_under_its_capacity():
    """Literal 0 of class 0 is included by clauses 0–3 at capacity 2: the
    list holds [0, 1], clauses 2 and 3 live only in ``pos``. Deleting 0 and
    1 brings the count back to 2 = capacity, with an empty prefix (a hole):
    the count alone would trust the list and miss clauses 2 and 3."""
    m, n, o, cap = 1, 6, 3, 2
    jcfg, tcfg = configs(m, n, o, index_capacity=cap)
    ta = np.full((m, n, 2 * o), jcfg.n_states, np.int16)
    ta[0, :4, 0] = jcfg.n_states + 1
    ta[0, 4, 1] = jcfg.n_states + 1
    jindex, tindex = both_indexes(jcfg, tcfg, ta)
    assert tindex.lists[0, 0].tolist() == [0, 1] and int(tindex.counts[0, 0]) == 4
    events = [np.array([0, 0], np.int32), np.array([0, 1], np.int32),
              np.array([0, 0], np.int32), np.array([False, False]),
              np.array([True, True])]
    replayed = indexing.index_update(tindex, indexing.Event(
        *(torch.from_numpy(e) for e in events)))
    jreplayed = jindexed.index_update_batched(
        *jindex, *(jnp.asarray(e) for e in events))
    for t, j in zip(replayed, jreplayed):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert int(replayed.counts[0, 0]) == cap
    assert (replayed.pos[0, 2:4, 0] != -1).all()
    assert not bool(indexed.walkable(replayed.lists, replayed.counts, n)[0, 0])
    # sample 0 has literal 0 false (x_0 = 0): clauses 2 and 3 are falsified
    x = np.array([[0, 1, 1], [1, 0, 1]], np.uint8)
    lit = np.concatenate([x, 1 - x], axis=-1)
    pol = np.array([1, 1, 1, -1, -1, -1], np.int32)
    got = walk(replayed, lit, pol)
    np.testing.assert_array_equal(got, pos_form(replayed, lit, pol))
    assert got.tolist() == [[0], [1]]
    for want in reference_votes(jreplayed[2], lit, pol):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# clause sharding: the partials add up
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,n", [(2, 20), (3, 20), (4, 22), (3, 22)],
                         ids=["C2-even", "C3-ragged", "C4-ragged", "C3-ragged22"])
def test_sharded_partials_sum_to_the_scores(c, n):
    m, o, b = 3, 12, 12
    jcfg, tcfg = configs(m, n, o)
    rng = np.random.default_rng(c * 100 + n)
    ta = random_state(jcfg, rng, per_clause=3.0)
    x, lit, _ = inputs(o, n, b, rng)
    full = indexing.build_index(tcfg, TMState(torch.from_numpy(ta)),
                                tcfg.resolved_index_capacity)
    want = walk(full, lit, clause_polarity(tcfg, "cpu").numpy())
    jbundle = japi.init_bundle(jcfg, engines=("indexed",),
                               state=JState(ta_state=jnp.asarray(ta)))
    np.testing.assert_array_equal(
        want, np.asarray(japi.bundle_scores(jbundle, jnp.asarray(x),
                                            engine="indexed")))
    assert len(np.unique(want)) > 1, "scores all equal: the check is void"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        session = TMSession(tcfg, Topology(clause_shards=c),
                            engines=("indexed",), device="cpu")
    bundle = session.prepare(TMState(torch.from_numpy(ta)))
    geom = distributed.geometry(tcfg, session.mesh)
    pols = distributed._polarity_grid(tcfg, session.mesh, geom)
    parts = []
    for r in range(c):
        index = bundle.ranks[0][r].caches["indexed"]
        assert index.pos.shape[1] == geom.n_local
        parts.append(walk(index, lit, pols[0][r].numpy()))
    np.testing.assert_array_equal(sum(parts), want)
    np.testing.assert_array_equal(session.scores(bundle, x, engine="indexed")
                                  .numpy(), want)


# ---------------------------------------------------------------------------
# the registry, the wrapper and the launch plan
# ---------------------------------------------------------------------------


def test_registry_plain_body_is_the_walk():
    prim = backend.get_primitive("indexed_votes")
    assert prim.plain is indexed.indexed_votes_walk_ref
    assert prim.kernel is indexed.indexed_votes
    jcfg, tcfg = configs(3, 8, 17)
    rng = np.random.default_rng(3)
    _, tindex = both_indexes(jcfg, tcfg, random_state(jcfg, rng))
    x, lit, pol = inputs(17, 8, 9, rng)
    before = indexed.indexed_votes.launches
    got = indexing.indexed_partial_scores(tindex, torch.from_numpy(x),
                                          torch.from_numpy(pol))
    assert indexed.indexed_votes.launches == before     # no launch on the CPU
    np.testing.assert_array_equal(got.numpy(), walk(tindex, lit, pol))


def test_cuda_wrapper_refuses_cpu_tensors():
    jcfg, tcfg = configs(2, 4, 5)
    rng = np.random.default_rng(4)
    _, tindex = both_indexes(jcfg, tcfg, random_state(jcfg, rng))
    _, lit, pol = inputs(5, 4, 3, rng)
    with pytest.raises(ValueError, match="CUDA tensor"):
        indexed.indexed_votes(*tindex, torch.from_numpy(lit),
                              torch.from_numpy(pol))


@pytest.mark.parametrize("b,m,n,window", [
    (1, 10, 2000, None), (32, 2, 2000, None), (33, 3, 20_000, None),
    (70, 2, 100, 7), (5, 1, 1, None), (2_500_000, 1, 40_000, 64),
    (320, 2, 2000, None)])
def test_walk_plan_covers_every_clause_and_sample(b, m, n, window):
    plan = indexed.walk_plan(b, m, n, window=window)
    assert plan.window == (min(n, indexed.MAX_WINDOW) if window is None
                           else window)
    assert plan.n_windows * plan.window >= n > (plan.n_windows - 1) * plan.window
    assert plan.n_words * 32 >= b > (plan.n_words - 1) * 32
    one_wave = indexed.MAX_CLUSTER * m * plan.n_words * plan.n_windows <= indexed.SMS
    assert plan.cluster == (indexed.MAX_CLUSTER if one_wave else indexed.CLUSTER)
    assert plan.grid == (plan.cluster, m, plan.n_words * plan.n_windows)
    assert plan.smem_bytes <= indexed.SMEM_LIMIT


def test_walk_plan_refuses_what_the_card_cannot_launch():
    with pytest.raises(ValueError, match="cluster"):
        indexed.walk_plan(1, 1, 10, cluster=17)
    with pytest.raises(ValueError, match="shared memory"):
        indexed.walk_plan(1, 1, 100_000, window=60_000)
    assert indexed.walk_plan(1, 1, 100_000).n_windows == 7
