"""Asynchronous stale-vote training in the port (``Topology(async_votes=K)``)
against the JAX reference, on the CPU.

  * the learning round's shard keywords (``pol``, ``clause_start``,
    ``clause_mask``, ``stale_votes``) of ``tm.update_batch_sequential`` and
    ``tm.update_batch_parallel`` against the reference's, which run on one
    JAX device with no mesh, ``(vs, vc)`` included;
  * a sharded asynchronous step, rank by rank, against the reference's
    round on that rank's rows and stale terms, and the accumulator's write
    buffer against ``jnp.round(vs / max(vc, 1))``;
  * the refresh against a hand computation (``stale = total − local``,
    overflow drained, data rank 0 only under composition);
  * ``async_votes=0`` bit-exact with synchronous learning, no vote
    reduction inside an asynchronous step, exact overflow accounting;
  * the quick units of the reference's ``tests/test_tm_async.py``.

All results are integers: tolerance 0.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import tm as jtm  # noqa: E402
from repro.core.types import TMConfig as JConfig  # noqa: E402
from repro.core.types import TMState as JState  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api, distributed, tm  # noqa: E402
from repro_torch.core.session import TMSession, Topology  # noqa: E402
from repro_torch.core.types import TMState, VoteAccumulator, include_mask  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

CFG = dict(n_classes=3, n_clauses=20, n_features=12, n_states=10, s=3.0,
           threshold=4)
BATCH = 8
MASK = np.array([1, 1, 0, 1, 1, 1, 1, 0], bool)


def configs():
    jcfg = JConfig(**CFG)
    return jcfg, convert.config_from_reference(dataclasses.asdict(jcfg))


def random_state(jcfg, rng, rows=None):
    shape = (jcfg.n_classes, rows or jcfg.n_clauses, 2 * jcfg.n_features)
    n = jcfg.n_states
    inc = rng.uniform(size=shape) < 0.15
    return np.where(inc, rng.integers(n + 1, 2 * n + 1, shape),
                    rng.integers(1, n + 1, shape)).astype(np.int16)


@functools.cache
def _draw_fn(jcfg, batch):
    def one(key):
        k_neg, k_a, k_b = jax.random.split(key, 3)
        neg = jax.random.randint(k_neg, (), 0, jcfg.n_classes - 1)
        a = jtm.draw_feedback_rands(jcfg, k_a)
        b = jtm.draw_feedback_rands(jcfg, k_b)
        return neg, a.clause_gate, a.type_i, b.clause_gate, b.type_i

    return jax.jit(lambda rng: jax.vmap(one)(jax.random.split(rng, batch)))


def port_draws(jcfg, key, batch=BATCH):
    return convert.draws_from_reference(
        *[np.array(t) for t in _draw_fn(jcfg, batch)(key)], device="cpu")


def data(jcfg, seed):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 2, (BATCH, jcfg.n_features)).astype(np.uint8)
    ys = rng.integers(0, jcfg.n_classes, BATCH).astype(np.int32)
    return rng, xs, ys


def shard(jcfg, rng, start, rows):
    """A clause shard's rows: state, polarity (0 past n_clauses), mask."""
    ta = random_state(jcfg, rng, rows)
    g = start + np.arange(rows)
    real = g < jcfg.n_clauses
    ta[:, ~real] = jcfg.n_states
    pol = np.where(g < jcfg.n_clauses // 2, 1, -1) * real
    return ta, pol.astype(np.int32), real


# ---------------------------------------------------------------------------
# the round's shard keywords against the reference
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(0, 1))
def reference_round(jcfg, parallel, ta, xs, ys, key, pol, start, mask,
                    clause_mask, stale_votes):
    """The reference's batch update of one shard (one compile per mode)."""
    fn = jtm.update_batch_parallel if parallel else jtm.update_batch_sequential
    return fn(jcfg, JState(ta_state=ta), xs, ys, key, pol=pol,
              clause_start=start, mask=mask, clause_mask=clause_mask,
              stale_votes=stale_votes)


@pytest.mark.parametrize("stale", [False, True], ids=["sync", "stale"])
@pytest.mark.parametrize("parallel", [False, True],
                         ids=["sequential", "parallel"])
@pytest.mark.parametrize("start", [0, 14, 9],
                         ids=["even", "ragged-tail", "inner"])
def test_shard_round_matches_reference(start, parallel, stale):
    jcfg, tcfg = configs()
    rng, xs, ys = data(jcfg, start)
    ta, pol, real = shard(jcfg, rng, start, 7)
    stale_votes = (rng.integers(-6, 7, jcfg.n_classes).astype(np.int32)
                   if stale else None)
    clause_mask = None if real.all() else real
    key = jax.random.key(start)
    want = reference_round(
        jcfg, parallel, jnp.asarray(ta), jnp.asarray(xs), jnp.asarray(ys),
        key, jnp.asarray(pol), jnp.int32(start), jnp.asarray(MASK),
        jnp.asarray(real), None if stale_votes is None
        else jnp.asarray(stale_votes))
    tfn = tm.update_batch_parallel if parallel else tm.update_batch_sequential
    got = tfn(tcfg, TMState(ta_state=torch.from_numpy(ta)), xs, ys,
              port_draws(jcfg, key), mask=MASK, pol=torch.from_numpy(pol),
              clause_start=start,
              clause_mask=None if clause_mask is None
              else torch.from_numpy(clause_mask),
              stale_votes=None if stale_votes is None
              else torch.from_numpy(stale_votes))
    if stale:
        (want, (wvs, wvc)), (got, (vs, vc)) = want, got
        np.testing.assert_array_equal(vs.numpy(), np.asarray(wvs))
        np.testing.assert_array_equal(vc.numpy(), np.asarray(wvc))
        assert int(vc.sum()) == 2 * int(MASK.sum())
    np.testing.assert_array_equal(got.ta_state.numpy(),
                                  np.asarray(want.ta_state))
    assert not np.array_equal(got.ta_state.numpy(), ta)
    np.testing.assert_array_equal(got.ta_state.numpy()[:, ~real],
                                  ta[:, ~real])     # padding rows frozen


def test_update_sample_takes_the_shard_keywords():
    jcfg, tcfg = configs()
    rng, xs, ys = data(jcfg, 1)
    ta, pol, real = shard(jcfg, rng, 14, 7)
    stale = rng.integers(-6, 7, jcfg.n_classes).astype(np.int32)
    key = jax.random.key(2)
    want, (wvs, wvc) = jtm.update_sample(
        jcfg, JState(ta_state=jnp.asarray(ta)), jnp.asarray(xs[0]),
        jnp.asarray(ys[0]), jax.random.split(key, 1)[0], pol=jnp.asarray(pol),
        clause_start=jnp.int32(14), clause_mask=jnp.asarray(real),
        stale_votes=jnp.asarray(stale))
    got, (vs, vc) = tm.update_sample(
        tcfg, TMState(ta_state=torch.from_numpy(ta)), torch.from_numpy(xs[0]),
        int(ys[0]), port_draws(jcfg, key, 1).sample(0),
        pol=torch.from_numpy(pol), clause_start=14,
        clause_mask=torch.from_numpy(real), stale_votes=torch.from_numpy(stale))
    np.testing.assert_array_equal(got.ta_state.numpy(), np.asarray(want.ta_state))
    np.testing.assert_array_equal(vs.numpy(), np.asarray(wvs))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(wvc))


# ---------------------------------------------------------------------------
# a sharded asynchronous step, rank by rank
# ---------------------------------------------------------------------------


def async_session(tcfg, c, d, k=4, **kw):
    return TMSession(tcfg, Topology(clause_shards=c, data_shards=d,
                                    async_votes=k),
                     engines=("dense", "bitpack", "indexed"), device="cpu",
                     **kw)


def with_stale(bundle, rng, m, same_over_data=False):
    """The bundle with random stale terms in every rank's accumulator."""
    rows = [[None] * len(bundle.ranks[0]) for _ in bundle.ranks]
    draws = rng.integers(-6, 7, (len(bundle.ranks), len(bundle.ranks[0]), m))
    if same_over_data:
        draws[:] = draws[0]
    for d, row in enumerate(bundle.ranks):
        for c, rank in enumerate(row):
            acc = rank.vote_acc
            stale = torch.from_numpy(draws[d, c].astype(np.int32))[None]
            rows[d][c] = dataclasses.replace(
                rank, vote_acc=acc._replace(stale=stale))
    return dataclasses.replace(bundle, ranks=tuple(map(tuple, rows)))


def write_buffer(vs, vc, old):
    return np.where(np.asarray(vc) > 0, np.asarray(jnp.round(
        vs / jnp.maximum(vc, 1)).astype(jnp.int32)), old)


@pytest.mark.parametrize("c,d", [(3, 1), (2, 2), (2, 3)],
                         ids=["clause_only-ragged", "composed_even",
                              "composed_ragged"])
def test_sharded_async_step_matches_reference_rank_by_rank(c, d):
    jcfg, tcfg = configs()
    rng, xs, ys = data(jcfg, 10 + c + d)
    ta = random_state(jcfg, rng)
    s = async_session(tcfg, c, d)
    g = s.geometry
    bundle = with_stale(s.prepare(TMState(ta_state=torch.from_numpy(ta))),
                        rng, jcfg.n_classes)
    key = jax.random.key(c * d)
    new = s.train_step(bundle, xs, ys, port_draws(jcfg, key), MASK)
    assert s._step.reductions == (1 if g.composes else 0)   # reassembly only
    padded = distributed.pad_state(tcfg, TMState(torch.from_numpy(ta)),
                                   g.n_padded).ta_state.numpy()
    pol_all = distributed.sharded_polarity(tcfg, g).numpy()
    sub = g.n_sub if g.composes else g.n_local
    want_state = padded.copy()
    for dd in range(d):
        for cc in range(c):
            off = dd * sub if g.composes else 0
            lo = cc * g.n_local + off
            hi = min(lo + sub, (cc + 1) * g.n_local)
            if hi <= lo:
                continue
            rows = np.full((jcfg.n_classes, sub, 2 * jcfg.n_features),
                           jcfg.n_states, np.int16)
            rows[:, :hi - lo] = padded[:, lo:hi]
            pol = np.zeros(sub, np.int32)
            pol[:hi - lo] = pol_all[lo:hi]
            real = (np.arange(sub) < hi - lo) & (lo + np.arange(sub)
                                                 < jcfg.n_clauses)
            acc = bundle.rank(dd, cc).vote_acc
            jst, (vs, vc) = jtm.update_batch_sequential(
                jcfg, JState(ta_state=jnp.asarray(rows)), jnp.asarray(xs),
                jnp.asarray(ys), key, pol=jnp.asarray(pol),
                clause_start=jnp.int32(lo), mask=jnp.asarray(MASK),
                clause_mask=jnp.asarray(real),
                stale_votes=jnp.asarray(acc.stale[0].numpy()))
            want_state[:, lo:hi] = np.asarray(jst.ta_state)[:, :hi - lo]
            got = new.rank(dd, cc).vote_acc
            np.testing.assert_array_equal(
                got.local[0].numpy(), write_buffer(vs, vc, acc.local[0].numpy()))
            np.testing.assert_array_equal(got.stale.numpy(), acc.stale.numpy())
    np.testing.assert_array_equal(new.state.ta_state.numpy(), want_state)
    assert not np.array_equal(want_state, padded)


def test_sharded_async_parallel_step_matches_reference():
    jcfg, tcfg = configs()
    rng, xs, ys = data(jcfg, 21)
    ta = random_state(jcfg, rng)
    s = async_session(tcfg, 2, 2, parallel=True)
    n = s.geometry.n_local
    bundle = with_stale(s.prepare(TMState(ta_state=torch.from_numpy(ta))),
                        rng, jcfg.n_classes, same_over_data=True)
    key = jax.random.key(5)
    new = s.train_step(bundle, xs, ys, port_draws(jcfg, key), MASK)
    assert s._step.reductions == 1          # the delta sum over data ranks
    half = BATCH // 2
    for cc in range(2):
        kw = dict(pol=jnp.asarray(np.where(np.arange(cc * n, (cc + 1) * n)
                                           < 10, 1, -1).astype(np.int32)),
                  clause_start=jnp.int32(cc * n))
        jshard = JState(ta_state=jnp.asarray(ta[:, cc * n:(cc + 1) * n]))
        stale = jnp.asarray(bundle.rank(0, cc).vote_acc.stale[0].numpy())
        # the state: every sample's delta, then one clip
        want, _ = jtm.update_batch_parallel(
            jcfg, jshard, jnp.asarray(xs), jnp.asarray(ys), key,
            mask=jnp.asarray(MASK), stale_votes=stale, **kw)
        np.testing.assert_array_equal(new.rank(0, cc).state.ta_state.numpy(),
                                      np.asarray(want.ta_state))
        # each data rank's votes: its own slice of the batch
        for dd in range(2):
            rows = slice(dd * half, (dd + 1) * half)
            _, (vs, vc) = jtm.update_batch_parallel(
                jcfg, jshard, jnp.asarray(xs[rows]), jnp.asarray(ys[rows]),
                key, batch_start=dd * half, batch_total=BATCH,
                mask=jnp.asarray(MASK[rows]), stale_votes=stale, **kw)
            np.testing.assert_array_equal(
                new.rank(dd, cc).vote_acc.local[0].numpy(),
                write_buffer(vs, vc, np.zeros(jcfg.n_classes, np.int32)))


# ---------------------------------------------------------------------------
# the refresh, the cadence and the overflow accounting
# ---------------------------------------------------------------------------


def set_accumulators(bundle, local, overflow):
    rows = []
    for d, row in enumerate(bundle.ranks):
        rows.append(tuple(dataclasses.replace(rank, vote_acc=VoteAccumulator(
            local=torch.tensor(local[d][c], dtype=torch.int32)[None],
            stale=torch.zeros_like(rank.vote_acc.stale),
            overflow=torch.tensor([overflow[d][c]], dtype=torch.int32)))
            for c, rank in enumerate(row)))
    return dataclasses.replace(bundle, ranks=tuple(rows))


@pytest.mark.parametrize("parallel", [False, True],
                         ids=["composed", "batch_parallel"])
def test_refresh_arithmetic_by_hand(parallel):
    _, tcfg = configs()
    s = async_session(tcfg, 2, 2, parallel=parallel)
    local = [[[1, -2, 3], [4, 5, -6]], [[7, 0, 1], [-1, 2, 2]]]
    overflow = [[3, 4], [30, 40]]
    bundle = set_accumulators(s.init_bundle(), local, overflow)
    out = s.refresh_votes(bundle)
    assert s._refresh.reductions == 1
    loc = np.asarray(local)
    for d in range(2):
        for c in range(2):
            # composed: every rank owns distinct rows, so the total is over
            # all four; batch-parallel: over the data rank's clause ranks
            total = loc[d].sum(0) if parallel else loc.sum((0, 1))
            acc = out.rank(d, c).vote_acc
            np.testing.assert_array_equal(acc.stale[0].numpy(),
                                          total - loc[d, c])
            np.testing.assert_array_equal(acc.local[0].numpy(), loc[d, c])
            assert int(acc.overflow[0]) == 0
    # data rank 0's counts only: the data ranks of a shard count one drop
    # once (composed), or hold replicated clause rows (batch-parallel)
    assert int(out.event_overflow) == 3 + 4
    np.testing.assert_array_equal(out.vote_acc.stale.numpy()[0],
                                  (loc[0].sum(0) if parallel
                                   else loc.sum((0, 1))) - loc[0, 0])


def test_async_zero_is_bit_exact_with_sync():
    jcfg, tcfg = configs()
    rng, xs, ys = data(jcfg, 30)
    ta = torch.from_numpy(random_state(jcfg, rng))
    states = []
    for topo in (Topology(), Topology(clause_shards=2),
                 Topology(clause_shards=2, async_votes=0)):
        s = TMSession(tcfg, topo, device="cpu")
        b = s.prepare(TMState(ta_state=ta))
        g = torch.Generator().manual_seed(4)
        for _ in range(3):
            b = s.train_step(b, xs, ys, g, MASK)
        states.append(s.unpad_state(b.state).ta_state)
        assert s.refresh_votes(b) is b            # a no-op when synchronous
    assert torch.equal(states[0], states[1]) and torch.equal(states[1],
                                                             states[2])
    assert not torch.equal(states[0], ta)


def test_async_step_reduces_no_vote_and_refreshes_every_k_steps():
    jcfg, tcfg = configs()
    rng, xs, ys = data(jcfg, 40)
    s = async_session(tcfg, 4, 1, k=4)
    b = s.prepare(TMState(ta_state=torch.from_numpy(random_state(jcfg, rng))))
    g = torch.Generator().manual_seed(1)
    for step in range(8):
        b = s.train_step(b, xs, ys, g)
        assert s._refresh.reductions == (step + 1) // 4
    assert s._step.reductions == 0
    assert b.vote_acc.stale.shape == (4, 3) and b.vote_acc.stale.any()


def crossings(cfg, a, b):
    return int((include_mask(cfg, TMState(a)) != include_mask(cfg, TMState(b)))
               .sum())


@pytest.mark.parametrize("c,d,distinct", [(2, 1, False), (2, 2, False),
                                          (2, 2, True)],
                         ids=["clause_only", "composed",
                              "composed-distinct-devices"])
def test_overflow_is_counted_once_and_drains_at_the_refresh(c, d, distinct):
    """With ``max_events=0`` every boundary crossing drops: the count must
    equal the crossings of the actual trajectory, lag between refreshes,
    and count each clause shard's drops once, not once per data rank.
    ``distinct``: every rank is its own ``torch.device`` (``cpu:0``,
    ``cpu:1``, …), so each data rank keeps its own copy and caches, as on
    distinct cards, and the count comes from data rank 0's copy."""
    jcfg, tcfg = configs()
    rng, xs, ys = data(jcfg, 50)
    ta = torch.from_numpy(random_state(jcfg, rng))
    mesh = (make_mesh(d, c, devices=[f"cpu:{i}" for i in range(c * d)])
            if distinct else None)
    for k in (0, 2):
        s = TMSession(tcfg, Topology(clause_shards=c, data_shards=d,
                                     async_votes=k), device="cpu",
                      max_events=0, mesh=mesh)
        b = s.prepare(TMState(ta_state=ta))
        g = torch.Generator().manual_seed(2)
        total, seen = 0, []
        for _ in range(4):
            before = s.unpad_state(b.state).ta_state
            b = s.train_step(b, xs, ys, g)
            total += crossings(tcfg, before, s.unpad_state(b.state).ta_state)
            seen.append(int(b.event_overflow))
        assert total > 0
        if k == 0:
            assert seen[-1] == total
        else:
            assert seen[0] == 0 and seen[1] == seen[2] and seen[3] == total


# ---------------------------------------------------------------------------
# quick units of the reference's tests/test_tm_async.py
# ---------------------------------------------------------------------------


def test_topology_async_votes_validation():
    assert Topology().async_votes == 0
    assert Topology(clause_shards=2, async_votes=4).describe()[
        "async_votes"] == 4
    with pytest.raises(ValueError, match="async_votes"):
        Topology(async_votes=-1)


def test_async_votes_requires_sharded_placement():
    _, tcfg = configs()
    with pytest.raises(ValueError, match="sharded"):
        TMSession(tcfg, Topology(async_votes=2), device="cpu")


def test_shard_rows_census():
    g = distributed.clause_geometry(16, 4, 1)
    assert g.shard_rows() == [
        {"shard": i, "real_rows": 4, "pad_rows": 0} for i in range(4)]
    g = distributed.clause_geometry(10, 4, 1)  # n_local=3: rows 3,3,3,1(+2)
    assert g.shard_rows() == [
        {"shard": 0, "real_rows": 3, "pad_rows": 0},
        {"shard": 1, "real_rows": 3, "pad_rows": 0},
        {"shard": 2, "real_rows": 3, "pad_rows": 0},
        {"shard": 3, "real_rows": 1, "pad_rows": 2}]
    assert sum(r["real_rows"] for r in g.shard_rows()) == 10


def test_bundle_carries_vote_acc():
    _, tcfg = configs()
    b = api.init_bundle(tcfg, engines=("dense",), device="cpu")
    assert b.vote_acc is None
    acc = VoteAccumulator(local=torch.zeros((1, 3), dtype=torch.int32),
                          stale=torch.zeros((1, 3), dtype=torch.int32),
                          overflow=torch.zeros((1,), dtype=torch.int32))
    b = dataclasses.replace(b, vote_acc=acc)
    g = torch.Generator().manual_seed(0)
    xs = np.zeros((2, tcfg.n_features), np.uint8)
    stepped = api.train_step(b, xs, [0, 1], g)      # through sync_caches
    assert stepped.vote_acc is acc
    s = async_session(tcfg, 2, 1)
    assert s.init_bundle().vote_acc.local.shape == (2, 3)
    assert TMSession(tcfg, Topology(clause_shards=2),
                     device="cpu").init_bundle().vote_acc is None
