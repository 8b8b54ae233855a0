"""The port's clause- and data-sharded topologies (``repro_torch.core.
distributed`` + ``TMSession``) against the JAX reference, on the CPU.

Every mesh here is ``device="cpu"`` ranks in one process: the port is
single-controller, so a (data × model) grid of CPU ranks runs the same code
that a grid of cards does. The reference side is the JAX package on one
device: its own slow tests pin JAX sharded ≡ JAX single-device, so holding
the port's sharded path against JAX single-device holds it against the
reference without a forced-device mesh.

  * ``clause_geometry`` against ``repro.core.distributed.clause_geometry``;
  * sharded ``scores`` of every engine against ``api.bundle_scores``;
  * sharded ``train_step``, sequential and batch-parallel, with and without
    a sample mask, against ``api.train_step`` under injected draws
    (``convert.draws_from_reference``): state, every cache, overflow;
  * reshard-on-restore, ``describe()``, the reduction counts, the
    ``replicated`` warning, ``make_mesh``'s refusal and import hygiene.

All results are integers: tolerance 0.
"""
import dataclasses
import functools
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import distributed as jdistributed  # noqa: E402
from repro.core import tm as jtm  # noqa: E402
from repro.core.types import TMConfig as JConfig  # noqa: E402
from repro.core.types import TMState as JState  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed, indexing  # noqa: E402
from repro_torch.core.bitpack import pack_bits  # noqa: E402
from repro_torch.core.session import TMSession, Topology, TsetlinMachine  # noqa: E402
from repro_torch.core.types import TMState, include_mask  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WIDE = dict(n_classes=3, n_clauses=20, n_features=12, n_states=10, s=3.0,
            threshold=4)
NARROW = dict(WIDE, n_clauses=8)
ENGINES = ("dense", "bitpack", "indexed")
BATCH = 12          # a multiple of every data-shard count below
# (clause_shards, data_shards, config): even, ragged, composed_even,
# composed_ragged, and replicated (n_local = 2 < 3 data ranks)
TOPOLOGIES = [(2, 1, "wide"), (3, 1, "wide"), (2, 2, "wide"), (2, 3, "wide"),
              (4, 3, "narrow")]
CONFIGS = {"wide": WIDE, "narrow": NARROW}
TOPO_IDS = [f"C{c}xD{d}-{k}" for c, d, k in TOPOLOGIES]


def configs(kw):
    jcfg = JConfig(**kw)
    return jcfg, convert.config_from_reference(dataclasses.asdict(jcfg))


def random_state(jcfg, rng):
    """About 15% includes at random depths, the rest excludes at random
    depths: clauses that fire for some inputs, and cells one step from the
    boundary on both sides."""
    shape = (jcfg.n_classes, jcfg.n_clauses, 2 * jcfg.n_features)
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


def port_draws(jcfg, key, batch):
    """The reference's draws for one batch step keyed by ``key`` (its batch
    split, each sample's split into three keys), as the port's draws."""
    return convert.draws_from_reference(
        *[np.array(t) for t in _draw_fn(jcfg, batch)(key)], device="cpu")


def case(name, seed=0):
    jcfg, tcfg = configs(CONFIGS[name])
    rng = np.random.default_rng(seed)
    ta = random_state(jcfg, rng)
    xs = rng.integers(0, 2, (BATCH, jcfg.n_features)).astype(np.uint8)
    ys = rng.integers(0, jcfg.n_classes, BATCH).astype(np.int32)
    return jcfg, tcfg, ta, xs, ys


def session(tcfg, c, d, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # 'replicated'
        return TMSession(tcfg, Topology(clause_shards=c, data_shards=d),
                         engines=ENGINES, device="cpu", **kw)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,c,d", [
    (16, 4, 2), (256, 4, 2), (128, 3, 2), (130, 2, 2), (10, 2, 4), (14, 2, 3),
    (6, 2, 4), (2, 1, 4), (6, 2, 1), (10, 3, 1), (2000, 4, 1), (2000, 3, 1),
    (2000, 2, 3), (2000, 2, 2)])
def test_clause_geometry_matches_reference(n, c, d):
    want = jdistributed.clause_geometry(n, c, d)
    got = distributed.clause_geometry(n, c, d)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("ragged_clauses", "composes", "n_sub_padded"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.shard_rows() == want.shard_rows()


def test_describe_reports_composition_and_shard_rows():
    _, tcfg = configs(WIDE)
    assert session(tcfg, 3, 1).describe()["shard_rows"] == [
        {"shard": 0, "real_rows": 7, "pad_rows": 0},
        {"shard": 1, "real_rows": 7, "pad_rows": 0},
        {"shard": 2, "real_rows": 6, "pad_rows": 1}]
    for (c, d), rule in {(2, 1): "clause_only", (2, 2): "composed_even",
                         (2, 3): "composed_ragged"}.items():
        desc = session(tcfg, c, d).describe()
        assert desc["composition"] == rule and desc["sharded"]
        assert (desc["clause_shards"], desc["data_shards"]) == (c, d)
        assert desc["mesh"] == ["cpu"] * (c * d)
    assert session(tcfg, 2, 2, parallel=True).describe()["composition"] == \
        "batch_parallel"
    one = TMSession(tcfg, device="cpu").describe()
    assert one["composition"] == "single" and not one["sharded"]
    _, narrow = configs(NARROW)
    assert session(narrow, 4, 3).describe()["composition"] == "replicated"


# ---------------------------------------------------------------------------
# scores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,d,name", TOPOLOGIES, ids=TOPO_IDS)
def test_sharded_scores_match_reference(c, d, name):
    jcfg, tcfg, ta, xs, _ = case(name)
    jbundle = japi.init_bundle(jcfg, engines=ENGINES,
                               state=JState(ta_state=jnp.asarray(ta)))
    s = session(tcfg, c, d)
    bundle = s.prepare(TMState(ta_state=torch.from_numpy(ta)))
    for engine in ENGINES:
        want = np.asarray(japi.bundle_scores(jbundle, jnp.asarray(xs),
                                             engine=engine))
        assert len(np.unique(want)) > 1, "scores all equal: the check is void"
        fn = s._sharded_scores_fn(engine)
        before = fn.reductions
        got = s.scores(bundle, xs, engine=engine)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=engine)
        assert fn.reductions == before + 1       # one reduction per call
        # a bucket callable is one make_sharded_scores call
        bucket = s.lower_scores(bundle, BATCH, engine=engine)
        np.testing.assert_array_equal(bucket(torch.from_numpy(xs)).numpy(),
                                      want)
        assert fn.reductions == before + 2


def test_sharded_scores_need_a_divisible_batch_and_a_prepared_cache():
    _, tcfg, ta, xs, _ = case("wide")
    s = session(tcfg, 2, 3)
    bundle = s.prepare(TMState(ta_state=torch.from_numpy(ta)))
    with pytest.raises(ValueError, match="data_shards=3"):
        s.scores(bundle, xs[:4])
    lean = TMSession(tcfg, Topology(clause_shards=2, engines=("dense",)),
                     device="cpu")
    with pytest.raises(KeyError, match="not built on the fly"):
        lean.scores(lean.prepare(TMState(ta_state=torch.from_numpy(ta))), xs,
                    engine="indexed")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

MASK = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 0], bool)
STEP_KEYS = (7, 8)


@functools.cache
def reference_steps(name, parallel, masked):
    """JAX single-device bundles after each of two ``train_step`` calls."""
    jcfg, _, ta, xs, ys = case(name)
    bundle = japi.init_bundle(jcfg, engines=ENGINES,
                              state=JState(ta_state=jnp.asarray(ta)))
    out = []
    for k in STEP_KEYS:
        bundle = japi.train_step_jit(
            bundle, jnp.asarray(xs), jnp.asarray(ys), jax.random.key(k),
            jnp.asarray(MASK) if masked else None, parallel=parallel,
            max_events=4096, donate=False)
        out.append(bundle)
    return out


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("parallel", [False, True],
                         ids=["sequential", "parallel"])
@pytest.mark.parametrize("c,d,name", TOPOLOGIES, ids=TOPO_IDS)
def test_sharded_train_step_matches_reference(c, d, name, parallel, masked):
    jcfg, tcfg, ta, xs, ys = case(name)
    s = session(tcfg, c, d, parallel=parallel)
    bundle = s.prepare(TMState(ta_state=torch.from_numpy(ta)))
    geom, n = s.geometry, s.geometry.n_local
    for k, want in zip(STEP_KEYS, reference_steps(name, parallel, masked)):
        bundle = s.train_step(bundle, xs, ys,
                              port_draws(jcfg, jax.random.key(k), BATCH),
                              MASK if masked else None)
        state = s.unpad_state(bundle.state).ta_state
        np.testing.assert_array_equal(state.numpy(),
                                      np.asarray(want.state.ta_state))
        assert int(bundle.event_overflow) == int(want.event_overflow) == 0
        # every rank's caches follow its state slice
        jwords = np.asarray(want.caches["bitpack"]).view(np.int32)
        padded = distributed.pad_state(tcfg, TMState(state), geom.n_padded)
        for dd in range(d):
            for cc in range(c):
                rank = bundle.rank(dd, cc)
                rows = slice(cc * n, (cc + 1) * n)
                assert torch.equal(rank.state.ta_state,
                                   padded.ta_state[:, rows])
                real = slice(cc * n, min((cc + 1) * n, tcfg.n_clauses))
                words = rank.caches["bitpack"].numpy()
                np.testing.assert_array_equal(
                    words[:, :real.stop - real.start], jwords[:, real])
                assert not words[:, real.stop - real.start:].any()
                np.testing.assert_array_equal(words, pack_bits(
                    include_mask(tcfg, rank.state)).numpy())
                checks = indexing.validate(tcfg, rank.state,
                                           rank.caches["indexed"])
                assert all(bool(v) for v in checks.values()), checks
        for engine in ENGINES:
            np.testing.assert_array_equal(
                s.scores(bundle, xs, engine=engine).numpy(),
                np.asarray(japi.bundle_scores(want, jnp.asarray(xs),
                                              engine=engine)), err_msg=engine)
    assert not np.array_equal(s.unpad_state(bundle.state).ta_state.numpy(), ta)


# Meshes of distinct devices: on the CPU, ``cpu:0``, ``cpu:1``, … are
# distinct ``torch.device`` objects that all place tensors in host memory.
# A rank is then never another rank's device, so every data rank keeps its
# own state copy and cache set and syncs them itself, the overflow count is
# read from data rank 0's copy, and every reduction moves its partials as
# on distinct cards: the branches a mesh of one repeated device skips.
DISTINCT = [(2, 2, "wide", False), (2, 3, "wide", False),
            (2, 2, "wide", True), (4, 3, "narrow", False)]


@pytest.mark.parametrize("c,d,name,parallel", DISTINCT,
                         ids=["composed_even", "composed_ragged",
                              "batch_parallel", "replicated"])
def test_distinct_device_mesh_matches_reference(c, d, name, parallel):
    jcfg, tcfg, ta, xs, ys = case(name)
    mesh = mesh_mod.make_mesh(d, c, devices=[f"cpu:{i}" for i in range(c * d)])
    s = session(tcfg, c, d, parallel=parallel, mesh=mesh)
    assert s.describe()["mesh"] == [f"cpu:{i}" for i in range(c * d)]
    bundle = s.prepare(TMState(ta_state=torch.from_numpy(ta)))
    for k, want in zip(STEP_KEYS, reference_steps(name, parallel, False)):
        for cc in range(c):     # one cache set per data rank, none shared
            for key in bundle.rank(0, cc).caches:
                assert len({id(bundle.rank(dd, cc).caches[key])
                            for dd in range(d)}) == d, key
        bundle = s.train_step(bundle, xs, ys,
                              port_draws(jcfg, jax.random.key(k), BATCH))
        np.testing.assert_array_equal(s.unpad_state(bundle.state).ta_state.numpy(),
                                      np.asarray(want.state.ta_state))
        assert int(bundle.event_overflow) == int(want.event_overflow) == 0
        for row in bundle.ranks:
            for rank in row:
                checks = indexing.validate(tcfg, rank.state,
                                           rank.caches["indexed"])
                assert all(bool(v) for v in checks.values()), checks
                np.testing.assert_array_equal(
                    rank.caches["bitpack"].numpy(),
                    pack_bits(include_mask(tcfg, rank.state)).numpy())
        for engine in ENGINES:
            np.testing.assert_array_equal(
                s.scores(bundle, xs, engine=engine).numpy(),
                np.asarray(japi.bundle_scores(want, jnp.asarray(xs),
                                              engine=engine)), err_msg=engine)


def test_sequential_step_reduces_one_vote_per_round():
    jcfg, tcfg, ta, xs, ys = case("wide")
    for (c, d), extra in {(2, 1): 0, (2, 3): 1}.items():   # + reassembly
        s = session(tcfg, c, d)
        bundle = s.prepare(TMState(ta_state=torch.from_numpy(ta)))
        s.train_step(bundle, xs, ys, port_draws(jcfg, jax.random.key(7),
                                                BATCH), MASK)
        valid = int(MASK.sum())
        # two rounds per valid sample, the overflow count, the reassembly
        assert s._step.reductions == 2 * valid + 1 + extra


def test_replicated_sequential_learning_warns():
    _, narrow = configs(NARROW)
    with pytest.warns(RuntimeWarning, match="'replicated'"):
        TMSession(narrow, Topology(clause_shards=4, data_shards=3),
                  device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        TMSession(narrow, Topology(clause_shards=4, data_shards=3),
                  device="cpu", parallel=True)


def test_machine_is_bit_exact_across_topologies_under_one_seed():
    """The estimator draws from one generator on the first rank's device
    and every shard slices the same draws: a sharded machine trains exactly
    as ``Topology(1)`` does from the same seed, epochs and masks included."""
    _, tcfg, ta, xs, ys = case("wide", seed=3)
    xs, ys = np.concatenate([xs, xs[:5]]), np.concatenate([ys, ys[:5]])
    machines = []
    for topo in (None, Topology(clause_shards=3, data_shards=2)):
        m = TsetlinMachine(tcfg, topology=topo, engines=ENGINES, device="cpu",
                           seed=5)
        m.bundle = m.session.prepare(TMState(ta_state=torch.from_numpy(ta)))
        machines.append(m.fit(xs, ys, epochs=2, batch_size=6))
    one, sharded = machines
    assert torch.equal(one.state.ta_state, sharded.state.ta_state)
    assert not np.array_equal(one.state.ta_state.numpy(), ta)
    for engine in ENGINES:
        assert torch.equal(one.scores(xs[:12], engine=engine),
                           sharded.scores(xs[:12], engine=engine))
    assert sharded.event_overflow == 0


def test_checkpoint_reshards_on_restore(tmp_path):
    _, tcfg, ta, xs, ys = case("wide", seed=4)
    src = TsetlinMachine(tcfg, topology=Topology(clause_shards=2),
                         engines=ENGINES, device="cpu", seed=1)
    src.bundle = src.session.prepare(TMState(ta_state=torch.from_numpy(ta)))
    src.fit(xs, ys, batch_size=6).save(tmp_path / "ck", step=2)
    for topo in (Topology(clause_shards=3, data_shards=2), Topology()):
        dst = TsetlinMachine.load(tmp_path / "ck", tcfg, topology=topo,
                                  engines=ENGINES, device="cpu")
        assert torch.equal(dst.state.ta_state, src.state.ta_state)
        for engine in ENGINES:
            assert torch.equal(dst.scores(xs, engine=engine),
                               src.scores(xs, engine=engine)), engine


# ---------------------------------------------------------------------------
# meshes and hygiene
# ---------------------------------------------------------------------------


def test_make_mesh_places_ranks_and_refuses_missing_cards(monkeypatch):
    mesh = mesh_mod.make_mesh(2, 3, device="cpu")
    assert mesh.shape == (2, 3) and mesh.device(1, 2) == torch.device("cpu")
    assert len(mesh_mod.make_mesh(1, 2, devices=["cpu", "cpu"]).devices) == 2
    with pytest.raises(ValueError, match="needs 4 devices"):
        mesh_mod.make_mesh(2, 2, devices=["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        mesh_mod.make_mesh(1, 2)
    _, tcfg = configs(WIDE)
    with pytest.raises(RuntimeError, match="needs 4 devices"):
        TMSession(tcfg, Topology(clause_shards=2, data_shards=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TMSession(tcfg, Topology(clause_shards=2))


def test_sharded_modules_import_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.launch.mesh, repro_torch.core.distributed\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    res = subprocess.run([sys.executable, "-c", code],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


def test_trainer_restarts_onto_another_topology(tmp_path):
    """Crash a ragged clause-sharded run, restart it on a composed
    data × clause topology: the caches rebuild there and the run ends where
    an uninterrupted single-device run does."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.runtime import (
        SimulatedFailure, Trainer, TrainLoopConfig, make_tm_task)

    _, tcfg = configs(WIDE)

    def trainer(path, topology, failure_at=None):
        task = make_tm_task(tcfg, topology=topology, batch=6, seed=2,
                            data_seed=9, metrics_every=2, device="cpu")
        return task.session, Trainer(
            step_fn=task.step_fn, state=task.state, batcher=task.batcher,
            checkpointer=Checkpointer(path, keep=10),
            loop=TrainLoopConfig(total_steps=6, ckpt_every=2, log_every=2,
                                 failure_at=failure_at),
            to_ckpt=task.to_ckpt, from_ckpt=task.from_ckpt)

    _, ref = trainer(tmp_path / "ref", None)
    ref.run()
    _, crashed = trainer(tmp_path / "ft", Topology(clause_shards=3),
                         failure_at=3)
    with pytest.raises(SimulatedFailure):
        crashed.run()
    s, tr = trainer(tmp_path / "ft", Topology(clause_shards=2, data_shards=3))
    resumed = tr.restore_if_available()
    assert resumed == 2
    tr.run(start_step=resumed)
    bundle = tr.state["bundle"]
    assert torch.equal(s.unpad_state(bundle.state).ta_state,
                       ref.state["bundle"].state.ta_state)
    assert int(bundle.event_overflow) == 0
    for c, index in enumerate(bundle.index):
        checks = indexing.validate(tcfg, bundle.rank(0, c).state, index)
        assert all(bool(v) for v in checks.values()), checks


def test_tm_serve_takes_the_topology_flags(tmp_path):
    import json

    from repro_torch.launch.tm_serve import main
    out = tmp_path / "serve.json"
    main(["--smoke", "--device", "cpu", "--clause-shards", "2",
          "--data-shards", "2", "--devices", "cpu,cpu,cpu,cpu",
          "--requests", "24", "--out", str(out)])
    record = json.loads(out.read_text())
    topo = record["topology"]
    assert (topo["clause_shards"], topo["data_shards"]) == (2, 2)
    assert topo["composition"] == "composed_even" and topo["sharded"]
    assert all(e["requests"] == 24 for e in record["engines"].values())
