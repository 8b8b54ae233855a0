"""PyTorch port (``repro_torch``) index, engines and bundle vs the JAX
reference, on the CPU.

Same TA state, same inputs (seeded numpy, handed to both packages):
``build_index`` and ``validate`` agree array for array, and every ported
engine's ``bundle_scores`` agrees with ``repro.core.api.bundle_scores``
exactly — including the classic ``empty_clause_output=0`` convention on the
dense engine. Integer results, tolerance 0.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import indexing as jindexing  # noqa: E402
from repro.core import tm as jtm  # noqa: E402
from repro.core.types import TMConfig as JConfig  # noqa: E402
from repro.core.types import TMState as JState  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api, indexing, tm  # noqa: E402
from repro_torch.core.engines import registered_engines  # noqa: E402
from repro_torch.core.types import TMConfig, TMState  # noqa: E402

ENGINES = ("dense", "bitpack", "indexed")


def make_pair(m=3, n=16, o=12, density=0.15, seed=0, empty_rows=3, **kw):
    """(jax cfg, jax state, torch cfg, torch state): the same random include
    pattern, with ``empty_rows`` clauses per class including nothing."""
    rng = np.random.default_rng(seed)
    jcfg = JConfig(n_classes=m, n_clauses=n, n_features=o, **kw)
    inc = rng.uniform(size=(m, n, 2 * o)) < density
    inc[:, :empty_rows] = False
    ta = np.where(inc, jcfg.n_states + 1 + rng.integers(0, 5, inc.shape),
                  jcfg.n_states - rng.integers(0, 5, inc.shape)).astype(np.int16)
    tcfg = convert.config_from_reference(dataclasses.asdict(jcfg))
    return (jcfg, JState(ta_state=jnp.asarray(ta)), tcfg,
            convert.state_from_reference(tcfg, ta, "cpu"))


def test_config_and_state_convert_from_reference():
    jcfg, jstate, tcfg, tstate = make_pair(s=7.5, threshold=9)
    assert tcfg == TMConfig(n_classes=3, n_clauses=16, n_features=12, s=7.5,
                            threshold=9)
    assert tcfg.state_dtype == torch.int16
    assert tstate.ta_state.dtype == torch.int16
    np.testing.assert_array_equal(tstate.ta_state.numpy(),
                                  np.asarray(jstate.ta_state))
    with pytest.raises(ValueError, match="shape"):
        convert.state_from_reference(tcfg, np.zeros((1, 2, 3), np.int16), "cpu")


@pytest.mark.parametrize("capacity", [None, 2])
def test_build_index_and_validate_match_reference(capacity):
    jcfg, jstate, tcfg, tstate = make_pair(density=0.3, seed=1)
    cap = capacity or tcfg.resolved_index_capacity
    want = jindexing.build_index(jcfg, jstate, cap)
    got = indexing.build_index(tcfg, tstate, cap)
    for name in ("lists", "counts", "pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    jv = jindexing.validate(jcfg, jstate, want)
    tv = indexing.validate(tcfg, tstate, got)
    assert {k: bool(v) for k, v in tv.items()} == \
        {k: bool(v) for k, v in jv.items()}
    # capacity 2 < the longest list: overflow is surfaced, not hidden
    assert bool(tv["overflow_ok"]) == (capacity is None)


def test_validate_flags_a_corrupted_index():
    _, _, tcfg, tstate = make_pair(seed=2)
    index = indexing.build_index(tcfg, tstate, tcfg.resolved_index_capacity)
    bad = index._replace(counts=index.counts + 1)
    assert not bool(indexing.validate(tcfg, tstate, bad)["counts_ok"])
    assert all(bool(v) for v in
               indexing.validate(tcfg, tstate, index).values())
    empty = indexing.empty_index(tcfg, 4, "cpu")
    assert int((empty.pos != indexing.NA).sum()) == 0


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", [0, 1])
def test_bundle_scores_match_reference(engine, seed):
    jcfg, jstate, tcfg, tstate = make_pair(seed=seed)
    x = np.random.default_rng(seed + 10).integers(0, 2, (7, 12)).astype(np.uint8)
    jb = japi.init_bundle(jcfg, engines=ENGINES, state=jstate)
    tb = api.init_bundle(tcfg, engines=ENGINES, state=tstate, device="cpu")
    want = np.asarray(japi.bundle_scores(jb, jnp.asarray(x), engine=engine))
    got = api.bundle_scores(tb, torch.from_numpy(x), engine=engine)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        api.bundle_predict(tb, torch.from_numpy(x), engine=engine).numpy(),
        np.asarray(japi.bundle_predict(jb, jnp.asarray(x), engine=engine)))


def test_dense_classic_empty_clause_convention_matches_reference():
    jcfg, jstate, tcfg, tstate = make_pair(seed=3, empty_rows=5,
                                           empty_clause_output=0)
    x = np.random.default_rng(4).integers(0, 2, (6, 12)).astype(np.uint8)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        tm.dense_clause_outputs(tcfg, tstate, xt).numpy(),
        np.asarray(jtm.dense_clause_outputs(jcfg, jstate, jnp.asarray(x))))
    tb = api.init_bundle(tcfg, engines=("dense",), state=tstate, device="cpu")
    jb = japi.init_bundle(jcfg, engines=("dense",), state=jstate)
    np.testing.assert_array_equal(
        api.bundle_scores(tb, xt, engine="dense").numpy(),
        np.asarray(japi.bundle_scores(jb, jnp.asarray(x), engine="dense")))
    ys = np.random.default_rng(5).integers(0, 3, 6)
    assert float(tm.accuracy(tcfg, tstate, xt, torch.from_numpy(ys))) == \
        float(jtm.accuracy(jcfg, jstate, jnp.asarray(x), jnp.asarray(ys)))


def test_missing_cache_slot_rebuilds_with_one_warning():
    _, _, tcfg, tstate = make_pair(seed=6)
    tb = api.init_bundle(tcfg, engines=("dense",), state=tstate, device="cpu")
    assert api.cache_keys_for(("dense",)) == ()
    assert api.cache_keys_for(ENGINES) == ("bitpack", "indexed")
    x = torch.zeros((2, 12), dtype=torch.uint8)
    api._REBUILD_WARNED.discard("bitpack")
    with pytest.warns(RuntimeWarning, match="rebuilding"):
        first = api.bundle_scores(tb, x, engine="bitpack")
    assert torch.equal(first, api.bundle_scores(tb, x, engine="dense"))


def test_fresh_state_scores_zero_on_every_engine():
    cfg = TMConfig(n_classes=2, n_clauses=4, n_features=5)
    bundle = api.init_bundle(cfg, device="cpu")
    # engines=None maintains every registered engine's cache, as the
    # reference's default bundle does
    assert set(bundle.caches) == {"bitpack", "compact", "indexed"}
    assert bundle.state.ta_state.dtype == torch.int16
    x = torch.ones((3, 5), dtype=torch.uint8)
    for engine in registered_engines():
        assert api.bundle_scores(bundle, x, engine=engine).abs().sum() == 0
