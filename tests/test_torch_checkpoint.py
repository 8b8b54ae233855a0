"""Checkpoints shared between the JAX reference and the PyTorch port.

A tiny JAX ``TsetlinMachine`` trains a few steps and saves a schema-v1
checkpoint; ``repro_torch``'s ``TsetlinMachine.load`` restores it and all
three ported engines score exactly as the JAX machine does. The other way
round, the port saves and the JAX package loads. A changed ``s`` raises
``CheckpointMismatch`` on both sides. Plus the port's ``Checkpointer``
units: round trip, atomic commit, retention, async error surfacing.
"""
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import tm_store as jstore  # noqa: E402
from repro.core import TMConfig as JConfig  # noqa: E402
from repro.core.session import TsetlinMachine as JMachine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import Checkpointer, tm_store  # noqa: E402
from repro_torch.core.session import TsetlinMachine  # noqa: E402

ENGINES = ("dense", "bitpack", "indexed")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A JAX machine trained for a few steps, saved, and its test inputs."""
    rng = np.random.default_rng(0)
    jcfg = JConfig(n_classes=3, n_clauses=16, n_features=12, n_states=20,
                   s=3.0, threshold=8)
    xs = rng.integers(0, 2, (24, 12)).astype(np.uint8)
    ys = (xs[:, 0] + xs[:, 1]).astype(np.int32)           # 3 classes
    machine = JMachine(jcfg, engines=ENGINES, seed=1).init()
    machine.fit(jnp.asarray(xs), jnp.asarray(ys), epochs=1, batch_size=8)
    directory = tmp_path_factory.mktemp("jax_ckpt")
    machine.save(directory, step=3)
    return jcfg, machine, directory, xs, ys


def test_fingerprints_agree_across_packages():
    for kw in ({}, {"s": 10.0, "threshold": 50, "index_capacity": 7},
               {"boost_true_positive": True, "empty_clause_output": 0}):
        jcfg = JConfig(n_classes=10, n_clauses=2000, n_features=784, **kw)
        tcfg = convert.config_from_reference(dataclasses.asdict(jcfg))
        np.testing.assert_array_equal(tm_store.config_fingerprint(tcfg),
                                      jstore.config_fingerprint(jcfg))


def test_port_loads_a_jax_checkpoint_and_scores_identically(trained):
    jcfg, jmachine, directory, xs, ys = trained
    assert int((np.asarray(jmachine.state.ta_state) > jcfg.n_states).sum()) > 0
    tcfg = convert.config_from_reference(dataclasses.asdict(jcfg))
    machine = TsetlinMachine.load(directory, tcfg, engines=ENGINES,
                                  device="cpu")
    np.testing.assert_array_equal(machine.state.ta_state.numpy(),
                                  np.asarray(jmachine.state.ta_state))
    for engine in ENGINES:
        np.testing.assert_array_equal(
            machine.scores(xs, engine=engine).numpy(),
            np.asarray(jmachine.scores(jnp.asarray(xs), engine=engine)))
    assert machine.evaluate(xs, ys) == jmachine.evaluate(jnp.asarray(xs),
                                                         jnp.asarray(ys))


def test_jax_loads_a_port_checkpoint_and_scores_identically(trained, tmp_path):
    jcfg, jmachine, directory, xs, _ = trained
    tcfg = convert.config_from_reference(dataclasses.asdict(jcfg))
    machine = TsetlinMachine.load(directory, tcfg, engines=ENGINES,
                                  device="cpu")
    machine.save(tmp_path, step=9)
    back = JMachine.load(tmp_path, jcfg, engines=ENGINES)
    np.testing.assert_array_equal(np.asarray(back.state.ta_state),
                                  machine.state.ta_state.numpy())
    for engine in ENGINES:
        np.testing.assert_array_equal(
            np.asarray(back.scores(jnp.asarray(xs), engine=engine)),
            machine.scores(xs, engine=engine).numpy())


def test_changed_s_is_a_mismatch_on_both_sides(trained, tmp_path):
    jcfg, _, directory, _, _ = trained
    tcfg = convert.config_from_reference(dataclasses.asdict(jcfg))
    wrong = dataclasses.replace(tcfg, s=tcfg.s + 1.0)
    with pytest.raises(tm_store.CheckpointMismatch, match="fingerprint"):
        TsetlinMachine.load(directory, wrong, device="cpu")
    TsetlinMachine(tcfg, device="cpu").init().save(tmp_path)
    with pytest.raises(jstore.CheckpointMismatch, match="fingerprint"):
        JMachine.load(tmp_path, dataclasses.replace(jcfg, s=jcfg.s + 1.0))


def test_not_a_tm_checkpoint_is_a_mismatch(tmp_path):
    Checkpointer(tmp_path).save(0, {"weights": np.zeros(3)}, blocking=True)
    cfg = convert.config_from_reference({"n_classes": 2, "n_clauses": 4,
                                         "n_features": 3})
    with pytest.raises(tm_store.CheckpointMismatch, match="schema-v1"):
        tm_store.load_tm(tmp_path, cfg, np.zeros((2, 4, 6)), device="cpu")


def test_load_tm_defaults_to_the_card(tmp_path, monkeypatch):
    """Like every entry point, ``load_tm`` lands on ``cuda`` unless told
    ``device="cpu"``, and raises on a host without CUDA."""
    cfg = convert.config_from_reference({"n_classes": 2, "n_clauses": 4,
                                         "n_features": 3})
    ta = torch.full((2, 4, 6), 7, dtype=torch.int16)
    tm_store.save_tm(tmp_path, cfg, ta)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm_store.load_tm(tmp_path, cfg, ta)
    got, step = tm_store.load_tm(tmp_path, cfg, ta, device="cpu")
    assert step == 0 and torch.equal(got, ta)


# -- Checkpointer units ------------------------------------------------------


def test_checkpointer_round_trip_and_manifest(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = {"b": torch.arange(6, dtype=torch.int16).reshape(2, 3),
            "a": {"x": np.ones(4, np.float32), "y": np.asarray(7, np.int32)}}
    ck.save(100, tree, blocking=True)
    assert ck.latest_step() == 100
    manifest = json.loads((tmp_path / "step_00000100" / "manifest.json")
                          .read_text())
    assert list(manifest["arrays"]) == ["a//x", "a//y", "b"]
    assert manifest["arrays"]["b"]["dtype"] == "int16"
    out = ck.restore(100, ["b", "a//x"])
    np.testing.assert_array_equal(out["b"], tree["b"].numpy())
    np.testing.assert_array_equal(out["a//x"], tree["a"]["x"])
    with pytest.raises(KeyError):
        ck.restore(100, ["missing"])


def test_checkpointer_ignores_uncommitted_steps(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(10, {"w": np.zeros(2)}, blocking=True)
    (tmp_path / "step_00000020.tmp").mkdir()
    (tmp_path / "step_00000030").mkdir()            # no manifest
    assert ck.latest_step() == 10


def test_checkpointer_retention(tmp_path):
    ck = Checkpointer(tmp_path, keep=2, keep_every=100)
    for s in (100, 150, 200, 250):
        ck.save(s, {"w": np.zeros(2)}, blocking=True)
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [100, 200, 250]


def test_checkpointer_async_error_surfaces_on_wait(tmp_path):
    ck = Checkpointer(tmp_path)
    (tmp_path / "step_00000001.tmp").write_text("")  # a file where a dir goes
    ck.save(1, {"w": np.zeros(2)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                         # raised once, then clear
