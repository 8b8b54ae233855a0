"""The port's TM examples, ``make_tm_task``'s engine keywords and the
``TMBatcher``'s shards, on the CPU, against the reference.

``make_tm_task(engines=..., metrics_engine=...)`` keeps exactly the named
caches and reads its metrics through the engine the reference's task
would; ``TMBatcher(shard_index=, shard_count=)`` shards concatenate to the
reference's global batch bit for bit; ``examples/torch_quickstart.py`` and
``examples/torch_tm_mnist.py`` run on ``--device cpu`` at small sizes,
``examples/torch_serve_lm.py`` at ``reduce_config`` width and
``examples/torch_train_lm.py`` for a few steps; and a
checkpoint that ``torch_tm_mnist`` writes loads in the reference's
``TsetlinMachine.load`` and predicts the same classes (the checkpoint format
is shared).
"""
import importlib.util
import warnings
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import TMConfig as JTMConfig  # noqa: E402
from repro.core import TsetlinMachine as JTsetlinMachine  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.runtime import tm_task as jtm_task  # noqa: E402

from repro_torch.core import TMConfig, TsetlinMachine  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.data.pipeline import TMBatcher  # noqa: E402
from repro_torch.runtime import make_tm_task  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KW = dict(n_classes=3, n_clauses=8, n_features=6, n_states=50, s=3.0,
          threshold=4)


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def first_step(task, monkeypatch):
    """One step of a task; returns (engines its metrics pass used, acc)."""
    used = []
    predict = task.session.predict

    def spy(bundle, x, *, engine):
        used.append(engine)
        return predict(bundle, x, engine=engine)

    monkeypatch.setattr(task.session, "predict", spy)
    _, metrics = task.step_fn(task.state, task.batcher(0))
    return used, float(metrics["acc"])


# -- make_tm_task: engines= and metrics_engine= ------------------------------


@pytest.mark.parametrize("engines,metrics_engine,want", [
    (("bitpack",), None, "bitpack"),
    (("bitpack", "indexed"), None, "indexed"),
    (None, None, "indexed"),
    (("dense", "bitpack"), "bitpack", "bitpack"),
])
def test_task_keeps_the_named_caches_and_meters_like_the_reference(
        engines, metrics_engine, want, monkeypatch):
    kw = dict(engines=engines, metrics_engine=metrics_engine, batch=8,
              seed=2, data_seed=9)
    task = make_tm_task(TMConfig(**KW), device="cpu", **kw)
    ref = jtm_task.make_tm_task(JTMConfig(**KW), **kw)
    # the port registers the reference's engines less the bitpack_xla alias
    assert task.session.engines == tuple(
        e for e in ref.session.engines if e != "bitpack_xla")
    assert set(task.state["bundle"].caches) == set(ref.state["bundle"].caches)
    got_used, got_acc = first_step(task, monkeypatch)
    ref_used, ref_acc = first_step(ref, monkeypatch)
    assert got_used == ref_used == [want]
    assert got_acc == ref_acc       # the same batch, the same initial state


def test_metrics_engine_outside_the_session_is_prepared_on_the_fly(monkeypatch):
    """As the reference's single-device session does: the engine's cache is
    prepared for the call, with a warning once per cache slot."""
    kw = dict(engines=("bitpack",), metrics_engine="indexed", batch=8,
              seed=2, data_seed=9)
    monkeypatch.setattr(api, "_REBUILD_WARNED", set())
    monkeypatch.setattr(japi, "_REBUILD_WARNED", set())
    task = make_tm_task(TMConfig(**KW), device="cpu", **kw)
    assert set(task.state["bundle"].caches) == {"bitpack"}
    with pytest.warns(RuntimeWarning, match="not maintained"):
        got_used, got_acc = first_step(task, monkeypatch)
    ref = jtm_task.make_tm_task(JTMConfig(**KW), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref_used, ref_acc = first_step(ref, monkeypatch)
    assert got_used == ref_used == ["indexed"]
    assert got_acc == ref_acc
    # an unregistered name fails in both packages at the first metrics pass
    for make, cfg in ((lambda c, **k: make_tm_task(c, device="cpu", **k),
                       TMConfig(**KW)),
                      (jtm_task.make_tm_task, JTMConfig(**KW))):
        bad = make(cfg, metrics_engine="nope", batch=8)
        with pytest.raises(KeyError, match="nope"):
            bad.step_fn(bad.state, bad.batcher(0))


# -- TMBatcher shards ----------------------------------------------------------


@pytest.mark.parametrize("shard_count", [1, 2, 4])
def test_batcher_shards_concatenate_to_the_reference_batch(shard_count):
    ref = jpipeline.TMBatcher(6, 3, 8, seed=1)
    for step in (0, 3):
        shards = [TMBatcher(6, 3, 8, seed=1, shard_index=i,
                            shard_count=shard_count)(step)
                  for i in range(shard_count)]
        want = ref(step)
        for key in ("x", "y"):
            assert all(len(s[key]) == 8 // shard_count for s in shards)
            got = np.concatenate([s[key] for s in shards])
            assert got.dtype == want[key].dtype
            np.testing.assert_array_equal(got, want[key])
            # and each shard is the reference's shard of the same index
            for i, s in enumerate(shards):
                np.testing.assert_array_equal(s[key], jpipeline.TMBatcher(
                    6, 3, 8, seed=1, shard_index=i,
                    shard_count=shard_count)(step)[key])


@pytest.mark.parametrize("batch,index,count", [(8, 0, 3), (8, 2, 2),
                                               (8, -1, 2), (8, 0, 0)])
def test_batcher_refuses_shards_that_do_not_fit(batch, index, count):
    with pytest.raises(ValueError):
        TMBatcher(6, 3, batch, seed=1, shard_index=index, shard_count=count)


# -- the examples ----------------------------------------------------------------


def test_quickstart_runs_on_the_cpu():
    out = load_example("torch_quickstart").main(["--device", "cpu"])
    assert out["event_overflow"] == 0
    assert len(out["accuracy"]) == 3 and out["accuracy"][-1] > 0.5
    preds = out["predictions"]
    assert set(preds) == {"dense", "bitpack", "indexed", "compact"}
    for p in preds.values():
        np.testing.assert_array_equal(p, preds["dense"])
    assert 0 < out["work_ratio"] < 1


TINY = ["--device", "cpu", "--epochs", "2", "--clauses", "16", "--features",
        "32", "--train", "64", "--test", "32", "--max-events", "8192"]


@pytest.mark.parametrize("extra", [
    [], ["--engines", "indexed,bitpack"],
    ["--clause-shards", "2", "--data-shards", "2", "--devices",
     "cpu,cpu,cpu,cpu"]], ids=["one-device", "engines", "sharded"])
def test_tm_mnist_runs_on_the_cpu(extra, tmp_path):
    out = load_example("torch_tm_mnist").main(
        TINY + ["--ckpt-dir", str(tmp_path)] + extra)
    assert out["roundtrip_ok"]
    assert len(out["epochs"]) == 2
    assert all(0 < e["events"] <= 8192 for e in out["epochs"])
    if "--engines" in extra:
        assert list(out["us_per_sample"]) == ["indexed", "bitpack"]
    assert 0 < out["work_ratio"] < 1
    if "--devices" in extra:
        assert out["placement"] == "4 shards on one device (cpu)"


def test_tm_mnist_checkpoint_loads_in_the_reference(tmp_path):
    load_example("torch_tm_mnist").main(TINY + ["--ckpt-dir", str(tmp_path)])
    kw = dict(n_classes=10, n_clauses=16, n_features=32, n_states=127,
              s=10.0, threshold=25)
    ours = TsetlinMachine.load(tmp_path, TMConfig(**kw), device="cpu")
    theirs = JTsetlinMachine.load(tmp_path, JTMConfig(**kw))
    np.testing.assert_array_equal(ours.state.ta_state.numpy(),
                                  np.asarray(theirs.state.ta_state))
    x = np.random.default_rng(3).integers(0, 2, (64, 32)).astype(np.uint8)
    for engine in ("indexed", "dense"):
        got = ours.predict(x, engine=engine).numpy()
        want = np.asarray(theirs.predict(jnp.asarray(x), engine=engine))
        np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "recurrentgemma-9b"])
def test_serve_lm_runs_on_the_cpu(arch, capsys):
    """The documented architecture (MoE routing, a sliding-window rolling
    cache: 32 + 16 tokens past the reduced window of 8) and a hybrid with
    a trailing recurrent block; the first token is the prefill's argmax."""
    import torch

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build

    res = load_example("torch_serve_lm").main(
        ["--arch", arch, "--device", "cpu", "--reduced"])
    out = capsys.readouterr().out
    assert f"arch={arch} (reduced) batch=4 device=cpu" in out
    assert "prefill:" in out and "decode:" in out
    assert res["generations"].shape == (4, 16)
    assert np.isfinite(res["decode_tok_s"]) and res["decode_tok_s"] > 0
    cfg = reduce_config(get_config(arch))
    m = build(cfg)
    logits, _ = m.prefill(serve.init_bf16(m, torch.device("cpu")), 48,
                          tokens=serve.make_prompts(cfg, 4, 32, "cpu"))
    np.testing.assert_array_equal(res["generations"][:, 0],
                                  logits.argmax(-1).numpy())


def test_train_lm_runs_on_the_cpu(tmp_path, capsys):
    """A few steps of the ~20M-parameter example at a small batch: the NLL
    falls, and the step-100 checkpoint path is not reached (no files)."""
    res = load_example("torch_train_lm").main(
        ["--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "params ≈ 16.8M" in out and "step    5  nll" in out
    assert "improved ✓" in out
    assert np.isfinite(res["last_nll"]) and res["last_nll"] < res["first_nll"]
    assert res["param_count"] > 16_000_000
    assert not list(tmp_path.glob("step_*"))
