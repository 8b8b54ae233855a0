"""The port's LM training path (``repro_torch.steps``, ``repro_torch.optim``,
``TokenBatcher`` / ``token_stream``, ``launch.train``) against the
reference package, on the CPU.

Inputs are seeded numpy. Tolerances, relative to the largest magnitude of
the reference's value:

* data: exact (the same numpy generators);
* schedule, ``_xent``, ``adamw.update``: 1e-6 (float32 kernels of the two
  libraries round the last ulp apart: ``cos``, ``pow``, reductions);
* compression: exact (one rounding per element, the same in both);
* remat on against remat off, in float32: 1e-6 of max|g| (the same
  operations recomputed).

One train step per architecture against the reference's is in
``tests/test_torch_lm_steps.py`` (whisper's in
``tests/test_torch_whisper.py``).
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import steps as jsteps  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcompression  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro.sharding import Policy  # noqa: E402

from repro_torch import configs, steps  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import pipeline, synthetic  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model, transformer, whisper  # noqa: E402
from repro_torch.optim import adamw, compression, schedule  # noqa: E402
from repro_torch.runtime.trainer import (  # noqa: E402
    SimulatedFailure, Trainer, TrainLoopConfig)

OPT_TOL = 1e-6
B, S = 4, 8


def t(a):
    return torch.from_numpy(np.array(a))


def f64(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def close(got, want, tol, what):
    """max |got - want| <= tol · max |want|."""
    got, want = f64(got), f64(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} x {scale}"


def tiny_cfg():
    """The reference's own step tests' model: qwen3 geometry, 2 layers."""
    return dataclasses.replace(
        configs.get_config("qwen3-1.7b"), n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, remat=False)


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture
def float32_compute(monkeypatch):
    for mod in (transformer, whisper, steps):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    for mod in (jtransformer, jwhisper, jsteps):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,batch,seq,seed,shards", [
    (101, 8, 16, 1, 1), (256, 8, 32, 0, 2), (151936, 4, 12, 3, 4)])
def test_token_stream_and_batcher_equal_reference(vocab, batch, seq, seed,
                                                  shards):
    np.testing.assert_array_equal(
        synthetic.token_stream(999, vocab, seed=seed),
        jsynthetic.token_stream(999, vocab, seed=seed))
    for shard in range(shards):
        ours = pipeline.TokenBatcher(vocab, batch, seq, seed=seed,
                                     shard_index=shard, shard_count=shards)
        ref = jpipeline.TokenBatcher(vocab, batch, seq, seed=seed,
                                     shard_index=shard, shard_count=shards)
        for step in (0, 3, 17):
            got, want = ours(step), ref(step)
            assert sorted(got) == sorted(want) == ["labels", "tokens"]
            for k in got:
                assert got[k].dtype == np.int32 and got[k].shape == (
                    batch // shards, seq)
                np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="multiple"):
        pipeline.TokenBatcher(vocab, 6, seq, shard_count=4)


# ---------------------------------------------------------------------------
# Optimizer pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(peak_lr=3e-4, warmup_steps=200, total_steps=10_000),
    dict(peak_lr=1e-3, warmup_steps=20, total_steps=100),
    dict(peak_lr=2e-3, warmup_steps=0, total_steps=10, min_ratio=0.05)])
def test_schedules_match_reference(kw):
    for step in list(range(0, 130, 3)) + [10_000, 20_000]:
        got = schedule.cosine_with_warmup(torch.tensor(step, dtype=torch.int32),
                                          **kw)
        want = jschedule.cosine_with_warmup(jnp.int32(step), **kw)
        assert got.dtype == torch.float32 and got.shape == ()
        close(got, want, OPT_TOL, f"cosine step {step}")
    const = schedule.constant(torch.tensor(7), peak_lr=kw["peak_lr"])
    assert const.dtype == torch.float32
    assert float(const) == float(jschedule.constant(7, peak_lr=kw["peak_lr"]))


def opt_tree(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(7, 5)) * scale).astype(np.float32),
            "b": (rng.normal(size=(13,)) * scale).astype(np.float32),
            "c": (rng.normal(size=(3, 4, 2)) * scale).astype(np.float32)}


@pytest.mark.parametrize("gscale,max_norm", [(10.0, 1.0), (1e-2, 1.0),
                                             (1.0, None)])
def test_adamw_update_matches_reference(gscale, max_norm):
    """Two steps from the same params, numpy grads and lr: params, both
    moments, the step and the metrics (clipping on and off)."""
    p_np = opt_tree(0)
    params = {k: t(v) for k, v in p_np.items()}
    state = adamw.init(params)
    jparams, jstate = {k: jnp.asarray(v) for k, v in p_np.items()}, jadamw.init(p_np)
    for step, lr in enumerate((1e-3, 3e-4)):
        g_np = opt_tree(10 + step, gscale)
        state, metrics = adamw.update({k: t(v) for k, v in g_np.items()},
                                      state, params, lr=lr,
                                      max_grad_norm=max_norm)
        jparams, jstate, jmetrics = jadamw.update(
            {k: jnp.asarray(v) for k, v in g_np.items()}, jstate, jparams,
            lr=lr, max_grad_norm=max_norm)
        assert int(state.step) == int(jstate.step) == step + 1
        for k in p_np:
            close(params[k], jparams[k], OPT_TOL, f"param {k}")
            close(state.mu[k], jstate.mu[k], OPT_TOL, f"mu {k}")
            close(state.nu[k], jstate.nu[k], OPT_TOL, f"nu {k}")
        close(metrics["grad_norm"], jmetrics["grad_norm"], OPT_TOL, "grad_norm")
        assert float(metrics["lr"]) == float(jmetrics["lr"])
    clipped, norm = adamw.clip_by_global_norm(
        {k: t(v) for k, v in g_np.items()}, 0.5)
    jclipped, jnorm = jadamw.clip_by_global_norm(g_np, 0.5)
    close(norm, jnorm, OPT_TOL, "global_norm")
    for k in g_np:
        close(clipped[k], jclipped[k], OPT_TOL, f"clipped {k}")


def test_adamw_groups_cover_every_tensor_once(monkeypatch):
    """The foreach groups (capped at _GROUP_ELEMENTS) partition the names in
    order; an update through one-tensor groups equals the one-group one."""
    monkeypatch.setattr(adamw, "_GROUP_ELEMENTS", 40)
    p_np = opt_tree(0)
    named = {k: t(v) for k, v in p_np.items()}
    groups = list(adamw._groups(list(named), named))
    assert groups == [["a"], ["b", "c"]]
    g = {k: t(v) for k, v in opt_tree(3).items()}
    small, whole = dict(named), {k: v.clone() for k, v in named.items()}
    s1, _ = adamw.update(g, adamw.init(small), small, lr=1e-2)
    monkeypatch.setattr(adamw, "_GROUP_ELEMENTS", 1 << 28)
    s2, _ = adamw.update(g, adamw.init(whole), whole, lr=1e-2)
    for k in p_np:
        assert torch.equal(small[k], whole[k]) and torch.equal(s1.mu[k], s2.mu[k])


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_compress_grads_matches_reference(mode):
    """Two rounds with error feedback: compressed grads (and their dtype)
    and residuals exactly as the reference's."""
    p_np = opt_tree(0)
    ef = compression.init_error_feedback({k: t(v) for k, v in p_np.items()})
    jef = jcompression.init_error_feedback(p_np)
    for k, v in ef.residual.items():
        assert v.dtype == torch.float32 and not v.any()
    for r in range(2):
        g_np = opt_tree(20 + r, 1e-2)
        comp, ef = compression.compress_grads({k: t(v) for k, v in g_np.items()},
                                              ef, mode=mode)
        jcomp, jef = jcompression.compress_grads(
            {k: jnp.asarray(v) for k, v in g_np.items()}, jef, mode=mode)
        for k in g_np:
            assert str(comp[k].dtype).split(".")[-1] == str(jcomp[k].dtype)
            np.testing.assert_array_equal(comp[k].float().numpy(),
                                          np.asarray(jcomp[k], np.float32))
            np.testing.assert_array_equal(ef.residual[k].numpy(),
                                          np.asarray(jef.residual[k]))


def test_xent_matches_reference():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 5, 37)) * 4).astype(np.float32)
    labels = rng.integers(0, 37, (3, 5)).astype(np.int32)
    loss, nll = steps._xent(t(logits), t(labels))
    jloss, jnll = jsteps._xent(jnp.asarray(logits), jnp.asarray(labels),
                               Policy.none())
    close(loss, jloss, OPT_TOL, "loss")
    close(nll, jnll, OPT_TOL, "nll")
    assert float(loss) > float(nll)          # the z-loss is positive


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------


def train_batch(cfg, seed=5):
    rng = np.random.default_rng(seed)
    s_text = S - (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, s_text)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, s_text)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_remat_gives_the_same_gradients(arch, float32_compute):
    """Every family runs backward with ``cfg.remat`` (a checkpoint per layer
    group, whisper's encoder and decoder blocks) and gets the gradients it
    gets without: the MoE dispatch, RWKV's chunks and the Griffin scan
    write no tensor that the recomputation needs."""
    base = configs.reduce_config(configs.get_config(arch))
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        m = model.build(cfg)
        params = m.init(torch.Generator().manual_seed(1))
        batch = torch_batch(train_batch(cfg))
        labels = batch.pop("labels")
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(np.random.default_rng(2).normal(
                size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
        logits, aux = m.apply_train(params, **batch)
        if cfg.family == "vlm":
            logits = logits[:, cfg.n_vision_tokens:]
        loss = steps._xent(logits, labels)[0] + 0.01 * aux
        grads[remat] = torch.autograd.grad(loss, list(params.parameters()),
                                           allow_unused=True)
    for g0, g1 in zip(grads[False], grads[True]):
        assert (g0 is None) == (g1 is None)
        if g0 is not None:
            close(g1, g0, 1e-6, f"{arch} remat grads")


# ---------------------------------------------------------------------------
# The port's own step, trainer and CLI
# ---------------------------------------------------------------------------


def tiny_state(cfg, seed=0):
    return steps.init_train_state(
        model.build(cfg).init(torch.Generator().manual_seed(seed)))


def test_microbatches_are_loss_equivalent():
    """M=1 and M=4 on one batch in bf16 compute (the reference's own test):
    nll to float32 accumulation precision; the Adam-amplified parameters
    with the reference's loose tolerance."""
    cfg = tiny_cfg()
    small = ShapeSpec("t", "train", 32, 8)
    batch = torch_batch(pipeline.TokenBatcher(cfg.vocab, 8, 32, seed=1)(0))
    outs = []
    for m in (1, 4):
        step = steps.make_train_step(cfg, small, microbatches=m, peak_lr=1e-3,
                                     warmup_steps=0, total_steps=10)
        outs.append(step.fn(tiny_state(cfg), dict(batch)))
    np.testing.assert_allclose(float(outs[0][1]["nll"]),
                               float(outs[1][1]["nll"]), rtol=1e-5)
    w1, w4 = (o[0]["params"].layers[0]["b0_attn_mlp"].attn.wq.weight.detach()
              for o in outs)
    np.testing.assert_allclose(w1.numpy(), w4.numpy(), rtol=0.5, atol=4e-3)


def test_train_step_decreases_loss():
    cfg = tiny_cfg()
    small = ShapeSpec("t", "train", 32, 8)
    step = steps.make_train_step(cfg, small, microbatches=2, peak_lr=2e-3,
                                 warmup_steps=5, total_steps=100)
    batcher = pipeline.TokenBatcher(cfg.vocab, 8, 32, seed=0)
    state, first, last = tiny_state(cfg), None, None
    for i in range(25):
        state, m = step.fn(state, torch_batch(batcher(i % 4)))
        first = float(m["nll"]) if i == 0 else first
        last = float(m["nll"])
    assert np.isfinite(last) and last < first - 0.1, (first, last)


def test_step_metadata_equals_reference():
    """loop_dims per family, the batch and state structures (shapes and
    dtypes, parameters by count and size), and the serving steps."""
    small = ShapeSpec("t", "train", 32, 8)
    jsmall = JShapeSpec("t", "train", 32, 8)
    cfg = tiny_cfg()
    assert steps.make_train_step(cfg, small, microbatches=4).loop_dims == {
        "microbatches": 4, "layers": 2}
    for arch in ("whisper-medium", "recurrentgemma-9b", "llava-next-mistral-7b"):
        c = configs.reduce_config(configs.get_config(arch))
        jc = jconfigs.reduce_config(jconfigs.get_config(arch))
        ours = steps.make_train_step(c, small, microbatches=2)
        ref = jsteps.make_train_step(jc, jsmall, None, microbatches=2)
        assert ours.loop_dims == ref.loop_dims and ours.meta == ref.meta
        state_s, batch_s = ours.arg_structs
        jstate_s, jbatch_s = ref.arg_structs
        assert {k: v[0] for k, v in batch_s.items()} == {
            k: v.shape for k, v in jbatch_s.items()}
        want = []        # the reference stacks layers: one shape per layer
        for path, a in jax.tree_util.tree_leaves_with_path(jstate_s["params"]):
            stacked = path[0].key in ("layers", "enc_layers")
            want += [a.shape[1:]] * a.shape[0] if stacked else [a.shape]
        for part in (state_s["params"], state_s["opt"].mu, state_s["ef"].residual):
            # an nn.Linear (the only ``.weight``) holds (in, out) as (out, in)
            assert sorted(s[::-1] if n.endswith(".weight") else s
                          for n, (s, _) in part.items()) == sorted(want)
            assert {dt for _, dt in part.values()} == {torch.float32}
        assert state_s["opt"].step == ((), torch.int32)
    for kind in ("prefill", "decode"):
        shape = ShapeSpec("s", kind, 16, 2)
        jshape = JShapeSpec("s", kind, 16, 2)
        ours = steps.make_step(cfg, shape)
        ref = jsteps.make_step(tiny_cfg(), jshape, None)
        assert ours.loop_dims == ref.loop_dims and ours.meta == ref.meta
        assert {dt for _, dt in ours.arg_structs[0].values()} == {torch.bfloat16}
    assert steps.batch_axes_for(8, None) == ()
    # with a mesh the steps build sharded (tests/test_torch_sharding.py
    # holds them against the unsharded port and their specs against the
    # reference's); the batch splits over ``data``
    mesh = make_mesh(2, 2, device="cpu")
    assert steps.batch_axes_for(8, mesh) == ("data",)
    sharded = steps.make_train_step(cfg, small, mesh=mesh)
    assert sharded.loop_dims == steps.make_train_step(cfg, small).loop_dims
    assert tuple(sharded.in_specs[1]["tokens"]) == ("data",)


def test_prefill_then_decode_steps_run():
    cfg = tiny_cfg()
    pstep = steps.make_prefill_step(cfg, ShapeSpec("p", "prefill", 16, 2))
    dstep = steps.make_decode_step(cfg, ShapeSpec("d", "decode", 16, 2))
    params = model.build(cfg).init(torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab,
                                                              (2, 16)))
    logits, cache = pstep.fn(params, {"tokens": toks})
    assert logits.shape == (2, cfg.vocab)
    lg2, cache = dstep.fn(params, cache, torch.zeros((2, 1), dtype=torch.int32),
                          torch.full((2,), 16, dtype=torch.int32))
    assert lg2.shape == (2, cfg.vocab) and bool(torch.isfinite(lg2).all())


def make_trainer(tmp_path, total, failure_at=None):
    cfg = tiny_cfg()
    step = steps.make_train_step(cfg, ShapeSpec("t", "train", 16, 4),
                                 microbatches=2, compress="bf16", peak_lr=1e-3,
                                 warmup_steps=2, total_steps=20)
    batcher = pipeline.TokenBatcher(cfg.vocab, 4, 16, seed=5)
    return Trainer(
        step_fn=step.fn, state=tiny_state(cfg),
        batcher=lambda i: torch_batch(batcher(i)),
        checkpointer=Checkpointer(tmp_path, keep=10),
        loop=TrainLoopConfig(total_steps=total, ckpt_every=3, log_every=1,
                             failure_at=failure_at),
        to_ckpt=steps.train_state_to_ckpt,
        from_ckpt=steps.train_state_from_ckpt)


def test_trainer_restart_is_bit_exact(tmp_path):
    """Crash after step 5, restart from the step-3 checkpoint of params,
    moments, bf16 error-feedback residuals and step: the run continues the
    uninterrupted one bit for bit."""
    ref = make_trainer(tmp_path / "ref", 8)
    ref.run()
    crashed = make_trainer(tmp_path / "ft", 8, failure_at=5)
    with pytest.raises(SimulatedFailure):
        crashed.run()
    resumed = make_trainer(tmp_path / "ft", 8)
    assert resumed.restore_if_available() == 3
    assert int(resumed.state["opt"].step) == 3
    resumed.run(start_step=3)
    want, got = (steps.train_state_to_ckpt(tr.state) for tr in (ref, resumed))
    assert sorted(got) == sorted(want)
    assert any(k.startswith("ef/") and bool(v.any()) for k, v in want.items())
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert [m for _, m in ref.metrics_log][-3:] == [
        m for _, m in resumed.metrics_log][-3:]


def test_checkpoint_is_a_snapshot_while_training_goes_on(tmp_path,
                                                        monkeypatch):
    """The step-3 save is held on its writer thread while step 4 updates
    the CPU state in place; what lands on disk is still the state at
    step 3."""
    released = threading.Event()
    write = Checkpointer._write

    def held_write(self, step, host, treedef):
        if step == 3:
            assert released.wait(60)
        write(self, step, host, treedef)

    monkeypatch.setattr(Checkpointer, "_write", held_write)
    tr = make_trainer(tmp_path, 5)
    inner, at3 = tr.step_fn, {}

    def step_fn(state, batch):
        if int(state["opt"].step) == 3:
            at3.update({k: v.clone()
                        for k, v in steps.train_state_to_ckpt(state).items()})
        out = inner(state, batch)
        if int(out[0]["opt"].step) == 4:
            released.set()
        return out

    tr.step_fn = step_fn
    assert tr.run() == 5
    loaded = Checkpointer(tmp_path).restore(3, tuple(at3))
    assert any(not torch.equal(v, steps.train_state_to_ckpt(tr.state)[k])
               for k, v in at3.items())
    for k, v in at3.items():
        assert np.array_equal(np.asarray(loaded[k]), v.numpy()), k


def test_train_main_on_cpu_and_restart(tmp_path, capsys):
    argv = ["--device", "cpu", "--reduced", "--steps", "10", "--batch", "4",
            "--seq", "16", "--compress", "int8"]
    res = train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "trained to step 10:" in out and "step     5  loss" in out
    assert res["end_step"] == 10 and res["device"] == "cpu"
    assert [s for s, _ in res["metrics_log"]] == [5, 10]
    assert all(np.isfinite(m["loss"]) for _, m in res["metrics_log"])
    assert (tmp_path / "a" / "step_00000010" / "manifest.json").exists()
    # 6 steps, then a second run of the CLI resumes at 6 and goes on to 10
    train.main(argv[:4] + ["6"] + argv[5:] + ["--ckpt-dir", str(tmp_path / "b")])
    resumed = train.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    want, got = (steps.train_state_to_ckpt(r["state"]) for r in (res, resumed))
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for arch in ("whisper-medium", "llava-next-mistral-7b"):
        with pytest.raises(SystemExit):
            train.main(["--device", "cpu", "--reduced", "--arch", arch])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(["--reduced"])
