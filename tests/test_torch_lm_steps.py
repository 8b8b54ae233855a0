"""One ``make_train_step`` step per decoder architecture of the port
(``repro_torch.steps``) against the reference's, on the CPU, at
``reduce_config`` width in float32 (every package's ``COMPUTE_DTYPE``
patched); whisper's step is in ``tests/test_torch_whisper.py``, the
optimizer, data and trainer pieces in ``tests/test_torch_lm_train.py``.

Weights are the port's init from a seeded generator, its constant-at-init
leaves perturbed, handed to the reference as its tree and carried back by
``convert.lm_params_from_reference``; the batch is seeded numpy. The step runs with ``peak_lr=0``, so the
parameters stay as they were and the first moment holds the clipped
gradients (``mu = 0.1·clip(g)``). Tolerances, relative to the largest
magnitude of the reference's value: ``loss`` / ``nll`` 1e-5; the
gradients, the second moment and ``grad_norm`` (a reduction of the
gradients) 1e-4: rwkv6-3b's gradient norm moves by 1.1e-4 between the
port's float32 and float64 runs, and the two packages' float32 ones are
2.5e-5 apart.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import steps as jsteps  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcompression  # noqa: E402

from repro_torch import configs, convert, steps  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import model, transformer, whisper  # noqa: E402

STEP_TOL, GRAD_TOL = 1e-5, 1e-4
DECODER_ARCHS = tuple(a for a in configs.ARCHS if a != "whisper-medium")
CONSTANT_AT_INIT = ("mu_x", "mu", "mu_k", "mu_r", "w0", "b_a", "b_i", "conv_b")
B, S = 4, 8


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


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture
def float32_compute(monkeypatch):
    for mod in (transformer, whisper, steps):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    for mod in (jtransformer, jwhisper, jsteps):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)


def reference_tree(jcfg, params) -> dict:
    """The port's ``params`` as the reference's tree (the structure of its
    ``init``, traced and not run): each leaf from the port parameter that
    ``convert.lm_params_from_reference`` would fill from it, stacked over
    the layers and transposed back where an ``nn.Linear`` holds it."""
    named = {n: p.detach().numpy() for n, p in params.named_parameters()}

    def get(path):
        name, transpose = convert._lm_target(path, set(named))
        return named[name].T if transpose else named[name]

    def leaf(path, struct):
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        if keys[0] in ("layers", "enc_layers"):
            out = np.stack([get((keys[0], str(j)) + keys[1:])
                            for j in range(struct.shape[0])])
        else:
            out = get(keys)
        assert out.shape == struct.shape, (keys, out.shape, struct.shape)
        return out

    structs = jax.eval_shape(jmodel.build(jcfg).init, jax.random.key(0))
    return jax.tree_util.tree_map_with_path(leaf, structs)


@functools.lru_cache(maxsize=None)
def reference_params(arch):
    """Weights at reduced width for both packages, as the reference's tree:
    the port's init from a seeded generator (drawing the reference's
    distributions; the reference's own init would cost a compile per
    architecture) with the leaves that start constant (norm scales,
    biases, RWKV's mixes, Griffin's gates) perturbed so that they are
    tested too. ``lm_params_from_reference`` carries them back exactly."""
    cfg = configs.reduce_config(configs.get_config(arch))
    params = model.build(cfg).init(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for name, p in params.named_parameters():
            last = name.split(".")[-1]
            if "scale" in name or last in CONSTANT_AT_INIT:
                p += torch.from_numpy(0.1 * rng.normal(size=p.shape).astype(
                    np.float32))
            elif last == "bias" or last.endswith("_bias"):
                p.copy_(torch.from_numpy(0.1 * rng.normal(size=p.shape).astype(
                    np.float32)))
    return reference_tree(jconfigs.reduce_config(jconfigs.get_config(arch)),
                          params)


def train_batch(cfg, seed=5):
    rng = np.random.default_rng(seed)
    s_text = S - (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, s_text)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, s_text)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def by_port_name(cfg, tree) -> dict:
    """A reference tree shaped like the params (a moment), keyed by the
    port's parameter names."""
    return {n: p.detach() for n, p in lm_params_from_reference(
        cfg, jax.tree.map(np.asarray, tree), "cpu").named_parameters()}


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_train_step_matches_reference(arch, float32_compute):
    """One ``make_train_step`` step at reduce_config width in float32 with
    ``peak_lr=0``: loss, nll, grad_norm, lr, the step; the gradients (the
    first moment) and the second moment by parameter name; the parameters
    unchanged."""
    cfg = configs.reduce_config(configs.get_config(arch))
    # the reference unrolled (its use_scan=False: the same function, which
    # compiles faster on the CPU than the scanned one)
    jcfg = dataclasses.replace(
        jconfigs.reduce_config(jconfigs.get_config(arch)), use_scan=False)
    jp = reference_params(arch)
    kw = dict(microbatches=1, peak_lr=0.0, warmup_steps=0, total_steps=10)
    shape = ShapeSpec("t", "train", S, B)
    batch = train_batch(cfg)
    params = lm_params_from_reference(cfg, jp, "cpu")
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    state, metrics = steps.make_train_step(cfg, shape, **kw).fn(
        steps.init_train_state(params), torch_batch(batch))
    jstep = jsteps.make_train_step(jcfg, JShapeSpec("t", "train", S, B), None,
                                   **kw)
    jstate = {"params": jp, "opt": jadamw.init(jp),
              "ef": jcompression.init_error_feedback(jp)}
    jstate, jmetrics = jax.jit(jstep.fn)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    for key in ("loss", "nll"):
        close(metrics[key], jmetrics[key], STEP_TOL, f"{arch} {key}")
    close(metrics["grad_norm"], jmetrics["grad_norm"], GRAD_TOL,
          f"{arch} grad_norm")
    assert float(metrics["lr"]) == float(jmetrics["lr"]) == 0.0
    assert int(state["opt"].step) == int(jstate["opt"].step) == 1
    for part, want in (("mu", jstate["opt"].mu), ("nu", jstate["opt"].nu)):
        want = by_port_name(cfg, want)
        got = getattr(state["opt"], part)
        assert sorted(got) == sorted(want)
        scale = max(float(w.abs().max()) for w in want.values())
        for n, w in want.items():
            err = float((got[n] - w).abs().max())
            assert err <= GRAD_TOL * scale, f"{arch} {part} {n}: {err} > {scale}"
    for n, p in state["params"].named_parameters():
        assert torch.equal(p.detach(), before[n]), n
