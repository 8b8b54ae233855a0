"""The port's CUDA kernels on the card (``cuda`` marker; skips without one).

Run on a machine with an NVIDIA GPU:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, bit for bit (integer results, tolerance 0), over unaligned shapes,
batches past one 32-sample word and the MNIST width; and the session's
scores on the card equal the same session's on the CPU. Imports no JAX, so
it runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitpack
from repro_torch.core.session import TMSession
from repro_torch.core.types import TMConfig, TMState
from repro_torch.kernels import clause_eval, indexed

# (m, n, o, b): the unaligned sweep of tests/test_kernels.py, a batch past
# one 32-sample word, and the tm_mnist width at the top serving bucket
SHAPES = [(2, 4, 5, 3), (3, 8, 17, 9), (10, 130, 50, 8), (2, 256, 196, 4),
          (1, 2, 2049, 2), (2, 64, 40, 70), (10, 2000, 784, 32)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def make_case(m, n, o, b, seed, dev):
    rng = np.random.default_rng(seed)
    include = rng.uniform(size=(m, n, 2 * o)) < 0.02
    x = rng.integers(0, 2, (b, o)).astype(np.uint8)
    pos = np.where(include, rng.integers(0, n, include.shape), -1)
    pol = np.where(np.arange(n) < n // 2, 1, -1).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(include), t(x), t(pos.astype(np.int32)), t(pol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_equal_plain_versions(cuda_device, shape):
    include, x, pos, pol = make_case(*shape, seed=sum(shape), dev=cuda_device)
    lit = torch.cat([x, 1 - x], dim=-1)
    before = indexed.indexed_votes.launches
    got = indexed.indexed_votes(pos, lit, pol)
    assert indexed.indexed_votes.launches == before + 1
    torch.testing.assert_close(got, indexed.indexed_votes_ref(pos, lit, pol),
                               rtol=0, atol=0)
    words = bitpack.pack_bits(include)
    lw = bitpack.packed_literals(x)
    got = clause_eval.clause_votes_packed(words, lw, pol)
    torch.testing.assert_close(got, clause_eval.clause_votes_ref(words, lw, pol),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    _, x, pos, pol = make_case(2, 8, 5, 3, seed=0, dev=cuda_device)
    lit = torch.cat([x, 1 - x], dim=-1)
    with pytest.raises(ValueError, match="uint8"):
        indexed.indexed_votes(pos, lit.to(torch.int32), pol)
    with pytest.raises(ValueError, match="contiguous"):
        indexed.indexed_votes(pos.transpose(0, 1).contiguous().transpose(0, 1),
                              lit, pol)
    with pytest.raises(ValueError, match="devices"):
        indexed.indexed_votes(pos, lit.cpu(), pol)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["indexed", "bitpack", "dense"])
def test_session_scores_on_card_equal_cpu(cuda_device, engine):
    cfg = TMConfig(n_classes=4, n_clauses=66, n_features=100)
    rng = np.random.default_rng(1)
    inc = rng.uniform(size=(4, 66, 200)) < 0.03
    ta = torch.from_numpy(
        np.where(inc, cfg.n_states + 1, cfg.n_states).astype(np.int16))
    xs = rng.integers(0, 2, (45, 100)).astype(np.uint8)
    scores = []
    for dev in (cuda_device, "cpu"):
        session = TMSession(cfg, engines=("indexed", "bitpack"), device=dev)
        bundle = session.prepare(TMState(ta_state=ta))
        scores.append(session.scores(bundle, xs, engine=engine).cpu())
    torch.testing.assert_close(scores[0], scores[1], rtol=0, atol=0)
