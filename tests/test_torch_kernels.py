"""PyTorch port (``repro_torch``) kernels vs the JAX reference, on the CPU.

The port's plain kernel versions (``indexed_votes_ref``, ``clause_votes_ref``)
are held against the reference's XLA bodies and its Pallas kernels in
interpret mode, and the port's bit packing against ``repro.core.bitpack``.
Every comparison is integer and exact (tolerance 0). Inputs come from a
seeded numpy generator and pass to both packages as numpy arrays.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
holds them against these plain versions there.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import bitpack as jbitpack  # noqa: E402
from repro.kernels import clause_eval as jclause_eval  # noqa: E402
from repro.kernels import indexed as jindexed  # noqa: E402
from repro.kernels.backend import _clause_votes_xla  # noqa: E402
from repro_torch.core import bitpack  # noqa: E402
from repro_torch.core.types import TMConfig  # noqa: E402
from repro_torch.kernels import _build, backend  # noqa: E402
from repro_torch.kernels import clause_eval, indexed, ta_update  # noqa: E402

# (m, n, o, b) — the deliberately unaligned sweep of tests/test_kernels.py
SHAPES = [
    (2, 4, 5, 3),
    (3, 8, 17, 9),
    (10, 130, 50, 8),
    (2, 256, 784 // 4, 4),
    (1, 2, 2049, 2),
]
PACK_WIDTHS = [1, 31, 32, 33, 100, 784, 1568]


def make_case(m, n, o, b, seed, density=0.3):
    """include (m, n, 2o) bool, x (B, o) uint8, pos (m, n, 2o) int32 with
    arbitrary non-NA slots where included, pol (n,) int32 ±1."""
    rng = np.random.default_rng(seed)
    include = rng.uniform(size=(m, n, 2 * o)) < density
    x = rng.integers(0, 2, (b, o)).astype(np.uint8)
    pos = np.where(include, rng.integers(0, n, include.shape), -1)
    pol = np.where(np.arange(n) < n // 2, 1, -1).astype(np.int32)
    return include, x, pos.astype(np.int32), pol


def literals(x):
    return np.concatenate([x, 1 - x], axis=-1)


# ---------------------------------------------------------------------------
# bit packing: int32 words bit-identical to the reference's uint32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", PACK_WIDTHS)
def test_pack_bits_bit_identical_to_reference(k):
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (3, k)).astype(np.uint8)
    bits[:, :min(k, 32)] = 1                     # bit 31 set wherever it exists
    want = np.asarray(jbitpack.pack_bits(jnp.asarray(bits)))
    got = bitpack.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(bitpack.unpack_bits(got, k).numpy(), bits)

    x = rng.integers(0, 2, (2, k)).astype(np.uint8)
    np.testing.assert_array_equal(
        bitpack.packed_literals(torch.from_numpy(x)).numpy().view(np.uint32),
        np.asarray(jbitpack.packed_literals(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# plain kernel versions vs the reference's XLA bodies and Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_indexed_votes_ref_matches_reference(shape):
    m, n, o, b = shape
    include, x, pos, pol = make_case(m, n, o, b, seed=sum(shape))
    lit = literals(x)
    got = indexed.indexed_votes_ref(torch.from_numpy(pos),
                                    torch.from_numpy(lit),
                                    torch.from_numpy(pol))
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, m)
    xla = jindexed.indexed_votes_xla(jnp.asarray(pos), jnp.asarray(lit),
                                     jnp.asarray(pol))
    pallas = jindexed.indexed_votes(jnp.asarray(pos), jnp.asarray(lit),
                                    jnp.asarray(pol), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("shape", SHAPES)
def test_clause_votes_ref_matches_reference(shape):
    m, n, o, b = shape
    include, x, _, pol = make_case(m, n, o, b, seed=sum(shape) + 1)
    inc_words = jbitpack.pack_bits(jnp.asarray(include.astype(np.uint8)))
    lit_words = jbitpack.packed_literals(jnp.asarray(x))
    got = clause_eval.clause_votes_ref(
        bitpack.pack_bits(torch.from_numpy(include)),
        bitpack.packed_literals(torch.from_numpy(x)),
        torch.from_numpy(pol))
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, m)
    xla = _clause_votes_xla(inc_words, lit_words, jnp.asarray(pol))
    pallas = jclause_eval.clause_votes_packed(inc_words, lit_words,
                                              jnp.asarray(pol), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_empty_clauses_vote_as_true_in_both_forms():
    """An empty clause is never falsified: +pol in clause_votes, 0 in the
    indexed form (whose scores are -Σ falsified·pol)."""
    m, n, o = 1, 4, 3
    pos = np.full((m, n, 2 * o), -1, np.int32)
    pol = np.array([1, 1, -1, -1], np.int32)
    x = np.array([[1, 0, 1]], np.uint8)
    assert indexed.indexed_votes_ref(
        torch.from_numpy(pos), torch.from_numpy(literals(x)),
        torch.from_numpy(pol)).tolist() == [[0]]
    inc = torch.zeros((m, n, 1), dtype=torch.int32)
    lit = bitpack.packed_literals(torch.from_numpy(x))
    pol_t = torch.from_numpy(np.array([1, 1, 1, -1], np.int32))
    assert clause_eval.clause_votes_ref(inc, lit, pol_t).tolist() == [[2]]


# ---------------------------------------------------------------------------
# routing: the device picks the body; the kernel never takes a CPU tensor
# ---------------------------------------------------------------------------


def test_registry_routes_cpu_tensors_to_plain_body():
    assert backend.registered_primitives() == (
        "clause_votes", "indexed_votes", "clause_outputs", "ta_update",
        "index_update")
    include, x, pos, pol = make_case(3, 8, 17, 9, seed=5)
    before = (indexed.indexed_votes.launches,
              clause_eval.clause_votes_packed.launches)
    got = backend.resolve("indexed_votes")(
        torch.from_numpy(pos), torch.from_numpy(literals(x)),
        torch.from_numpy(pol))
    want = indexed.indexed_votes_ref(
        torch.from_numpy(pos), torch.from_numpy(literals(x)),
        torch.from_numpy(pol))
    assert torch.equal(got, want)
    backend.resolve("clause_votes")(
        bitpack.pack_bits(torch.from_numpy(include)),
        bitpack.packed_literals(torch.from_numpy(x)), torch.from_numpy(pol))
    after = (indexed.indexed_votes.launches,
             clause_eval.clause_votes_packed.launches)
    assert after == before                   # no kernel launch on the CPU


@pytest.mark.parametrize("kernel", [indexed.indexed_votes,
                                    clause_eval.clause_votes_packed])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    a = torch.zeros((1, 2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel(a, torch.zeros((1, 4), dtype=torch.uint8),
               torch.ones(2, dtype=torch.int32))


def test_only_the_auto_backend_exists():
    with pytest.raises(ValueError, match="device"):
        TMConfig(n_classes=2, n_clauses=4, n_features=3, backend="pallas")
    assert TMConfig(n_classes=2, n_clauses=4, n_features=3).backend == "auto"
    with pytest.raises(KeyError, match="registered"):
        backend.resolve("compact_votes")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_every_kernel_source_is_a_registered_primitive_body():
    assert _build.sources() == ["clause_outputs", "clause_votes",
                                "indexed_votes", "ta_update"]
    kernels = {backend.get_primitive(name).kernel.__module__.rsplit(".")[-1]
               + "." + backend.get_primitive(name).kernel.__name__
               for name in backend.registered_primitives()}
    assert {"clause_eval.clause_outputs_packed", "clause_eval.clause_votes_packed",
            "indexed.indexed_votes", "ta_update.ta_update"} <= kernels


def test_learning_kernel_wrappers_refuse_cpu_tensors():
    n, L = 4, 6
    with pytest.raises(ValueError, match="CUDA tensor"):
        clause_eval.clause_outputs_packed(torch.zeros((1, n, 1), dtype=torch.int32),
                                          torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ta_update.ta_update(
            torch.ones((n, L), dtype=torch.int16), torch.zeros(L, dtype=torch.uint8),
            torch.zeros(n, dtype=torch.int8), torch.zeros(n, dtype=torch.bool),
            torch.zeros(n, dtype=torch.bool), torch.zeros((n, L)),
            n_states=3, s=3.9)
