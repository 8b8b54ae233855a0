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
from repro_torch.core import bitpack, indexing  # noqa: E402
from repro_torch.core.types import TMConfig, TMState  # noqa: E402
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
        "round_vote", "index_update")
    include, x, _, pol = make_case(3, 8, 17, 9, seed=5)
    cfg = TMConfig(n_classes=3, n_clauses=8, n_features=17)
    index = indexing.build_index(cfg, TMState(torch.from_numpy(np.where(
        include, cfg.n_states + 1, cfg.n_states).astype(np.int16))), 8)
    before = (indexed.indexed_votes.launches,
              clause_eval.clause_votes_packed.launches,
              clause_eval.round_vote.launches)
    lit = torch.from_numpy(literals(x))
    got = backend.resolve("indexed_votes")(*index, lit, torch.from_numpy(pol))
    want = indexed.indexed_votes_ref(index.pos, lit, torch.from_numpy(pol))
    assert torch.equal(got, want)
    backend.resolve("clause_votes")(
        bitpack.pack_bits(torch.from_numpy(include)),
        bitpack.packed_literals(torch.from_numpy(x)), torch.from_numpy(pol))
    row = torch.from_numpy(np.where(include[0], cfg.n_states + 1,
                                    cfg.n_states).astype(np.int16))
    words = bitpack.packed_literals(torch.from_numpy(x[0]))
    out, vote = backend.resolve("round_vote")(row, words, torch.from_numpy(pol),
                                              n_states=cfg.n_states)
    assert torch.equal(out, clause_eval.clause_outputs_ref(
        bitpack.pack_bits(torch.from_numpy(include[:1])), words[None])[0, 0])
    after = (indexed.indexed_votes.launches,
             clause_eval.clause_votes_packed.launches,
             clause_eval.round_vote.launches)
    assert after == before                   # no kernel launch on the CPU


@pytest.mark.parametrize("kernel", [indexed.indexed_votes,
                                    clause_eval.clause_votes_packed])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    a = torch.zeros((1, 2, 4), dtype=torch.int32)
    args = (a, torch.zeros((1, 4), dtype=torch.uint8),
            torch.ones(2, dtype=torch.int32))
    if kernel is indexed.indexed_votes:      # (lists, counts) of the index
        args = (torch.zeros((1, 4, 2), dtype=torch.int32),
                torch.zeros((1, 4), dtype=torch.int32)) + args
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel(*args)


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
    assert _build.sources() == ["clause_eval", "indexed_votes", "ta_update"]
    kernels = {backend.get_primitive(name).kernel.__module__.rsplit(".")[-1]
               + "." + backend.get_primitive(name).kernel.__name__
               for name in backend.registered_primitives()}
    assert {"clause_eval.clause_outputs_packed", "clause_eval.clause_votes_packed",
            "clause_eval.round_vote", "indexed.indexed_votes",
            "ta_update.ta_update"} <= kernels


def test_learning_kernel_wrappers_refuse_cpu_tensors():
    n, L = 4, 6
    with pytest.raises(ValueError, match="CUDA tensor"):
        clause_eval.clause_outputs_packed(torch.zeros((1, n, 1), dtype=torch.int32),
                                          torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        clause_eval.round_vote(torch.ones((n, L), dtype=torch.int16),
                               torch.zeros(1, dtype=torch.int32),
                               torch.ones(n, dtype=torch.int32), n_states=3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ta_update.ta_update(
            torch.ones((n, L), dtype=torch.int16), torch.zeros(L, dtype=torch.uint8),
            torch.zeros(n, dtype=torch.int8), torch.zeros(n, dtype=torch.bool),
            torch.zeros(n, dtype=torch.bool), torch.zeros((n, L)),
            n_states=3, s=3.9)


# ---------------------------------------------------------------------------
# launch geometry of csrc/clause_eval.cu: clause_eval.launch_plan is pure, so
# its tiling is checked here; the helpers below mirror the kernel's index math
# ---------------------------------------------------------------------------

# (B, m, n, W): the card tests' SHAPES, the training round and the top
# serving bucket at the MNIST width, row widths from one word to
# IMDb-scale rows that need several chunks, and the shard widths of the
# MNIST width's sharded topologies (n_local 500 and 667, n_sub 334: the
# training round, and scoring 1020 rows split over 1 or 3 data ranks)
PLAN_SHAPES = sorted({
    (3, 2, 4, 1), (9, 3, 8, 2), (8, 10, 130, 4), (4, 2, 256, 13),
    (2, 1, 2, 129), (70, 2, 64, 3), (32, 10, 2000, 49), (1, 10, 2000, 49),
    (1, 1, 2000, 49), (33, 2, 130, 65), (9, 1, 2001, 49),
    *((b, m, n, w) for w in (1, 2, 49, 129, 2500)
      for b, m, n in ((1, 1, 2000), (32, 10, 2000), (70, 3, 130))),
    *((b, m, n, 49) for n in (334, 500, 667)
      for b, m in ((1, 1), (2, 1), (340, 10), (1020, 10))),
})


def block_tiles(plan, m, x, y):
    """(class, first clause) of each tile block (x, y) takes. Tiled: tiles
    x, x + gx, … below m · n_ctiles; direct: clause tile x of class y."""
    if plan.route == "direct":
        return [(y, x)]
    return [divmod(t, plan.n_ctiles) for t in
            range(x, m * plan.n_ctiles, plan.grid[0])]


def tile_cells(plan, b, m, n, i, jt, y):
    """(sample, class, clause) of every cell that the block's threads store
    for the tile (i, jt) of sample tile y (j < n, sample < B)."""
    t = np.arange(plan.threads)
    if plan.route == "direct":          # lane 0 of each ks-lane group
        j, bb = np.broadcast_arrays((jt * plan.ct + t // plan.ks)[:, None],
                                    np.arange(b)[None, :])
        keep = (t % plan.ks == 0)[:, None] & (j < n)
    else:
        warp, lane = t // 32, t % 32
        j, bb = np.broadcast_arrays(              # (threads, sb)
            (jt * plan.ct + warp // plan.sg * 32 + lane)[:, None],
            y * plan.bt + (warp % plan.sg * plan.sb)[:, None]
            + np.arange(plan.sb)[None, :])
        keep = (j < n) & (bb < b)
    return bb[keep], np.full(int(keep.sum()), i), j[keep]


def copy_runs(src, dst, wn):
    """Runs of words as the kernel copies them (arrays of source and shared
    word offsets, one per run): 4-byte head words up to the source's next
    16-byte line, then 16-byte quads, then 4-byte tail words. Returns
    (head, quads, tail) word counts per run."""
    head = np.minimum((4 - src % 4) % 4, wn)
    quads = (wn - head) // 4
    return head, quads, wn - head - 4 * quads


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_launch_plan_tiles_cover_every_cell_once(shape):
    b, m, n, w = shape
    plan = clause_eval.launch_plan(b, m, n, w)
    assert plan.route == ("direct" if b <= 2 else "tiled")
    assert plan.bt == plan.sb * plan.sg and plan.bt <= 32
    if plan.route == "direct":         # B = 1 and 2 idle no lane
        assert plan.bt == b and plan.ct * plan.ks == plan.threads
        assert plan.ks == 1 or 4 * plan.ks // 2 < w
    else:
        assert plan.ct == plan.threads // plan.sg and plan.sb == 8
        assert plan.threads // 32 % plan.sg == 0
    count = np.zeros((b, m, n), np.int64)
    for y in range(plan.grid[1]):
        for x in range(plan.grid[0]):
            for i, jt in block_tiles(plan, m, x, y):
                np.add.at(count, tile_cells(plan, b, m, n, i, jt, y), 1)
    assert (count == 1).all()
    assert plan.n_btiles * plan.bt >= b and plan.n_ctiles * plan.ct >= n


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_launch_plan_fits_shared_memory(shape):
    b, m, n, w = shape
    for route in ("tiled", "direct") if b <= 2 else ("tiled",):
        plan = clause_eval.launch_plan(b, m, n, w, route=route)
        assert plan.smem_bytes <= 232_448
        assert plan.n_chunks == max(1, -(-w // plan.wc)) and plan.wc >= 1
        if route == "direct":
            assert plan.smem_bytes == 0 and plan.n_chunks == 1
            continue
        assert plan.smem_bytes == clause_eval.smem_bytes(
            plan.ct, plan.bt, plan.wc, plan.stride, plan.n_chunks)
        if w <= 49:                 # a row of the MNIST width is one chunk
            assert plan.n_chunks == 1
        assert w <= plan.wc * plan.n_chunks < w + plan.n_chunks


@pytest.mark.parametrize("base", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_launch_plan_copies_are_aligned_or_scalar(shape, base):
    """Every 16-byte cp.async of every stage of the tiled route has a
    16-byte-aligned source and destination, the 4-byte ones take the rest,
    and each row's words land in their own slot of the include buffer.
    ``base`` is the include tensor's word offset in its 16-byte line (a
    view). The direct route issues no copies."""
    b, m, n, w = shape
    plan = clause_eval.launch_plan(b, m, n, w, route="tiled")
    buf_words = (plan.ct * plan.stride + 3 + 3) & ~3
    assert plan.stride >= plan.wc and (plan.stride - w) % 4 == 0
    g = np.arange(m * n)                          # every clause row, flat
    r = g % n % plan.ct                           # its row within its tile
    flat = plan.n_chunks == 1 and plan.stride == w
    for c in range(plan.n_chunks):
        w0 = c * plan.wc
        wn = min(plan.wc, w - w0)
        src = base + g * w + w0                   # the row's chunk
        shift = (src - r * w) % 4                 # the tile's first row's
        dst = shift + r * plan.stride
        if flat:                                  # one run per tile
            first = r == 0
            rows = np.minimum(plan.ct, n - g % n)[first]
            src, dst, wn = src[first], dst[first], rows * w
        head, quads, tail = copy_runs(src, dst, wn)
        assert (head + 4 * quads + tail == wn).all()
        assert (head <= 3).all() and (tail < 4).all()
        body = quads > 0
        assert ((src + head)[body] % 4 == 0).all()
        assert ((dst + head)[body] % 4 == 0).all()
        # each row's slot [dst, dst + wn) lies in the buffer, apart from
        # its neighbours' (rows are stride >= wn words apart)
        assert (dst + wn <= buf_words).all() and plan.stride >= min(plan.wc, w)


def test_launch_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="threads"):
        clause_eval.launch_plan(32, 10, 2000, 49, threads=48)
    with pytest.raises(ValueError, match="one warp or more"):
        clause_eval.launch_plan(32, 10, 2000, 49, threads=64)
    with pytest.raises(ValueError, match="B <= 2"):
        clause_eval.launch_plan(3, 10, 2000, 49, route="direct")
    with pytest.raises(ValueError, match="shared bytes"):
        clause_eval.launch_plan(32, 10, 2000, 2500, wc=2500)
    with pytest.raises(ValueError, match="no work"):
        clause_eval.launch_plan(0, 10, 2000, 49)


# ---------------------------------------------------------------------------
# round_vote (csrc/clause_eval.cu round_vote_launch): its plain body is the
# reference's round, its geometry round_vote_plan's; emulate_round_vote
# mirrors the kernel's loops, loads and bit tests on the CPU
# ---------------------------------------------------------------------------

# (n, L): the paper's widths, 2o off a multiple of 8 (the scalar route), a
# row of one unit, and n off a multiple of the clauses a block takes
VOTE_SHAPES = [(2000, 1568), (2000, 10000), (13, 34), (130, 1570), (5, 8),
               (67, 2), (9, 0), (33, 96)]


def vote_case(n, L, seed, n_states=127):
    """A class row of int16 states whose clauses are mixed: about 2% of
    the literals included, a third of the clauses true (includes only on
    true literals), clause 0 empty, clause 1 all-included, states at N and
    N + 1 among them; a sample's (L,) literals; pol ±1 with the last rows
    0 (padding)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, L // 2).astype(np.uint8)
    lit = np.concatenate([x, 1 - x]) if L % 2 == 0 else rng.integers(0, 2, L)
    include = rng.uniform(size=(n, L)) < 0.02
    true_rows = rng.uniform(size=n) < 1 / 3
    include[true_rows] &= lit[None].astype(bool)
    include[0] = False
    if n > 1:
        include[1] = True
    ta = np.where(include, rng.integers(n_states + 1, 2 * n_states + 1, (n, L)),
                  rng.integers(1, n_states + 1, (n, L)))
    ta[include & (rng.uniform(size=(n, L)) < 0.3)] = n_states + 1
    ta[~include & (rng.uniform(size=(n, L)) < 0.3)] = n_states
    pol = np.where(np.arange(n) < n // 2, 1, -1).astype(np.int32)
    pol[max(0, n - 3):] = 0
    words = bitpack.pack_bits(torch.from_numpy(lit.astype(np.uint8)))
    return (torch.from_numpy(ta.astype(np.int16)), words,
            torch.from_numpy(pol), include, lit)


def signed16(v):
    """The low halfword of ``v`` as a signed 16-bit integer."""
    v &= 0xFFFF
    return v - 0x10000 if v & 0x8000 else v


def emulate_round_vote(ta, words, pol, n_states, plan):
    """The kernel's arithmetic, lane by lane: each warp's clause groups of
    ``ks`` lanes, ``VOTE_UNROLL`` units a lane per pass, a unit's 8 states
    as four 32-bit words compared a halfword at a time (``__vcmpgts2``)
    against the literal byte ``u`` of the packed words, the group's ballot,
    the warp's exit once each group has a falsifier; the vote summed."""
    n, L = ta.shape
    ks, unroll = plan.ks, clause_eval.VOTE_UNROLL
    units = L // 8 if plan.vec else L
    lit_bytes = words.numpy().view(np.uint8)
    state_words = (ta.numpy().view(np.uint32) if plan.vec else None)
    nn = (n_states & 0xFFFF) * 0x10001
    out = np.zeros(n, np.int8)
    per_warp = 32 // ks
    for w0 in range(0, plan.grid * plan.threads // ks, per_warp):
        clauses = range(w0, w0 + per_warp)
        done = {j: j >= n for j in clauses}
        for u0 in range(0, units, ks * unroll):
            for j in clauses:
                if done[j]:
                    continue
                hit = 0
                for t in range(unroll):
                    for kp in range(ks):
                        u = u0 + t * ks + kp
                        if u >= units:
                            continue
                        lb = int(lit_bytes[u >> 3 if not plan.vec else u])
                        if plan.vec:
                            bits = 0
                            for h in range(4):
                                v = int(state_words[j, 4 * u + h])
                                c = sum(0xFFFF << (16 * q) for q in range(2)
                                        if signed16(v >> (16 * q))
                                        > signed16(nn))
                                bits |= ((c & 1) | ((c >> 15) & 2)) << (2 * h)
                            hit |= bits & ~lb
                        else:
                            hit |= (int(ta[j, u]) > n_states) & ~(lb >> (u & 7)) & 1
                done[j] = done[j] or hit != 0
            if all(done.values()):
                break
        for j in clauses:
            if j < n:
                out[j] = 0 if done[j] else 1
    out = torch.from_numpy(out)
    return out, (out.to(torch.int32) * pol).sum(dtype=torch.int32)


@pytest.mark.parametrize("n,L", VOTE_SHAPES)
def test_round_vote_ref_is_the_references_round(n, L):
    """The plain body against the reference's packed route: its XLA clause
    outputs of the packed include mask, and the polarity sum."""
    from repro.kernels.backend import _clause_outputs_xla

    ta, words, pol, include, lit = vote_case(n, L, seed=n + L)
    out, vote = clause_eval.round_vote_ref(ta, words, pol, n_states=127)
    want = np.asarray(_clause_outputs_xla(
        jbitpack.pack_bits(jnp.asarray(include[None].astype(np.uint8))),
        jnp.asarray(words.numpy()[None].view(np.uint32))))[0, 0]
    assert out.dtype == torch.int8 and vote.dtype == torch.int32
    assert vote.dim() == 0
    np.testing.assert_array_equal(out.numpy(), want)
    assert int(vote) == int((want.astype(np.int64) * pol.numpy()).sum())
    if n > 2 and L > 2:
        assert out[0] == 1 and out[1] == 0 and 0 < int(out.sum()) < n


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("n,L", [s for s in VOTE_SHAPES if s[0] * s[1] < 50_000]
                         + [(40, 1568), (24, 10000)])
def test_round_vote_kernel_arithmetic_is_the_plain_body(n, L, offset):
    """The kernel's loops and bit tests, emulated on the CPU, on both
    routes (the vector route where 2o % 8 == 0 and the row is aligned)."""
    ta, words, pol, _, _ = vote_case(n, L, seed=3 * n + L)
    vec = L % 8 == 0 and offset == 0
    plan = clause_eval.round_vote_plan(n, L, vec)
    got = emulate_round_vote(ta, words, pol, 127, plan)
    want = clause_eval.round_vote_ref(ta, words, pol, n_states=127)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,L", VOTE_SHAPES)
@pytest.mark.parametrize("vec", [True, False])
def test_round_vote_plan_covers_every_row_and_adapts_to_the_width(n, L, vec):
    if vec and L % 8:
        with pytest.raises(ValueError, match="no plan"):
            clause_eval.round_vote_plan(n, L, vec)
        return
    plan = clause_eval.round_vote_plan(n, L, vec)
    per_block = plan.threads // plan.ks
    assert plan.threads % 32 == 0 and plan.ks in (1, 2, 4, 8, 16, 32)
    assert (plan.grid - 1) * per_block < n <= plan.grid * per_block
    units = L // 8 if vec else L
    # the least ks whose passes of VOTE_UNROLL loads cover a row, at most 32
    assert plan.ks == 32 or plan.ks * clause_eval.VOTE_UNROLL >= units
    assert plan.ks == 1 or (plan.ks // 2) * clause_eval.VOTE_UNROLL < units
    if (L, vec) in ((1568, True), (10000, True)):
        assert plan.ks == 32                 # the paper's widths: a warp a clause


def test_round_vote_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="no plan"):
        clause_eval.round_vote_plan(0, 1568, True)
    with pytest.raises(ValueError, match="no plan"):
        clause_eval.round_vote_plan(10, 34, True)
