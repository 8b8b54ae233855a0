"""The port's CUDA kernels on the card (``cuda`` marker; skips without one).

Run on a machine with an NVIDIA GPU:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, bit for bit (integer results, tolerance 0), over unaligned shapes,
batches past one 32-sample word and the MNIST width and the IMDb width;
the learning round's ``round_vote`` on both of its routes, aligned and
not, with empty, all-included and padding rows, and in learning steps; the
list walk ``indexed_votes`` on real indexes (``build_index``) against
the plain walk and the position form, also overflowing, after replays that
leave holes and unsorted lists, over several clause windows and cluster
sizes, and replayed from a CUDA graph; the session's
scores on the card equal the same session's on the CPU (the compact engine
too); and one training step on the card equals the same step on the CPU
under the same draws, state and caches alike; and the TM-native wrappers
of ``kernels/ops.py`` equal the unpacked oracles of ``kernels/ref.py``.
The LM path: float32 card = CPU for every family,
whisper included; one train step's gradients card = CPU; remat on = off;
the sharded LM path on ``["cuda:0"] * 4`` = the CPU mesh for every
family, and ``gpipe_apply`` on the card = the sequential stack. The
dry-run tools: ``dryrun.run_tm_checks`` / ``run_tm_async_checks`` with
k ranks on ``cuda:0`` (each kernel-backed engine launches its kernel),
and ``launch.trace`` on fake CUDA tensors = a real run on the card
(FLOPs, collectives, argument bytes). One latent-attention (MLA) layer of
deepseek-v2-lite at its published widths and 4,096 positions = the plain
float32 reference (``tmbench/reference/deepseek_v2.py``), in float32 and
in bf16 (the bf16 layer's core is the MLA attention kernel). That kernel
(``kernels/mla_attention.py``, forward and backward) against float32
``_sdpa`` at S = 1, 77, 1,000 and the training cell's 4,096, on any
positions and a strided v, its error within 1.25x of bf16 ``_sdpa``'s;
what it refuses; its launches in every layer of a train step.
Imports no JAX, so it runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitpack, indexing, tm
from repro_torch.core.session import TMSession
from repro_torch.core.types import TMConfig, TMState
from repro_torch.kernels import clause_eval, indexed, ops, ref, ta_update

# (m, n, o, b): the unaligned sweep of tests/test_kernels.py, a batch past
# one 32-sample word, and the tm_mnist width at the top serving bucket
SHAPES = [(2, 4, 5, 3), (3, 8, 17, 9), (10, 130, 50, 8), (2, 256, 196, 4),
          (1, 2, 2049, 2), (2, 64, 40, 70), (10, 2000, 784, 32)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def index_of(include, capacity=None):
    """The falsification index of an include mask: ``build_index`` of a
    state that includes exactly there (it reads nothing of the config but
    ``n_states``), at ``capacity`` (default n: no list overflows)."""
    m, n, L = include.shape
    cfg = TMConfig(n_classes=m, n_clauses=2, n_features=L // 2)
    ta = torch.where(include, cfg.n_states + 1, cfg.n_states).to(torch.int16)
    return indexing.build_index(cfg, TMState(ta_state=ta), capacity or n)


def make_case(m, n, o, b, seed, dev):
    """include (m, n, 2o) bool, x (B, o) uint8, its ``ClauseIndex`` and
    pol (n,) int32 ±1, on ``dev``."""
    rng = np.random.default_rng(seed)
    include = rng.uniform(size=(m, n, 2 * o)) < 0.02
    x = rng.integers(0, 2, (b, o)).astype(np.uint8)
    pol = np.where(np.arange(n) < n // 2, 1, -1).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(include), t(x), index_of(t(include)), t(pol)


def assert_votes_equal(index, lit, pol, **plan):
    """The kernel against the plain walk and the position form, bit for bit;
    one launch per call."""
    before = indexed.indexed_votes.launches
    got = indexed.indexed_votes(*index, lit, pol, **plan)
    assert indexed.indexed_votes.launches == before + 1
    torch.testing.assert_close(
        got, indexed.indexed_votes_walk_ref(*index, lit, pol), rtol=0, atol=0)
    torch.testing.assert_close(got, indexed.indexed_votes_ref(index.pos, lit, pol),
                               rtol=0, atol=0)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_equal_plain_versions(cuda_device, shape):
    include, x, index, pol = make_case(*shape, seed=sum(shape), dev=cuda_device)
    lit = torch.cat([x, 1 - x], dim=-1)
    assert_votes_equal(index, lit, pol)
    words = bitpack.pack_bits(include)
    lw = bitpack.packed_literals(x)
    got = clause_eval.clause_votes_packed(words, lw, pol)
    torch.testing.assert_close(got, clause_eval.clause_votes_ref(words, lw, pol),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    _, x, (lists, counts, pos), pol = make_case(2, 8, 5, 3, seed=0,
                                                dev=cuda_device)
    lit = torch.cat([x, 1 - x], dim=-1)
    with pytest.raises(ValueError, match="uint8"):
        indexed.indexed_votes(lists, counts, pos, lit.to(torch.int32), pol)
    with pytest.raises(ValueError, match="contiguous"):
        indexed.indexed_votes(lists, counts,
                              pos.transpose(0, 1).contiguous().transpose(0, 1),
                              lit, pol)
    with pytest.raises(ValueError, match="devices"):
        indexed.indexed_votes(lists, counts, pos, lit.cpu(), pol)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [1, 3, 40])
def test_indexed_votes_on_overflowing_and_replayed_indexes(cuda_device, capacity):
    """Lists past their capacity (ids only in ``pos``); then two batched
    replays: most includes deleted (lists that overflowed shrink back under
    the capacity with holes in their prefixes), then random crossings
    (unsorted lists). After each, the kernel equals the plain walk, the
    position form and the position form of a rebuild."""
    dev, m, n, o = cuda_device, 3, 200, 60
    gen = torch.Generator(device=dev).manual_seed(capacity)
    include = torch.rand((m, n, 2 * o), generator=gen, device=dev) < 0.05
    x = torch.randint(0, 2, (70, o), generator=gen, device=dev, dtype=torch.uint8)
    lit = torch.cat([x, 1 - x], dim=-1)
    pol = torch.where(torch.arange(n, device=dev) < n // 2, 1, -1).to(torch.int32)
    index = index_of(include, capacity)
    assert bool((index.counts > capacity).any()) == (capacity < 40)
    assert_votes_equal(index, lit, pol)
    holes = 0
    for flips in (include & (torch.rand(include.shape, generator=gen,
                                        device=dev) < 0.8),
                  torch.rand(include.shape, generator=gen, device=dev) < 0.05):
        buf = indexing.events_from_transition(include, include ^ flips, 1 << 16)
        assert int(buf.overflow) == 0
        index = indexing.index_update(index, buf.events)
        include = include ^ flips
        got = assert_votes_equal(index, lit, pol)
        torch.testing.assert_close(
            got, indexed.indexed_votes_ref(index_of(include).pos, lit, pol),
            rtol=0, atol=0)
        holes += int((~indexed.walkable(index.lists, index.counts, n)
                      & (index.counts <= capacity)).sum())
    assert (holes > 0) == (capacity < 40), holes


@pytest.mark.cuda
@pytest.mark.parametrize("n,window,cluster", [
    (20_000, None, 8), (2000, 300, 8), (2000, 64, 16), (130, 7, 1),
    (2000, None, 4)])
def test_indexed_votes_over_clause_windows_and_cluster_sizes(
        cuda_device, n, window, cluster):
    """More than one clause window (n past ``MAX_WINDOW``, or a forced
    window), and clusters of 1 to 16 blocks, against the plain walk."""
    dev, m, o = cuda_device, 2, 300
    gen = torch.Generator(device=dev).manual_seed(n + cluster)
    include = torch.rand((m, n, 2 * o), generator=gen, device=dev) < 4 / (2 * o)
    x = torch.randint(0, 2, (33, o), generator=gen, device=dev, dtype=torch.uint8)
    lit = torch.cat([x, 1 - x], dim=-1)
    pol = torch.where(torch.arange(n, device=dev) < n // 2, 1, -1).to(torch.int32)
    plan = indexed.walk_plan(33, m, n, window=window, cluster=cluster)
    assert plan.n_windows > 1 or cluster != 8
    got = assert_votes_equal(index_of(include), lit, pol, window=window,
                             cluster=cluster)
    assert got.unique().numel() > 1


@pytest.mark.cuda
def test_indexed_votes_replays_in_a_cuda_graph(cuda_device):
    """No host sync in the wrapper: captured once, replayed on new inputs."""
    include, x, index, pol = make_case(10, 2000, 784, 32, seed=3, dev=cuda_device)
    lit = torch.cat([x, 1 - x], dim=-1)
    indexed.indexed_votes(*index, lit, pol)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = indexed.indexed_votes(*index, lit, pol)
    lit.copy_(1 - lit)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, indexed.indexed_votes_walk_ref(*index, lit, pol),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["indexed", "bitpack", "dense", "compact"])
def test_session_scores_on_card_equal_cpu(cuda_device, engine):
    cfg = TMConfig(n_classes=4, n_clauses=66, n_features=100)
    rng = np.random.default_rng(1)
    inc = rng.uniform(size=(4, 66, 200)) < 0.03
    ta = torch.from_numpy(
        np.where(inc, cfg.n_states + 1, cfg.n_states).astype(np.int16))
    xs = rng.integers(0, 2, (45, 100)).astype(np.uint8)
    scores = []
    for dev in (cuda_device, "cpu"):
        session = TMSession(cfg, engines=("indexed", "bitpack", "compact"),
                            device=dev)
        bundle = session.prepare(TMState(ta_state=ta))
        scores.append(session.scores(bundle, xs, engine=engine).cpu())
    torch.testing.assert_close(scores[0], scores[1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(1, 2000, 784, 1)])
def test_clause_outputs_kernel_equals_plain_version(cuda_device, shape):
    include, x, _, _ = make_case(*shape, seed=sum(shape) + 2, dev=cuda_device)
    include[:, :1] = False                                # an empty clause
    words = bitpack.pack_bits(include)
    lw = bitpack.packed_literals(x)
    before = clause_eval.clause_outputs_packed.launches
    got = clause_eval.clause_outputs_packed(words, lw)
    assert clause_eval.clause_outputs_packed.launches == before + 1
    torch.testing.assert_close(got, clause_eval.clause_outputs_ref(words, lw),
                               rtol=0, atol=0)
    assert bool((got[:, :, 0] == 1).all())


# (B, m, n, o) for the clause_eval tiling: B off a multiple of the 8 samples
# a thread holds (9, 33, 70) and past one 32-sample tile; n off a multiple of
# the 64-row clause tile (130, 2001); rows of 1, 49 and 65 words (4·W bytes
# off a 16-byte line for W = 49, 65); m·n under one tile; the MNIST bucket
TILING = [(9, 2, 130, 784), (33, 3, 2001, 16), (70, 2, 130, 1040),
          (1, 1, 5, 784), (2, 3, 2001, 1040), (1, 1, 2000, 784),
          (32, 10, 2000, 784)]
# launch plans besides the default: the tiled route at B <= 2 too (where
# the default is the direct route) and with one warp per sample group, rows
# staged in several chunks, a few blocks each walking many tiles, and the
# direct route's narrowest and widest lane groups
PLANS = {"default": {}, "tiled": dict(route="tiled"),
         "tiled_threads128": dict(route="tiled", threads=128),
         "chunks": dict(route="tiled", wc=8),
         "persistent": dict(route="tiled", blocks=3),
         "direct_ks1": dict(route="direct", ks=1),
         "direct_ks32": dict(route="direct", ks=32, threads=64)}
TILING_PLANS = [(shape, plan) for shape in TILING for plan in PLANS
                if shape[0] <= 2 or not plan.startswith("direct")]


def tiling_case(b, m, n, o, seed, dev):
    """Packed include words with mostly short clauses (so outputs vary),
    clause 0 empty, clause 1 every include bit set, clause 2 the literal at
    bit 31 of word 0 alone (true for about half the samples); packed
    literals; pol in {-1, 0, +1} (0 marks padding rows)."""
    rng = np.random.default_rng(seed)
    L = 2 * o
    lengths = rng.integers(1, 4, (m, n))
    include = np.zeros((m, n, L), bool)
    for k in range(3):
        cell = rng.integers(0, L, (m, n))
        np.put_along_axis(include, cell[..., None], (lengths > k)[..., None], -1)
    include[:, 0] = False
    if n > 1:
        include[:, 1] = True
    if n > 2:
        include[:, 2] = False
        include[:, 2, 31] = True
    x = rng.integers(0, 2, (b, o)).astype(np.uint8)
    x[:, 31 if o > 31 else 31 - o] = np.arange(b) % 2    # literal 31 alternates
    pol = rng.integers(-1, 2, n).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (bitpack.pack_bits(t(include)), bitpack.packed_literals(t(x)),
            t(pol))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,plan", TILING_PLANS)
def test_clause_kernels_across_the_tiling(cuda_device, shape, plan):
    b, m, n, o = shape
    words, lw, pol = tiling_case(b, m, n, o, seed=sum(shape), dev=cuda_device)
    p = clause_eval.launch_plan(b, m, n, words.shape[-1], **PLANS[plan])
    got = clause_eval.clause_outputs_packed(words, lw, plan=p)
    want = clause_eval.clause_outputs_ref(words, lw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool((got[:, :, 0] == 1).all())
    if n > 1:
        assert not bool(got[:, :, 1].any())
    if n > 2 and b > 1:                       # decided by bit 31 alone
        assert 0 < int(got[:, :, 2].sum()) < b * m
    torch.testing.assert_close(
        clause_eval.clause_votes_packed(words, lw, pol, plan=p),
        clause_eval.clause_votes_ref(words, lw, pol), rtol=0, atol=0)


@pytest.mark.cuda
def test_clause_votes_padding_rows_vote_nothing(cuda_device):
    words, lw, pol = tiling_case(32, 10, 2000, 784, seed=7, dev=cuda_device)
    padded = torch.where(torch.arange(2000, device=cuda_device) >= 1500, 0, pol)
    got = clause_eval.clause_votes_packed(words, lw, padded)
    torch.testing.assert_close(got, clause_eval.clause_votes_packed(
        words[:, :1500].contiguous(), lw, pol[:1500].contiguous()), rtol=0, atol=0)
    torch.testing.assert_close(got, clause_eval.clause_votes_ref(words, lw, padded),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_clause_kernels_take_a_view_off_a_16_byte_line(cuda_device):
    words, lw, pol = tiling_case(9, 2, 130, 784, seed=8, dev=cuda_device)
    flat = torch.empty(words.numel() + 1, dtype=torch.int32, device=cuda_device)
    odd = flat[1:].view(words.shape)
    odd.copy_(words)
    torch.testing.assert_close(clause_eval.clause_outputs_packed(odd, lw),
                               clause_eval.clause_outputs_ref(words, lw),
                               rtol=0, atol=0)
    torch.testing.assert_close(clause_eval.clause_votes_packed(odd, lw, pol),
                               clause_eval.clause_votes_ref(words, lw, pol),
                               rtol=0, atol=0)


def edge_uniforms(n, L, s, boost, gen, dev):
    """Uniforms with a quarter of the cells exactly at a float32 threshold
    or one ulp either side of it."""
    u = torch.rand((n, L), generator=gen, device=dev)
    edges = []
    for thr in ta_update.thresholds(s, boost):
        t = np.float32(thr)
        edges += [t, np.nextafter(t, np.float32(0)), np.nextafter(t, np.float32(1))]
    edges = torch.tensor([e for e in edges if e < 1], device=dev)
    pick = torch.rand((n, L), generator=gen, device=dev) < 0.25
    which = torch.randint(0, len(edges), (n, L), generator=gen, device=dev)
    return torch.where(pick, edges[which], u)


@pytest.mark.cuda
@pytest.mark.parametrize("boost", [False, True])
@pytest.mark.parametrize("n,o,s", [(3, 5, 3.0), (8, 17, 3.9), (130, 50, 3.9),
                                   (66, 40, 3.0), (2000, 784, 3.9),
                                   (2000, 784, 10.0)])
def test_ta_update_kernel_equals_plain_version(cuda_device, n, o, s, boost):
    dev, L, n_states = cuda_device, 2 * o, 127
    gen = torch.Generator(device=dev).manual_seed(n + o)
    ta = torch.randint(1, 2 * n_states + 1, (n, L), generator=gen, device=dev,
                       dtype=torch.int16)
    lit = torch.randint(0, 2, (L,), generator=gen, device=dev, dtype=torch.uint8)
    cout = torch.randint(0, 2, (n,), generator=gen, device=dev, dtype=torch.int8)
    t1 = torch.rand(n, generator=gen, device=dev) < 0.5
    act = torch.rand(n, generator=gen, device=dev) < 0.7
    u = edge_uniforms(n, L, s, boost, gen, dev)
    kw = dict(n_states=n_states, s=s, boost_true_positive=boost)
    want = ta_update.ta_update_ref(ta, lit, cout, t1, act, u, **kw)
    before = ta_update.ta_update.launches
    got = ta_update.ta_update(ta, lit, cout, t1, act, u, **kw)
    assert ta_update.ta_update.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # in place, and through the scalar path (a buffer off 16-byte alignment)
    row = ta.clone()
    assert ta_update.ta_update(row, lit, cout, t1, act, u, **kw, out=row) is row
    torch.testing.assert_close(row, want, rtol=0, atol=0)
    flat = torch.empty(n * L + 1, dtype=torch.int16, device=dev)
    odd = flat[1:].view(n, L)
    odd.copy_(ta)
    ta_update.ta_update(odd, lit, cout, t1, act, u, **kw, out=odd)
    torch.testing.assert_close(odd, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_learning_kernels_refuse_what_they_do_not_take(cuda_device):
    dev, n, L = cuda_device, 8, 10
    words = torch.zeros((1, n, 1), dtype=torch.int32, device=dev)
    lw = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        clause_eval.clause_outputs_packed(words.to(torch.int64), lw)
    with pytest.raises(ValueError, match="devices"):
        clause_eval.clause_outputs_packed(words, lw.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        clause_eval.clause_outputs_packed(
            torch.zeros((1, 2, n), dtype=torch.int32, device=dev).transpose(1, 2),
            torch.zeros((1, 2), dtype=torch.int32, device=dev))
    args = [torch.ones((n, L), dtype=torch.int16, device=dev),
            torch.zeros(L, dtype=torch.uint8, device=dev),
            torch.zeros(n, dtype=torch.int8, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev),
            torch.zeros((n, L), device=dev)]
    kw = dict(n_states=3, s=3.9)
    for i, bad in ((0, args[0].to(torch.int32)), (3, args[3].to(torch.int8)),
                   (5, args[5].to(torch.float64))):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError, match="must be"):
            ta_update.ta_update(*wrong, **kw)
    with pytest.raises(ValueError, match="devices"):
        ta_update.ta_update(*args[:5], args[5].cpu(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ta_update.ta_update(*args[:5], torch.zeros((L, n), device=dev).T, **kw)


# --- round_vote: the learning round's vote half, from the TA states --------

# (n, L): the MNIST and IMDb widths, 2o off a multiple of 8 (the scalar
# route: 34, 1570), n off a multiple of the clauses a block takes (13, 130,
# 2001, 67), rows of one unit and of none
VOTE_SHAPES = [(2000, 1568), (2000, 10000), (13, 34), (130, 1570),
               (2001, 1568), (67, 2), (9, 0), (33, 96), (5, 8)]


def vote_row(n, L, seed, dev, all_true=False, n_states=127):
    """A class row of int16 states on ``dev`` (about 2% included; a third
    of the clauses, or all with ``all_true``, include only true literals;
    clause 0 empty, clause 1 all-included; states at N and N + 1), the
    sample's (W,) literal words and pol ±1 with the last 3 rows 0."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, L // 2).astype(np.uint8)
    lit = np.concatenate([x, 1 - x]).astype(bool)
    include = rng.uniform(size=(n, L)) < 0.02
    true_rows = np.ones(n, bool) if all_true else rng.uniform(size=n) < 1 / 3
    include[true_rows] &= lit[None]
    include[0] = False
    if n > 1:
        include[1] = True
    ta = np.where(include, rng.integers(n_states + 1, 2 * n_states + 1, (n, L)),
                  rng.integers(1, n_states + 1, (n, L)))
    ta[include & (rng.uniform(size=(n, L)) < 0.3)] = n_states + 1
    ta[~include & (rng.uniform(size=(n, L)) < 0.3)] = n_states
    pol = np.where(np.arange(n) < n // 2, 1, -1).astype(np.int32)
    pol[max(0, n - 3):] = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    words = bitpack.pack_bits(torch.from_numpy(lit.astype(np.uint8)))
    return t(ta.astype(np.int16)), words.to(dev), t(pol)


@pytest.mark.cuda
@pytest.mark.parametrize("all_true", [False, True], ids=["mixed", "all_true"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("n,L", VOTE_SHAPES)
def test_round_vote_kernel_equals_plain_version(cuda_device, n, L, offset,
                                                all_true):
    """Outputs and vote bit for bit against the plain body, one launch a
    call; ``unaligned`` views the row 2 bytes into a buffer, so the kernel
    takes the scalar route at every width."""
    ta, words, pol = vote_row(n, L, n + L + offset, cuda_device, all_true)
    if offset:
        flat = torch.empty(n * L + offset, dtype=torch.int16, device=cuda_device)
        row = flat[offset:].view(n, L)
        row.copy_(ta)
        ta = row
    before = clause_eval.round_vote.launches
    out, vote = clause_eval.round_vote(ta, words, pol, n_states=127)
    assert clause_eval.round_vote.launches == before + 1
    want_out, want_vote = clause_eval.round_vote_ref(ta, words, pol, n_states=127)
    assert out.dtype == torch.int8 and vote.dtype == torch.int32
    assert tuple(out.shape) == (n,) and vote.dim() == 0
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(vote, want_vote, rtol=0, atol=0)
    if L > 2:
        assert int(out[0]) == 1 and int(out[1]) == 0
        assert 0 < int(out.sum()) < n
        if all_true:
            assert int(out[2:].sum()) == n - 2


@pytest.mark.cuda
def test_round_vote_refuses_what_it_does_not_take(cuda_device):
    dev, n, L = cuda_device, 8, 40
    ta = torch.ones((n, L), dtype=torch.int16, device=dev)
    words = torch.zeros(2, dtype=torch.int32, device=dev)
    pol = torch.ones(n, dtype=torch.int32, device=dev)
    kw = dict(n_states=3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        clause_eval.round_vote(ta.cpu(), words.cpu(), pol.cpu(), **kw)
    for bad, match in (((ta.to(torch.int32), words, pol), "int16"),
                       ((ta[0], words, pol), "int16"),
                       ((ta, words.to(torch.int64), pol), "literal words"),
                       ((ta, words[:1], pol), "literal words"),
                       ((ta, words[None], pol), "literal words"),
                       ((ta, words, pol.to(torch.int64)), "pol"),
                       ((ta, words, pol[:-1]), "pol"),
                       ((ta, words.cpu(), pol), "devices"),
                       ((ta, words, pol.cpu()), "devices"),
                       ((ta.T.contiguous().T, words, pol), "contiguous"),
                       ((ta, torch.zeros(4, dtype=torch.int32, device=dev)[::2],
                         pol), "contiguous")):
        before = clause_eval.round_vote.launches
        with pytest.raises(ValueError, match=match):
            clause_eval.round_vote(*bad, **kw)
        assert clause_eval.round_vote.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
@pytest.mark.parametrize("shards", [1, 3])
def test_learning_rounds_on_card_launch_round_vote(cuda_device, parallel, shards):
    """A small learning step on the card equals the CPU's state bit for
    bit; every valid round launches ``round_vote`` once per rank (padding
    rows at polarity 0 on the ragged 3-shard split) and no round packs
    include words for ``clause_outputs_packed``."""
    from repro_torch.core.session import Topology
    from repro_torch.launch.mesh import make_mesh

    cfg = TMConfig(n_classes=4, n_clauses=64, n_features=100, n_states=20,
                   s=3.9, threshold=8)
    rng = np.random.default_rng(11)
    ta = torch.from_numpy(rng.integers(1, 2 * cfg.n_states + 1,
                                       (4, 64, 200)).astype(np.int16))
    xs = rng.integers(0, 2, (6, 100)).astype(np.uint8)
    ys = rng.integers(0, 4, 6)
    mask = np.array([1, 1, 0, 1, 1, 1], bool)
    draws = tm.draw_sample_draws(
        cfg, torch.Generator(device=cuda_device).manual_seed(12), 6)
    update = tm.update_batch_parallel if parallel else tm.update_batch_sequential
    want = update(cfg, TMState(ta_state=ta), xs, ys, tm.SampleDraws(
        draws.neg_raw.cpu(), *(tm.FeedbackRands(*(f.cpu() for f in d))
                               for d in draws[1:])), mask=mask).ta_state
    assert not torch.equal(want, ta)
    counters = (clause_eval.round_vote, clause_eval.clause_outputs_packed,
                ta_update.ta_update)
    before = [k.launches for k in counters]
    if shards == 1:
        got = update(cfg, TMState(ta_state=ta.to(cuda_device)), xs, ys, draws,
                     mask=mask).ta_state
    else:
        session = TMSession(cfg, Topology(clause_shards=shards),
                            mesh=make_mesh(1, shards,
                                           devices=["cuda:0"] * shards),
                            engines=("indexed",), parallel=parallel,
                            max_events=16384)
        bundle = session.train_step(session.prepare(TMState(ta_state=ta)),
                                    xs, ys, draws, mask)
        got = session.unpad_state(bundle.state).ta_state
    assert torch.equal(got.cpu(), want)
    rounds = 2 * int(mask.sum()) * shards
    assert [k.launches - b for k, b in zip(counters, before)] == [rounds, 0, rounds]


@pytest.mark.cuda
@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_train_step_on_card_equals_cpu(cuda_device, parallel):
    cfg = TMConfig(n_classes=4, n_clauses=66, n_features=100, n_states=20,
                   s=3.9, threshold=8)
    rng = np.random.default_rng(3)
    ta = torch.from_numpy(rng.integers(1, 2 * cfg.n_states + 1,
                                       (4, 66, 200)).astype(np.int16))
    xs = rng.integers(0, 2, (5, 100)).astype(np.uint8)
    ys = rng.integers(0, 4, 5)
    mask = np.array([1, 1, 0, 1, 1], bool)
    draws = tm.draw_sample_draws(
        cfg, torch.Generator(device=cuda_device).manual_seed(4), 5)
    bundles = []
    for dev in (cuda_device, "cpu"):
        session = TMSession(cfg, engines=("indexed", "bitpack", "dense"),
                            device=dev, parallel=parallel, max_events=8192)
        bundle = session.prepare(TMState(ta_state=ta))
        on_dev = tm.SampleDraws(*(
            t.to(dev) if isinstance(t, torch.Tensor) else
            tm.FeedbackRands(*(f.to(dev) for f in t)) for t in draws))
        before = ta_update.ta_update.launches
        bundles.append(session.train_step(bundle, xs, ys, on_dev, mask))
        if dev != "cpu":
            assert ta_update.ta_update.launches == before + 2 * 4
    card, cpu = bundles
    assert torch.equal(card.state.ta_state.cpu(), cpu.state.ta_state)
    assert not torch.equal(cpu.state.ta_state, ta)
    assert torch.equal(card.caches["bitpack"].cpu(), cpu.caches["bitpack"])
    for a, b in zip(card.index, cpu.index):
        assert torch.equal(a.cpu(), b)
    assert int(card.event_overflow) == int(cpu.event_overflow) == 0


# ---------------------------------------------------------------------------
# sharded topologies: the kernels at shard widths, k shards on one card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [334, 500, 667])
def test_kernels_at_shard_widths_with_padding_rows(cuda_device, n):
    """The shard widths of the MNIST width's sharded topologies (n_sub 334,
    n_local 500 and 667), with the trailing rows padding: polarity 0 in the
    vote kernels, frozen (active False) in ta_update."""
    dev, m, o = cuda_device, 10, 784
    _, x, _, pol = make_case(m, n, o, 340, seed=n, dev=dev)
    # about three literals per clause, so that clauses fire and votes vary
    gen = torch.Generator(device=dev).manual_seed(n)
    include = torch.rand((m, n, 2 * o), generator=gen, device=dev) < 3 / (2 * o)
    pad = torch.arange(n, device=dev) >= n - 3
    include[:, pad] = False
    index = index_of(include)
    pol = torch.where(pad, 0, pol)
    lit = torch.cat([x, 1 - x], dim=-1)
    words, lw = bitpack.pack_bits(include), bitpack.packed_literals(x)
    for b in (1, 2, 340):
        assert_votes_equal(index, lit[:b].contiguous(), pol)
        torch.testing.assert_close(
            clause_eval.clause_votes_packed(words, lw[:b].contiguous(), pol),
            clause_eval.clause_votes_ref(words, lw[:b], pol), rtol=0, atol=0)
    assert clause_eval.clause_votes_ref(words, lw, pol).unique().numel() > 1
    for b, mm in ((1, 1), (32, m)):
        w = words[:mm].contiguous()
        torch.testing.assert_close(
            clause_eval.clause_outputs_packed(w, lw[:b].contiguous()),
            clause_eval.clause_outputs_ref(w, lw[:b]), rtol=0, atol=0)
    L, kw = 2 * o, dict(n_states=127, s=3.9, boost_true_positive=False)
    ta = torch.randint(1, 255, (n, L), generator=gen, device=dev,
                       dtype=torch.int16)
    cout = torch.randint(0, 2, (n,), generator=gen, device=dev, dtype=torch.int8)
    act = (torch.rand(n, generator=gen, device=dev) < 0.7) & ~pad
    u = edge_uniforms(n, L, 3.9, False, gen, dev)
    got = ta_update.ta_update(ta, lit[0], cout, pol > 0, act, u, **kw)
    torch.testing.assert_close(
        got, ta_update.ta_update_ref(ta, lit[0], cout, pol > 0, act, u, **kw),
        rtol=0, atol=0)
    torch.testing.assert_close(got[pad], ta[pad], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("c,d,parallel", [(3, 1, False), (2, 3, False),
                                          (2, 2, True)],
                         ids=["ragged", "composed_ragged", "batch_parallel"])
def test_sharded_step_on_one_card_equals_topology_one(cuda_device, c, d,
                                                      parallel):
    from repro_torch.core.session import Topology
    from repro_torch.launch.mesh import make_mesh

    cfg = TMConfig(n_classes=4, n_clauses=66, n_features=100, n_states=20,
                   s=3.9, threshold=8)
    rng = np.random.default_rng(5)
    ta = torch.from_numpy(rng.integers(1, 2 * cfg.n_states + 1,
                                       (4, 66, 200)).astype(np.int16))
    xs = rng.integers(0, 2, (12, 100)).astype(np.uint8)
    ys = rng.integers(0, 4, 12)
    engines = ("indexed", "bitpack", "dense")
    one = TMSession(cfg, engines=engines, device=cuda_device,
                    parallel=parallel, max_events=16384)
    sharded = TMSession(cfg, Topology(clause_shards=c, data_shards=d),
                        mesh=make_mesh(d, c, devices=["cuda:0"] * (c * d)),
                        engines=engines, parallel=parallel, max_events=16384)
    results = []
    for s in (one, sharded):
        bundle = s.prepare(TMState(ta_state=ta))
        g = torch.Generator(device=cuda_device).manual_seed(9)
        before = ta_update.ta_update.launches
        bundle = s.train_step(bundle, xs, ys, g)
        assert ta_update.ta_update.launches > before
        results.append((s.unpad_state(bundle.state).ta_state.cpu(),
                        [s.scores(bundle, xs, engine=e).cpu() for e in engines],
                        int(bundle.event_overflow)))
    (want, want_scores, _), (got, got_scores, overflow) = results
    assert torch.equal(got, want) and not torch.equal(got, ta)
    for a, b in zip(got_scores, want_scores):
        assert torch.equal(a, b)
    assert overflow == 0


# ---------------------------------------------------------------------------
# the compact engine on the card; the four kernels at the IMDb width
# ---------------------------------------------------------------------------


def _row_sets(comp):
    ids = torch.where(comp.lit_idx < 0, 1 << 30, comp.lit_idx)
    return comp.lengths.cpu(), torch.sort(ids, dim=-1).values.cpu()


@pytest.mark.cuda
def test_compact_engine_on_card_equals_dense_and_the_cpu(cuda_device):
    """Scores equal the dense engine's; a step's compact replay on the card
    ends where it ends on the CPU, lengths and rows as sets, and equals a
    rebuild of the stepped state."""
    from repro_torch.core import indexing

    cfg = TMConfig(n_classes=4, n_clauses=66, n_features=100, n_states=20,
                   s=3.9, threshold=8)
    rng = np.random.default_rng(11)
    ta = torch.from_numpy(rng.integers(1, 2 * cfg.n_states + 1,
                                       (4, 66, 200)).astype(np.int16))
    xs = rng.integers(0, 2, (5, 100)).astype(np.uint8)
    ys = rng.integers(0, 4, 5)
    draws = tm.draw_sample_draws(
        cfg, torch.Generator(device=cuda_device).manual_seed(12), 5)
    out = []
    for dev in (cuda_device, "cpu"):
        session = TMSession(cfg, engines=("compact", "dense"), device=dev,
                            max_events=16384)
        bundle = session.prepare(TMState(ta_state=ta))
        assert torch.equal(session.scores(bundle, xs, engine="compact"),
                           session.scores(bundle, xs, engine="dense"))
        on_dev = tm.SampleDraws(*(
            t.to(dev) if isinstance(t, torch.Tensor) else
            tm.FeedbackRands(*(f.to(dev) for f in t)) for t in draws))
        bundle = session.train_step(bundle, xs, ys, on_dev)
        comp = bundle.caches["compact"]
        rebuilt = indexing.compact(cfg, bundle.state, cfg.n_literals)
        for a, b in zip(_row_sets(comp), _row_sets(rebuilt)):
            assert torch.equal(a, b)
        assert all(bool(v) for v in indexing.validate_compact(
            cfg, bundle.state, comp).values())
        out.append(_row_sets(comp))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_four_kernels_at_the_imdb_width(cuda_device):
    """tm_imdb: m=2, n=2000, o=5000 (2o=10000 literals, W=313 words), the
    votes at B=32 on the tiled route in more than one staged chunk."""
    dev, m, n, o, b = cuda_device, 2, 2000, 5000, 32
    L = 2 * o
    gen = torch.Generator(device=dev).manual_seed(13)
    include = torch.rand((m, n, L), generator=gen, device=dev) < 116 / L
    x = (torch.rand((b, o), generator=gen, device=dev) < 0.01).to(torch.uint8)
    include[:, :, :o] = False     # clauses of absent words: about half fire
    index = index_of(include)
    pol = torch.where(torch.arange(n, device=dev) < n // 2, 1, -1).to(torch.int32)
    lit = torch.cat([x, 1 - x], dim=-1)
    words, lw = bitpack.pack_bits(include), bitpack.packed_literals(x)
    plan = clause_eval.launch_plan(b, m, n, words.shape[-1])
    assert words.shape[-1] == 313 and plan.route == "tiled" and plan.n_chunks > 1
    want = assert_votes_equal(index, lit, pol)
    torch.testing.assert_close(clause_eval.clause_votes_packed(words, lw, pol),
                               want, rtol=0, atol=0)
    assert want.unique().numel() > 1
    for bb, mm in ((1, 1), (b, m)):
        w = words[:mm].contiguous()
        torch.testing.assert_close(
            clause_eval.clause_outputs_packed(w, lw[:bb].contiguous()),
            clause_eval.clause_outputs_ref(w, lw[:bb]), rtol=0, atol=0)
    kw = dict(n_states=127, s=27.0, boost_true_positive=False)
    ta = torch.randint(1, 255, (n, L), generator=gen, device=dev,
                       dtype=torch.int16)
    cout = clause_eval.clause_outputs_packed(words[:1], lw[:1])[0, 0]
    act = torch.rand(n, generator=gen, device=dev) < 0.5
    u = edge_uniforms(n, L, 27.0, False, gen, dev)
    for t1 in (pol > 0, pol <= 0):
        torch.testing.assert_close(
            ta_update.ta_update(ta, lit[0], cout, t1, act, u, **kw),
            ta_update.ta_update_ref(ta, lit[0], cout, t1, act, u, **kw),
            rtol=0, atol=0)


# (m, n, o, b): mid sizes, a partial last literal word (2o = 650, W = 21)
# and full ones (2o = 640, W = 20), batches past one 32-sample word
OPS_SHAPES = [(5, 200, 325, 40), (4, 128, 320, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", OPS_SHAPES)
def test_wrappers_equal_the_unpacked_oracles(cuda_device, shape):
    """``kernels/ops`` on CUDA tensors (packing, then each kernel) against
    ``kernels/ref`` on the unpacked include mask, bit for bit; each wrapper
    launches its kernel."""
    dev, (m, n, o, b) = cuda_device, shape
    cfg = TMConfig(n_classes=m, n_clauses=n, n_features=o, n_states=127,
                   s=3.9)
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    include = torch.rand((m, n, 2 * o), generator=gen, device=dev) < 0.01
    ta = torch.where(include, 128, 127).to(torch.int16)
    state = TMState(ta_state=ta)
    x = torch.randint(0, 2, (b, o), generator=gen, device=dev,
                      dtype=torch.uint8)
    lit = torch.cat([x, 1 - x], dim=-1)
    votes = ref.clause_votes_ref(include, lit)
    assert votes.unique().numel() > 1
    assert torch.equal(ops.pack_include(cfg, state).cpu(),
                       ops.pack_include(cfg, TMState(ta_state=ta.cpu())))
    for call, want, kernel in (
            (lambda: ops.tm_votes(cfg, state, x), votes,
             clause_eval.clause_votes_packed),
            (lambda: ops.tm_votes_packed(ops.pack_include(cfg, state), x),
             votes, clause_eval.clause_votes_packed),
            (lambda: ops.tm_predict(cfg, state, x), votes.argmax(-1),
             clause_eval.clause_votes_packed),
            (lambda: ops.tm_clause_outputs(cfg, state, x),
             ref.clause_outputs_ref(include, lit),
             clause_eval.clause_outputs_packed)):
        before = kernel.launches
        torch.testing.assert_close(call(), want, rtol=0, atol=0)
        assert kernel.launches == before + 1
    row = torch.randint(1, 255, (n, 2 * o), generator=gen, device=dev,
                        dtype=torch.int16)
    cout = ref.clause_outputs_ref(row[None] > 127, lit[:1])[0, 0]
    act = torch.rand(n, generator=gen, device=dev) < 0.6
    pol = torch.arange(n, device=dev) < n // 2
    kw = dict(n_states=127, s=3.9, boost_true_positive=False)
    for u in (torch.rand((n, 2 * o), generator=gen, device=dev),
              edge_uniforms(n, 2 * o, 3.9, False, gen, dev)):
        for t1 in (pol, ~pol):
            before = ta_update.ta_update.launches
            got = ops.tm_ta_update(cfg, row, lit[0], cout, t1, act, u)
            assert ta_update.ta_update.launches == before + 1
            torch.testing.assert_close(
                got, ref.ta_update_ref(row, lit[0], cout, t1, act, u, **kw),
                rtol=0, atol=0)


# --- the LM serving path (no kernel of its own: float32 card == CPU) --------

LM_ARCHS = ("qwen3-1.7b", "granite-8b", "minitron-4b", "qwen2-72b",
            "llava-next-mistral-7b", "mixtral-8x7b", "qwen2-moe-a2.7b",
            "rwkv6-3b", "recurrentgemma-9b", "whisper-medium")


def lm_rel(got, want):
    """max |got - want| over max |want|, on the CPU in float64."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_card_matches_cpu(cuda_device, arch, monkeypatch):
    """Float32 (TF32 off) prefill and two decode steps of the same weights
    on the card and on the CPU agree to 1e-4 of max|logit| (summation
    order); the card's bf16 prefill is within 5e-2 of its float32 one.
    Whisper takes frames and decodes from its prefill's cross K/V."""
    import copy

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import transformer, whisper
    from repro_torch.models.model import build

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for mod in (transformer, whisper):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    cfg = reduce_config(get_config(arch))
    m = build(cfg)
    host = m.init(torch.Generator().manual_seed(0))
    card = copy.deepcopy(host).to(cuda_device)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)))
    extra, n_vis = {}, 0
    if cfg.family == "vlm":
        n_vis = cfg.n_vision_tokens
        extra["vision_embeds"] = torch.from_numpy(
            rng.normal(size=(2, n_vis, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        extra["frames"] = torch.from_numpy(
            rng.normal(size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    outs, fed = [], None
    for params, dev in ((host, torch.device("cpu")), (card, cuda_device)):
        kw = {k: v.to(dev) for k, v in extra.items()}
        logits, cache = m.prefill(params, 16, tokens=tokens.to(dev), **kw)
        steps = [logits]
        fed = fed or [logits.argmax(-1)[:, None]]     # the CPU's greedy tokens
        for i in range(2):
            pos = torch.full((2,), n_vis + 8 + i, dtype=torch.int32, device=dev)
            logits, cache = m.decode_step(params, fed[i].to(dev), cache, pos)
            steps.append(logits)
            if len(fed) < 2:
                fed.append(logits.argmax(-1)[:, None])
        outs.append(steps)
    for got, want in zip(outs[1], outs[0]):
        assert lm_rel(got, want) <= 1e-4
    for mod in (transformer, whisper):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.bfloat16)
    kw = {k: v.to(cuda_device) for k, v in extra.items()}
    l16, _ = m.prefill(card.to(torch.bfloat16), 16, tokens=tokens.to(cuda_device),
                       **kw)
    assert lm_rel(l16, outs[1][0]) <= 5e-2


@pytest.mark.cuda
def test_lm_decode_products_accumulate_in_float32(cuda_device):
    """Two bf16 operands on the card go to bmm(out_dtype=float32): a float32
    result equal to the upcast product up to summation order."""
    from repro_torch.models.attention import _dot_f32

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(4, 8, 2, 128, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    k = torch.randn(4, 8, 4096, 128, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    got = _dot_f32(a, k.transpose(-1, -2))
    assert got.dtype == torch.float32 and got.shape == (4, 8, 2, 4096)
    assert lm_rel(got, torch.matmul(a.float(), k.float().transpose(-1, -2))) <= 1e-5
    assert lm_rel(got, _dot_f32(a.cpu(), k.cpu().transpose(-1, -2))) <= 1e-5


@pytest.mark.cuda
def test_lm_serve_main_on_card(cuda_device):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build

    res = serve.main(["--reduced"])
    assert res["device"].startswith("cuda") and res["peak_bytes"] > 0
    assert res["generations"].shape == (4, 16)
    cfg = reduce_config(get_config("qwen3-1.7b"))
    m = build(cfg)
    logits, _ = m.prefill(serve.init_bf16(m, cuda_device), 48,
                          tokens=serve.make_prompts(cfg, 4, 32, cuda_device))
    np.testing.assert_array_equal(res["generations"][:, 0],
                                  logits.argmax(-1).cpu().numpy())


@pytest.mark.cuda
def test_moe_sort_equals_einsum_on_card(cuda_device, monkeypatch):
    """The two MoE dispatches agree on the card (float32 to 1e-5, bf16 to
    2e-2 of max|out|), with capacity drops and dropless, and the card's
    float32 sort output equals the CPU's to 1e-5."""
    import copy

    from repro_torch.models.moe import init_moe, moe_block

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    p = init_moe(torch.Generator(device=cuda_device).manual_seed(0), 256, 512,
                 8, n_shared=2, d_ff_shared=384)
    x = torch.randn(4, 64, 256, generator=torch.Generator(
        device=cuda_device).manual_seed(1), device=cuda_device)
    host = copy.deepcopy(p).cpu()
    for dropless in (False, True):
        kw = dict(top_k=2, capacity_factor=1.0, dropless=dropless)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            q = copy.deepcopy(p).to(dtype)
            a, aux_a = moe_block(q, x.to(dtype), dispatch="sort", **kw)
            b, aux_b = moe_block(q, x.to(dtype), dispatch="einsum", **kw)
            assert lm_rel(a, b) <= tol, (dropless, dtype)
            assert lm_rel(aux_a.detach(), aux_b.detach()) <= 1e-6
        a, _ = moe_block(p, x, dispatch="sort", **kw)
        c, _ = moe_block(host, x.cpu(), dispatch="sort", **kw)
        assert lm_rel(a.detach(), c.detach()) <= 1e-5, dropless


@pytest.mark.cuda
def test_recurrences_on_card_match_cpu(cuda_device, monkeypatch):
    """Both chunked recurrences on the card against the CPU (float32, 1e-5
    of max|ref|) at a reduced width: RG-LRU's diagonal form over a padded
    second chunk of 256, RWKV's matrix form over four chunks of 32."""
    from repro_torch.models import recurrence

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gen = torch.Generator().manual_seed(0)
    a = torch.rand(300, 2, 512, generator=gen) * 0.1 + 0.9
    b = torch.randn(300, 2, 512, generator=gen)
    h0 = torch.randn(2, 512, generator=gen)
    r, k, w_raw = (torch.randn(100, 2, 4, 64, generator=gen) for _ in range(3))
    v = torch.randn(100, 2, 4, 64, generator=gen)
    w = torch.exp(-torch.exp(w_raw - 1.0))
    u = torch.rand(4, 64, generator=gen) * 0.5
    s0 = torch.randn(2, 4, 64, 64, generator=gen)
    host = (recurrence.chunked_diag_recurrence(a, b, h0, chunk=256)
            + recurrence.chunked_matrix_recurrence(r, k, v, w, u, s0, chunk=32))
    card = (recurrence.chunked_diag_recurrence(
                *(x.to(cuda_device) for x in (a, b, h0)), chunk=256)
            + recurrence.chunked_matrix_recurrence(
                *(x.to(cuda_device) for x in (r, k, v, w, u, s0)), chunk=32))
    for got, want in zip(card, host):
        assert got.is_cuda and lm_rel(got, want) <= 1e-5


# --- LM training (no kernel of its own: float32 card == CPU) ---------------

TRAIN_ARCHS = ("qwen3-1.7b", "qwen2-moe-a2.7b", "rwkv6-3b", "recurrentgemma-9b",
               "whisper-medium")


def train_case(arch, remat=False):
    """(cfg, a float32 train state on the CPU, a seeded batch)."""
    import dataclasses

    from repro_torch import steps
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models.model import build

    cfg = dataclasses.replace(reduce_config(get_config(arch)), remat=remat)
    params = steps._init_for(build(cfg), cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8)).astype(
        np.int32)) for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(4, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return cfg, steps.init_train_state(params), batch


@pytest.mark.cuda
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_card_matches_cpu(cuda_device, arch, monkeypatch):
    """One float32 ``make_train_step`` step (M=2, ``peak_lr=0``, TF32 off)
    on the card and on the CPU: loss and nll to 1e-5, the gradients (the
    first moment) to 1e-4 of their largest magnitude."""
    import copy

    from repro_torch import steps
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import transformer, whisper

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for mod in (transformer, whisper, steps):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    cfg, host, batch = train_case(arch)
    card = steps.init_train_state(copy.deepcopy(host["params"]).to(cuda_device))
    step = steps.make_train_step(cfg, ShapeSpec("t", "train", 8, 4),
                                 microbatches=2, peak_lr=0.0, warmup_steps=0)
    host, mh = step.fn(host, dict(batch))
    card, mc = step.fn(card, {k: v.to(cuda_device) for k, v in batch.items()})
    for key in ("loss", "nll"):
        assert lm_rel(mc[key], mh[key]) <= 1e-5, key
    scale = max(float(t.abs().max()) for t in host["opt"].mu.values())
    for n, t in host["opt"].mu.items():
        assert card["opt"].mu[n].is_cuda
        assert float((card["opt"].mu[n].cpu() - t).abs().max()) <= 1e-4 * scale, n


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-medium"])
def test_remat_on_card_gives_the_same_gradients(cuda_device, arch):
    """bf16 training on the card: the gradients with ``cfg.remat`` (each
    block recomputed in the backward) equal those without, to 1e-6 of
    max|g| (the same kernels run twice)."""
    import copy

    from repro_torch import steps
    from repro_torch.models.model import build

    grads = []
    for remat in (False, True):
        cfg, state, batch = train_case(arch, remat)
        params = copy.deepcopy(state["params"]).to(cuda_device)
        batch = {k: v.to(cuda_device) for k, v in batch.items()}
        labels = batch.pop("labels")
        with torch.enable_grad():
            logits, aux = build(cfg).apply_train(
                steps._cast_view(params, torch.bfloat16), **batch)
            loss = steps._xent(logits, labels)[0] + 0.01 * aux
            grads.append(torch.autograd.grad(loss, list(params.parameters())))
    scale = max(float(g.abs().max()) for g in grads[0])
    for g0, g1 in zip(*grads):
        assert float((g1 - g0).abs().max()) <= 1e-6 * scale


@pytest.mark.cuda
def test_train_main_on_card(cuda_device, tmp_path):
    from repro_torch.launch import train

    res = train.main(["--reduced", "--steps", "5", "--batch", "4", "--seq",
                      "16", "--ckpt-dir", str(tmp_path)])
    assert res["device"].startswith("cuda") and res["end_step"] == 5
    assert all(np.isfinite(m["loss"]) for _, m in res["metrics_log"])
    assert next(iter(res["state"]["opt"].mu.values())).is_cuda


# --- the sharded LM path: k shards on one card against the CPU mesh ---------

SHARDED_ARCHS = ("qwen3-1.7b", "qwen2-moe-a2.7b")


def sharded_case(arch):
    """The reduced width of tests/test_torch_sharding.py (2 layers, d 64,
    4 heads, 2 K/V heads, vocab 256; the MoE with 4 experts of 32)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(
        get_config(arch), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=256, remat=False)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, n_experts=4, top_k=2, d_ff_expert=32,
                                  d_ff_shared=64)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SHARDED_ARCHS)
def test_sharded_lm_on_card_matches_cpu_mesh(cuda_device, arch, monkeypatch):
    """A (2, 2) mesh on ``["cuda:0"] * 4`` against the same mesh on the CPU,
    float32 (TF32 off): prefill of 4 tokens and 4 decode steps, logits to
    1e-5 of max|logit|; one train step (M=2): loss, nll and grad_norm to
    1e-5, the first moment to 1e-5 of its largest magnitude. Every rank's
    tensors stay on the card."""
    from repro_torch import convert, sharding, steps
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.models.model import build

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for mod in (transformer, steps):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    cfg = sharded_case(arch)
    meshes = (make_mesh(2, 2, device="cpu"),
              make_mesh(2, 2, devices=["cuda:0"] * 4))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8)).astype(np.int32))
    outs = []
    for mesh in meshes:
        params = convert.shard_lm(build(cfg).init(
            torch.Generator().manual_seed(0)), mesh)
        assert all(t.device == mesh.devices[0] for xs in params.shards.values()
                   for t in xs)
        pstep = steps.make_prefill_step(cfg, ShapeSpec("p", "prefill", 16, 4), mesh)
        dstep = steps.make_decode_step(cfg, ShapeSpec("d", "decode", 16, 4), mesh)
        lg, cache = pstep.fn(params, sharding.shard_tree(
            {"tokens": toks[:, :4]}, pstep.in_specs[1], mesh))
        logits = [sharding.gather(lg, pstep.out_specs[0], mesh, "cpu")]
        for i in range(4, 8):
            lg, cache = dstep.fn(
                params, cache, sharding.shard(toks[:, i:i + 1], dstep.in_specs[2], mesh),
                sharding.shard(torch.full((4,), i, dtype=torch.int32),
                               dstep.in_specs[3], mesh))
            logits.append(sharding.gather(lg, dstep.out_specs[0], mesh, "cpu"))
        tstep = steps.make_train_step(cfg, ShapeSpec("t", "train", 8, 4), mesh,
                                      microbatches=2, peak_lr=0.0, warmup_steps=0)
        state = convert.shard_train_state(steps.init_train_state(
            build(cfg).init(torch.Generator().manual_seed(0))), mesh)
        state, met = tstep.fn(state, sharding.shard_tree(
            {"tokens": toks, "labels": labels}, tstep.in_specs[1], mesh))
        mu = {n: sharding.gather(xs, state["params"].specs[n], mesh, "cpu")
              for n, xs in state["opt"].mu.items()}
        outs.append((logits, met, mu))
    (l_cpu, m_cpu, mu_cpu), (l_card, m_card, mu_card) = outs
    for got, want in zip(l_card, l_cpu):
        assert lm_rel(got, want) <= 1e-5
    for key in ("loss", "nll", "grad_norm"):
        assert lm_rel(m_card[key], m_cpu[key]) <= 1e-5, key
    scale = max(float(t.abs().max()) for t in mu_cpu.values())
    for n, t in mu_cpu.items():
        assert float((mu_card[n] - t).abs().max()) <= 1e-5 * scale, n


FAMILY_ARCHS = ("rwkv6-3b", "recurrentgemma-9b", "whisper-medium")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_sharded_families_on_card_match_cpu_mesh(cuda_device, arch,
                                                 monkeypatch):
    """The RWKV-6, hybrid and whisper families at ``reduce_config`` width on
    a (2, 2) mesh of ``["cuda:0"] * 4`` against the same mesh on the CPU,
    float32 (TF32 off): prefill of 4 tokens and 4 decode steps, logits and
    every cache leaf (the hybrid's tail, whisper's cross K/V) to 1e-5 of
    their largest magnitude; one train step (M=2, remat on): loss, nll and
    grad_norm to 1e-5, the first moment to 1e-5 of its largest
    magnitude."""
    import dataclasses

    from repro_torch import convert, sharding, steps
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer, whisper
    from repro_torch.models.model import build

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for mod in (transformer, whisper, steps):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    cfg = dataclasses.replace(reduce_config(get_config(arch)), remat=True)
    meshes = (make_mesh(2, 2, device="cpu"),
              make_mesh(2, 2, devices=["cuda:0"] * 4))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8)).astype(np.int32))
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = torch.from_numpy(rng.normal(
            size=(4, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    outs = []
    for mesh in meshes:
        params = convert.shard_lm(build(cfg).init(
            torch.Generator().manual_seed(0)), mesh)
        pstep = steps.make_prefill_step(cfg, ShapeSpec("p", "prefill", 16, 4), mesh)
        dstep = steps.make_decode_step(cfg, ShapeSpec("d", "decode", 16, 4), mesh)
        lg, cache = pstep.fn(params, sharding.shard_tree(
            {"tokens": toks[:, :4], **extra}, pstep.in_specs[1], mesh))
        logits = [sharding.gather(lg, pstep.out_specs[0], mesh, "cpu")]
        for i in range(4, 8):
            lg, cache = dstep.fn(
                params, cache, sharding.shard(toks[:, i:i + 1], dstep.in_specs[2], mesh),
                sharding.shard(torch.full((4,), i, dtype=torch.int32),
                               dstep.in_specs[3], mesh))
            logits.append(sharding.gather(lg, dstep.out_specs[0], mesh, "cpu"))
        whole = sharding.gather_tree(cache, dstep.out_specs[1], mesh, "cpu")
        tstep = steps.make_train_step(cfg, ShapeSpec("t", "train", 8, 4), mesh,
                                      microbatches=2, peak_lr=0.0, warmup_steps=0)
        state = convert.shard_train_state(steps.init_train_state(
            build(cfg).init(torch.Generator().manual_seed(0))), mesh)
        state, met = tstep.fn(state, sharding.shard_tree(
            {"tokens": toks, "labels": labels, **extra}, tstep.in_specs[1], mesh))
        mu = {n: sharding.gather(xs, state["params"].specs[n], mesh, "cpu")
              for n, xs in state["opt"].mu.items()}
        outs.append((logits, whole, met, mu))
    (l_cpu, c_cpu, m_cpu, mu_cpu), (l_card, c_card, m_card, mu_card) = outs
    for got, want in zip(l_card, l_cpu):
        assert lm_rel(got, want) <= 1e-5

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree

    card = dict(leaves(c_card))
    for path, want in leaves(c_cpu):
        if path.endswith("/pos"):
            assert torch.equal(card[path], want), path
        else:
            assert lm_rel(card[path], want) <= 1e-5, path
    for key in ("loss", "nll", "grad_norm"):
        assert lm_rel(m_card[key], m_cpu[key]) <= 1e-5, key
    scale = max(float(t.abs().max()) for t in mu_cpu.values())
    for n, t in mu_cpu.items():
        assert float((mu_card[n] - t).abs().max()) <= 1e-5 * scale, n


@pytest.mark.cuda
def test_gpipe_on_card_matches_sequential(cuda_device, monkeypatch):
    """``gpipe_apply`` over 4 stages on ``["cuda:0"] * 4`` against the
    sequential stack on the card, float32 (TF32 off): 1e-6."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.pipeline import gpipe_apply

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    mesh = make_mesh(1, 4, devices=["cuda:0"] * 4)
    ws = torch.from_numpy((np.random.default_rng(1).normal(size=(4, 16, 16))
                           * 0.3).astype(np.float32)).to(cuda_device)
    xs = torch.from_numpy(np.random.default_rng(2).normal(
        size=(6, 2, 16)).astype(np.float32)).to(cuda_device)
    want = xs
    for s in range(4):
        want = torch.tanh(want @ ws[s])
    for out in gpipe_apply(lambda w, x: torch.tanh(x @ w), ws, xs, mesh=mesh,
                           axis="model"):
        assert out.is_cuda
        assert lm_rel(out, want) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,n_clauses,rule", [
    ((2, 4), 256, "composed_even"), ((2, 3), 128, "composed_ragged")])
def test_dryrun_tm_checks_on_card(cuda_device, mesh, n_clauses, rule):
    """``dryrun.run_tm_checks`` with k ranks on ``cuda:0``: no failure, one
    int32 reduction per scores call, each kernel-backed engine launching
    its kernel once per rank and nothing else, the learning kernels in the
    train steps; the launches the record holds are the wrappers' counts."""
    from repro_torch.launch import dryrun

    kernels = (indexed.indexed_votes, clause_eval.clause_votes_packed,
               clause_eval.clause_outputs_packed, clause_eval.round_vote,
               ta_update.ta_update)
    before = {k.__name__: k.launches for k in kernels}
    rec = dryrun.run_tm_checks(data=mesh[0], model=mesh[1], n_clauses=n_clauses,
                               expect_composition=rule, device="cuda",
                               save=False)
    assert rec["failures"] == []
    ranks = mesh[0] * mesh[1]
    for name, eng in rec["engines"].items():
        assert eng["collective_count"] == 1, name
        kernel = dryrun.ENGINE_KERNELS.get(name)
        want = {k: (ranks if k == kernel else 0) for k in eng["kernel_launches"]}
        assert eng["kernel_launches"] == want, name
    assert all(rec["train_kernel_launches"][k] > 0
               for k in ("round_vote", "ta_update"))
    assert rec["train_kernel_launches"]["clause_outputs_packed"] == 0
    total = {k: rec["train_kernel_launches"][k] + sum(
        e["kernel_launches"][k] for e in rec["engines"].values()) for k in before}
    assert {k.__name__: k.launches - before[k.__name__] for k in kernels} == total


@pytest.mark.cuda
def test_dryrun_tm_async_checks_on_card(cuda_device):
    from repro_torch.launch import dryrun

    rec = dryrun.run_tm_async_checks(device="cuda", save=False)
    assert rec["failures"] == []
    assert [c["async_count"] for c in rec["cells"].values()] == [0, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
@pytest.mark.parametrize("mesh_shape", [None, (2, 2)])
def test_trace_equals_card_run(cuda_device, kind, mesh_shape):
    """A reduced qwen3 step traced on fake CUDA tensors against the same
    step run for real on the card (unsharded, and a (2, 2) mesh on
    ``cuda:0``): FLOPs against ``FlopCounterMode``, the collectives'
    calls and payloads against the mesh counter, and argument bytes per
    rank against the resident ones, exactly."""
    from repro_torch import configs, steps
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, trace
    from repro_torch.launch.mesh import make_mesh

    cfg = configs.reduce_config(configs.get_config("qwen3-1.7b"))
    shape = {"decode": ShapeSpec("d", "decode", 32, 4),
             "prefill": ShapeSpec("p", "prefill", 16, 4),
             "train": ShapeSpec("t", "train", 16, 8)}[kind]
    kw = {"microbatches": 2} if kind == "train" else {}
    tmesh = None if mesh_shape is None else dryrun.trace_mesh(mesh_shape)
    acct = trace.trace_step(steps.make_step(cfg, shape, tmesh, **kw), cfg,
                            tmesh, device="cuda")
    assert acct["device"].startswith("cuda")
    mesh = (None if mesh_shape is None
            else make_mesh(*mesh_shape, devices=["cuda:0"] * 4))
    step = steps.make_step(cfg, shape, mesh, **kw)
    args = trace.real_step_args(step, cfg, mesh, cuda_device)
    resident = trace.tree_rank_bytes(args, 1 if mesh is None else 4)
    if mesh is not None:
        mesh.collectives.reset()
    with trace.flop_counter() as fc:
        step.fn(*args)
    assert acct["cost"]["flops_all_ranks_trace"] == fc.get_total_flops()
    assert acct["memory"]["argument_bytes_per_device"] == max(resident)
    if mesh is not None:
        counter = mesh.collectives.snapshot()
        assert acct["collectives"]["counter"] == counter
        assert (trace.counter_stats(counter, mesh).by_kind
                == acct["collectives"]["by_kind"])


@pytest.mark.cuda
def test_mla_layer_at_published_widths_matches_the_reference(cuda_device):
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from tmbench import harness
    from tmbench.reference import deepseek_v2 as mla_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deepseek-v2-lite")
    conf = harness.load_json(harness.ROOT / "tmbench/configs/deepseek_v2_lite_ep8.json")
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    p = attention.init_mla(gen, cfg)
    x = torch.randn(2, 4096, cfg.d_model, generator=gen, device=cuda_device)
    pos = torch.arange(4096, device=cuda_device)[None]
    w = {"wq": p.wq.weight, "wkv_a": p.wkv_a.weight, "kv_norm": p.kv_norm.scale,
         "wkv_b": p.wkv_b.weight, "wo": p.wo.weight}
    with torch.no_grad():
        want = mla_ref.mla(w, x, conf)
        got, (c, k_r) = attention.mla_attend(p, cfg, x, pos)
        assert float((got - want).abs().max() / want.abs().max()) < 1e-4
        got16, _ = attention.mla_attend(p.to(torch.bfloat16), cfg,
                                        x.to(torch.bfloat16), pos)
        assert float((got16.float() - want).abs().max() / want.abs().max()) < 2e-2
    assert c.shape == (2, 4096, 512) and k_r.shape == (2, 4096, 64)


# -- the MLA attention core kernel (csrc/mla_attention.cu) ----------------------
# (B, S, H): S = 1, a ragged 77 and 1,000, and the training cell's 4,096
MLA_CORE_SHAPES = [(2, 1, 16), (2, 77, 16), (2, 1000, 16), (2, 4096, 16)]


def _mla_core_case(dev, b, s, h, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
    return rnd(b, s, h, 192), rnd(b, s, h, 192), rnd(b, s, h, 128), rnd(b, s, h, 128)


def _mla_core_grads(fn, q, k, v, dout, dtype):
    """fn's output and the gradients of q, k, v under ``dout``, float32."""
    ts = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
    out = fn(*ts)
    out.backward(dout.to(out.dtype))
    return [out.detach().float()] + [t.grad.float() for t in ts]


def _assert_core_within_sdpa(q, k, v, dout, pos, scale):
    """The kernel's output and gradients against float32 ``_sdpa``: each
    error (max |Δ|) at most 1.25× bf16 ``_sdpa``'s against the same truth,
    or under 2**-10 of the largest truth (a bf16 half-ulp; S = 1's dq and
    dk are exactly 0)."""
    from repro_torch.kernels import mla_attention
    from repro_torch.models import attention

    mask = attention._mask(pos, pos, "causal", None)

    def sdpa(q_, k_, v_):
        return attention._sdpa(q_, k_, v_, mask, scale)
    truth = _mla_core_grads(sdpa, q, k, v, dout, torch.float32)
    bf16 = _mla_core_grads(sdpa, q, k, v, dout, torch.bfloat16)
    f0, b0 = mla_attention.attention_fwd.launches, mla_attention.attention_bwd.launches
    got = _mla_core_grads(lambda q_, k_, v_: mla_attention.mla_attention(
        q_, k_, v_, pos, scale), q, k, v, dout, torch.bfloat16)
    assert mla_attention.attention_fwd.launches == f0 + 1
    assert mla_attention.attention_bwd.launches == b0 + 1
    floor = 2 ** -10 * max(float(t.abs().max()) for t in truth)
    for name, t, ref16, mine in zip(("out", "dq", "dk", "dv"), truth, bf16, got):
        assert torch.isfinite(mine).all(), name
        err_ref = float((ref16 - t).abs().max())
        err = float((mine - t).abs().max())
        assert err <= max(1.25 * err_ref, floor), (name, err, err_ref, floor)


@pytest.mark.cuda
@pytest.mark.parametrize("b, s, h", MLA_CORE_SHAPES)
def test_mla_core_kernel_against_float32_sdpa(cuda_device, b, s, h):
    from repro_torch.configs import get_config
    from repro_torch.models import attention

    q, k, v, dout = _mla_core_case(cuda_device, b, s, h, seed=s)
    pos = torch.arange(s, device=cuda_device)[None].expand(b, s)
    _assert_core_within_sdpa(q, k, v, dout, pos,
                             attention.mla_scale(get_config("deepseek-v2-lite")))


@pytest.mark.cuda
def test_mla_core_kernel_on_any_positions_and_a_strided_v(cuda_device):
    """Positions that are no ``arange`` (a permutation, -1 slots whose rows
    attend to every key, repeats) and v a column slice of a wider tensor,
    as ``mla_attend`` hands it over."""
    b, s, h = 2, 300, 4
    q, k, _, dout = _mla_core_case(cuda_device, b, s, h, seed=7)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    v = torch.randn(b, s, h, 256, generator=gen, device=cuda_device).to(
        torch.bfloat16)[..., 128:]
    pos = torch.stack([torch.randperm(s, generator=gen, device=cuda_device),
                       torch.arange(s, device=cuda_device) // 3])
    pos[0, ::11] = -1
    pos[1, 100:140] = -1
    _assert_core_within_sdpa(q, k, v, dout, pos, 0.1147)


@pytest.mark.cuda
def test_mla_core_kernel_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels import mla_attention

    q, k, v, _ = _mla_core_case(cuda_device, 1, 64, 2)
    pos = torch.arange(64, device=cuda_device)[None]
    with pytest.raises(ValueError, match="bfloat16"):
        mla_attention.mla_attention(q.float(), k.float(), v.float(), pos, 0.1)
    with pytest.raises(ValueError, match="head dims"):
        mla_attention.mla_attention(q[..., :128], k[..., :128], v, pos, 0.1)
    wide = torch.zeros(1, 64, 2, 384, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="unit last stride"):
        mla_attention.mla_attention(wide[..., ::2], k, v, pos, 0.1)


@pytest.mark.cuda
def test_a_train_step_launches_the_core_in_every_layer(cuda_device):
    """Three MLA layers at the published widths, two microbatches, remat:
    the forward kernel runs twice a layer a microbatch (forward and
    recompute), the backward once, and the loss is finite."""
    import dataclasses

    from repro_torch import steps
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import mla_attention
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("deepseek-v2-lite"), n_layers=3,
                              experts_held=8, vocab=1024, remat=True)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    state = steps.init_train_state(transformer.init_params(gen, cfg))
    step = steps.make_step(cfg, ShapeSpec("t", "train", 512, 4), microbatches=2).fn
    ids = torch.randint(0, cfg.vocab, (4, 513), generator=gen, device=cuda_device)
    f0, b0 = mla_attention.attention_fwd.launches, mla_attention.attention_bwd.launches
    _, metrics = step(state, {"tokens": ids[:, :-1].to(torch.int32),
                              "labels": ids[:, 1:].to(torch.int32)})
    assert torch.isfinite(torch.as_tensor(metrics["loss"])).all()
    assert mla_attention.attention_fwd.launches - f0 == 2 * 2 * cfg.n_layers
    assert mla_attention.attention_bwd.launches - b0 == 2 * cfg.n_layers


@pytest.mark.cuda
def test_the_launch_clis_run_reduced_deepseek_on_card(cuda_device, tmp_path):
    """``--arch deepseek-v2-lite --reduced`` trains a step and serves on the
    card in the CLIs' bf16: the cut keeps the published head dims, so every
    prefill and training forward and backward launches the core kernels."""
    from repro_torch.kernels import mla_attention
    from repro_torch.launch import serve, train

    f0, b0 = mla_attention.attention_fwd.launches, mla_attention.attention_bwd.launches
    res = train.main(["--arch", "deepseek-v2-lite", "--reduced", "--steps", "1",
                      "--batch", "2", "--seq", "64", "--ckpt-dir", str(tmp_path)])
    assert res["device"].startswith("cuda") and res["end_step"] == 1
    assert mla_attention.attention_fwd.launches > f0
    assert mla_attention.attention_bwd.launches > b0
    f1 = mla_attention.attention_fwd.launches
    out = serve.main(["--arch", "deepseek-v2-lite", "--reduced", "--batch", "2",
                      "--prompt-len", "16", "--gen", "3"])
    assert out["device"].startswith("cuda") and out["generations"].shape == (2, 3)
    assert mla_attention.attention_fwd.launches > f1
