"""Bit-packed clause evaluation (port of ``repro.kernels.clause_eval``).

    falsified(b, i, j)  ⇔  any_w( inc[i, j, w] & ~lit[b, w] ) != 0
    outputs(b, i, j)    =  [not falsified]                    (empty clause true)
    votes(b, i)         =  Σ_j outputs(b, i, j) · pol(j)

Words are ``torch.int32`` carrying the reference's ``uint32`` bits
(``core/bitpack.py``). Two primitives, each with two bodies:

  * votes (the bitpack engine): :func:`clause_votes_ref`, plain PyTorch, the
    counterpart of the reference's ``_clause_votes_xla``
    (``src/repro/kernels/backend.py:186``); :func:`clause_votes_packed`, the
    hand-written CUDA kernel that replaces the TPU kernel ``_votes_kernel``
    (``src/repro/kernels/clause_eval.py:45``).
  * per-clause outputs (the learning round): :func:`clause_outputs_ref`,
    the counterpart of ``_clause_outputs_xla`` (``backend.py:197``);
    :func:`clause_outputs_packed`, the CUDA kernel that replaces
    ``_outputs_kernel`` (``clause_eval.py:121``).

Both kernels live in ``csrc/clause_eval.cu``: one core (``v |= inc & ~lit``
over a row's words, the violation words in registers) on two routes, tiled
for B ≥ 3 and direct for B ≤ 2, with two epilogues (see the source for
the design). The launch geometry is chosen here, by the pure function
:func:`launch_plan`, so that the CPU tests can check it. CPU tensors take
the plain bodies.

A third primitive, the learning round's vote half, replaces no TPU kernel:
:func:`round_vote_ref` packs a class row's include mask and runs
:func:`clause_outputs_ref` and the polarity sum, as the reference's round
does; :func:`round_vote` (``round_vote_launch`` in the same source) reads
the row's int16 states instead, and gives the clause outputs and the vote
in one launch, a clause read only until a falsifier turns up. Its geometry
is :func:`round_vote_plan`'s.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

SMS = 132                     # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448          # shared bytes one block may use (227 KB)
_SMEM_PER_SM = 233_472        # shared bytes of one SM, 1 KB reserved per block
_STAGE_BUDGET = 96 * 1024     # shared bytes for a block's staged words
_MAX_THREADS = 256
_SAMPLES_PER_THREAD = 8       # tiled route


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Geometry of one ``csrc/clause_eval.cu`` launch.

    ``route="tiled"``: a block takes clause tiles of ``ct`` rows of one
    class and a sample tile of ``bt`` samples (``blockIdx.y``). Thread ``t``
    (warp ``t // 32``, lane ``t % 32``) holds the ``1 × sb`` cells of clause
    ``j0 + (warp // sg) · 32 + lane`` and samples
    ``b0 + (warp % sg) · sb + s``. Blocks are persistent over the
    ``m · n_ctiles`` clause tiles (block ``x`` takes tiles ``x, x + gx, …``),
    and each tile is staged ``wc`` words of a row at a time, ``stride``
    shared words per row.

    ``route="direct"`` (B ≤ 2): block ``(x, i)`` takes clauses
    ``x · ct + t // ks`` of class ``i``, ``ks`` lanes to a clause, and all
    ``bt = B`` samples; nothing is staged in shared memory.
    """

    route: str               # "tiled" or "direct"
    ks: int                  # direct: lanes per clause row (1 when tiled)
    sb: int                  # samples per thread (tiled: 8; direct: B)
    sg: int                  # sample groups (warps of distinct samples) per block
    threads: int             # threads per block
    ct: int                  # clause rows per tile
    bt: int                  # samples per tile
    wc: int                  # words of a row per staged chunk
    stride: int              # shared words per staged row
    n_ctiles: int            # clause tiles per class
    n_btiles: int            # sample tiles
    n_chunks: int            # chunks per row
    grid: tuple[int, int]    # (persistent blocks over clause tiles, n_btiles)
    smem_bytes: int          # dynamic shared memory per block


def _round4(x: int) -> int:
    return (x + 3) & ~3


def row_stride(wc: int, w: int) -> int:
    """Shared words per staged row: at least ``wc``, equal to ``w`` mod 4
    (so a row's 16-byte copies stay aligned in shared memory wherever its
    source starts) and not a multiple of 8 (so the 32 rows a warp reads at
    one word fall in at least 8 banks: in 32 when the stride is odd)."""
    s = wc + (w - wc) % 4
    return s + 4 if s % 8 == 0 else s


def smem_bytes(ct: int, bt: int, wc: int, stride: int, n_chunks: int) -> int:
    """Dynamic shared bytes: two include buffers, the literal words (one
    buffer when a row is one chunk, else two; ``bt + 4`` words per literal
    word) and ``bt`` vote slots."""
    inc_words = _round4(ct * stride + 3)
    lit_words = _round4(wc * (bt + 4))
    return 4 * (2 * inc_words + (1 if n_chunks == 1 else 2) * lit_words + bt)


def launch_plan(b: int, m: int, n: int, w: int, *, route: str | None = None,
                ks: int | None = None, threads: int | None = None,
                wc: int | None = None, blocks: int | None = None) -> LaunchPlan:
    """The launch geometry for ``b`` samples against ``(m, n, w)`` include
    words (pure; the keyword arguments override the defaults).

    Defaults: the direct route for ``b <= 2`` (an include word serves at
    most two samples, so staging it buys no reuse), 256 threads, ``ks`` the
    power of two nearest above ``w / 4`` (at most 32; 16 at the MNIST
    width), so each lane loads about four words. The tiled route otherwise:
    eight samples per thread, up to four sample groups (32 samples) per
    block, two warps (64 clause rows) per sample group, the longest chunk
    that keeps a block's staged words within 96 KB, and one wave of resident
    blocks, persistent over the clause tiles.
    """
    if b < 1 or m < 1 or n < 1 or w < 0:
        raise ValueError(f"launch_plan: no work for (B, m, n, W)={(b, m, n, w)}")
    route = route or ("direct" if b <= 2 else "tiled")
    if route == "direct":
        return _direct_plan(b, m, n, w, ks, threads)
    if route != "tiled":
        raise ValueError(f"launch_plan: route must be 'tiled' or 'direct', "
                         f"got {route!r}")
    sb = _SAMPLES_PER_THREAD
    groups = -(-b // sb)
    sg = 1 if groups <= 1 else 2 if groups <= 2 else 4
    threads = threads if threads is not None else 64 * sg
    if threads % 32 or not 32 <= threads <= _MAX_THREADS or threads // 32 % sg:
        raise ValueError(f"launch_plan: {threads} threads for {sg} sample "
                         f"groups (one warp or more each)")
    ct, bt = threads // sg, sb * sg
    if wc is None:   # 2·ct·(wc + 7) + 2·(bt + 4)·wc + bt words at most
        wc_max = max(1, (_STAGE_BUDGET // 4 - 14 * ct - bt)
                     // (2 * ct + 2 * (bt + 4)))
        n_chunks = max(1, -(-w // wc_max))
        wc = max(1, -(-w // n_chunks))
    n_chunks = max(1, -(-w // wc))
    stride = row_stride(wc, w)
    smem = smem_bytes(ct, bt, wc, stride, n_chunks)
    if smem > SMEM_LIMIT:
        raise ValueError(f"launch_plan: {smem} shared bytes exceed {SMEM_LIMIT}")
    n_ctiles, n_btiles = -(-n // ct), -(-b // bt)
    if blocks is None:
        per_sm = min(32, 2048 // threads, _SMEM_PER_SM // (smem + 1024))
        blocks = max(1, SMS * per_sm // n_btiles)
    grid = (min(m * n_ctiles, blocks), n_btiles)
    return LaunchPlan(route="tiled", ks=1, sb=sb, sg=sg,
                      threads=threads, ct=ct, bt=bt, wc=wc, stride=stride,
                      n_ctiles=n_ctiles, n_btiles=n_btiles, n_chunks=n_chunks,
                      grid=grid, smem_bytes=smem)


def _direct_plan(b: int, m: int, n: int, w: int, ks: int | None,
                 threads: int | None) -> LaunchPlan:
    if b > 2:
        raise ValueError(f"launch_plan: the direct route takes B <= 2, got {b}")
    if ks is None:
        ks = 1
        while ks < 32 and 4 * ks < w:
            ks *= 2
    threads = threads if threads is not None else _MAX_THREADS
    if ks not in (1, 2, 4, 8, 16, 32) or threads % 32 or not (
            32 <= threads <= _MAX_THREADS):
        raise ValueError(f"launch_plan: direct route with ks={ks}, "
                         f"{threads} threads")
    ct = threads // ks
    wc = max(1, w)
    n_ctiles = -(-n // ct)
    return LaunchPlan(route="direct", ks=ks, sb=b, sg=1, threads=threads,
                      ct=ct, bt=b, wc=wc, stride=wc, n_ctiles=n_ctiles,
                      n_btiles=1, n_chunks=1, grid=(n_ctiles, m), smem_bytes=0)


_default_plan = functools.lru_cache(maxsize=256)(launch_plan)


def _plan_args(plan: LaunchPlan, m: int, n: int, w: int, b: int) -> list[int]:
    direct = plan.route == "direct"
    groups = plan.ks if direct else plan.sg
    return [m, n, w, b, int(direct), groups.bit_length() - 1, plan.threads,
            plan.wc, plan.stride, plan.n_ctiles, plan.n_chunks, plan.grid[0],
            plan.grid[1], plan.smem_bytes]


_PLAN_TYPES = [ctypes.c_int] * 14


def clause_votes_ref(include_packed: torch.Tensor, lit_packed: torch.Tensor,
                     pol: torch.Tensor) -> torch.Tensor:
    """(m, n, W) include words + (B, W) literal words + (n,) ±1 polarity →
    (B, m) int32 polarity-signed vote sums (plain PyTorch)."""
    viol = include_packed[None] & ~lit_packed[:, None, None]   # (B, m, n, W)
    out = ~(viol != 0).any(dim=-1)                             # (B, m, n)
    return (out.to(torch.int32) * pol.to(torch.int32)).sum(
        -1, dtype=torch.int32)


@functools.cache
def _launcher():
    p = ctypes.c_void_p
    return _build.entry("clause_eval", "clause_votes_launch",
                        [p, p, p, p, *_PLAN_TYPES, p])


def _require(cond: bool, msg: str, name: str = "clause_votes_packed") -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def clause_votes_packed(include_packed: torch.Tensor, lit_packed: torch.Tensor,
                        pol: torch.Tensor, *,
                        plan: LaunchPlan | None = None) -> torch.Tensor:
    """CUDA kernel: (B, m) int32 votes, same contract as
    :func:`clause_votes_ref`.

    Takes ``include_packed`` (m, n, W) int32, ``lit_packed`` (B, W) int32 and
    ``pol`` (n,) int32, all contiguous on one CUDA device, and raises on
    anything else. Launches on the current stream without synchronising.
    ``plan`` overrides :func:`launch_plan`'s default geometry.
    """
    inc, lit = include_packed, lit_packed
    _require(inc.is_cuda, f"include words must be a CUDA tensor, got {inc.device}")
    _require(lit.device == inc.device and pol.device == inc.device,
             f"operands on different devices: include {inc.device}, "
             f"literals {lit.device}, pol {pol.device}")
    _require(inc.dtype == torch.int32 and inc.dim() == 3,
             f"include words must be (m, n, W) int32, got "
             f"{tuple(inc.shape)} {inc.dtype}")
    m, n, w = inc.shape
    _require(lit.dtype == torch.int32 and lit.dim() == 2 and lit.shape[1] == w,
             f"literal words must be (B, {w}) int32, got "
             f"{tuple(lit.shape)} {lit.dtype}")
    _require(pol.dtype == torch.int32 and tuple(pol.shape) == (n,),
             f"pol must be ({n},) int32, got {tuple(pol.shape)} {pol.dtype}")
    _require(inc.is_contiguous() and lit.is_contiguous()
             and pol.is_contiguous(), "operands must be contiguous")
    b = lit.shape[0]
    out = torch.zeros((b, m), dtype=torch.int32, device=inc.device)
    if b == 0 or m == 0 or n == 0:
        return out
    plan = plan or _default_plan(b, m, n, w)
    launch = _launcher()
    with torch.cuda.device(inc.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(inc.data_ptr(), lit.data_ptr(), pol.data_ptr(),
                      out.data_ptr(), *_plan_args(plan, m, n, w, b), stream)
    _build.check(code, "clause_eval")
    clause_votes_packed.launches += 1
    return out


clause_votes_packed.launches = 0


def clause_outputs_ref(include_packed: torch.Tensor,
                       lit_packed: torch.Tensor) -> torch.Tensor:
    """(m, n, W) include words + (B, W) literal words → (B, m, n) int8
    clause outputs, 1 where no included literal is false (an empty clause
    gives 1; plain PyTorch)."""
    viol = include_packed[None] & ~lit_packed[:, None, None]   # (B, m, n, W)
    return (~(viol != 0).any(dim=-1)).to(torch.int8)


@functools.cache
def _outputs_launcher():
    p = ctypes.c_void_p
    return _build.entry("clause_eval", "clause_outputs_launch",
                        [p, p, p, *_PLAN_TYPES, p])


def clause_outputs_packed(include_packed: torch.Tensor,
                          lit_packed: torch.Tensor, *,
                          plan: LaunchPlan | None = None) -> torch.Tensor:
    """CUDA kernel: (B, m, n) int8 clause outputs, same contract as
    :func:`clause_outputs_ref`.

    Takes ``include_packed`` (m, n, W) int32 and ``lit_packed`` (B, W) int32,
    both contiguous on one CUDA device, and raises on anything else.
    Launches on the current stream without synchronising. ``plan``
    overrides :func:`launch_plan`'s default geometry.
    """
    inc, lit = include_packed, lit_packed
    need = functools.partial(_require, name="clause_outputs_packed")
    need(inc.is_cuda, f"include words must be a CUDA tensor, got {inc.device}")
    need(lit.device == inc.device,
         f"operands on different devices: include {inc.device}, "
         f"literals {lit.device}")
    need(inc.dtype == torch.int32 and inc.dim() == 3,
         f"include words must be (m, n, W) int32, got "
         f"{tuple(inc.shape)} {inc.dtype}")
    m, n, w = inc.shape
    need(lit.dtype == torch.int32 and lit.dim() == 2 and lit.shape[1] == w,
         f"literal words must be (B, {w}) int32, got "
         f"{tuple(lit.shape)} {lit.dtype}")
    need(inc.is_contiguous() and lit.is_contiguous(),
         "operands must be contiguous")
    b = lit.shape[0]
    if w == 0:   # no literals: every clause is empty, hence true
        return torch.ones((b, m, n), dtype=torch.int8, device=inc.device)
    out = torch.empty((b, m, n), dtype=torch.int8, device=inc.device)
    if out.numel() == 0:
        return out
    plan = plan or _default_plan(b, m, n, w)
    launch = _outputs_launcher()
    with torch.cuda.device(inc.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(inc.data_ptr(), lit.data_ptr(), out.data_ptr(),
                      *_plan_args(plan, m, n, w, b), stream)
    _build.check(code, "clause_eval")
    clause_outputs_packed.launches += 1
    return out


clause_outputs_packed.launches = 0


# -- the learning round's vote half, straight from the TA states ------------

VOTE_THREADS = 256
VOTE_UNROLL = 8               # loads a lane issues before it tests them (kRoundUnroll)


@dataclasses.dataclass(frozen=True)
class VotePlan:
    """Geometry of one ``round_vote_launch``: ``ks`` lanes share a clause
    row, ``threads // ks`` clauses a block, ``grid`` blocks cover the ``n``
    rows; ``vec`` reads 8 states a load (else one)."""

    vec: bool
    ks: int
    threads: int
    grid: int


@functools.lru_cache(maxsize=256)
def round_vote_plan(n: int, L: int, vec: bool) -> VotePlan:
    """The launch geometry of :func:`round_vote` for ``n`` rows of ``L``
    states (pure). A unit is 8 states on the vector route, one otherwise;
    ``ks`` is the least power of two (at most 32) whose ``VOTE_UNROLL``
    loads a lane cover a row's units, so a short row shares a warp with
    others and a long one takes a warp (32 lanes) alone."""
    if n < 1 or L < 0 or (vec and L % 8):
        raise ValueError(f"round_vote_plan: no plan for (n, L, vec)={(n, L, vec)}")
    units = L // 8 if vec else L
    ks = 1
    while ks < 32 and ks * VOTE_UNROLL < units:
        ks *= 2
    return VotePlan(vec=vec, ks=ks, threads=VOTE_THREADS,
                    grid=-(-n // (VOTE_THREADS // ks)))


def round_vote_ref(ta_row: torch.Tensor, lit_words: torch.Tensor,
                   pol: torch.Tensor, *,
                   n_states: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, 2o) TA states + (W,) packed literal words + (n,) int32 polarity →
    ((n,) int8 clause outputs, 0-d int32 vote) (plain PyTorch): the row's
    include mask packed, :func:`clause_outputs_ref`, the polarity sum."""
    # imported here: repro_torch.core imports this module's registry
    from repro_torch.core.bitpack import pack_bits

    inc_words = pack_bits(ta_row > n_states)[None]                # (1, n, W)
    clause_out = clause_outputs_ref(inc_words, lit_words[None])[0, 0]
    return clause_out, (clause_out.to(torch.int32) * pol).sum(dtype=torch.int32)


@functools.cache
def _vote_launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry("clause_eval", "round_vote_launch",
                        [p, p, p, p, p, i, i, i, i, i, i, i, p])


def round_vote(ta_row: torch.Tensor, lit_words: torch.Tensor,
               pol: torch.Tensor, *,
               n_states: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel: the same contract as :func:`round_vote_ref`, in one
    launch that reads the states themselves (nothing packed).

    Takes ``ta_row`` (n, 2o) int16, ``lit_words`` (ceil(2o/32),) int32 and
    ``pol`` (n,) int32, all contiguous on one CUDA device, and raises on
    anything else. A row off 16-byte alignment, or 2o not a multiple of 8,
    takes the scalar route. Launches on the current stream (a 4-byte fill,
    then the kernel) without synchronising.
    """
    if not ta_row.is_cuda:
        raise ValueError(f"round_vote: ta_row must be a CUDA tensor, got "
                         f"{ta_row.device}")
    dev = ta_row.device
    if ta_row.dtype != torch.int16 or ta_row.dim() != 2:
        raise ValueError(f"round_vote: ta_row must be (n, 2o) int16, got "
                         f"{tuple(ta_row.shape)} {ta_row.dtype}")
    n, L = ta_row.shape
    if lit_words.device != dev or pol.device != dev:
        raise ValueError(f"round_vote: operands on different devices: ta_row "
                         f"{dev}, literals {lit_words.device}, pol {pol.device}")
    if lit_words.dtype != torch.int32 or lit_words.shape != ((L + 31) // 32,):
        raise ValueError(f"round_vote: literal words must be ({(L + 31) // 32},) "
                         f"int32, got {tuple(lit_words.shape)} {lit_words.dtype}")
    if pol.dtype != torch.int32 or pol.shape != (n,):
        raise ValueError(f"round_vote: pol must be ({n},) int32, got "
                         f"{tuple(pol.shape)} {pol.dtype}")
    if not (ta_row.is_contiguous() and lit_words.is_contiguous()
            and pol.is_contiguous()):
        raise ValueError("round_vote: operands must be contiguous")
    out = torch.empty(n, dtype=torch.int8, device=dev)
    if n == 0:
        return out, torch.zeros((), dtype=torch.int32, device=dev)
    vote = torch.empty((), dtype=torch.int32, device=dev)
    plan = round_vote_plan(n, L, L % 8 == 0 and ta_row.data_ptr() % 16 == 0)
    launch = _vote_launcher()
    with torch.cuda.device(dev):
        code = launch(ta_row.data_ptr(), lit_words.data_ptr(), pol.data_ptr(),
                      out.data_ptr(), vote.data_ptr(), n, L, n_states,
                      int(plan.vec), plan.ks.bit_length() - 1, plan.threads,
                      plan.grid, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "clause_eval")
    round_vote.launches += 1
    return out, vote


round_vote.launches = 0
