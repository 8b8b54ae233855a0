"""Dispatch-trace accounting: the port's counterpart of ``repro.launch.hlo``.

The reference reads a step's cost from XLA: ``compiled.cost_analysis()``
(FLOPs, bytes accessed), ``memory_analysis()`` (argument, output, temp
and alias bytes) and the collectives parsed from the HLO text. The port
has no HLO to parse: a step is an eager PyTorch program. So the port runs
the step itself, once, on *fake* tensors (``FakeTensorMode``: shapes,
dtypes and devices, no data; nothing is launched and nothing allocated)
under ``CostMode``, a ``TorchDispatchMode`` that sees every aten op the
program dispatches (the same ops, in-place updates, autograd and remat as
a real run on that device) and counts, per rank of the mesh:

  * **FLOPs**: ``torch.utils.flop_counter``'s formulas (the registry that
    ``FlopCounterMode`` reads; ``FLOP_FORMULAS`` amends ``bmm`` for its
    ``out_dtype`` overload), so the count equals ``flop_counter()`` over a
    real run of the same program;
  * **bytes accessed**: the bytes of every non-view op's tensor inputs plus
    its outputs. This is an *unfused* upper bound on device-memory traffic
    (every intermediate is written and read back); it is not XLA's fused
    "bytes accessed", and no parity with the reference is claimed for it;
  * **live bytes**: each new storage counted once, on the rank of the op
    that made it, and released when its storage is freed (a weakref
    finalizer: the storage object lives exactly as long as the storage);
    views and in-place ops allocate nothing. The peak of a rank is the
    most of its new bytes alive at once;
  * **collectives**: every collective of ``repro_torch.sharding`` runs
    through ``CostMode.observe`` (the mesh counter's ``observer``): its
    inner ops count as the collective, not as compute, and its outputs
    belong to their ``PerRank`` index. The mesh's ``CollectiveCounter``
    keeps calls and payload bytes as in a real run; the trace adds the
    per-device result bytes of each call.

A rank's ops are found by data flow: ``place`` tags each argument with its
rank, an op's outputs take the rank of its inputs, and a collective's
outputs take their index. An op whose inputs carry no rank or several (the
autograd engine's sums of gradients that crossed a collective, factory
ops) is counted apart as *unattributed*: per-rank figures plus that part
sum to the whole, and per-device figures are the maximum over ranks (ranks
differ only by ragged padding).

Fake CUDA tensors need CUDA's device guards (indexing, ``copy_``, the
autograd engine), which a torch built without CUDA lacks; there the trace
runs on fake CPU tensors, the CPU's program (``attention._dot_f32`` and
``common.linear_f32`` upcast instead of ``bmm(..., out_dtype=float32)``:
the same FLOPs, more bytes).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
import weakref
from collections import defaultdict

import torch
from torch import nn
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import sharding
from repro_torch.launch.mesh import DeviceMesh, axis_size

# The port's collectives by the reference's HLO instruction names.
HLO_KIND = {
    "psum": "all-reduce", "pmax": "all-reduce", "pmean": "all-reduce",
    "psum_scatter": "reduce-scatter", "all_gather": "all-gather",
    "all_to_all": "all-to-all", "ppermute": "collective-permute",
}

# Ops that move no data: they only make or describe a tensor.
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
               torch.ops.aten.empty_like, torch.ops.aten.new_empty,
               torch.ops.aten.new_empty_strided,
               torch.ops.aten._local_scalar_dense}

_RANK = "_trace_rank"
_ARG = "_trace_argument"


def _bmm_flop(a_shape, b_shape, *_, out_shape=None, **kwargs) -> int:
    """``bmm``'s FLOPs, its ``out_dtype`` overload included (whose third
    positional argument, a dtype, ``flop_counter``'s own formula takes for
    the output's shape)."""
    b, m, k = a_shape
    n = b_shape[2]
    return 2 * b * m * n * k


# flop_counter's formulas, amended where the port's ops need it
# (``attention._dot_f32`` and ``common.linear_f32`` call
# ``bmm(..., out_dtype=float32)`` on the card).
FLOP_FORMULAS = {torch.ops.aten.bmm: _bmm_flop}


def flop_counter() -> FlopCounterMode:
    """A ``FlopCounterMode`` with the trace's formulas, to count a real run
    as the trace counts it."""
    return FlopCounterMode(display=False, custom_mapping=FLOP_FORMULAS)


def nbytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's elements (``numel · element_size``)."""
    return t.numel() * t.element_size()


def _div(a: int, b: int):
    return a // b if a % b == 0 else a / b


def result_bytes(kind: str, payload: int, group: int, ranks: int):
    """Per-device result bytes of collectives from a ``CollectiveCounter``'s
    payload (every participating rank's input bytes summed): ``payload /
    ranks`` is one rank's input, and the result on that rank is that input
    (all-reduce, all-to-all, collective-permute), ``group`` times it
    (all-gather) or a ``group``-th of it (reduce-scatter). ``ranks`` is the
    number of participating ranks (every rank of a mesh whose groups along
    the axes hold more than one)."""
    hlo = HLO_KIND[kind]
    if hlo == "all-gather":
        return _div(payload * group, ranks)
    if hlo == "reduce-scatter":
        return _div(payload, ranks * group)
    return _div(payload, ranks)


@dataclasses.dataclass
class CollectiveStats:
    """The reference's ``hlo.CollectiveStats``: per-device result bytes,
    by HLO kind (``by_kind``) and by the port's ``"<kind>/<axes>"`` key
    (``by_call``), the number of calls, and the program-order schedule of
    ``(kind, bytes, axes)``."""

    total_bytes: int
    by_kind: dict
    count: int
    schedule: list
    by_call: dict = dataclasses.field(default_factory=dict)


def collective_stats(schedule) -> CollectiveStats:
    """``CollectiveStats`` of a schedule of ``(kind, bytes, axes)`` (the
    port's kind names, per-device result bytes) in program order."""
    by_kind: dict = defaultdict(int)
    by_call: dict = defaultdict(int)
    total = 0
    out = []
    for kind, b, axes in schedule:
        hlo = HLO_KIND[kind]
        total += b
        by_kind[hlo] += b
        by_call[f"{kind}/{'+'.join(axes)}"] += b
        out.append((hlo, b, "+".join(axes)))
    return CollectiveStats(total_bytes=total, by_kind=dict(by_kind),
                           count=len(out), schedule=out, by_call=dict(by_call))


def counter_stats(snapshot: dict, mesh: DeviceMesh) -> CollectiveStats:
    """``CollectiveStats`` of a ``CollectiveCounter.snapshot()`` of a real
    run, its payloads turned into per-device result bytes by
    ``result_bytes`` (no schedule: a counter keeps totals)."""
    by_kind: dict = defaultdict(int)
    by_call = {}
    for key, payload in snapshot["bytes"].items():
        kind, axes = key.split("/")
        b = result_bytes(kind, payload, axis_size(mesh, tuple(axes.split("+"))),
                         mesh.size)
        by_call[key] = b
        by_kind[HLO_KIND[kind]] += b
    return CollectiveStats(total_bytes=sum(by_call.values()),
                           by_kind=dict(by_kind),
                           count=sum(snapshot["calls"].values()), schedule=[],
                           by_call=by_call)


# ---------------------------------------------------------------------------
# The cost mode
# ---------------------------------------------------------------------------


class CostMode(TorchDispatchMode):
    """Counts a fake-tensor run per rank (see the module docstring). Slot
    ``ranks`` of every per-rank list is the unattributed part; a one-rank
    trace attributes everything to rank 0."""

    def __init__(self, ranks: int):
        super().__init__()
        self.ranks = ranks
        n = ranks + 1
        self.flops = [0] * n
        self.bytes = [0] * n
        self.live = [0] * n
        self.peak = [0] * n
        self.live_all = 0
        self.peak_all = 0
        self.ops = 0
        self.cross_rank_ops = 0
        self.counting = False
        self.calls: list = []        # (kind, axes, [result bytes per rank])
        self._storages: dict = {}    # id(storage) -> [slot, nbytes, argument]
        self._argument_ids: set = set()
        self._collective: list | None = None
        self._read: set = set()      # ids of the arguments an op has read
        self._registry = flop_counter().flop_registry

    # -- storages -------------------------------------------------------------

    def _track(self, t: torch.Tensor, slot: int, argument: bool = False):
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        nb = st.nbytes()
        self._storages[key] = [slot, nb, argument]
        weakref.finalize(st, self._free, key)
        if argument:
            self._argument_ids.add(key)
            return
        if self._collective is not None:
            self._collective.append(key)
        self._add(slot, nb)

    def _add(self, slot: int, nb: int) -> None:
        self.live[slot] += nb
        self.peak[slot] = max(self.peak[slot], self.live[slot])
        self.live_all += nb
        self.peak_all = max(self.peak_all, self.live_all)

    def _free(self, key: int) -> None:
        slot, nb, argument = self._storages.pop(key)
        if argument:
            self._argument_ids.discard(key)
            return
        self.live[slot] -= nb
        self.live_all -= nb

    def _move(self, key: int, slot: int) -> None:
        entry = self._storages.get(key)
        if entry is None or entry[2] or entry[0] == slot:
            return
        self.live[entry[0]] -= entry[1]
        self.live_all -= entry[1]
        entry[0] = slot
        self._add(slot, entry[1])

    def is_argument(self, t: torch.Tensor) -> bool:
        """Whether ``t`` lies in the storage of a placed argument."""
        return id(t.untyped_storage()) in self._argument_ids

    # -- placement --------------------------------------------------------------

    def place(self, struct, spec, mesh: DeviceMesh | None, device):
        """An argument of ``(shape, dtype)`` laid out by ``spec``: a
        ``PerRank`` of empty (fake) tensors on the mesh's devices, each
        tagged with its rank, or one tensor on ``device`` without a mesh."""
        shape, dtype = struct
        if mesh is None:
            return self.argument(torch.empty(shape, dtype=dtype,
                                             device=device), 0)
        local = sharding.local_shape(shape, spec, mesh)
        return sharding.PerRank(
            self.argument(torch.empty(local, dtype=dtype, device=dev), r)
            for r, dev in enumerate(mesh.devices))

    def argument(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """Tag ``t`` as rank ``rank``'s argument; returns it."""
        setattr(t, _RANK, rank)
        setattr(t, _ARG, True)
        self._track(t, rank, argument=True)
        return t

    def was_read(self, t: torch.Tensor) -> bool:
        """Whether an op of the counted run took argument ``t`` as input (a
        collective's included)."""
        return id(t) in self._read

    # -- dispatch -------------------------------------------------------------

    def _slot(self, tensors) -> int:
        tags = {getattr(t, _RANK, None) for t in tensors}
        tags.discard(None)
        if len(tags) == 1:
            return tags.pop()
        if self.ranks == 1:
            return 0
        if tags:
            self.cross_rank_ops += 1
        return self.ranks

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.counting or func.namespace == "prim":
            return out
        ins = [a for a in pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        in_ids = {id(a) for a in ins}
        self._read.update(id(a) for a in ins if getattr(a, _ARG, False))
        if self._collective is not None:
            for o in outs:
                if id(o) not in in_ids:
                    self._track(o, self.ranks)
            return out
        self.ops += 1
        packet = func.overloadpacket
        if packet.__name__.startswith("_foreach_"):
            self._foreach(args, outs, in_ids)
            return out
        slot = self._slot(ins)
        rank = slot if slot < self.ranks else None
        for o in outs:
            if id(o) not in in_ids:
                setattr(o, _RANK, rank)
                self._track(o, slot)
        formula = self._registry.get(packet)
        if formula is not None:
            self.flops[slot] += formula(*args, **kwargs, out_val=out)
        if outs and not func.is_view and packet not in _NO_TRAFFIC:
            self.bytes[slot] += (sum(nbytes(a) for a in ins)
                                 + sum(nbytes(o) for o in outs))
        return out

    def _foreach(self, args, outs, in_ids) -> None:
        """A ``_foreach_*`` op is one elementwise op per list index: index
        ``i``'s bytes go to the rank of its tensors."""
        lists = [a for a in args if isinstance(a, (list, tuple))]
        n = len(lists[0])
        for i in range(n):
            ts = [lst[i] for lst in lists if isinstance(lst[i], torch.Tensor)]
            slot = self._slot(ts)
            mine = outs[i::n] if len(outs) == n else []
            for o in mine:
                if id(o) not in in_ids:
                    setattr(o, _RANK, slot if slot < self.ranks else None)
                    self._track(o, slot)
            self.bytes[slot] += (sum(nbytes(t) for t in ts)
                                 + sum(nbytes(o) for o in mine)
                                 + (nbytes(ts[0]) if not outs else 0))

    # -- collectives ------------------------------------------------------------

    def observe(self, fn, xs, mesh: DeviceMesh, *args, **kwargs):
        """Run collective ``fn``: its ops count as the collective, its
        outputs belong to their ranks, and a counted call keeps its
        per-rank result bytes."""
        if self._collective is not None or not self.counting:
            return fn(xs, mesh, *args, **kwargs)
        if torch.is_grad_enabled():
            for r, x in enumerate(xs):
                if isinstance(x, torch.Tensor) and x.requires_grad:
                    x.register_hook(functools.partial(self._grad_hook, r))
        sched = mesh.collectives.schedule
        before = len(sched)
        self._collective = []
        try:
            out = fn(xs, mesh, *args, **kwargs)
        finally:
            made, self._collective = self._collective, None
        for r, t in enumerate(out):
            setattr(t, _RANK, r)
            key = id(t.untyped_storage())
            if key in made:
                self._move(key, r)
        for kind, _, axes in sched[before:]:
            self.calls.append((kind, axes, [nbytes(t) for t in out]))
        return out

    def _grad_hook(self, rank: int, grad: torch.Tensor) -> None:
        """The gradient of rank ``rank``'s input to a collective (the
        autograd engine sums it across ranks, the collective's backward)
        belongs to ``rank``."""
        setattr(grad, _RANK, rank)
        self._move(id(grad.untyped_storage()), rank)

    # -- results ----------------------------------------------------------------

    def rank_schedule(self, rank: int) -> list:
        """``(kind, result bytes, axes)`` of every collective call on
        ``rank``, in program order."""
        return [(kind, per[rank], axes) for kind, axes, per in self.calls]


def _tree_tensors(tree, rank=None):
    """``(rank, tensor)`` of every tensor in a step's inputs or outputs:
    ``PerRank`` entries by index, a ``ShardedModule``'s shards, a module's
    parameters and a loose tensor by their trace tag (else 0)."""
    if isinstance(tree, sharding.PerRank):
        for r, t in enumerate(tree):
            yield from _tree_tensors(t, r)
    elif isinstance(tree, sharding.ShardedModule):
        for xs in tree.shards.values():
            yield from _tree_tensors(xs)
    elif isinstance(tree, nn.Module):
        for p in tree.parameters():
            yield from _tree_tensors(p, rank)
    elif isinstance(tree, torch.Tensor):
        tag = getattr(tree, _RANK, None)
        yield (rank if rank is not None else (tag or 0)), tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_tensors(v, rank)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_tensors(v, rank)


def tree_rank_bytes(tree, ranks: int, keep=None) -> list[int]:
    """Bytes per rank of every distinct tensor in ``tree`` (those for which
    ``keep(tensor)`` holds, when given)."""
    out = [0] * ranks
    seen = set()
    for r, t in _tree_tensors(tree):
        if (r, id(t)) in seen:
            continue
        seen.add((r, id(t)))
        if keep is None or keep(t):
            out[r] += nbytes(t)
    return out


# ---------------------------------------------------------------------------
# Tracing a step
# ---------------------------------------------------------------------------


def _require_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError(
            "this torch was built without CUDA: a fake CUDA tensor cannot be "
            "indexed, copied into or differentiated here (CUDA's device "
            "guards are missing); trace with device='cpu' for the CPU's "
            "program")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported trace device {str(device)!r}")
    return dev


@contextlib.contextmanager
def fake_mode(device="cuda"):
    """A ``FakeTensorMode`` for tracing on ``device`` (checked: fake CUDA
    needs a torch built with CUDA)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _require_device(device)
    with FakeTensorMode():
        yield


def place_step_args(step, template: nn.Module, mesh, mode: CostMode, device):
    """A ``steps.StepBuild``'s arguments as fake tensors from its
    ``arg_structs`` laid out by its ``in_specs`` (never ``model.init``):
    the parameters as a ``ShardedModule`` over ``template`` (the model's
    module on the meta device; a mesh) or ``template`` holding them (no
    mesh), the rest as ``PerRank`` trees (or tensors)."""
    def tree(structs, specs):
        return sharding._map(lambda st, sp: mode.place(st, sp, mesh, device),
                             structs, specs)

    def module(structs, specs):
        if mesh is not None:
            shards = {n: sharding.PerRank(
                mode.argument(nn.Parameter(t), r) for r, t in
                enumerate(mode.place(structs[n], specs[n], mesh, device)))
                for n in structs}
            return sharding.ShardedModule(template, specs, mesh, shards)
        for name, _ in list(template.named_parameters()):
            head, _, last = name.rpartition(".")
            owner = template.get_submodule(head) if head else template
            owner._parameters[last] = mode.argument(nn.Parameter(
                mode.place(structs[name], specs[name], None, device)), 0)
        return template

    if step.meta["kind"] == "train":
        st, sp = step.arg_structs[0], step.in_specs[0]
        state = {"params": module(st["params"], sp["params"]),
                 "opt": tree(st["opt"], sp["opt"]),
                 "ef": tree(st["ef"], sp["ef"])}
        return state, tree(step.arg_structs[1], step.in_specs[1])
    params = module(step.arg_structs[0], step.in_specs[0])
    return (params,) + tuple(tree(s, p) for s, p in
                             zip(step.arg_structs[1:], step.in_specs[1:]))


def _warm_specs(cfg) -> None:
    """Build the sharded stack's cached parameter specs now: they come from
    a module on the meta device, which cannot be made under a
    ``FakeTensorMode``."""
    from repro_torch.models import transformer, whisper

    if cfg.family == "encdec":
        whisper._whisper_specs(cfg)
    else:
        transformer._lm_specs(cfg)


def real_step_args(step, cfg, mesh, device, *, seed: int = 0,
                   max_positions=None):
    """``place_step_args`` with real tensors on ``device`` (a mesh's own
    devices when given), to run the step for real beside its trace:
    floating leaves ``normal(0, 0.02)`` from a generator seeded with
    ``seed``, integer leaves 0."""
    from repro_torch.steps import _meta_module

    args = place_step_args(step, _meta_module(cfg, max_positions), mesh,
                           CostMode(1 if mesh is None else mesh.size), device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for _, t in _tree_tensors(args):
            if t.is_floating_point():
                t.normal_(0, 0.02, generator=gen)
            else:
                t.zero_()
    return args


def _max(xs) -> float:
    return max(xs) if xs else 0


def trace_step(step, cfg, mesh: DeviceMesh | None = None, *, device="cuda",
               max_positions=None) -> dict:
    """Run ``step`` (a ``steps.StepBuild`` made on ``mesh``, a
    ``launch.mesh.make_trace_mesh``, or unsharded for None) once on fake
    tensors and return its accounting: ``memory`` and ``cost`` per device
    (the maximum over ranks) and over all ranks, ``per_rank`` lists,
    ``collectives`` (per-device ``CollectiveStats`` fields and the mesh
    counter's calls and payload bytes), the schedule and the trace's time.
    The tensors lie on the mesh's devices, or on ``device`` without one;
    the trace enters its own ``FakeTensorMode`` (call it outside one).
    ``max_positions``: whisper's decoder positions, as the step was made
    with."""
    from repro_torch.steps import _meta_module

    dev = _require_device(mesh.devices[0] if mesh is not None else device)
    t0 = time.perf_counter()
    ranks = 1 if mesh is None else mesh.size
    template = _meta_module(cfg, max_positions)
    _warm_specs(cfg)
    with fake_mode(dev):
        mode = CostMode(ranks)
        with mode:
            args = place_step_args(step, template, mesh, mode, dev)
            if mesh is not None:
                mesh.collectives.reset()
                mesh.collectives.schedule = []
                mesh.collectives.observer = mode.observe
            mode.counting = True
            try:
                out = step.fn(*args)
            finally:
                mode.counting = False
                if mesh is not None:
                    mesh.collectives.observer = None
            returned = {id(t) for _, t in _tree_tensors(out)}
            arg_b = tree_rank_bytes(args, ranks, lambda t: (
                mode.was_read(t) or id(t) in returned))
            out_b = tree_rank_bytes(out, ranks)
            alias_b = tree_rank_bytes(out, ranks, mode.is_argument)
            del out, args
    counter = (mesh.collectives.snapshot() if mesh is not None
               else {"calls": {}, "bytes": {}})
    if mesh is not None:
        mesh.collectives.schedule = None
    trace_s = time.perf_counter() - t0
    stats = [collective_stats(mode.rank_schedule(r)) for r in range(ranks)]
    top = max(range(ranks), key=lambda r: stats[r].total_bytes)
    new_out = [o - a for o, a in zip(out_b, alias_b)]
    temp = [max(0, p - n) for p, n in zip(mode.peak[:ranks], new_out)]
    memory = {
        "argument_bytes_per_device": _max(arg_b),
        "output_bytes_per_device": _max(out_b),
        "temp_bytes_per_device": _max(temp),
        "alias_bytes_per_device": _max(alias_b),
    }
    memory["peak_estimate_per_device"] = (
        memory["argument_bytes_per_device"] + memory["output_bytes_per_device"]
        + memory["temp_bytes_per_device"] - memory["alias_bytes_per_device"])
    memory.update(peak_new_bytes_per_device=_max(mode.peak[:ranks]),
                  peak_new_bytes_all_ranks=mode.peak_all,
                  peak_new_bytes_unattributed=mode.peak[ranks])
    cost = {
        "flops_per_device_trace": _max(mode.flops[:ranks]),
        "bytes_accessed_per_device_trace": _max(mode.bytes[:ranks]),
        "flops_all_ranks_trace": sum(mode.flops),
        "bytes_accessed_all_ranks_trace": sum(mode.bytes),
        "flops_unattributed_trace": mode.flops[ranks],
        "bytes_accessed_unattributed_trace": mode.bytes[ranks],
    }
    st = stats[top]
    return {
        "memory": memory, "cost": cost,
        "collectives": {"total_bytes": st.total_bytes, "by_kind": st.by_kind,
                        "count": st.count, "by_call": st.by_call,
                        "counter": counter},
        "schedule": st.schedule,
        "per_rank": {"flops": mode.flops[:ranks], "bytes": mode.bytes[:ranks],
                     "peak_new_bytes": mode.peak[:ranks],
                     "argument_bytes": arg_b, "output_bytes": out_b,
                     "alias_bytes": alias_b,
                     "collective_bytes": [s.total_bytes for s in stats]},
        "ops": mode.ops, "cross_rank_ops": mode.cross_rank_ops,
        "ranks": ranks, "device": str(dev), "trace_s": trace_s,
    }
