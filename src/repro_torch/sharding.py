"""Sharding: partition specs, the activation policy, per-rank layouts and
collectives (the port's ``repro.sharding``).

The port's multi-device LM path is single-controller, as the TM side's is:
one process holds a ``launch.mesh.DeviceMesh`` (a data × model grid of
ranks), and a logical array laid out over it is a ``PerRank`` list, entry
``r`` on ``mesh.devices[r]``. A spec ``P`` says how: one entry per dim,
``None`` (whole) or an axis name (or a tuple of names) whose ranks split
that dim in order. A rank's slice is ``shard``; ``gather`` reassembles the
array; ``shard_tree`` / ``gather_tree`` do it for nested dicts, lists and
named tuples, as the reference's ``named_shardings`` + ``device_put`` do,
and raise on a dim the axes do not divide, as jit does.

Parameters (DESIGN.md §4): every weight matrix has one dim on ``model``
(tensor parallel) and one on ``data`` (FSDP: gathered over ``data`` just
before use). ``_RULES`` is the reference's table, verbatim, over the
reference's leaf paths (``"layers/b0_attn_mlp/attn/wq"``); ``param_specs``
names each port parameter by that path (the layer index dropped where the
reference stacks the layers) and transposes the spec of an ``nn.Linear``,
which the port holds ``(out, in)`` and the reference ``(in, out)``.

A weight-stationary decode step (``Policy.decode_mode``) moves its
activations between the residual's layout (d on ``data``) and the
caches' (rows on the batch axes) with ``psum_to_batch``,
``stationary_to_batch``, ``batch_to_stationary`` and ``gather_batch``.

Collectives are explicit functions over ``PerRank`` lists: ``all_gather``
(a concatenation in rank order), ``all_to_all`` (each rank's chunks
exchanged, moving a split from one dim to another), ``psum`` (a sum in
fixed rank order on the group's first device, copied back to each rank),
``psum_scatter`` (that sum, each rank keeping its chunk), ``pmax``,
``pmean`` and ``ppermute`` (a rotation). Each is differentiable (autograd
runs through the whole grid in one graph, so the backward of a data
all-gather is the reduce-scatter of the weight gradients) and counted on
the mesh's ``CollectiveCounter`` when its group has more than one rank. There is no
counterpart of the reference's global ``current_mesh()``: the mesh rides on
the ``Policy``.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import re
from typing import Any

import torch
from torch import nn

from repro_torch.launch.mesh import (
    DeviceMesh,
    _axes,
    axis_groups,
    axis_index,
    axis_size,
)

# Mesh axis names (single pod: data/model; a multi-pod mesh adds "pod").
POD, DATA, MODEL = "pod", "data", "model"


def _entry(part):
    """A spec entry in the reference's normal form: a tuple of one axis is
    the axis, an empty one ``None``."""
    if isinstance(part, (tuple, list)):
        return None if not part else part[0] if len(part) == 1 else tuple(part)
    return part


class P(tuple):
    """A partition spec: one entry per dim, ``None`` or an axis name or a
    tuple of axis names (the reference's ``PartitionSpec``, normalised as
    it is, so ``tuple(spec)`` of either compares equal)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_entry(p) for p in parts))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)

    def axes(self) -> set:
        """Every axis name the spec uses."""
        return {a for part in self for a in _axes(part)}


class PerRank(list):
    """One logical tensor laid out over a mesh: entry ``r`` is rank ``r``'s
    tensor, on ``mesh.devices[r]``."""


# ---------------------------------------------------------------------------
# Param partition rules — by leaf path regex (the reference's, verbatim).
# Conventions: weights stored (in_dim, out_dim); stacked layer dim first.
# ---------------------------------------------------------------------------

# (regex over "/"-joined path, spec WITHOUT the stacked-layer dim)
_RULES: list[tuple[str, P]] = [
    # embeddings: (vocab, d) — vocab on model (TP), d on data (FSDP)
    (r"embed/tokens$", P(MODEL, DATA)),
    (r"lm_head$", P(DATA, MODEL)),       # (d, vocab)
    (r"pos_embed$", P(None, DATA)),
    # attention
    (r"attn/wq(/kernel)?$", P(DATA, MODEL)),
    (r"attn/wk(/kernel)?$", P(DATA, MODEL)),
    (r"attn/wv(/kernel)?$", P(DATA, MODEL)),
    (r"attn/wo(/kernel)?$", P(MODEL, DATA)),
    (r"attn/[bw][qkvo]_bias$", P(MODEL)),
    # dense mlp (swiglu/gelu)
    (r"mlp/w_(gate|up)(/kernel)?$", P(DATA, MODEL)),
    (r"mlp/w_down(/kernel)?$", P(MODEL, DATA)),
    # moe experts: (E, d, f) — f on model (TP inside expert), d on data
    (r"moe/shared/w_(gate|up)$", P(DATA, MODEL)),
    (r"moe/shared/w_down$", P(MODEL, DATA)),
    (r"moe/w_(gate|up)$", P(None, DATA, MODEL)),
    (r"moe/w_down$", P(None, MODEL, DATA)),
    (r"moe/router$", P(DATA, None)),
    (r"moe/shared_gate$", P(DATA)),
    # rwkv6 time/channel-mix projections: (d, d') → in on data, out on model
    (r"rwkv/cm/w_v$", P(MODEL, DATA)),    # (d_ff, d): f on model (TP out)
    (r"rwkv/.*w_(r|k|v|g)$", P(DATA, MODEL)),
    (r"rwkv/.*w_o$", P(MODEL, DATA)),
    # griffin recurrent block: branch projections + RG-LRU gates
    (r"rec/w_(y|x)$", P(DATA, MODEL)),
    (r"rec/w_o$", P(MODEL, DATA)),
    (r"rec/conv_w$", P(None, MODEL)),
    (r"rec/conv_b$", P(MODEL)),
    (r"rglru/w_[ai]$", P(DATA, MODEL)),
    (r"rglru/b_[ai]$", P(MODEL)),
    (r"rglru/lam$", P(MODEL)),
    # per-channel vectors (decays, mixes, norms over d_model): replicate
    (r".*(norm|scale|ln)[^/]*$", P()),
]


def _spec_for(path: str, ndim: int, stacked: bool) -> P:
    for pat, spec in _RULES:
        if re.search(pat, path):
            parts = tuple(spec)
            if stacked:
                parts = (None,) + parts
            # pad/truncate to ndim
            parts = parts[:ndim] + (None,) * max(0, ndim - len(parts))
            return P(*parts)
    return P()  # replicate by default (small vectors)


_STACKED = ("layers", "enc_layers")


def reference_path(name: str, module: nn.Module,
                   prefix: str = "") -> tuple[str, bool]:
    """The reference's leaf path of port parameter ``name`` of ``module``
    (the inverse of ``convert._lm_target``), after ``prefix`` (the path of
    ``module`` itself, e.g. ``"moe/"``), and whether the port holds it
    transposed: an ``nn.Linear``'s ``weight`` is the reference's ``(in,
    out)`` leaf of the layer's name, its ``bias`` the ``<layer>_bias``
    leaf. The layer index of a stacked prefix (``layers``,
    ``enc_layers``) is dropped."""
    *head, last = name.split(".")
    owner = module.get_submodule(".".join(head)) if head else module
    transposed = False
    if isinstance(owner, nn.Linear):
        if last == "weight":
            parts, transposed = head, True
        else:                                    # attn.wq.bias → attn/wq_bias
            parts = head[:-1] + [head[-1] + "_bias"]
    else:
        parts = head + [last]
    if parts[0] in _STACKED and len(parts) > 2 and parts[1].isdigit():
        parts = [parts[0]] + parts[2:]
    return prefix + "/".join(parts), transposed


def param_specs(module: nn.Module, prefix: str = "") -> dict[str, P]:
    """``{name: P}`` for every parameter of an ``LM`` or ``Whisper`` (any
    device, ``meta`` included), or of a block under its reference
    ``prefix``: the reference's spec of its leaf, without the stacked dim,
    reversed for an ``nn.Linear`` weight."""
    out = {}
    for name, p in module.named_parameters():
        path, transposed = reference_path(name, module, prefix)
        spec = _spec_for(path, p.ndim, stacked=False)
        out[name] = P(*reversed(spec)) if transposed else spec
    return out


# ---------------------------------------------------------------------------
# Activation policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Policy:
    """Activation sharding policy bound to mesh axis names, and the mesh.

    ``Policy.none()`` is the single-device path. The ``act_*`` /
    ``kv_cache`` / ``logits`` methods return the reference's specs for
    those activations; the sharded stack reads ``act_residual`` to decide
    whether the residual stream is sequence-split over ``model`` between
    blocks (Megatron-SP). ``decode_mode`` (``steps.make_decode_step``'s
    policy) is weight-stationary serving: a decode step's residual lies d
    on ``data`` (``act_residual``), so every weight product contracts the
    rank's ``data`` slice with its own shard and only activation-sized
    partial sums move (``psum_to_batch`` and the layout moves below); no
    weight is gathered but where the reference's program gathers one
    (the MoE experts, RWKV-6, Griffin's gates)."""

    active: bool = True
    batch_axes: tuple = (DATA,)          # axes sharding the batch dim
    model_axis: str | None = MODEL
    seq_shard_residual: bool = True      # Megatron-SP on the residual stream
    decode_mode: bool = False
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    @staticmethod
    def none() -> "Policy":
        return Policy(active=False)

    @staticmethod
    def for_mesh(mesh: DeviceMesh) -> "Policy":
        batch = (POD, DATA) if POD in mesh.axis_names else (DATA,)
        return Policy(active=True, batch_axes=batch, model_axis=MODEL,
                      mesh=mesh)

    @property
    def b(self):
        """Batch-dim spec element (None when the batch can't be sharded)."""
        return self.batch_axes if self.batch_axes else None

    def act_btd(self) -> P:
        """(B, S, D) worked activations: batch sharded, d whole."""
        if self.decode_mode:
            return P(None, None, DATA)
        return P(self.b, None, None)

    def act_btd_tp(self) -> P:
        """(B, S, D_shard) intermediate of a TP matmul: last dim on model."""
        return P(self.b, None, self.model_axis)

    def act_residual(self) -> P:
        """Residual stream between blocks: seq on model (SP) when
        ``seq_shard_residual``; decode: d on data."""
        if self.decode_mode:
            return P(None, None, DATA)
        if not self.seq_shard_residual:
            return self.act_btd()
        return P(self.b, self.model_axis, None)

    def act_heads(self) -> P:
        """(B, S, H, Dh): heads on model."""
        return P(self.b, None, self.model_axis, None)

    def kv_cache(self) -> P:
        """(B, S, H_kv, Dh) cache: batch on data, seq on model."""
        return P(self.b, self.model_axis, None, None)

    def logits(self) -> P:
        """(B, S, V): vocab on model."""
        return P(self.b, None, self.model_axis)

    def sequence_split(self, seq_len: int) -> bool:
        """Whether the residual of a ``seq_len``-token pass lies split over
        ``model``: ``act_residual`` says so and ``model`` divides it (an
        indivisible length keeps the residual whole, the same values)."""
        if not self.active or self.model_axis is None:
            return False
        return (self.act_residual()[1] == self.model_axis
                and seq_len % axis_size(self.mesh, self.model_axis) == 0)


# ---------------------------------------------------------------------------
# Layouts: a rank's slice of an array, and back
# ---------------------------------------------------------------------------


def _check_spec(spec: P, shape, mesh: DeviceMesh, what: str = "") -> None:
    if len(spec) > len(shape):
        raise ValueError(f"{what}: spec {spec} has more entries than dims "
                         f"{tuple(shape)}")
    for dim, part in enumerate(spec):
        n = axis_size(mesh, part)
        if shape[dim] % n:
            raise ValueError(f"{what}: dim {dim} of {tuple(shape)} is not "
                             f"divisible by the {n} ranks of {part!r}")


def _rank_index(spec: P, shape, mesh: DeviceMesh, r: int) -> tuple:
    idx = []
    for dim, part in enumerate(spec):
        n = axis_size(mesh, part)
        step = shape[dim] // n
        i = axis_index(mesh, r, _axes(part))
        idx.append(slice(i * step, (i + 1) * step))
    return tuple(idx)


def shard(t: torch.Tensor, spec: P, mesh: DeviceMesh, what: str = "") -> PerRank:
    """Each rank's slice of ``t`` (a copy, contiguous, on its device)."""
    _check_spec(spec, t.shape, mesh, what)
    return PerRank(
        t[_rank_index(spec, t.shape, mesh, r)].to(dev, copy=True).contiguous()
        for r, dev in enumerate(mesh.devices))


def local_shape(shape, spec: P, mesh: DeviceMesh) -> tuple:
    """A rank's shape of a ``shape`` array laid out by ``spec``."""
    _check_spec(spec, shape, mesh)
    return tuple(s // axis_size(mesh, spec[i]) if i < len(spec) else s
                 for i, s in enumerate(shape))


def replica_axes(spec: P, mesh: DeviceMesh) -> tuple:
    """The mesh axes a spec does not use: its shards repeat along them."""
    used = spec.axes()
    return tuple(a for a in mesh.axis_names if a not in used)


def canonical_ranks(spec: P, mesh: DeviceMesh) -> list[int]:
    """One rank per distinct shard: coordinate 0 along every replica axis."""
    rep = replica_axes(spec, mesh)
    return [r for r in range(mesh.size) if axis_index(mesh, r, rep) == 0]


def gather(xs, spec: P, mesh: DeviceMesh, device=None) -> torch.Tensor:
    """The array a ``PerRank`` holds under ``spec``, on ``device`` (rank
    0's by default), assembled from one copy of each shard."""
    dev = mesh.devices[0] if device is None else torch.device(device)
    local = xs[0].shape
    full = tuple(s * (axis_size(mesh, spec[i]) if i < len(spec) else 1)
                 for i, s in enumerate(local))
    out = torch.empty(full, dtype=xs[0].dtype, device=dev)
    for r in canonical_ranks(spec, mesh):
        out[_rank_index(spec, full, mesh, r)] = xs[r].detach().to(dev)
    return out


def _map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts, lists and named tuples
    whose specs mirror it (``P`` leaves)."""
    if isinstance(specs, P):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, s) for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, s) for v, s in zip(tree, specs))
    raise TypeError(f"no spec for leaf {type(tree).__name__}")


def shard_tree(tree, specs, mesh: DeviceMesh):
    """``shard`` over a tree of tensors: each leaf becomes a ``PerRank``.
    Raises ``ValueError`` on a dim its axes do not divide."""
    return _map(lambda t, s: shard(t, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh: DeviceMesh, device=None):
    """``gather`` over a tree of ``PerRank`` leaves."""
    return _map(lambda xs, s: gather(xs, s, mesh, device), tree, specs)


def tree_bytes(tree) -> list[int]:
    """Resident bytes per rank of a tree of ``PerRank`` leaves (a
    ``ShardedModule`` counts its shards)."""
    if isinstance(tree, ShardedModule):
        tree = tree.shards
    if isinstance(tree, PerRank):
        return [t.numel() * t.element_size() for t in tree]
    if isinstance(tree, dict):
        parts = [tree_bytes(v) for v in tree.values()]
    elif isinstance(tree, (list, tuple)):
        parts = [tree_bytes(v) for v in tree]
    else:
        return []
    parts = [p for p in parts if p]
    return [sum(col) for col in zip(*parts)] if parts else []


def local_structs(structs, specs, mesh: DeviceMesh):
    """A rank's ``(shape, dtype)`` tree of ``structs`` (a tree of ``(shape,
    dtype)``) laid out by ``specs`` (a mirror tree of ``P``)."""
    return _map(lambda st, spec: (local_shape(st[0], spec, mesh), st[1]),
                structs, specs)


def predicted_bytes(structs, specs, mesh: DeviceMesh) -> int:
    """Bytes each rank holds of a tree of ``(shape, dtype)`` structs laid
    out by ``specs`` (a mirror tree of ``P``)."""
    total = 0

    def one(struct, spec):
        nonlocal total
        shape, dtype = struct
        n = 1
        for s in local_shape(shape, spec, mesh):
            n *= s
        total += n * torch.empty((), dtype=dtype).element_size()

    _map(one, structs, specs)
    return total


def cache_partition_specs(cache_tree, policy: Policy):
    """PartitionSpecs for a decode cache's ``(shape, dtype)`` tree by
    leaf-name rules (the reference's, for every family's leaves)."""
    bax = policy.batch_axes if policy.batch_axes else None
    m = policy.model_axis

    def spec(path, leaf):
        path = "/".join(path)
        stacked = path.startswith("layers") or path.startswith("cross")
        nd = len(leaf[0]) - (1 if stacked else 0)
        if path.endswith("/k") or path.endswith("/v"):
            if "cross" in path:     # (B, S_enc, H, Dh): heads on model
                out = (bax, None, m, None)[:nd]
            else:                    # (B, Hkv, S, Dh): seq on model
                out = (bax, None, m, None)[:nd]
        elif path.endswith("/pos"):
            out = (bax, m)[:nd]
        elif path.endswith("/wkv"):  # (B, H, Dk, Dv): Dv on model
            out = (bax, None, None, m)[:nd]
        elif path.endswith("_shift"):  # (B, d)
            out = (bax, m)[:nd]
        elif path.endswith("/h"):    # (B, d_rnn)
            out = (bax, m)[:nd]
        elif path.endswith("/conv"):  # (B, 3, d_rnn)
            out = (bax, None, m)[:nd]
        else:
            out = (bax,) + (None,) * (nd - 1)
        if stacked:
            out = (None,) + tuple(out)
        return P(*out)

    def walk(tree, path=()):
        if isinstance(tree, tuple) and len(tree) == 2 and isinstance(
                tree[1], torch.dtype):
            return spec(path, tree)
        if isinstance(tree, dict):
            return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
        return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]

    return walk(cache_tree)


# ---------------------------------------------------------------------------
# Sharded modules
# ---------------------------------------------------------------------------


def module_view(module: nn.Module, tensors: dict, prefix: str = "",
                dtype=None) -> nn.Module:
    """A shallow copy of ``module``'s tree holding ``tensors[name]`` (full
    names under ``prefix``) in place of its parameters, the others kept;
    with ``dtype``, float32 tensors are cast (differentiably). The
    single-device functions run unchanged on such a view."""
    view = copy.copy(module)
    params = {}
    for n, p in module._parameters.items():
        t = tensors.get(prefix + n, p)
        if dtype is not None and t is not None and t.dtype == torch.float32:
            t = t.to(dtype)
        params[n] = t
    view.__dict__["_parameters"] = params
    view.__dict__["_modules"] = {
        n: (None if m is None else module_view(m, tensors, f"{prefix}{n}.",
                                               dtype))
        for n, m in module._modules.items()}
    return view


@dataclasses.dataclass
class ShardedModule:
    """An ``LM`` (or ``Whisper``) laid out over ``mesh`` by ``specs``:
    ``shards[name]`` is a ``PerRank`` of ``nn.Parameter``s, and
    ``template`` the module's structure on the ``meta`` device."""

    template: nn.Module
    specs: dict
    mesh: DeviceMesh
    shards: dict

    def rank_view(self, r: int, dtype=None) -> nn.Module:
        """Rank ``r``'s module: its shards in place of the parameters
        (float32 ones cast to ``dtype`` when given)."""
        return module_view(self.template, {n: xs[r] for n, xs in
                                           self.shards.items()}, dtype=dtype)

    def rank_parameters(self, r: int) -> dict:
        """``{name: rank r's shard}``."""
        return {n: xs[r] for n, xs in self.shards.items()}


def meta_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module``'s structure whose parameters lie on the
    ``meta`` device (nothing of the data is copied)."""
    memo = {id(p): nn.Parameter(torch.empty_like(p, device="meta"),
                                requires_grad=p.requires_grad)
            for p in module.parameters()}
    return copy.deepcopy(module, memo)


@torch.no_grad()
def shard_module(module: nn.Module, mesh: DeviceMesh, *, specs=None,
                 consume: bool = False) -> ShardedModule:
    """``module``'s parameters laid out by ``specs`` (``param_specs`` by
    default; raising on an indivisible dim), each shard a new
    ``nn.Parameter`` on its rank's device. ``consume=True`` frees each
    source parameter once it is sharded, so the peak is one copy and one
    parameter."""
    specs = param_specs(module) if specs is None else specs
    template = meta_copy(module)
    shards = {}
    for name, p in list(module.named_parameters()):
        shards[name] = PerRank(nn.Parameter(t, requires_grad=p.requires_grad)
                               for t in shard(p.detach(), specs[name], mesh, name))
        if consume:
            p.data = torch.empty(0, dtype=p.dtype)
    return ShardedModule(template, specs, mesh, shards)


def gather_module(sharded: ShardedModule, device=None) -> nn.Module:
    """The whole module, its parameters assembled on ``device`` (rank 0's
    by default)."""
    out = copy.deepcopy(sharded.template).to_empty(
        device=device or sharded.mesh.devices[0])
    with torch.no_grad():
        for name, p in out.named_parameters():
            xs = sharded.shards[name]
            p.data = gather(xs, sharded.specs[name], sharded.mesh,
                            p.device).to(xs[0].dtype)
    return out


def _tensor(module: nn.Module, name: str) -> torch.Tensor:
    """The tensor a (view) module holds as parameter ``name`` (a cast
    view's is no ``nn.Parameter``)."""
    head, _, last = name.rpartition(".")
    return (module.get_submodule(head) if head else module)._parameters[last]


def gather_params(modules, specs: dict, mesh: DeviceMesh, prefix: str = "",
                  *, skip=(), extra=None) -> list[nn.Module]:
    """Per-rank views of ``modules`` (rank ``r``'s module holding its
    shards) with every parameter all-gathered over ``data`` along the dim
    its spec (``specs[prefix + name]``) puts there — FSDP's gather just
    before use, dropped with the views. Names in ``skip`` stay local;
    ``extra`` maps names to further axes to gather them over."""
    extra = extra or {}
    names = [n for n, _ in modules[0].named_parameters() if n not in skip]
    tensors = [{} for _ in modules]
    for n in names:
        xs = PerRank(_tensor(m, n) for m in modules)
        axes = (DATA,) + tuple(extra.get(n, ()))
        for dim, part in enumerate(specs[prefix + n]):
            if part in axes:
                xs = all_gather(xs, mesh, part, dim)
        for r, t in enumerate(xs):
            tensors[r][n] = t
    return [module_view(m, t) for m, t in zip(modules, tensors)]


# ---------------------------------------------------------------------------
# Collectives over PerRank lists
# ---------------------------------------------------------------------------


def _observed(fn):
    """A collective that runs through ``mesh.collectives.observer`` when
    one is set (``launch.trace`` while it traces: it attributes the
    collective's outputs to their ranks and keeps its work apart)."""
    @functools.wraps(fn)
    def collective(xs, mesh: DeviceMesh, *args, **kwargs):
        observer = mesh.collectives.observer
        if observer is None:
            return fn(xs, mesh, *args, **kwargs)
        return observer(fn, xs, mesh, *args, **kwargs)
    return collective


def _record(mesh: DeviceMesh, kind: str, axes: tuple, xs, groups) -> None:
    if any(len(g) > 1 for g in groups):
        mesh.collectives.record(kind, axes, sum(
            x.numel() * x.element_size() for g in groups if len(g) > 1
            for x in (xs[r] for r in g)))


@_observed
def all_gather(xs, mesh: DeviceMesh, axes, dim: int) -> PerRank:
    """Each rank gets its group's tensors along ``axes`` concatenated on
    ``dim`` in rank order (the reference's tiled ``all_gather``)."""
    axes = _axes(axes)
    groups = axis_groups(mesh, axes)
    _record(mesh, "all_gather", axes, xs, groups)
    out = PerRank([None] * mesh.size)
    for g in groups:
        for r in g:
            dev = mesh.devices[r]
            out[r] = (xs[r] if len(g) == 1 else
                      torch.cat([xs[q].to(dev) for q in g], dim=dim))
    return out


@_observed
def all_to_all(xs, mesh: DeviceMesh, axes, split_dim: int,
               concat_dim: int) -> PerRank:
    """Each rank cuts its tensor into one chunk per rank of its group along
    ``axes`` on ``split_dim`` and sends chunk ``j`` to the group's rank
    ``j``, which concatenates what it receives on ``concat_dim`` in rank
    order (the reference's tiled ``all_to_all``): an array split on
    ``concat_dim`` becomes the same array split on ``split_dim``. Each rank
    sends what it holds once; ``all_gather`` + slice would move |group|
    times as much."""
    axes = _axes(axes)
    groups = axis_groups(mesh, axes)
    _record(mesh, "all_to_all", axes, xs, groups)
    out = PerRank([None] * mesh.size)
    for g in groups:
        n = len(g)
        if n > 1 and xs[g[0]].shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of "
                             f"{tuple(xs[g[0]].shape)} is not divisible by {n}")
        for j, r in enumerate(g):
            dev = mesh.devices[r]
            out[r] = (xs[r] if n == 1 else torch.cat(
                [xs[q].chunk(n, dim=split_dim)[j].to(dev) for q in g],
                dim=concat_dim))
    return out


def _reduce(kind: str, op, xs, mesh: DeviceMesh, axes) -> PerRank:
    axes = _axes(axes)
    groups = axis_groups(mesh, axes)
    _record(mesh, kind, axes, xs, groups)
    out = PerRank([None] * mesh.size)
    for g in groups:
        if len(g) == 1:
            out[g[0]] = xs[g[0]]
            continue
        dev0 = mesh.devices[g[0]]
        acc = xs[g[0]]
        for q in g[1:]:                          # fixed rank order
            acc = op(acc, xs[q].to(dev0))
        acc = acc.to(xs[g[0]].dtype)
        for r in g:                              # each rank its own copy
            out[r] = acc if r == g[0] else acc.to(mesh.devices[r], copy=True)
    return out


def _add(acc, x):
    """``acc + x``; bf16 / fp16 partial sums accumulate in float32 (the
    sum is rounded to the inputs' dtype once, by ``_reduce``)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return acc.float() + x.float()
    return acc + x


@_observed
def psum(xs, mesh: DeviceMesh, axes) -> PerRank:
    """Sum over ``axes``: each group's tensors added in rank order on the
    group's first device (in float32 for bf16 / fp16, rounded once); every
    rank gets its own copy of the sum."""
    return _reduce("psum", _add, xs, mesh, axes)


@_observed
def pmax(xs, mesh: DeviceMesh, axes) -> PerRank:
    """Elementwise max over ``axes``."""
    return _reduce("pmax", torch.maximum, xs, mesh, axes)


@_observed
def pmean(xs, mesh: DeviceMesh, axes) -> PerRank:
    """Mean over ``axes`` (``psum`` over the group's size)."""
    n = axis_size(mesh, axes)
    if n == 1:
        return PerRank(xs)
    return PerRank(x / n for x in _reduce("pmean", _add, xs, mesh, axes))


@_observed
def psum_scatter(xs, mesh: DeviceMesh, axes, dim: int) -> PerRank:
    """``psum`` over ``axes``, each rank keeping chunk ``axis_index`` of
    ``dim`` (a reduce-scatter)."""
    axes = _axes(axes)
    n = axis_size(mesh, axes)
    if n == 1:
        return PerRank(xs)
    summed = _reduce("psum_scatter", _add, xs, mesh, axes)
    return PerRank(s.chunk(n, dim=dim)[axis_index(mesh, r, axes)]
                   for r, s in enumerate(summed))


@_observed
def ppermute(xs, mesh: DeviceMesh, axis: str, perm) -> PerRank:
    """Send rank ``src``'s tensor to rank ``dst`` along ``axis`` for each
    ``(src, dst)`` of ``perm`` (coordinates along the axis); a rank that
    receives nothing gets zeros."""
    groups = axis_groups(mesh, axis)
    _record(mesh, "ppermute", _axes(axis), xs, groups)
    out = PerRank(torch.zeros_like(x) for x in xs)
    for g in groups:
        for src, dst in perm:
            out[g[dst]] = xs[g[src]].to(mesh.devices[g[dst]], copy=True)
    return out


# ---------------------------------------------------------------------------
# The weight-stationary decode layout (``Policy.decode_mode``)
# ---------------------------------------------------------------------------
# A decode step's residual lies as ``act_residual`` says, d on ``data``,
# replicated over ``model``: every rank holds its ``data`` slice of d for
# the rows of its batch axes other than ``data`` (``pod``, pure data
# parallelism: the reference's program, too, computes on a pod's rows).
# The state a step reads (caches, flash-decode) keeps its rows on all the
# batch axes. These move an activation between the two layouts, or sum the
# partial products of weights contracted over their ``data`` rows into the
# batch layout.


def psum_to_batch(xs, policy: Policy) -> PerRank:
    """Partial sums over ``data`` of the residual's rows → the sums of the
    rank's batch rows: a reduce-scatter over ``data`` on dim 0 (a psum when
    the batch does not lie on ``data``)."""
    if DATA in policy.batch_axes:
        return psum_scatter(xs, policy.mesh, DATA, 0)
    return psum(xs, policy.mesh, DATA)


def stationary_to_batch(xs, policy: Policy) -> PerRank:
    """(rows, …, d/|data|) → the rank's batch rows, whole d: an all_to_all
    over ``data`` (an all_gather of d when the batch does not lie on
    ``data``)."""
    if DATA in policy.batch_axes:
        return all_to_all(xs, policy.mesh, DATA, 0, -1)
    return all_gather(xs, policy.mesh, DATA, -1)


def batch_to_stationary(xs, policy: Policy) -> PerRank:
    """The inverse of ``stationary_to_batch``."""
    mesh = policy.mesh
    if DATA in policy.batch_axes:
        return all_to_all(xs, mesh, DATA, -1, 0)
    n = axis_size(mesh, DATA)
    return PerRank(x.chunk(n, dim=-1)[axis_index(mesh, r, DATA)]
                   for r, x in enumerate(xs))


def gather_batch(xs, policy: Policy) -> PerRank:
    """The rank's batch rows → the residual's rows (an all_gather over
    ``data`` when the batch lies on it)."""
    if DATA in policy.batch_axes:
        return all_gather(xs, policy.mesh, DATA, 0)
    return PerRank(xs)
