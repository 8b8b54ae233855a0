"""Inputs made from the seed: TA states, request rows and training rows.

Copies of the chip smoke's sound generators (``served_state``,
``requests``, ``trained_like_state``) and of the port's distribution-
matched synthetic data (``bow_documents``, ``binarized_images``), rewritten
as a few large calls on the device from one ``torch.Generator``. The same
seed gives the same tensors on the same device type.
"""
from __future__ import annotations

import numpy as np
import torch

_SEED_MASK = (1 << 63) - 1


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one named stream of a run's seed (any whole
    number, negative or past 64 bits included)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             int(int(seed) < 0)] + [ord(c) for c in tag]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) & _SEED_MASK


def generator(seed: int, tag: str, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``(seed, tag)``."""
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def served_state(m: int, n: int, o: int, n_states: int, avg_len: int,
                 gen: torch.Generator, dtype=torch.int16):
    """``(ta, include)``: TA states whose clauses include about ``avg_len``
    literals each (lengths uniform on [avg_len/2, 3·avg_len/2]), never x_k
    with ¬x_k; included cells at N+1, the others at N."""
    dev = gen.device
    lengths = torch.randint(avg_len // 2, avg_len + avg_len // 2 + 1,
                            (m, n, 1), generator=gen, device=dev)
    rank = torch.rand((m, n, o), generator=gen, device=dev).argsort(-1).argsort(-1)
    chosen = rank < lengths
    del rank
    negated = torch.rand((m, n, o), generator=gen, device=dev) < 0.5
    include = torch.cat([chosen & ~negated, chosen & negated], dim=-1)
    ta = torch.where(include, n_states + 1, n_states).to(dtype)
    return ta, include


def trained_like_state(include: torch.Tensor, n_states: int,
                       gen: torch.Generator, dtype=torch.int16) -> torch.Tensor:
    """TA states with ``include``'s pattern at trained depths: include
    states uniform on [N+1, 2N], exclude states on [1, N]."""
    dev = gen.device
    deep = torch.randint(n_states + 1, 2 * n_states + 1, include.shape,
                         generator=gen, device=dev)
    shallow = torch.randint(1, n_states + 1, include.shape, generator=gen,
                            device=dev)
    return torch.where(include, deep, shallow).to(dtype)


def requests(include: torch.Tensor, base: torch.Tensor,
             gen: torch.Generator) -> torch.Tensor:
    """(count, o) uint8 rows: ``base`` with the literals of one random
    (class, clause) each made true, so every row satisfies a clause."""
    m, n, two_o = include.shape
    o = two_o // 2
    count = base.shape[0]
    dev = gen.device
    ci = torch.randint(0, m, (count,), generator=gen, device=dev)
    cj = torch.randint(0, n, (count,), generator=gen, device=dev)
    rows = include[ci, cj]
    x = torch.where(rows[:, :o], 1, base)
    return torch.where(rows[:, o:], 0, x).to(torch.uint8)


def random_bits(count: int, o: int, gen: torch.Generator) -> torch.Tensor:
    """(count, o) uint8 fair coin flips."""
    return torch.randint(0, 2, (count, o), generator=gen, device=gen.device,
                         dtype=torch.uint8)


def bow_documents(count: int, o: int, n_classes: int, gen: torch.Generator,
                  *, active_frac: float = 0.01, signal: int = 40):
    """IMDb-like bags of words → ``(x (count, o) uint8, y (count,) int64)``:
    a background of ``active_frac·o`` random terms per document plus a
    quarter of its class's ``signal`` terms (the port's ``bow_documents``
    distribution)."""
    dev = gen.device
    n_active = max(4, int(active_frac * o))
    y = torch.randint(0, n_classes, (count,), generator=gen, device=dev)
    sig = torch.randint(0, o, (n_classes, signal), generator=gen, device=dev)
    x = torch.zeros((count, o), dtype=torch.uint8, device=dev)
    background = torch.randint(0, o, (count, n_active), generator=gen, device=dev)
    x.scatter_(1, background, 1)
    take = torch.randint(0, signal, (count, max(2, signal // 4)),
                         generator=gen, device=dev)
    x.scatter_(1, sig[y].gather(1, take), 1)
    return x, y


def binarized_images(count: int, o: int, n_classes: int, gen: torch.Generator,
                     *, active: float = 0.3, noise: float = 0.05):
    """Class-template Bernoulli images → ``(x (count, o) uint8, y (count,)
    int64)``: each class a template with ``active`` of its pixels on, each
    sample its class's template with ``noise`` of its pixels flipped (the
    port's ``binarized_images`` distribution)."""
    dev = gen.device
    templates = torch.rand((n_classes, o), generator=gen, device=dev) < active
    y = torch.randint(0, n_classes, (count,), generator=gen, device=dev)
    flip = torch.rand((count, o), generator=gen, device=dev) < noise
    return (templates[y] ^ flip).to(torch.uint8), y


DATASETS = {"image": binarized_images, "bow": bow_documents}


def dataset(data: dict, count: int, o: int, n_classes: int,
            gen: torch.Generator):
    """``(x, y)``: ``count`` rows of the configuration's ``data``
    (``{"kind": "image" | "bow", ...its parameters}``)."""
    params = {k: v for k, v in data.items() if k != "kind"}
    return DATASETS[data["kind"]](count, o, n_classes, gen, **params)


def host_rows(t: torch.Tensor) -> np.ndarray:
    """A device tensor as the pageable host array a user would hold."""
    return t.to("cpu", copy=True).numpy()


def served_inputs(ctx):
    """``(ta, include)`` of a run's served state, made from its seed at
    the configuration's mean clause length."""
    cfg = ctx.cfg
    g = generator(ctx.seed, "state", ctx.device)
    return served_state(cfg.n_classes, cfg.n_clauses, cfg.n_features,
                        cfg.n_states, int(ctx.cell.config["avg_clause_len"]), g)


def request_pool(ctx, include: torch.Tensor, params: dict) -> torch.Tensor:
    """A run's request rows on the device: ``params["pool_rows"]`` base
    rows from its seed (``params["base"]``: ``bits``, fair coin flips, or
    ``data``, the configuration's data), each with one random clause made
    true."""
    cfg = ctx.cfg
    g = generator(ctx.seed, "rows", ctx.device)
    count = params["pool_rows"]
    if params["base"] == "data":
        base, _ = dataset(ctx.cell.config["data"], count, cfg.n_features,
                          cfg.n_classes, g)
    else:
        base = random_bits(count, cfg.n_features, g)
    return requests(include, base, g)
