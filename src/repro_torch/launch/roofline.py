"""Roofline analysis: three terms per (arch × shape × mesh) cell (the port's
``repro.launch.roofline``).

Hardware: one NVIDIA H100 80GB HBM3 (SXM) per rank, at its 700 W limit:

    compute term    = FLOPs_per_device / 989e12     (bf16 dense tensor cores)
    memory term     = bytes_per_device / 3.35e12    (HBM3)
    collective term = collective_bytes_per_device / 50e9

The collective term's rate is one 400 Gb/s NDR InfiniBand NIC per GPU:
every 16-rank axis of the production mesh spans two 8-GPU hosts, so each
collective's bytes cross the network at that rate, not over NVLink.

The counts come from ``launch.trace`` (per device, the maximum over
ranks). Eager PyTorch runs every layer and microbatch, so the direct
trace (``analyze_cell``'s default) counts the whole program; nothing is
counted once, and no loop needs unrolling. ``probe_costs`` is the cheap
path for large meshes (``roofline_sweep``): it traces the step at one and
two layers (and at one, two and three microbatches for training) and
reconstructs the full depth from

    cost(M, L) = g(M) + Σ_d (L_d − 1) · h_d(M)

with ``g`` quadratic in M (the sharded train step gathers the whole batch
for every microbatch, so its collective bytes grow as M²) and each ``h_d``
(one more layer of dimension d: decoder layers or a hybrid's pattern
groups, whisper's encoder layers) linear in M (the optimizer's per-layer
work does not scale with M). Serving steps take L_d = 1, 2 only.

Bytes are ``launch.trace``'s unfused count (every op's inputs and outputs),
an upper bound on device-memory traffic, so the memory term is a bound of
the same kind.

MODEL_FLOPS (useful-work yardstick): 6·N·D (train) / 2·N·D (inference),
N = params (dense) or active params (MoE), D = tokens processed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch import trace
from repro_torch.launch.dryrun import (
    cell_config, cell_shape, lower_cell, mesh_name, serve_positions,
    trace_mesh)
from repro_torch.steps import make_step

# NVIDIA H100 80GB HBM3 (SXM), 700 W.
PEAK_FLOPS = 989e12      # bf16 dense FLOP/s
HBM_BW = 3.35e12         # B/s
NET_BW = 50e9            # B/s per GPU: one 400 Gb/s NDR NIC

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch" / "roofline"

_KEYS = ("flops", "bytes", "coll_bytes")


# ---------------------------------------------------------------------------
# Probe machinery
# ---------------------------------------------------------------------------


def _probe_cfg(cfg: ModelConfig, shape: ShapeSpec, layer_overrides: dict):
    """``cfg`` with the given layer counts (``layers``: decoder layers, or
    a hybrid's pattern groups, its tail kept; ``enc_layers``: whisper's
    encoder), one of each by default. Nothing else changes: the port's
    eager program hides no loop body from the count."""
    del shape
    upd: dict = {}
    if cfg.family == "hybrid":
        pat = cfg.pattern or ("rec", "rec", "attn")
        upd["n_layers"] = (len(pat) * layer_overrides.get("layers", 1)
                           + cfg.n_layers % len(pat))
    else:
        upd["n_layers"] = layer_overrides.get("layers", 1)
    if cfg.family == "encdec":
        upd["n_enc_layers"] = layer_overrides.get("enc_layers", 1)
    return dataclasses.replace(cfg, **upd)


def per_device(record: dict) -> dict:
    """``{"flops", "bytes", "coll_bytes"}`` per device of a dry-run record
    or a ``trace.trace_step`` result."""
    return {"flops": float(record["cost"]["flops_per_device_trace"]),
            "bytes": float(record["cost"]["bytes_accessed_per_device_trace"]),
            "coll_bytes": float(record["collectives"]["total_bytes"])}


def _measure(cfg, shape, mesh, *, microbatches, kind, microbatches_full=8,
             step_kwargs=None):
    """Trace one probe; its cost scalars per device. A train probe's batch
    is ``microbatches`` production microbatches (``global_batch /
    microbatches_full`` rows each)."""
    kw = dict(step_kwargs or {})
    shape_p = shape
    if kind == "train":
        kw.update(microbatches=microbatches)
        kw.setdefault("compress", "none")
        mb = shape.global_batch // microbatches_full
        shape_p = dataclasses.replace(shape, global_batch=mb * microbatches)
    step = make_step(cfg, shape_p, mesh, **kw)
    return per_device(trace.trace_step(
        step, cfg, mesh, max_positions=serve_positions(cfg, shape)))


def _quadratic(f1: float, f2: float, f3: float, m: int) -> float:
    """The quadratic through (1, f1), (2, f2), (3, f3) at ``m``."""
    return (f1 * (m - 2) * (m - 3) / 2 - f2 * (m - 1) * (m - 3)
            + f3 * (m - 1) * (m - 2) / 2)


def probe_costs(arch: str, shape_name: str, *, multi_pod=False,
                cfg_override=None, microbatches_full=8, verbose=True,
                mesh=None, device="cuda", step_kwargs=None,
                shape_override=None):
    """Trace the probe set and reconstruct the full program's cost per
    device (the module docstring's model)."""
    cfg = cell_config(arch, cfg_override)
    shape = cell_shape(shape_name, shape_override)
    mesh = trace_mesh(mesh, multi_pod=multi_pod, device=device)
    kind = shape.kind
    dims = ["layers"] + (["enc_layers"] if cfg.family == "encdec" else [])
    full_counts = {"layers": (cfg.n_layers // len(cfg.pattern or
                                                  ("rec", "rec", "attn"))
                              if cfg.family == "hybrid" else cfg.n_layers)}
    if cfg.family == "encdec":
        full_counts["enc_layers"] = cfg.n_enc_layers
    m_full = microbatches_full if kind == "train" else 1
    ms = (1, 2, 3) if kind == "train" else (1,)

    def measure(over, m):
        got = _measure(_probe_cfg(cfg, shape, over), shape, mesh,
                       microbatches=m, kind=kind,
                       microbatches_full=microbatches_full,
                       step_kwargs=step_kwargs)
        if verbose:
            print(f"  probe {over} M={m}: {got}", flush=True)
        return got

    base = {m: measure({}, m) for m in ms}
    g = {k: (_quadratic(base[1][k], base[2][k], base[3][k], m_full)
             if kind == "train" else base[1][k]) for k in _KEYS}
    h = {}
    for d in dims:
        two = {m: measure({d: 2}, m) for m in ms[:2]}
        h1 = {k: two[1][k] - base[1][k] for k in _KEYS}
        h2 = ({k: two[2][k] - base[2][k] for k in _KEYS}
              if kind == "train" else h1)
        h[d] = {k: h1[k] + (m_full - 1) * (h2[k] - h1[k]) for k in _KEYS}
    total = {k: g[k] + sum((full_counts[d] - 1) * h[d][k] for d in dims)
             for k in _KEYS}
    return {"per_device": total,
            "probe_coeffs": {"g": g, "h": h, "m_full": m_full,
                             "full_counts": full_counts,
                             "probes": 2 * len(dims) + 3 if kind == "train"
                             else len(dims) + 1}}


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS
# ---------------------------------------------------------------------------


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    n = (cfg.active_param_count() if cfg.family == "moe"
         else cfg.param_count())
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


# ---------------------------------------------------------------------------
# Report assembly
# ---------------------------------------------------------------------------


def roofline_terms(per_device: dict) -> dict:
    """Compute, memory and collective times of one device's counts and
    the largest of them, the step's lower bound."""
    comp = per_device["flops"] / PEAK_FLOPS
    mem = per_device["bytes"] / HBM_BW
    coll = per_device["coll_bytes"] / NET_BW
    dom = max(("compute", comp), ("memory", mem), ("collective", coll),
              key=lambda kv: kv[1])[0]
    return {
        "compute_s": comp, "memory_s": mem, "collective_s": coll,
        "dominant": dom,
        "step_lower_bound_s": max(comp, mem, coll),
    }


def analyze_cell(arch: str, shape_name: str, *, multi_pod=False,
                 cfg_override=None, tag="baseline", save=True, verbose=True,
                 probes=False, mesh=None, device="cuda", step_kwargs=None,
                 record=None, shape_override=None):
    """The cell's roofline record: its per-device counts from a dry-run
    ``record`` of the same cell when given, else the probes (``probes``),
    else a direct trace of the whole program."""
    cfg = cell_config(arch, cfg_override)
    shape = cell_shape(shape_name, shape_override)
    mesh = trace_mesh(mesh, multi_pod=multi_pod, device=device)
    coeffs = None
    if record is not None:
        per_dev, method = per_device(record), "dryrun record"
    elif probes:
        costs = probe_costs(arch, shape_name, cfg_override=cfg_override,
                            verbose=verbose, mesh=mesh,
                            step_kwargs=step_kwargs,
                            shape_override=shape_override)
        per_dev, coeffs, method = (costs["per_device"], costs["probe_coeffs"],
                                   "probes")
    else:
        per_dev = per_device(lower_cell(
            arch, shape_name, cfg_override=cfg_override, save=False,
            mesh=mesh, step_kwargs=step_kwargs,
            shape_override=shape_override))
        method = "trace"
    terms = roofline_terms(per_dev)
    mf = model_flops(cfg, shape)
    mf_dev = mf / mesh.size
    useful = mf_dev / max(per_dev["flops"], 1e-9)
    out = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
        "tag": tag, "method": method, "trace_device": str(mesh.devices[0]),
        "per_device": per_dev,
        "terms": terms,
        "model_flops_total": mf,
        "model_flops_per_device": mf_dev,
        "useful_flops_ratio": useful,
        "roofline_fraction": min(1.0, useful) * (
            terms["compute_s"] / max(terms["step_lower_bound_s"], 1e-30)),
        "probe_coeffs": coeffs,
    }
    if save:
        path = RESULTS / arch / shape_name
        path.mkdir(parents=True, exist_ok=True)
        (path / f"{out['mesh']}.{tag}.json").write_text(json.dumps(out, indent=2))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="roofline of one cell")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--probes", action="store_true",
                    help="reconstruct from one- and two-layer probes")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cpu on a host without "
                         "CUDA)")
    args = ap.parse_args(argv)
    rec = analyze_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                       tag=args.tag, probes=args.probes, device=args.device)
    print(json.dumps({k: v for k, v in rec.items()
                      if k != "probe_coeffs"}, indent=2))


if __name__ == "__main__":
    main()
