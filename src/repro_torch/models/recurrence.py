"""Recurrence substrate for the SSM and hybrid families (the port's
``repro.models.recurrence``).

Two chunked engines, each with a naive sequential oracle beside it:

  * ``chunked_diag_recurrence`` — h_t = a_t ⊙ h_{t-1} + b_t over (T, B, D):
    a Python loop over chunks with a log-depth scan inside each chunk, so
    only chunk-boundary states live across iterations. Used by RG-LRU.

  * ``chunked_matrix_recurrence`` — the GLA/RWKV matrix-state recurrence
      S_t = diag(w_t) S_{t-1} + k_t^T v_t,   o_t = r_t·S_{t-1} + (r_t⊙u⊙k_t)·v_t
    evaluated chunk-parallel: intra-chunk pairwise decay ratios are taken in
    log space, where every exponent is ≤ 0. The (C, C, B, H, Dk) relative
    decay tensor is materialised per chunk (42 MB at rwkv6-3b, B=4, C=32).
    Used by RWKV-6.
"""
from __future__ import annotations

import torch


def _pad_time(x, chunk, value=0.0):
    """Pad axis 0 up to a multiple of ``chunk`` with ``value``; returns the
    padded tensor and the original length."""
    t = x.shape[0]
    pad = (-t) % chunk
    if pad:
        x = torch.cat([x, x.new_full((pad,) + x.shape[1:], value)], dim=0)
    return x, t


def diag_recurrence_ref(a, b, h0):
    """Naive sequential oracle. a, b: (T, B, D); h0: (B, D) → (hs, hT)."""
    h, hs = h0, []
    for at, bt in zip(a, b):
        h = at * h + bt
        hs.append(h)
    return torch.stack(hs), h


def _affine_scan(a, b):
    """Inclusive scan over axis 0 of the affine maps h ↦ a_t h + b_t,
    composed in time order: returns (A_t, B_t) with h_t = A_t h_{-1} + B_t.

    A Hillis–Steele scan: ⌈log2 T⌉ steps, each combining element i with
    element i - s. (The one-shot form exp(la)·cumsum(b·exp(-la)) is not
    used: ``la`` reaches about -27 over a 256-step chunk at RG-LRU's
    initial decays, and the exponentials swamp recent terms.)"""
    s = 1
    while s < a.shape[0]:
        a, b = (torch.cat([a[:s], a[s:] * a[:-s]]),
                torch.cat([b[:s], b[s:] + a[s:] * b[:-s]]))
        s *= 2
    return a, b


def chunked_diag_recurrence(a, b, h0, *, chunk=256):
    """Exact chunked evaluation of h_t = a_t h_{t-1} + b_t.

    a, b: (T, B, D) — a in (0, 1]; h0: (B, D). Returns (hs (T,B,D), hT).
    Padded steps are the identity: a = 1, b = 0.
    """
    a_p, t = _pad_time(a, chunk, 1.0)
    b_p, _ = _pad_time(b, chunk)
    h, hs = h0, []
    for start in range(0, a_p.shape[0], chunk):
        aa, bb = _affine_scan(a_p[start:start + chunk], b_p[start:start + chunk])
        hc = aa * h[None] + bb
        h = hc[-1]
        hs.append(hc)
    return torch.cat(hs)[:t], h


def matrix_recurrence_ref(r, k, v, w, u, s0):
    """Naive oracle. r, k, w: (T,B,H,Dk); v: (T,B,H,Dv); u: (H,Dk);
    s0: (B,H,Dk,Dv). Returns (o (T,B,H,Dv), sT)."""
    s, outs = s0, []
    for rt, kt, vt, wt in zip(r, k, v, w):
        kv = kt[..., :, None] * vt[..., None, :]          # (B,H,Dk,Dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, s)
                    + torch.einsum("bhk,hk,bhkv->bhv", rt, u, kv))
        s = wt[..., None] * s + kv
    return torch.stack(outs), s


def chunked_matrix_recurrence(r, k, v, w, u, s0, *, chunk=32):
    """Exact chunk-parallel evaluation of the RWKV-6 recurrence, in
    float32. Shapes as in ``matrix_recurrence_ref``; returns o in v's
    dtype and sT in float32. Padded steps have w = 1 and r = k = v = 0.
    All decay exponents are within-chunk differences la_i - la_j with
    i ≥ j, so they are ≤ 0.
    """
    t, b, h, dk = r.shape
    dv = v.shape[-1]
    rc, _ = _pad_time(r.float(), chunk)
    kc, _ = _pad_time(k.float(), chunk)
    vc, _ = _pad_time(v.float(), chunk)
    wc, _ = _pad_time(w.float(), chunk, 1.0)
    uf = u.float()
    tt = torch.arange(chunk, device=r.device)
    causal = tt[:, None] > tt[None, :]                    # (C, C): τ < t
    s = s0.float()
    outs = []
    for start in range(0, rc.shape[0], chunk):
        rt, kt, vt, wt = (x[start:start + chunk] for x in (rc, kc, vc, wc))
        logw = torch.log(wt.clamp_min(1e-30))
        la = torch.cumsum(logw, dim=0)                     # (C,B,H,Dk)
        la_prev = la - logw                                # la_{t-1}
        # cross-chunk contribution: o_t += (r_t ⊙ a_{t-1}) S_0
        o = torch.einsum("cbhk,bhkv->cbhv", rt * torch.exp(la_prev), s)
        # intra-chunk: P[t,τ] = Σ_d r_td k_τd exp(la_prev[t,d] - la[τ,d]), τ<t
        diff = la_prev[:, None] - la[None, :]              # (C,C,B,H,Dk)
        diff = torch.where(causal[:, :, None, None, None], diff, 0.0)
        pmat = (rt[:, None] * kt[None] * torch.exp(diff)).sum(-1)  # (C,C,B,H)
        pmat = torch.where(causal[:, :, None, None], pmat, 0.0)
        o = o + torch.einsum("csbh,sbhv->cbhv", pmat, vt)
        # diagonal bonus term: ((r_t ⊙ u) · k_t) v_t
        o = o + (rt * uf * kt).sum(-1)[..., None] * vt
        # state at the chunk's end: diag(a_C) S + Σ_τ diag(a_C/a_τ) k_τ v_τ
        k_scaled = kt * torch.exp(la[-1][None] - la)       # exp ≤ 1
        s = torch.exp(la[-1])[..., None] * s + torch.einsum(
            "cbhk,cbhv->bhkv", k_scaled, vt)
        outs.append(o)
    o = torch.cat(outs)[:t]
    return o.to(v.dtype), s


def matrix_recurrence_step(r, k, v, w, u, s):
    """Single decode step. r, k, w: (B,H,Dk); v: (B,H,Dv); s: (B,H,Dk,Dv)
    float32. Returns (o in v's dtype, the new float32 state)."""
    r, k, v32, w = r.float(), k.float(), v.float(), w.float()
    kv = k[..., :, None] * v32[..., None, :]
    o = (torch.einsum("bhk,bhkv->bhv", r, s)
         + torch.einsum("bhk,hk,bhkv->bhv", r, u.float(), kv))
    return o.to(v.dtype), w[..., None] * s + kv
