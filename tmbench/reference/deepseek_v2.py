"""A plain float32 reference of DeepSeek-V2's decoder (arXiv:2405.04434
§2.1-2.2; YaRN, arXiv:2309.00071), for the comparison that decides an LM
cell's ``correct``: the forward pass, the training loss and, by autograd,
its gradients, from weights it is handed; and the AdamW update of one
training step (``lr_at``, ``adamw``).

Plain ``torch`` operations in float32, TF32 off; no cache, no batching
tricks, no kernel. Per token ``h`` of a layer (d_model, H heads):

* ``q = W_Q h``, per head ``[q_C; q_R]`` (``qk_nope`` + ``qk_rope``);
  ``[c; k_R] = W_KVA h``, ``c <- RMSNorm(c)``; ``[k_C; v] = W_KVB c`` per
  head; rope on ``q_R`` and on ``k_R`` (one key a token, shared by every
  head); keys ``[k_C; k_R]``; causal softmax attention with scale
  ``qk_head_dim^-0.5 · m²``, ``m = 0.1·mscale_all_dim·ln(factor) + 1``;
  output ``W_O · concat(o_1..o_H)``.
* YaRN frequencies: ``theta^(-2i/D)`` below ``low``, divided by ``factor``
  above ``high``, a linear ramp between, ``low``/``high`` the indices that
  turn ``beta_fast``/``beta_slow`` times over the original positions;
  cos/sin times ``m(mscale) / m(mscale_all_dim)``.
* The first ``first_k_dense_replace`` layers have a SwiGLU MLP; the rest a
  router over all ``n_routed_experts`` (softmax, top ``num_experts_per_tok``,
  not renormalised, ``routed_scaling_factor``) and the shared experts added
  ungated. A layer computes only the experts ``held = (first, n)`` it is
  given (all of them for the uncut layer): assignments to other experts
  add nothing. In training each expert takes at most ``capacity =
  max(1, int(cf·S·k/E))`` assignments of a sequence, the first in token
  order; serving is dropless.
* Loss: token cross-entropy + ``1e-4·mean(lse²)`` + ``aux_loss_alpha``
  times the load-balance loss ``E·Σ_e mean(p_e)·frac(top-1 = e)`` summed
  over the expert layers.
* A training step: the gradient is the mean of its microbatches' (the
  batch's rows in order, a loss each), scaled to a global 2-norm of at most
  ``max_grad_norm`` over every parameter; then AdamW (decoupled weight
  decay, bias corrections at the step's count), at the learning rate of a
  linear warm-up to ``peak_lr`` then a cosine to a tenth of it.

Departures, each a choice of the program this reference is held to:

* rope pairs dimension ``i`` with ``i + D/2`` (rotate-half). The published
  model interleaves, then halves; under random weights that is a fixed
  relabeling of ``W_Q``'s and ``W_KVA``'s rope columns.
* the load-balance loss is the program's: the Switch form above, over a
  microbatch, at the published coefficient ``aux_loss_alpha``. The
  published model's (``seq_aux`` true) is taken per sequence over all
  top-k picks: ``α·Σ_e f_e·P_e``, ``f_e = E/(k·S)·count_e``, ``P_e`` the
  sequence's mean probability.
* no q-LoRA (the published ``q_lora_rank`` is null), no bias.

``low=True`` is the control: the latent ``c``, the queries, keys, values
and the heads' outputs rounded through ``float8_e4m3fn``, one precision
below the program's bfloat16 (in the forward pass; gradients pass the
rounding unchanged).

Weights (``nn.Linear`` layout, ``(out, in)``): ``{"embed": (V, d),
"lm_head": (V, d), "final_norm": (d,), "layers": [{"norm1", "norm2",
"wq", "wkv_a", "kv_norm", "wkv_b", "wo", and "mlp": {"w_gate", "w_up",
"w_down"} or "router" (d, E), "experts": {"w_gate" (n, d, f), "w_up" (n,
d, f), "w_down" (n, f, d)}, "shared": {"w_gate", "w_up", "w_down"}}]}``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.utils.checkpoint

FP8_MAX = 448.0


def yarn_range(dim: int, theta: float, beta_fast: float, beta_slow: float,
               original_max: int) -> tuple[int, int]:
    """``(low, high)`` frequency indices of YaRN's ramp, within [0, dim-1]."""
    def index(turns):
        return (dim * np.log(original_max / (turns * 2 * np.pi))
                / (2 * np.log(theta)))
    return (max(int(np.floor(index(beta_fast))), 0),
            min(int(np.ceil(index(beta_slow))), dim - 1))


def yarn_m(factor: float, mscale: float) -> float:
    """``0.1·mscale·ln(factor) + 1`` (1 for factor <= 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * float(np.log(factor)) + 1.0


def softmax_scale(conf: dict) -> float:
    """``qk_head_dim^-0.5 · m(mscale_all_dim)²``."""
    rs = conf["rope_scaling"]
    m = yarn_m(rs["factor"], rs["mscale_all_dim"])
    return float((conf["qk_nope_head_dim"] + conf["qk_rope_head_dim"]) ** -0.5
                 * m * m)


def inv_freq(conf: dict) -> np.ndarray:
    """The rope dims' inverse frequencies (float64)."""
    rs, dim, theta = conf["rope_scaling"], conf["qk_rope_head_dim"], conf["rope_theta"]
    extra = 1.0 / theta ** (np.arange(0, dim, 2) / dim)
    low, high = yarn_range(dim, theta, rs["beta_fast"], rs["beta_slow"],
                           rs["original_max_position_embeddings"])
    ramp = np.clip((np.arange(dim // 2) - low) / max(high - low, 1e-3), 0, 1)
    return extra / rs["factor"] * ramp + extra * (1 - ramp)


def rope(x: torch.Tensor, conf: dict) -> torch.Tensor:
    """x (B, S, heads, D) rotated by position 0..S-1, rotate-half pairs."""
    rs = conf["rope_scaling"]
    mult = yarn_m(rs["factor"], rs["mscale"]) / yarn_m(rs["factor"], rs["mscale_all_dim"])
    freqs = torch.tensor(inv_freq(conf), dtype=torch.float32, device=x.device)
    pos = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)
    ang = pos[:, None] * freqs[None]
    cos = (torch.cos(ang) * mult)[None, :, None]
    sin = (torch.sin(ang) * mult)[None, :, None]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8_e4m3fn (saturating) in the forward pass;
    the gradient passes as it is (float8 has no range for gradients that
    are not scaled, which would read as zero)."""
    low = x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(torch.float32)
    return x + (low - x).detach()


def mla(w: dict, x: torch.Tensor, conf: dict, low: bool = False) -> torch.Tensor:
    """Causal multi-head latent attention of x (B, S, d)."""
    b, s, _ = x.shape
    h, dn, dr, dv = (conf["num_attention_heads"], conf["qk_nope_head_dim"],
                     conf["qk_rope_head_dim"], conf["v_head_dim"])
    r = conf["kv_lora_rank"]
    q = (x @ w["wq"].T).reshape(b, s, h, dn + dr)
    ckr = x @ w["wkv_a"].T
    c = rms(ckr[..., :r], w["kv_norm"], conf["rms_norm_eps"])
    if low:
        c = fp8(c)
    kv = (c @ w["wkv_b"].T).reshape(b, s, h, dn + dv)
    k_r = rope(ckr[..., r:][:, :, None], conf)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], conf)], -1)
    k = torch.cat([kv[..., :dn], k_r.expand(b, s, h, dr)], -1)
    v = kv[..., dn:]
    if low:
        q, k, v = fp8(q), fp8(k), fp8(v)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * softmax_scale(conf)
    future = torch.triu(torch.ones(s, s, dtype=torch.bool, device=x.device), 1)
    p = torch.softmax(scores.masked_fill(future, float("-inf")), -1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    if low:
        o = fp8(o)
    return o.reshape(b, s, h * dv) @ w["wo"].T


def swiglu(w: dict, x: torch.Tensor) -> torch.Tensor:
    """``w_down(silu(w_gate x) · w_up x)`` with ``nn.Linear`` weights."""
    return (torch.nn.functional.silu(x @ w["w_gate"].T) * (x @ w["w_up"].T)) @ w["w_down"].T


def moe(w: dict, x: torch.Tensor, conf: dict, held: tuple[int, int],
        train: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The expert layer's output on x (B, S, d) from the experts
    ``held = (first, n)`` plus the shared experts, and its load-balance
    loss."""
    b, s, d = x.shape
    e, k = conf["n_routed_experts"], conf["num_experts_per_tok"]
    probs = torch.softmax(x @ w["router"], -1)                  # (B, S, E)
    gates, experts = torch.topk(probs, k, -1)
    if conf["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    gates = gates * conf["routed_scaling_factor"]
    cap = max(1, int(conf["capacity_factor"] * s * k / e)) if train else s * k
    flat_e = experts.reshape(b, s * k)
    flat_g = gates.reshape(b, s * k)
    token = torch.arange(s, device=x.device).repeat_interleave(k)
    out = torch.zeros_like(x)
    first, n = held
    for j in range(n):
        hit = flat_e == first + j
        keep = hit & (torch.cumsum(hit, 1) <= cap)              # first `cap` in order
        rows, cols = torch.nonzero(keep, as_tuple=True)
        tok = token[cols]
        xe = x[rows, tok]
        ew = {name: w["experts"][name][j] for name in ("w_gate", "w_up", "w_down")}
        ye = (torch.nn.functional.silu(xe @ ew["w_gate"]) * (xe @ ew["w_up"])) @ ew["w_down"]
        out = out.index_put((rows, tok), ye * flat_g[rows, cols][:, None],
                            accumulate=True)
    top1 = torch.nn.functional.one_hot(experts[..., 0], e).float()
    aux = e * torch.sum(probs.mean((0, 1)) * top1.mean((0, 1)))
    return out + swiglu(w["shared"], x), aux


def layer(w: dict, x: torch.Tensor, conf: dict, held, train: bool,
          low: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block: (x out, load-balance loss or 0)."""
    eps = conf["rms_norm_eps"]
    x = x + mla(w, rms(x, w["norm1"], eps), conf, low)
    hdn = rms(x, w["norm2"], eps)
    if "mlp" in w:
        return x + swiglu(w["mlp"], hdn), torch.zeros((), device=x.device)
    y, aux = moe(w, hdn, conf, held, train)
    return x + y, aux


def forward(weights: dict, tokens: torch.Tensor, conf: dict, held,
            train: bool = True, low: bool = False,
            checkpoint: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V) float32, load-balance loss summed
    over the expert layers). ``checkpoint``: recompute each layer in the
    backward pass, so that only its input is kept."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = weights["embed"][tokens.long()].float()
    aux = torch.zeros((), device=x.device)
    for w in weights["layers"]:
        if checkpoint and torch.is_grad_enabled():
            x, a = torch.utils.checkpoint.checkpoint(
                layer, w, x, conf, held, train, low, use_reentrant=False)
        else:
            x, a = layer(w, x, conf, held, train, low)
        aux = aux + a
    x = rms(x, weights["final_norm"], conf["rms_norm_eps"])
    return x @ weights["lm_head"].T, aux


def loss(weights: dict, tokens: torch.Tensor, labels: torch.Tensor,
         conf: dict, held, low: bool = False,
         checkpoint: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The training loss of one batch and its logits (B, S, V)."""
    logits, aux = forward(weights, tokens, conf, held, True, low, checkpoint)
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    total = (lse - gold).mean() + 1e-4 * (lse * lse).mean() + conf["aux_loss_alpha"] * aux
    return total, logits


def lr_at(step: int, opt: dict) -> float:
    """The learning rate of the step that starts at count ``step``."""
    warm, total = opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return opt["peak_lr"] * step / max(1, warm)
    t = min(max((step - warm) / max(1, total - warm), 0.0), 1.0)
    return opt["peak_lr"] * (0.1 + 0.45 * (1 + float(np.cos(np.pi * t))))


def adamw(theta: torch.Tensor, grad: torch.Tensor, m: torch.Tensor,
          v: torch.Tensor, step: int, gnorm: float,
          opt: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """One AdamW step of a parameter from its value ``theta``, its mean
    gradient, its moments ``m`` and ``v`` and the step's count ``step``
    (before it), the gradient scaled by the clip of the global norm
    ``gnorm``. Returns (the parameter's change, the new first moment)."""
    b1, b2 = opt["b1"], opt["b2"]
    g = grad * min(1.0, opt["max_grad_norm"] / max(gnorm, 1e-9))
    m1 = b1 * m + (1 - b1) * g
    v1 = b2 * v + (1 - b2) * g * g
    t = step + 1
    m_hat = m1 / (1 - b1 ** t)
    v_hat = v1 / (1 - b2 ** t)
    delta = -lr_at(step, opt) * (m_hat / (torch.sqrt(v_hat) + opt["eps"])
                                 + opt["weight_decay"] * theta)
    return delta, m1
