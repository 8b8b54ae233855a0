"""The port's MoE, recurrence, RWKV-6 and Griffin modules against the
reference package's, on the CPU.

Weights come from the reference's ``init_*`` (its constant leaves perturbed
by seeded numpy so they are tested too) and cross into the port's modules
by the rule ``convert.lm_params_from_reference`` uses; inputs come from
seeded numpy. Tolerance: ``F32_TOL`` = 1e-5 of max|ref| in float32 (the
packages sum in other orders); ``_slots`` and the MoE's drop pattern are
exact. The model-level checks of these families (bf16 at 2e-2 of
max|logit|, caches, decode) are in ``tests/test_torch_lm.py``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import griffin as jgriffin  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import recurrence as jrec  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.sharding import Policy  # noqa: E402

from repro_torch.convert import _lm_target  # noqa: E402
from repro_torch.models import griffin, moe, recurrence, rwkv6  # noqa: E402

POLICY = Policy.none()
F32_TOL = 1e-5
CONSTANT_AT_INIT = ("mu_x", "mu", "mu_k", "mu_r", "w0", "b_a", "b_i",
                    "conv_b", "scale", "bias")


def t(a):
    return torch.from_numpy(np.array(a, np.float32))       # a writable copy


def f64(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().double().numpy()
    return np.asarray(a, np.float64)


def close(got, want, what, tol=F32_TOL):
    """max |got - want| <= tol · max |want| (both as float64 numpy)."""
    got, want = f64(got), f64(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} x {scale}"


def flat(tree, prefix=()):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        if isinstance(val, (dict, list)):
            yield from flat(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def reference(tree, seed):
    """The reference's params as float32 numpy, constant leaves perturbed."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in flat(jax.tree.map(np.asarray, tree)):
        leaf = np.asarray(leaf, np.float32)
        if path[-1] in CONSTANT_AT_INIT:
            leaf = leaf + 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def load(module, tree):
    """Copy a reference tree into a port module: every leaf into exactly one
    parameter, ``nn.Linear`` weights transposed."""
    params = dict(module.named_parameters())
    for path, leaf in flat(tree):
        name, transpose = _lm_target(path, set(params))
        params.pop(name).data.copy_(t(leaf.T if transpose else leaf))
    assert not params, sorted(params)
    return module


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def distinct_experts(rng, g, tt, k, e):
    """(G, T, k) top-k expert ids: distinct within each token."""
    return np.argsort(rng.uniform(size=(g, tt, e)), axis=-1)[..., :k]


@pytest.mark.parametrize("capacity", [1, 3, 8])
def test_slots_equal_reference(capacity):
    """Ranks and the kept mask equal, exactly, with and without drops."""
    rng = np.random.default_rng(0)
    experts = distinct_experts(rng, 3, 9, 2, 4)
    slot, keep = moe._slots(torch.from_numpy(experts), 2, 4, capacity)
    jslot, jkeep = jmoe._slots(jnp.asarray(experts), 2, 4, capacity)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if capacity < 8:
        assert not keep.all()


# (n_experts, top_k, capacity_factor, n_shared, normalize, dropless)
MOE_CASES = [(6, 2, 0.5, 0, True, False),     # capacity 1: drops per group
             (5, 3, 1.0, 2, False, False),    # shared experts, drops
             (6, 2, 0.5, 2, True, True)]      # dropless


def moe_pair(e, n_shared, seed, d=16, f=12):
    jp = reference(jmoe.init_moe(jax.random.key(seed), d, f, e,
                                 n_shared=n_shared,
                                 d_ff_shared=20 if n_shared else None), seed)
    p = moe.MoE(d, f, e, n_shared=n_shared,
                d_ff_shared=20 if n_shared else None)
    return jp, load(p, jp)


@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_block_matches_reference(dispatch, case):
    """Output and aux of both dispatches; the drops are per group, so the
    dropping cases differ from the dropless output."""
    e, k, cf, n_shared, normalize, dropless = case
    jp, p = moe_pair(e, n_shared, seed=1)
    x = np.random.default_rng(2).normal(size=(3, 10, 16)).astype(np.float32)
    kw = dict(top_k=k, capacity_factor=cf, act="silu", dispatch=dispatch,
              normalize=normalize, dropless=dropless)
    out, aux = moe.moe_block(p, t(x), **kw)
    jout, jaux = jmoe.moe_block(jp, x, policy=POLICY, **kw)
    close(out, jout, f"moe {dispatch} {case}")
    close(aux, jaux, f"aux {dispatch} {case}")
    if not dropless:
        free, _ = moe.moe_block(p, t(x), **dict(kw, dropless=True))
        assert not torch.allclose(out, free), "no token was dropped"


def test_moe_sort_equals_einsum_with_groups():
    """The two dispatches agree in the port too, with groups that are not
    batch rows (``num_groups``)."""
    _, p = moe_pair(6, 2, seed=3)
    x = t(np.random.default_rng(4).normal(size=(2, 12, 16)))
    for dropless in (False, True):
        kw = dict(top_k=2, capacity_factor=0.75, num_groups=4,
                  dropless=dropless)
        a, aux_a = moe.moe_block(p, x, dispatch="sort", **kw)
        b, aux_b = moe.moe_block(p, x, dispatch="einsum", **kw)
        close(a, b, f"sort vs einsum dropless={dropless}")
        assert float(aux_a.detach()) == float(aux_b.detach())


# ---------------------------------------------------------------------------
# Recurrences
# ---------------------------------------------------------------------------


def diag_inputs(seed, tt, b=2, d=6):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, size=(tt, b, d)).astype(np.float32)
    bb = rng.normal(size=(tt, b, d)).astype(np.float32)
    h0 = rng.normal(size=(b, d)).astype(np.float32)
    return a, bb, h0


@pytest.mark.parametrize("tt", [8, 11, 1])
def test_diag_recurrence_matches_reference(tt):
    """Chunk 4 over lengths that do and do not divide it: the port's chunked
    form against the reference's chunked form and its oracle, and the
    oracles against each other."""
    a, b, h0 = diag_inputs(5, tt)
    hs, h_t = recurrence.chunked_diag_recurrence(t(a), t(b), t(h0), chunk=4)
    jhs, jh_t = jrec.chunked_diag_recurrence(a, b, h0, chunk=4)
    rhs, rh_t = jrec.diag_recurrence_ref(a, b, h0)
    for got, want, what in ((hs, jhs, "hs"), (h_t, jh_t, "hT"),
                            (hs, rhs, "hs vs oracle"), (h_t, rh_t, "hT vs oracle")):
        close(got, want, f"diag T={tt} {what}")
    ohs, oh_t = recurrence.diag_recurrence_ref(t(a), t(b), t(h0))
    close(ohs, rhs, "oracle hs")
    close(oh_t, rh_t, "oracle hT")


def test_diag_recurrence_is_stable_over_a_long_chunk():
    """RG-LRU's decays over a 256-step chunk and a second, padded chunk: the
    log-depth scan keeps recent terms that a one-shot cumsum would swamp."""
    rng = np.random.default_rng(6)
    lam = rng.uniform(0.9, 0.999, size=8)
    log_a = -8.0 * np.log1p(np.exp(np.log(np.expm1(-np.log(lam) / 8.0))))
    r = rng.uniform(size=(300, 2, 8))
    a = np.exp(log_a * r).astype(np.float32)
    b = rng.normal(size=(300, 2, 8)).astype(np.float32)
    h0 = np.zeros((2, 8), np.float32)
    hs, h_t = recurrence.chunked_diag_recurrence(t(a), t(b), t(h0), chunk=256)
    rhs, rh_t = jrec.diag_recurrence_ref(a, b, h0)
    close(hs, rhs, "long chunk hs")
    close(h_t, rh_t, "long chunk hT")


def matrix_inputs(seed, tt, b=2, h=2, dk=4, dv=5):
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(size=(tt, b, h, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(tt, b, h, dv)).astype(np.float32)
    w = np.exp(-np.exp(rng.normal(-1.0, 1.0, size=(tt, b, h, dk)))).astype(np.float32)
    u = rng.uniform(0, 0.5, size=(h, dk)).astype(np.float32)
    s0 = rng.normal(size=(b, h, dk, dv)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("tt", [8, 11, 3])
def test_matrix_recurrence_matches_reference(tt):
    inputs = matrix_inputs(7, tt)
    o, s_t = recurrence.chunked_matrix_recurrence(*map(t, inputs), chunk=4)
    jo, js_t = jrec.chunked_matrix_recurrence(*inputs, chunk=4)
    ro, rs_t = jrec.matrix_recurrence_ref(*inputs)
    for got, want, what in ((o, jo, "o"), (s_t, js_t, "sT"),
                            (o, ro, "o vs oracle"), (s_t, rs_t, "sT vs oracle")):
        close(got, want, f"matrix T={tt} {what}")
    oo, os_t = recurrence.matrix_recurrence_ref(*map(t, inputs))
    close(oo, ro, "oracle o")
    close(os_t, rs_t, "oracle sT")


def test_matrix_recurrence_step_matches_reference():
    inputs = matrix_inputs(8, 1)
    r, k, v, w = (x[0] for x in inputs[:4])       # one step: drop the T axis
    u, s0 = inputs[4:]
    o, s = recurrence.matrix_recurrence_step(*map(t, (r, k, v, w, u, s0)))
    jo, js = jrec.matrix_recurrence_step(r, k, v, w, u, s0)
    close(o, jo, "step o")
    close(s, js, "step s")
    # bf16 inputs: o comes back in v's dtype, the state in float32
    o16, s16 = recurrence.matrix_recurrence_step(
        *(t(x).to(torch.bfloat16) for x in (r, k, v, w, u)), t(s0))
    assert o16.dtype == torch.bfloat16 and s16.dtype == torch.float32


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

D, DFF, H, DH = 32, 48, 2, 16


@pytest.fixture(scope="module")
def rwkv_pair():
    jp = reference(jrwkv.init_rwkv_block(jax.random.key(9), D, DFF, H, DH), 9)
    return jp, load(rwkv6.RWKVBlock(D, DFF, H, DH), jp)


def test_group_norm_matches_reference(rwkv_pair):
    jp, p = rwkv_pair
    x = np.random.default_rng(10).normal(size=(3, 5, H, DH)).astype(np.float32) * 2
    close(rwkv6._group_norm(p.rwkv["tm"].out_norm, t(x)),
          jrwkv._group_norm(jp["rwkv"]["tm"]["out_norm"], x), "group norm")


def rwkv_state(seed, b=2):
    rng = np.random.default_rng(seed)
    return {"tm_shift": rng.normal(size=(b, D)).astype(np.float32),
            "cm_shift": rng.normal(size=(b, D)).astype(np.float32),
            "wkv": rng.normal(size=(b, H, DH, DH)).astype(np.float32)}


@pytest.mark.parametrize("tt", [8, 7])
def test_timemix_and_channelmix_seq_match_reference(rwkv_pair, tt):
    jp, p = rwkv_pair
    x = np.random.default_rng(11).normal(size=(2, tt, D)).astype(np.float32)
    st = rwkv_state(12)
    out, (last, s_t) = rwkv6.timemix_seq(
        p.rwkv["tm"], t(x), t(st["tm_shift"]), t(st["wkv"]), n_heads=H,
        head_dim=DH, chunk=4)
    jout, (jlast, js_t) = jrwkv.timemix_seq(
        jp["rwkv"]["tm"], x, st["tm_shift"], st["wkv"], n_heads=H,
        head_dim=DH, chunk=4, policy=POLICY)
    close(out, jout, "timemix_seq")
    close(last, jlast, "timemix_seq shift")
    close(s_t, js_t, "timemix_seq wkv")
    out, last = rwkv6.channelmix_seq(p.rwkv["cm"], t(x), t(st["cm_shift"]))
    jout, jlast = jrwkv.channelmix_seq(jp["rwkv"]["cm"], x, st["cm_shift"])
    close(out, jout, "channelmix_seq")
    close(last, jlast, "channelmix_seq shift")
    state = {k: t(v) for k, v in st.items()}
    out, new = rwkv6.rwkv_block_seq(p, t(x), state, n_heads=H, head_dim=DH,
                                    chunk=4)
    jout, jnew = jrwkv.rwkv_block_seq(jp, x, st, n_heads=H, head_dim=DH,
                                      chunk=4, policy=POLICY)
    close(out, jout, "rwkv_block_seq")
    for name in st:
        close(new[name], jnew[name], f"rwkv_block_seq {name}")


def test_timemix_and_channelmix_step_match_reference(rwkv_pair):
    jp, p = rwkv_pair
    x = np.random.default_rng(13).normal(size=(2, D)).astype(np.float32)
    st = rwkv_state(14)
    out, (last, s) = rwkv6.timemix_step(p.rwkv["tm"], t(x), t(st["tm_shift"]),
                                        t(st["wkv"]), n_heads=H, head_dim=DH)
    jout, (jlast, js) = jrwkv.timemix_step(jp["rwkv"]["tm"], x, st["tm_shift"],
                                           st["wkv"], n_heads=H, head_dim=DH)
    close(out, jout, "timemix_step")
    close(s, js, "timemix_step wkv")
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    out, last = rwkv6.channelmix_step(p.rwkv["cm"], t(x), t(st["cm_shift"]))
    jout, _ = jrwkv.channelmix_step(jp["rwkv"]["cm"], x, st["cm_shift"])
    close(out, jout, "channelmix_step")
    state = {k: t(v) for k, v in st.items()}
    out, new = rwkv6.rwkv_block_step(p, t(x), state, n_heads=H, head_dim=DH)
    jout, jnew = jrwkv.rwkv_block_step(jp, x, st, n_heads=H, head_dim=DH,
                                       policy=POLICY)
    close(out, jout, "rwkv_block_step")
    for name in st:
        close(new[name], jnew[name], f"rwkv_block_step {name}")


def test_rwkv_state_dtypes_match_reference():
    """An empty state keeps the shifts in bf16 whatever the compute dtype."""
    got = rwkv6.init_rwkv_state(3, D, H, DH)
    want = jrwkv.init_rwkv_state(3, D, H, DH)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(w.dtype), name
        assert not got[name].any()


# ---------------------------------------------------------------------------
# Griffin
# ---------------------------------------------------------------------------

DR = 24


@pytest.fixture(scope="module")
def griffin_pair():
    jp = reference(jgriffin.init_recurrent_block(jax.random.key(15), D, DR), 15)
    return jp, load(griffin.RecurrentBlock(D, DR), jp)


def griffin_state(seed, b=2):
    rng = np.random.default_rng(seed)
    return {"conv": rng.normal(size=(b, 3, DR)).astype(np.float32),
            "h": rng.normal(size=(b, DR)).astype(np.float32)}


@pytest.mark.parametrize("tt", [8, 7, 2])
def test_recurrent_block_seq_matches_reference(griffin_pair, tt):
    """Chunk 4: lengths that do and do not divide it, and one shorter than
    the conv's history."""
    jp, p = griffin_pair
    x = np.random.default_rng(16).normal(size=(2, tt, D)).astype(np.float32)
    st = griffin_state(17)
    out, new = griffin.recurrent_block_seq(
        p, t(x), {k: t(v) for k, v in st.items()}, chunk=4)
    jout, jnew = jgriffin.recurrent_block_seq(jp, x, st, chunk=4,
                                              policy=POLICY)
    close(out, jout, "recurrent_block_seq")
    for name in st:
        assert new[name].dtype == torch.float32
        close(new[name], jnew[name], f"recurrent_block_seq {name}")


def test_recurrent_block_step_matches_reference(griffin_pair):
    jp, p = griffin_pair
    x = np.random.default_rng(18).normal(size=(2, D)).astype(np.float32)
    st = griffin_state(19)
    out, new = griffin.recurrent_block_step(p, t(x),
                                            {k: t(v) for k, v in st.items()})
    jout, jnew = jgriffin.recurrent_block_step(jp, x, st, policy=POLICY)
    close(out, jout, "recurrent_block_step")
    for name in st:
        close(new[name], jnew[name], f"recurrent_block_step {name}")
    got = griffin.init_griffin_state(3, DR)
    for name, w in jgriffin.init_griffin_state(3, DR).items():
        assert tuple(got[name].shape) == w.shape
        assert str(got[name].dtype).split(".")[-1] == str(w.dtype)
