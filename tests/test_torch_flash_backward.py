"""The port's flash attention backward (K4's plain version and the
``FlashAttention`` autograd Function) against the JAX package's.

Same seeded numpy q, k, v and output cotangent through both: the gradients
of ``sum(o * w)`` through the port's ``"flash"`` backend (on CPU tensors the
wrappers compute the kernels' plain versions) against ``jax.grad`` through
JAX ``flash_attention`` in Pallas interpret mode and through
``xla_attention``; and ``flash_bwd_plain`` against the JAX ``_flash_bwd``
kernels themselves. For ``xla_attention`` the cotangent is zero on rows with
no live key, where the plain backend gives a uniform softmax and the flash
kernels zeros. All in fp32 with ``atol=1e-5``: the sums run in another
order, nothing else differs.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.transformer.attention import xla_attention as jax_xla_attention
from deepspeed_tpu_torch.ops.cuda import LAUNCHES
from deepspeed_tpu_torch.ops.cuda import flash_attention as port_flash
from deepspeed_tpu_torch.ops.transformer.attention import dot_product_attention

jax_flash = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")

ATOL = 1e-5

CASES = [
    dict(lq=32, lk=32, causal=True),
    dict(lq=32, lk=32, causal=False),
    dict(lq=16, lk=48, causal=True),  # lq < lk: offset lk - lq
    dict(lq=32, lk=32, causal=False, kv_lengths=[32, 9, 0]),  # zero-length and ragged rows
    dict(lq=32, lk=32, causal=True, kv_lengths=[32, 20, 5]),
    dict(lq=48, lk=48, causal=True, window=8),
]


def _ids(case):
    return "-".join(f"{k}={v}" for k, v in case.items())


def _inputs(seed, b, lq, lk, h=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, lk, h, d), dtype=np.float32)
    v = rng.standard_normal((b, lk, h, d), dtype=np.float32)
    w = rng.standard_normal((b, lq, h, d), dtype=np.float32)
    return q, k, v, w


def _live_rows(case, b):
    lq, lk = case["lq"], case["lk"]
    q_pos = np.arange(lq)[:, None] + (lk - lq)
    k_pos = np.arange(lk)[None, :]
    valid = np.ones((lq, lk), bool)
    if case["causal"]:
        valid &= k_pos <= q_pos
    if case.get("window") is not None:
        valid &= k_pos > q_pos - case["window"]
    valid = np.broadcast_to(valid, (b, lq, lk)).copy()
    if case.get("kv_lengths") is not None:
        valid &= k_pos[None] < np.asarray(case["kv_lengths"])[:, None, None]
    return valid.any(-1)  # [B, Lq]


def _port_grads(q, k, v, w, **kw):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    lens = kw.pop("kv_lengths", None)
    if lens is not None:
        kw["kv_lengths"] = torch.tensor(lens, dtype=torch.int32)
    o = dot_product_attention(qt, kt, vt, backend="flash", **kw)
    (o * torch.from_numpy(w)).sum().backward()
    return [x.grad.numpy() for x in (qt, kt, vt)]


def _jax_grads(fn, q, k, v, w):
    def loss(q_, k_, v_):
        return jnp.sum(fn(q_, k_, v_) * jnp.asarray(w))
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]


def _jax_kwargs(case):
    kw = {k: v for k, v in case.items() if k not in ("lq", "lk")}
    if kw.get("kv_lengths") is not None:
        kw["kv_lengths"] = jnp.asarray(kw["kv_lengths"], jnp.int32)
    return kw


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_autograd_matches_jax_flash_and_xla(case):
    b = 3
    q, k, v, w = _inputs(0, b, case["lq"], case["lk"])
    w = w * _live_rows(case, b)[..., None, None]  # no cotangent on rows with no live key
    before = dict(LAUNCHES)
    got = _port_grads(q, k, v, w, **{key: val for key, val in case.items() if key not in ("lq", "lk")})
    assert LAUNCHES == before, "the plain versions on CPU tensors count no kernel launch"
    jkw = _jax_kwargs(case)
    ref_flash = _jax_grads(lambda *a: jax_flash.flash_attention(*a, interpret=True, **jkw), q, k, v, w)
    ref_xla = _jax_grads(lambda *a: jax_xla_attention(*a, **jkw), q, k, v, w)
    for name, g, rf, rx in zip("qkv", got, ref_flash, ref_xla):
        assert np.all(np.isfinite(g)), name
        np.testing.assert_allclose(g, rf, atol=ATOL, rtol=0, err_msg=f"d{name} vs JAX flash")
        np.testing.assert_allclose(g, rx, atol=ATOL, rtol=0, err_msg=f"d{name} vs JAX xla")


def test_fully_masked_rows_have_zero_finite_gradients():
    """A sequence of length 0 has no live key anywhere: its output is zero,
    and so are its gradients (lse = NEG_INF/2 makes p exactly 0)."""
    q, k, v, w = _inputs(1, 2, 32, 32)
    dq, dk, dv = _port_grads(q, k, v, w, causal=False, kv_lengths=[17, 0])
    for g in (dq, dk, dv):
        assert np.all(np.isfinite(g))
        assert np.all(g[1] == 0.0)
    assert np.all(dk[0, 17:] == 0.0) and np.all(dv[0, 17:] == 0.0)  # keys past the length
    assert np.abs(dq[0]).max() > 0


def test_recompute_policy_equals_lse():
    q, k, v, w = _inputs(2, 2, 48, 48)
    kw = dict(causal=True, window=20, kv_lengths=[48, 30])
    grads = {}
    for policy in port_flash.POLICIES:
        grads[policy] = _port_grads(q, k, v, w, policy=policy, **kw)
    for a, b in zip(grads["lse"], grads["recompute"]):
        np.testing.assert_array_equal(a, b)


def test_recompute_policy_saves_no_lse():
    q, k, v, _ = (torch.from_numpy(x).requires_grad_() for x in _inputs(3, 1, 8, 8))
    saved = {}
    for policy in port_flash.POLICIES:
        o = port_flash.FlashAttention.apply(q, k, v, None, 0.25, True, None, policy)
        saved[policy] = [t is not None for t in o.grad_fn.saved_tensors]
    assert saved["lse"] == [True] * 5 + [False] and saved["recompute"] == [True] * 4 + [False, False]


def test_unknown_policy_raises():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(4, 1, 8, 8))
    with pytest.raises(ValueError, match="policy"):
        dot_product_attention(q, k, v, backend="flash", policy="stash")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flash_bwd_plain_matches_jax_kernels(case):
    """K4's plain version against the JAX dq and dk/dv Pallas kernels on
    the forward residuals (o, lse) of the JAX forward kernel."""
    b, lq, lk = 3, case["lq"], case["lk"]
    q, k, v, do = _inputs(5, b, lq, lk)
    jkw = _jax_kwargs(case)
    lens = jkw.get("kv_lengths")
    scale = 16**-0.5
    bhld = [jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v, do)]
    o, lse = jax_flash._flash_fwd(*bhld[:3], scale, case["causal"], 16, 16, True,
                                  kv_lengths=lens, window=case.get("window"))
    ref = jax_flash._flash_bwd((*bhld[:3], o, lse, lens), bhld[3], scale, case["causal"], 16, 16,
                               True, window=case.get("window"))[:3]
    o_t = torch.from_numpy(np.asarray(o).transpose(0, 2, 1, 3).copy())
    got = port_flash.flash_bwd_plain(
        *map(torch.from_numpy, (q, k, v)), o_t, torch.from_numpy(np.array(lse)),
        torch.from_numpy(do), scale=scale, causal=case["causal"],
        kv_lengths=None if lens is None else torch.tensor(case["kv_lengths"], dtype=torch.int32),
        window=case.get("window"))
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r).transpose(0, 2, 1, 3), atol=ATOL, rtol=0,
                                   err_msg=f"d{name}")
