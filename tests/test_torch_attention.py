"""The PyTorch port's attention against the JAX package's.

Same seeded numpy inputs through both: the port's plain attention against
JAX ``xla_attention``, and the port's ``"flash"`` backend (on CPU tensors
its wrappers compute the kernels' plain versions) against JAX
``flash_attention`` / ``flash_decode`` in Pallas interpret mode and against
``xla_attention`` on the rows that have a live key. Rows with no live key
are zeros in both flash versions and a uniform softmax in ``xla_attention``.
All in fp32 with ``atol=1e-5``.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.pallas import attention_geometry as jax_geometry
from deepspeed_tpu.ops.transformer.attention import xla_attention as jax_xla_attention
from deepspeed_tpu_torch.ops.cuda import LAUNCHES
from deepspeed_tpu_torch.ops.cuda import attention_geometry
from deepspeed_tpu_torch.ops.cuda import flash_attention as port_flash
from deepspeed_tpu_torch.ops.transformer.attention import dot_product_attention, xla_attention

# the package re-exports a function of the same name; the module is what is wanted
jax_flash = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")

ATOL = 1e-5


def _qkv(seed, b, lq, lk, h=2, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, lq, h, d), dtype=np.float32),
            rng.standard_normal((b, lk, h, d), dtype=np.float32),
            rng.standard_normal((b, lk, h, d), dtype=np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


XLA_CASES = [
    dict(lq=8, lk=8, causal=True),
    dict(lq=8, lk=8, causal=False),
    dict(lq=4, lk=12, causal=True),  # kv-cache offset lk - lq
    dict(lq=8, lk=8, causal=False, kv_lengths=[8, 3, 0]),
    dict(lq=12, lk=12, causal=True, window=4),
    dict(lq=3, lk=10, causal=True, decode_lengths=[3, 0, 7]),   # multi-token append, length 0
    dict(lq=2, lk=10, causal=True, decode_lengths=[12, 1, 5]),  # parked length > P
]


@pytest.mark.parametrize("case", XLA_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_plain_attention_matches_jax_xla(case):
    case = dict(case)
    q, k, v = _qkv(0, 3, case.pop("lq"), case.pop("lk"))
    kw = {key: (np.asarray(val, np.int32) if isinstance(val, list) else val)
          for key, val in case.items()}
    ref = jax_xla_attention(*_j(q, k, v), **{k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_)
                                             for k_, v_ in kw.items()})
    out = xla_attention(*_t(q, k, v), **{k_: (torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_)
                                         for k_, v_ in kw.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


FLASH_CASES = [
    dict(lq=32, lk=32, causal=True),
    dict(lq=32, lk=32, causal=False),
    dict(lq=16, lk=48, causal=True),  # offset lk - lq
    dict(lq=32, lk=32, causal=False, kv_lengths=[32, 9, 0]),  # length 0: no live key at all
    dict(lq=32, lk=32, causal=True, kv_lengths=[32, 20, 5]),
    dict(lq=48, lk=48, causal=True, window=8),
]


def _flash_live_rows(case, b, lq, lk):
    """[B, Lq] mask of query rows that have at least one live key."""
    q_pos = np.arange(lq)[:, None] + (lk - lq)
    k_pos = np.arange(lk)[None, :]
    valid = np.ones((lq, lk), bool)
    if case.get("causal", True):
        valid &= k_pos <= q_pos
    if case.get("window") is not None:
        valid &= k_pos > q_pos - case["window"]
    valid = np.broadcast_to(valid, (b, lq, lk)).copy()
    if case.get("kv_lengths") is not None:
        valid &= k_pos[None] < np.asarray(case["kv_lengths"])[:, None, None]
    return valid.any(-1)


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_flash_forward_matches_jax_flash_and_xla(case):
    case = dict(case)
    lq, lk = case.pop("lq"), case.pop("lk")
    q, k, v = _qkv(1, 3, lq, lk)
    lens = case.get("kv_lengths")
    jkw = dict(case, kv_lengths=None if lens is None else jnp.asarray(lens, jnp.int32))
    tkw = dict(case, kv_lengths=None if lens is None else torch.tensor(lens, dtype=torch.int32))
    before = dict(LAUNCHES)
    out = dot_product_attention(*_t(q, k, v), backend="flash", **tkw).numpy()
    assert LAUNCHES == before, "the plain version on CPU tensors counts no kernel launch"
    ref_flash = np.asarray(jax_flash.flash_attention(*_j(q, k, v), interpret=True, **jkw))
    np.testing.assert_allclose(out, ref_flash, atol=ATOL, rtol=0)
    live = _flash_live_rows(case, 3, lq, lk)
    ref_xla = np.asarray(jax_xla_attention(*_j(q, k, v), **jkw))
    np.testing.assert_allclose(out[live], ref_xla[live], atol=ATOL, rtol=0)
    assert np.all(out[~live] == 0.0)


@pytest.mark.parametrize("case", [dict(causal=True), dict(causal=False, kv_lengths=[32, 0]),
                                  dict(causal=True, window=8)],
                         ids=["causal", "kv_lengths", "window"])
def test_flash_forward_lse_matches_jax_kernel(case):
    """The log-sum-exp residual, including NEG_INF/2 on rows with no live key."""
    q, k, v = _qkv(2, 2, 32, 32)
    lens = case.get("kv_lengths")
    _, lse = port_flash.flash_fwd(*_t(q, k, v), scale=16**-0.5, causal=case["causal"],
                                  kv_lengths=None if lens is None else torch.tensor(lens, dtype=torch.int32),
                                  window=case.get("window"))
    bhld = [jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)]
    _, ref = jax_flash._flash_fwd(*bhld, 16**-0.5, case["causal"], 16, 16, True,
                                  kv_lengths=None if lens is None else jnp.asarray(lens, jnp.int32),
                                  window=case.get("window"))
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-6)


DECODE_CASES = [
    dict(lq=1, lengths=[1, 5, 32, 17]),
    dict(lq=4, lengths=[4, 9, 32, 20]),        # multi-token append
    dict(lq=4, lengths=[0, 2, 3, 30]),         # length 0; rows with position < 0
    dict(lq=1, lengths=[33, 32 + 1, 7, 1]),    # parked: length > P
    dict(lq=4, lengths=[36, 11, 0, 4]),        # parked with Lq = 4 (P + Lq)
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: f"lq={c['lq']}-lengths={c['lengths']}")
def test_flash_decode_matches_jax_decode_and_xla(case):
    lq, lengths = case["lq"], case["lengths"]
    p_len = 32
    q, k, v = _qkv(3, len(lengths), lq, p_len)
    out = dot_product_attention(*_t(q, k, v), backend="flash", causal=False,
                                decode_lengths=torch.tensor(lengths, dtype=torch.int32)).numpy()
    jlens = jnp.asarray(lengths, jnp.int32)
    ref_kernel = np.asarray(jax_flash.flash_decode(*_j(q, k, v), jlens, interpret=True))
    np.testing.assert_allclose(out, ref_kernel, atol=ATOL, rtol=0)
    q_pos = np.asarray(lengths)[:, None] - lq + np.arange(lq)[None, :]
    live = q_pos >= 0
    ref_xla = np.asarray(jax_xla_attention(*_j(q, k, v), causal=False, decode_lengths=jlens))
    np.testing.assert_allclose(out[live], ref_xla[live], atol=ATOL, rtol=0)
    assert np.all(out[~live] == 0.0)


@pytest.mark.parametrize("bad", ["bias", "mask", "dropout", "causal_lq_gt_lk"])
def test_flash_backend_refuses_what_the_kernel_does_not_compute(bad):
    q, k, v = _t(*_qkv(4, 1, 8, 8))
    kwargs = {"bias": dict(bias=torch.zeros(1, 2, 8, 8)),
              "mask": dict(mask=torch.ones(1, 1, 8, 8, dtype=torch.bool)),
              "dropout": dict(dropout_rate=0.1, generator=torch.Generator().manual_seed(0)),
              "causal_lq_gt_lk": {}}[bad]
    if bad == "causal_lq_gt_lk":
        k, v = k[:, :4], v[:, :4]
    with pytest.raises(ValueError):
        dot_product_attention(q, k, v, backend="flash", causal=True, **kwargs)


def test_unknown_backend_raises():
    q, k, v = _t(*_qkv(5, 1, 4, 4))
    with pytest.raises(ValueError, match="unknown attention backend"):
        dot_product_attention(q, k, v, backend="nope")


@pytest.mark.parametrize("length,preferred", [(1024, 512), (48, 512), (96, 64), (7, 512), (384, 256)])
def test_pick_block_matches_jax(length, preferred):
    assert attention_geometry.pick_block(length, preferred) == jax_geometry.pick_block(length, preferred)
