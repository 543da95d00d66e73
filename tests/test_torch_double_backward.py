"""Second derivatives through the port's ``torch.autograd.Function``\\ s
against the JAX package's ``custom_vjp``\\ s.

A Hessian-vector product (``jvp`` of ``grad``) through a JAX ``custom_vjp``
differentiates its backward rule: through a Pallas kernel (K1/K4's flash
attention, K6's block-sparse attention, K5's row permutation, run here in
interpret mode) it raises, since ``pallas_call`` has no forward-mode rule.
The port's ``FlashAttention``, ``SparseAttention`` and ``PermuteRows``
must raise on a second derivative too, on the CPU where their plain
versions run inside them, and not return an HVP with the kernel's own
terms missing. Each case first establishes what JAX does at the same call
(fp32). Where JAX computes an HVP, the port's (reverse over reverse)
matches it within 1e-6 of the largest entry, both sides fed fp64: the fused
LM head (its ``custom_vjp`` backward is plain ``jnp``, and so is
``_FusedLMHeadLoss``'s), the plain ``"xla"`` attention, the plain
permutation and the unfused head. Both attentions keep their logits and
softmax in fp32 whatever the input dtype, so their inputs are drawn at std
0.5: at std 1 the sharper softmax leaves the two HVPs 3.2e-6 apart (fp32
sums in another order), at 0.5 1.8e-7.

``_StreamIn`` (``offload_param``'s copy in) raises on a second derivative
as well, where JAX's ``stream_in`` (an identity backward) gives one: its
backward adds into the flat gradient buffer outside the graph (a deliberate
difference, ``ROADMAP.md`` Queue C).
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.models.common import fused_lm_head_loss as jax_fused_loss
from deepspeed_tpu.models.gpt2 import cross_entropy_loss as jax_cross_entropy
from deepspeed_tpu.ops.pallas import moe_dispatch as jax_md
from deepspeed_tpu.ops.transformer.attention import xla_attention as jax_xla_attention
import deepspeed_tpu.ops.sparse_attention as jax_sparse
from deepspeed_tpu_torch.models.common import fused_lm_head_loss
from deepspeed_tpu_torch.models.gpt2 import cross_entropy_loss
from deepspeed_tpu_torch.ops.cuda import moe_dispatch as md
from deepspeed_tpu_torch.ops.sparse_attention import sparse_attention
from deepspeed_tpu_torch.ops.transformer.attention import dot_product_attention

jax_flash = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")

HVP_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _attn_inputs(dtype):
    rng = np.random.default_rng(0)
    return (0.5 * rng.standard_normal((1, 32, 2, 16))).astype(dtype)


def _perm_maps():
    rng = np.random.default_rng(1)
    fwd = rng.permutation(12)[:8].reshape(1, 8).astype(np.int64)
    bwd = np.array(jax_md.inverse_index(jnp.asarray(fwd), 12))
    return fwd, bwd


PERM_MAPS = _perm_maps()  # built outside any trace (the JAX losses are jitted)


def _head_inputs(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 16)).astype(dtype)
    w = (0.1 * rng.standard_normal((40, 16))).astype(dtype)
    labels = rng.integers(0, 40, (2, 9))
    return x, w, labels


def _layout():
    return jax_sparse.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=1,
                                          attention="unidirectional").make_layout(32)


# name -> (input maker, JAX loss of x, port loss of x)
CASES = {
    "flash attention (K1/K4)": (
        _attn_inputs,
        lambda x: jnp.sum(jax_flash.flash_attention(x, x, x, causal=True, interpret=True) ** 2),
        lambda x: (dot_product_attention(x, x, x, backend="flash", causal=True) ** 2).sum()),
    "block-sparse attention (K6)": (
        _attn_inputs,
        lambda x: jnp.sum(jax_sparse.sparse_attention(x, x, x, _layout(), 16, causal=True,
                                                      interpret=True) ** 2),
        lambda x: (sparse_attention(x, x, x, _layout(), 16, causal=True) ** 2).sum()),
    "row permutation (K5)": (
        lambda dtype: np.random.default_rng(3).standard_normal((1, 12, 8)).astype(dtype),
        lambda x: jnp.sum(jax_md.permute_rows(x, *map(jnp.asarray, PERM_MAPS), impl="pallas",
                                              interpret=True) ** 3),
        lambda x: (md.permute_rows(x, *map(torch.from_numpy, PERM_MAPS), impl="pallas")
                   ** 3).sum()),
}

# the cases through which JAX computes an HVP
PLAIN_CASES = {
    "fused LM head": (
        lambda dtype: _head_inputs(dtype)[0],
        lambda x: jax_fused_loss(x, jnp.asarray(_head_inputs(np.float64)[1]),
                                 jnp.asarray(_head_inputs(np.float64)[2]), chunk=8),
        lambda x: fused_lm_head_loss(x, torch.from_numpy(_head_inputs(np.float64)[1]),
                                     torch.from_numpy(_head_inputs(np.float64)[2]), chunk=8)),
    "xla attention": (
        _attn_inputs,
        lambda x: jnp.sum(jax_xla_attention(x, x, x, causal=True) ** 2),
        lambda x: (dot_product_attention(x, x, x, backend="xla", causal=True) ** 2).sum()),
    "row permutation, plain gather": (
        lambda dtype: np.random.default_rng(3).standard_normal((1, 12, 8)).astype(dtype),
        lambda x: jnp.sum(jax_md.permute_rows(x, *map(jnp.asarray, PERM_MAPS), impl="xla") ** 3),
        lambda x: (md.permute_rows(x, *map(torch.from_numpy, PERM_MAPS), impl="xla") ** 3).sum()),
    "unfused LM head": (
        lambda dtype: _head_inputs(dtype)[0],
        lambda x: jax_cross_entropy(x @ jnp.asarray(_head_inputs(np.float64)[1]).T,
                                    jnp.asarray(_head_inputs(np.float64)[2])),
        lambda x: cross_entropy_loss(x @ torch.from_numpy(_head_inputs(np.float64)[1]).t(),
                                     torch.from_numpy(_head_inputs(np.float64)[2]))),
}


def _jax_hvp(loss, x, v):
    return jax.jit(lambda a, t: jax.jvp(jax.grad(loss), (a,), (t,))[1])(jnp.asarray(x), jnp.asarray(v))


def _port_hvp(loss, x, v):
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(loss(xt), xt, create_graph=True)
    (hv,) = torch.autograd.grad(g, xt, torch.from_numpy(v))
    return hv.numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_second_derivative_raises_as_jax(case):
    make, jax_loss, port_loss = CASES[case]
    x = make(np.float32)
    v = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    with pytest.raises(Exception):  # JAX: no jvp through a custom_vjp
        _jax_hvp(jax_loss, x, v)
    # the first derivative still works, and agrees with JAX's
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(port_loss(xt), xt)
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.jit(jax.grad(jax_loss))(jnp.asarray(x))),
                               atol=1e-4, rtol=1e-4)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        _port_hvp(port_loss, x, v)


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_plain_hvp_matches_jax(case):
    make, jax_loss, port_loss = PLAIN_CASES[case]
    x = make(np.float64)
    v = np.random.default_rng(9).standard_normal(x.shape)
    with jax.enable_x64(True):
        want = np.asarray(_jax_hvp(jax_loss, x, v))
    assert want.dtype == np.float64
    got = _port_hvp(port_loss, x, v)
    np.testing.assert_allclose(got, want, rtol=0, atol=HVP_RTOL * np.abs(want).max())
