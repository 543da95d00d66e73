"""The port's chunked fused LM-head loss against the JAX package's and
against the dense head.

Same seeded numpy hidden states, LM-head weight and labels (with
``ignore_index`` tokens, and token counts that are not a multiple of the
chunk) through JAX ``fused_lm_head_loss`` and the port's, comparing the
value and the gradients with respect to x and the tied ``[V, E]`` W; and
the port's fused loss against its own dense ``cross_entropy_loss`` over
full logits. In fp32 with
``rtol=1e-5`` (value) and ``atol=1e-6`` (gradients of a mean over ~100
tokens, ~1e-3 in size): the sums run in another order, nothing else
differs. A bf16 case is held to 2e-2 of the largest gradient: both sides
round the logits and the softmax coefficients to bf16 at the same places,
but each framework's products round their fp32 sums on their own.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.models.common import fused_lm_head_loss as jax_fused_loss
from deepspeed_tpu.models.gpt2 import cross_entropy_loss as jax_cross_entropy
from deepspeed_tpu_torch.models.common import fused_head_loss_output, fused_lm_head_loss
from deepspeed_tpu_torch.models.gpt2 import cross_entropy_loss, get_gpt2_config


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


V, E = 96, 32


def _inputs(seed, b, t, ignore_frac=0.2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, E), dtype=np.float32)
    w = rng.standard_normal((V, E), dtype=np.float32) * 0.3
    labels = rng.integers(0, V, (b, t)).astype(np.int32)
    labels[rng.random((b, t)) < ignore_frac] = -100
    return x, w, labels


def _port(x, w, labels, dtype=torch.float32, **kw):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).to(dtype).requires_grad_()
    loss = fused_lm_head_loss(xt, wt, torch.from_numpy(labels), **kw)
    loss.backward()
    return loss.float().item(), xt.grad.float().numpy(), wt.grad.float().numpy()


def _jax(x, w, labels, dtype=jnp.float32, **kw):
    def f(x_, w_):
        return jax_fused_loss(x_.astype(dtype), w_.astype(dtype), jnp.asarray(labels), **kw)
    val, (gx, gw) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    return float(val), np.asarray(gx), np.asarray(gw)


@pytest.mark.parametrize("b,t,chunk", [(2, 37, 16), (3, 24, 24), (1, 50, 64), (2, 30, 7),
                                       (1, 1, 8)],
                         ids=["ragged-tail", "exact-chunks", "one-short-chunk", "many-chunks",
                              "one-token"])
def test_fused_loss_matches_jax(b, t, chunk):
    x, w, labels = _inputs(0, b, t)
    kw = dict(chunk=chunk)
    val, gx, gw = _port(x, w, labels, **kw)
    rval, rgx, rgw = _jax(x, w, labels, **kw)
    np.testing.assert_allclose(val, rval, rtol=1e-5)
    np.testing.assert_allclose(gx, rgx, atol=1e-6, rtol=0)
    np.testing.assert_allclose(gw, rgw, atol=1e-6, rtol=0)


def test_fused_loss_bf16_matches_jax():
    x, w, labels = _inputs(1, 2, 40)
    val, gx, gw = _port(x, w, labels, torch.bfloat16, chunk=16)
    rval, rgx, rgw = _jax(x, w, labels, jnp.bfloat16, chunk=16)
    np.testing.assert_allclose(val, rval, rtol=2e-2)
    for g, r in ((gx, rgx), (gw, rgw)):
        assert np.abs(g - r).max() <= 2e-2 * np.abs(r).max()


def test_fused_loss_matches_dense_cross_entropy():
    x, w, labels = _inputs(2, 2, 45)
    val, gx, gw = _port(x, w, labels, chunk=32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    dense = cross_entropy_loss(xt @ wt.t(), torch.from_numpy(labels))
    dense.backward()
    np.testing.assert_allclose(val, dense.item(), rtol=1e-5)
    np.testing.assert_allclose(gx, xt.grad.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(gw, wt.grad.numpy(), atol=1e-6, rtol=0)
    rdense = jax_cross_entropy(jnp.asarray(x) @ jnp.asarray(w).T, jnp.asarray(labels))
    np.testing.assert_allclose(dense.item(), float(rdense), rtol=1e-5)


def test_head_output_shifts_by_one_token():
    """``fused_head_loss_output`` scores x[:, t] against labels[:, t + 1]."""
    x, w, labels = _inputs(3, 2, 20, ignore_frac=0.0)
    cfg = get_gpt2_config("test", fused_head_loss_chunk=8)
    got = fused_head_loss_output(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(labels),
                                 cfg)
    want = cross_entropy_loss(torch.from_numpy(x[:, :-1] @ w.T), torch.from_numpy(labels[:, 1:]))
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)


def test_all_tokens_ignored_gives_zero_loss_and_gradients():
    x, w, labels = _inputs(4, 1, 10, ignore_frac=1.0)
    val, gx, gw = _port(x, w, labels, chunk=4)
    assert val == 0.0 and not gx.any() and not gw.any()
