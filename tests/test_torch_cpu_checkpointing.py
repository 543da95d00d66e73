"""``activation_checkpointing.cpu_checkpointing`` of the port against the
JAX package's.

JAX applies it in the user-facing ``checkpoint()`` when no remat policy is
configured: the outputs of products with no batch dims go to pinned host
memory, the rest is recomputed (``offload_dot_with_no_batch_dims``). The
port keeps ``aten.mm``/``addmm`` outputs in a host cache of its own
(dispatch modes around the forward and the recompute). Here, over a stack
of four blocks with products with and without batch dims (fp32):

- the gradients bit-equal to ``checkpoint()`` without it (full recompute)
  and within 1e-5 of max |g| of JAX's ``checkpoint()`` with it;
- the recompute really takes the products from the host: every one is
  counted, the recompute reads them in order, and a host copy changed by
  hand changes the gradients;
- a remat policy wins over it, and the models' remat ignores it (the engine
  trains bit-equal with and without it and offloads nothing), as in JAX;
- the config block takes it.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jax_ck
import deepspeed_tpu_torch
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ck
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    ck.reset()
    jax_ck.reset()


JAX_RTOL = 1e-5
N_BLOCKS = 4


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    ws = [(0.3 * rng.standard_normal((16, 16))).astype(np.float32) for _ in range(2 * N_BLOCKS)]
    return x, ws


def _port_block(x, w1, w2):
    """Two products with no batch dims (``@ w``) and two with (h h^T h)."""
    h = torch.tanh(x @ w1)
    a = torch.bmm(torch.bmm(h, h.transpose(1, 2)), h) / 16.0
    return x + torch.tanh(a) @ w2


def _jax_block(x, w1, w2):
    h = jnp.tanh(x @ w1)
    a = jnp.matmul(jnp.matmul(h, jnp.swapaxes(h, 1, 2)), h) / 16.0
    return x + jnp.tanh(a) @ w2


def _port_grads(cpu: bool, policy=None, corrupt=None):
    ck.reset()
    ck.configure(checkpoint_in_cpu=cpu, policy=policy)
    x, ws = _inputs()
    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    h = xt
    for i in range(N_BLOCKS):
        h = ck.checkpoint(_port_block, h, wt[2 * i], wt[2 * i + 1])
    if corrupt is not None:
        corrupt()
    (h * h).sum().backward()
    return [t.grad.clone() for t in [xt] + wt]


def test_gradients_bit_equal_recompute_and_match_jax():
    before = dict(ck.OFFLOADED)
    got = _port_grads(cpu=True)
    assert ck.OFFLOADED["products"] - before["products"] == 2 * N_BLOCKS
    assert ck.OFFLOADED["bytes"] - before["bytes"] == 2 * N_BLOCKS * 2 * 6 * 16 * 4
    want = _port_grads(cpu=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    kept = _port_grads(False, "dots_with_no_batch_dims_saveable")  # the products kept on the card
    assert all(torch.equal(a, b) for a, b in zip(got, kept))

    jax_ck.reset()
    jax_ck.configure(checkpoint_in_cpu=True)
    x, ws = _inputs()

    def loss(x_, *ws_):
        h = x_
        for i in range(N_BLOCKS):
            h = jax_ck.checkpoint(_jax_block, h, ws_[2 * i], ws_[2 * i + 1])
        return jnp.sum(h * h)

    ref = jax.jit(jax.grad(loss, argnums=tuple(range(1 + len(ws)))))(jnp.asarray(x), *map(jnp.asarray, ws))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=JAX_RTOL * np.abs(r).max(), rtol=0)


def test_recompute_reads_the_host_copies(monkeypatch):
    queues = []
    real = ck.host_offload_contexts

    def spy():
        fwd, rec = real()
        queues.append(fwd.storage)
        return fwd, rec

    monkeypatch.setattr(ck, "host_offload_contexts", spy)

    def corrupt():
        host, _ = queues[0][0]
        host.add_(1.0)  # block 0's first product, as the recompute will read it

    changed = _port_grads(cpu=True, corrupt=corrupt)
    # the recompute reads each block's queue in order; torch stops it after
    # the last op the backward needs, before the block's second product,
    # whose output no backward reads (its copy is never taken back)
    assert len(queues) == N_BLOCKS and all(len(q) == 1 for q in queues)
    monkeypatch.undo()
    clean = _port_grads(cpu=True)
    assert not torch.equal(changed[1], clean[1])


def test_a_policy_wins_and_the_models_remat_ignores_it():
    before = dict(ck.OFFLOADED)
    _port_grads(cpu=True, policy="dots_saveable")
    assert ck.OFFLOADED == before
    ids = np.random.default_rng(1).integers(0, 256, (4, 32)).astype(np.int32)
    losses = {}
    for cpu in (False, True):
        ck.reset()
        config = {"train_batch_size": 4, "activation_checkpointing": {"cpu_checkpointing": cpu}}
        ck.configure(deepspeed_config=config)
        model = deepspeed_tpu_torch.GPT2LMHeadModel(
            deepspeed_tpu_torch.get_gpt2_config("test", remat=True), device="cpu")
        engine = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")[0]
        losses[cpu] = [float(engine.train_batch(ids)) for _ in range(2)]
    assert losses[True] == losses[False] and ck.OFFLOADED == before
    assert DeepSpeedConfig({"train_batch_size": 4, "activation_checkpointing": {
        "cpu_checkpointing": True}}).activation_checkpointing_config.cpu_checkpointing is True
