"""Random-LTD of the port against the JAX package's.

- ``RandomLayerTokenDrop`` around a GPT-2 "test" block with JAX's kept
  positions injected (``sampled_indices``): the output within 1e-6 and the
  input and weight gradients within 1e-5 of JAX's (fp32; the port's block on
  the ``"flash"`` backend, whose plain versions run on the CPU, JAX's on
  ``"xla"``); the tokens that were not kept come through bit for bit, every
  token gets a gradient, and eval passes everything through the layer.
- ``RandomLTDScheduler``: JAX's ramp, ``consumed_layer_tokens`` and
  ``state_dict`` equal step for step.
- The ops: ``token_gather``/``token_scatter_`` equal to JAX's on the same
  indices and a round trip in both layouts, the gather's gradient, the
  samplers' shapes, order and distinctness, ``bert_sample_tokens``' mask.

The port draws its positions from a ``torch.Generator`` and JAX from
threefry, a deliberate difference: the tests inject JAX's draws.
"""

import numpy as np
import pytest

from flax.linen import unbox
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.models.gpt2 import Block as JaxBlock, get_gpt2_config as jax_config
from deepspeed_tpu.ops import random_ltd as jax_ltd
from deepspeed_tpu.runtime.data_pipeline.data_routing.basic_layer import (
    RandomLayerTokenDrop as JaxDrop)
from deepspeed_tpu.runtime.data_pipeline.data_routing.scheduler import (
    RandomLTDScheduler as JaxScheduler)
from deepspeed_tpu_torch.checkpoint.from_jax import _torch_key
from deepspeed_tpu_torch.models.common import flatten_tree
from deepspeed_tpu_torch.models.gpt2 import Block, get_gpt2_config
from deepspeed_tpu_torch.ops import random_ltd as port_ltd
from deepspeed_tpu_torch.runtime.data_pipeline import RandomLayerTokenDrop, RandomLTDScheduler


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FWD_ATOL = 1e-6
GRAD_ATOL = 1e-5
B, L, R = 2, 24, 10


def _jax_indices(seed=0):
    idx, _ = jax_ltd.gpt_sample_tokens(R, L, batch_size=B, rng=jax.random.PRNGKey(seed))
    return np.asarray(idx)[0]  # [B, R], sorted


@pytest.fixture(scope="module")
def jax_layer():
    """JAX's wrapped block: weights, output and gradients at JAX's draw."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, L, 64)).astype(np.float32)
    w = rng.standard_normal((B, L, 64)).astype(np.float32)
    idx = _jax_indices()
    layer = JaxDrop(layer=JaxBlock(jax_config("test", dropout=0.0)))
    params = layer.init({"params": jax.random.PRNGKey(1), "random_ltd": jax.random.PRNGKey(2)},
                        jnp.asarray(x), False, reserved_length=R)
    params = unbox(params)

    def run(p, xx):
        out = layer.apply(p, xx, False, reserved_length=R, sampled_indices=jnp.asarray(idx))
        return out[0] if isinstance(out, tuple) else out

    out = np.asarray(jax.jit(run)(params, jnp.asarray(x)))
    gp, gx = jax.jit(jax.grad(lambda p, xx: jnp.sum(run(p, xx) * jnp.asarray(w)), argnums=(0, 1)))(
        params, jnp.asarray(x))
    gp = unbox(gp)
    return dict(x=x, w=w, idx=idx, params=jax.device_get(params["params"]["layer"]), out=out,
                grad_x=np.asarray(gx), grad_params=flatten_tree(jax.device_get(gp["params"]["layer"]), "/"))


def _port_layer(params):
    block = Block(get_gpt2_config("test", dropout=0.0, attention_backend="flash"), torch.device("cpu"))
    sd = {_torch_key(path): torch.from_numpy(np.asarray(v)) for path, v in flatten_tree(params, "/").items()}
    block.load_state_dict(sd)
    return RandomLayerTokenDrop(block)


def test_layer_matches_jax_with_injected_indices(jax_layer):
    layer = _port_layer(jax_layer["params"])
    x = torch.from_numpy(jax_layer["x"]).requires_grad_()
    out, l_aux = layer(x, deterministic=False, reserved_length=R,
                       sampled_indices=torch.from_numpy(jax_layer["idx"]))
    assert l_aux is None
    np.testing.assert_allclose(out.detach().numpy(), jax_layer["out"], atol=FWD_ATOL, rtol=0)
    (out * torch.from_numpy(jax_layer["w"])).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), jax_layer["grad_x"], atol=GRAD_ATOL, rtol=0)
    grads = {n: p.grad.numpy() for n, p in layer.layer.named_parameters()}
    for path, g in jax_layer["grad_params"].items():
        np.testing.assert_allclose(grads[_torch_key(path)], np.asarray(g), atol=GRAD_ATOL, rtol=0,
                                   err_msg=path)
    # the tokens that were not kept come through bit for bit
    dropped = np.ones((B, L), bool)
    dropped[np.arange(B)[:, None], jax_layer["idx"]] = False
    assert torch.equal(out.detach()[torch.from_numpy(dropped)], x.detach()[torch.from_numpy(dropped)])
    assert bool((x.grad.abs().sum(-1) > 0).all())  # every token has a gradient


def test_drawn_positions_and_eval_pass_through(jax_layer):
    layer = _port_layer(jax_layer["params"])
    x = torch.from_numpy(jax_layer["x"])
    gen = torch.Generator().manual_seed(5)
    out, _ = layer(x, deterministic=False, reserved_length=R, generator=gen)
    changed = (out != x).any(-1).sum(-1)
    assert changed.tolist() == [R, R]
    full, _ = layer(x, deterministic=True, reserved_length=R)
    want, _ = layer.layer(x)
    assert torch.equal(full, want)


def _ltd_config(**extra):
    cfg = {"total_layer_num": 4, "random_ltd_layer_num": 2,
           "random_ltd_schedule": {"min_value": 16, "max_value": 64, "schedule_type": "fixed_linear",
                                   "schedule_config": {"require_steps": 8, "seq_per_step": 16}}}
    cfg.update(extra)
    return cfg


def test_scheduler_ramp_and_state_dict_equal_jax():
    port, ref = RandomLTDScheduler(_ltd_config(global_batch_size=4)), JaxScheduler(
        _ltd_config(global_batch_size=4))
    assert port.get_current_seq() == ref.get_current_seq() == 16
    for t in range(1, 14):
        assert port.update_seq(t) == ref.update_seq(t)
        assert port.state == ref.state
    assert port.get_total_layer_tokens(20) == ref.get_total_layer_tokens(20)
    blob = port.state_dict()
    assert blob == ref.state_dict()
    twin = RandomLTDScheduler(_ltd_config())
    twin.load_state_dict(blob)
    assert twin.get_current_seq() == 64 and twin.state_dict() == blob


@pytest.mark.parametrize("batch_first", [True, False])
def test_gather_scatter_equal_jax_and_round_trip(batch_first):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, L, 8)).astype(np.float32)
    y = rng.standard_normal((B, R, 8)).astype(np.float32)
    if not batch_first:
        x, y = x.swapaxes(0, 1).copy(), y.swapaxes(0, 1).copy()
    idx = _jax_indices(3)[None]
    got = port_ltd.token_gather(torch.from_numpy(x), torch.from_numpy(idx), batch_first=batch_first)
    want = jax_ltd.token_gather(jnp.asarray(x), jnp.asarray(idx), batch_first=batch_first)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xt = torch.from_numpy(x)
    back = port_ltd.token_scatter_(xt, got, torch.from_numpy(idx), batch_first=batch_first)
    assert torch.equal(back, xt)
    scattered = port_ltd.token_scatter_(xt, torch.from_numpy(y), torch.from_numpy(idx),
                                        batch_first=batch_first)
    np.testing.assert_array_equal(scattered.numpy(), np.asarray(jax_ltd.token_scatter_(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx), batch_first=batch_first)))
    assert torch.equal(xt, torch.from_numpy(x))  # out of place: the input is untouched


def test_gather_gradient_is_the_zero_filled_scatter():
    x = torch.ones((1, 8, 4), requires_grad=True)
    idx, _ = port_ltd.gpt_sample_tokens(3, 8, 1, generator=torch.Generator().manual_seed(4))
    port_ltd.token_gather(x, idx).sum().backward()
    rows = idx[0, 0]
    assert bool((x.grad[0, rows] == 1).all())
    dead = torch.tensor([i for i in range(8) if i not in rows.tolist()])
    assert bool((x.grad[0, dead] == 0).all())


def test_samplers_shape_order_and_masks():
    gen = torch.Generator().manual_seed(0)
    idx, mask = port_ltd.gpt_sample_tokens(8, 32, batch_size=3, layers=2, generator=gen,
                                           attn_mask=torch.ones((3, 1, 32, 32), dtype=torch.bool))
    assert idx.shape == (2, 3, 8) and mask.shape == (3, 1, 8, 8)
    flat = idx.reshape(-1, 8)
    assert bool((flat.diff(dim=-1) > 0).all()) and int(flat.min()) >= 0 and int(flat.max()) < 32
    again, _ = port_ltd.gpt_sample_tokens(8, 32, batch_size=3, layers=2, generator=gen)
    assert not torch.equal(idx, again)  # a fresh draw each call
    attn = torch.from_numpy(np.random.default_rng(0).integers(0, 2, (2, 1, 16, 16)).astype(bool))
    idx, new = port_ltd.bert_sample_tokens(4, 16, batch_size=2, layers=3, attn_mask=attn,
                                           generator=torch.Generator().manual_seed(1))
    assert idx.shape == (3, 2, 4) and new.shape == (3, 2, 1, 4, 4)
    rows = idx[1, 1]
    assert torch.equal(new[1, 1], attn[1][:, rows][:, :, rows])
    with pytest.raises(ValueError):
        port_ltd.gpt_sample_tokens(40, 32, batch_size=1)
    t = torch.tensor([[3, 1, 2], [9, 7, 8]])
    assert port_ltd.token_sort_(t).tolist() == [[1, 2, 3], [7, 8, 9]] == t.tolist()
