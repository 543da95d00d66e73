"""Progressive layer drop: the port's host schedule, model gate and engine
wiring against the JAX package's.

The theta schedule equals JAX's ``ProgressiveLayerDrop`` at every step
(exactly: the same float64 expression); the engine anneals it from its step
count as JAX's engine mirrors its in-graph theta; GPT-2 "test" with theta 1
keeps every sublayer (its training loss and gradients equal the model's
without PLD, bit for bit), eval ignores theta, the drops follow the depth
rule ``1 - (i + 1) / n_layer (1 - theta)`` (the share of kept draws over
1000 forwards within four binomial standard deviations of it), a dropped MoE sublayer adds no balancing
loss, and a model without support trains on with JAX's warning.
"""

import logging

import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.progressive_layer_drop import ProgressiveLayerDrop as JaxPLD
import deepspeed_tpu_torch
from deepspeed_tpu_torch.runtime.engine import default_causal_lm_loss
from deepspeed_tpu_torch.runtime.progressive_layer_drop import ProgressiveLayerDrop


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("theta,gamma", [(0.5, 0.001), (0.2, 0.1), (0.9, 1.0)])
def test_theta_schedule_equals_jax(theta, gamma):
    port, jax_pld = ProgressiveLayerDrop(theta, gamma), JaxPLD(theta, gamma)
    assert port.get_theta() == jax_pld.get_theta() == 1.0
    for step in range(0, 200, 7):
        port.update_state(step)
        jax_pld.update_state(step)
        assert port.get_theta() == jax_pld.get_theta()
        assert port.get_state() == jax_pld.get_state()


def _model(**kw):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", n_positions=64, **kw)
    return deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu")


IDS = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 32)))


def _loss_and_grads(model, **kw):
    model.zero_grad()
    loss = default_causal_lm_loss(model(IDS, **kw), {"input_ids": IDS})
    loss.backward()
    return loss.detach(), [p.grad.clone() for p in model.parameters()]


def test_theta_one_keeps_every_block_and_eval_ignores_theta():
    pld, plain = _model(progressive_layer_drop=True), _model()
    want = _loss_and_grads(plain)
    got = _loss_and_grads(pld, deterministic=False, pld_theta=1.0, generator=torch.Generator().manual_seed(3))
    assert bool(pld.last_pld_keep.all())
    assert torch.equal(got[0], want[0]) and all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    with torch.no_grad():
        assert torch.equal(pld(IDS, pld_theta=0.1), plain(IDS))


def test_drops_follow_the_depth_rule():
    model = _model(progressive_layer_drop=True, n_layer=4)
    gen = torch.Generator().manual_seed(0)
    theta, kept = 0.4, []
    with torch.no_grad():
        for _ in range(1000):
            model(IDS[:, :8], deterministic=False, pld_theta=theta, generator=gen)
            kept.append(model.last_pld_keep.float())
    share = torch.stack(kept).mean(0)
    want = torch.tensor([1.0 - (i + 1) / 4 * (1.0 - theta) for i in range(4)])
    sigma = (want * (1 - want) / len(kept)).sqrt()[:, None]
    assert ((share - want[:, None]).abs() <= 4 * sigma).all(), share


def test_a_dropped_moe_sublayer_adds_no_balancing_loss():
    model = _model(progressive_layer_drop=True, moe_num_experts=4, moe_layer_freq=2,
                   moe_use_rts=False)
    block = model.h_1
    x = torch.randn(2, 8, 64)
    mask = torch.tensor([True, False])
    _, l_aux = block(x, deterministic=False, gating_seed=1, pld_keep=0.5, pld_mask=mask)
    assert float(l_aux) == 0.0
    _, l_aux = block(x, deterministic=False, gating_seed=1, pld_keep=0.5,
                     pld_mask=torch.tensor([True, True]))
    assert float(l_aux) > 0.0


def test_engine_anneals_theta_and_warns_without_support(caplog):
    config = {"train_batch_size": 4, "progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                                                "gamma": 0.3}}
    engine = deepspeed_tpu_torch.initialize(model=_model(progressive_layer_drop=True), device="cpu",
                                            config=config)[0]
    ids = np.random.default_rng(1).integers(0, 256, (4, 32)).astype(np.int32)
    jax_pld = JaxPLD(0.5, 0.3)
    for _ in range(3):
        engine.train_batch(ids)
        jax_pld.update_state(engine.global_steps)
        assert engine.progressive_layer_drop.get_theta() == jax_pld.get_theta()
    assert engine.module.last_pld_keep.shape == (2, 2)
    with caplog.at_level(logging.WARNING):
        llama = deepspeed_tpu_torch.LlamaForCausalLM(deepspeed_tpu_torch.get_llama_config("test"),
                                                     device="cpu")
        engine = deepspeed_tpu_torch.initialize(model=llama, device="cpu", config=config)[0]
    assert "will not drop layers" in caplog.text
    engine.train_batch(ids)
    assert engine.progressive_layer_drop.get_theta() < 1.0
