"""The port's MoE modules (``deepspeed_tpu_torch/moe/``) against the JAX
package's ``deepspeed_tpu/moe/``.

* The top-1 and top-2 decision cores, and the dense and sorted gating
  functions built on them, on the same logits, with the JAX draws (RSample
  and top-2 Gumbel noise, RTS uniforms) recomputed by ``jax.random`` in the
  JAX split order and handed to the port: routing decisions (experts, slots,
  masks, counts) must be equal exactly, gate probabilities and the aux loss
  within ``RTOL`` (fp32 softmax and means summed in another order).
* ``MOELayer`` and ``MoE(use_residual=True)`` with GPT-2 MLP experts, from
  the JAX init: outputs, the aux loss and every parameter gradient within
  ``LAYER_TOL`` of the largest magnitude of the JAX tensor, in fp32.
* The sorted route against the dense route inside the port.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import flax.linen as nn
import torch

from deepspeed_tpu.models.gpt2 import MLP as JaxMLP, get_gpt2_config as jax_config
from deepspeed_tpu.moe import MoE as JaxMoE
from deepspeed_tpu.moe import routing as jax_routing
from deepspeed_tpu.moe import sharded_moe as jsm
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.common import flatten_tree
from deepspeed_tpu_torch.models.gpt2 import MLP, get_gpt2_config
from deepspeed_tpu_torch.moe import (MoE, MOELayer, TopKGate, drop_tokens, gather_tokens,
                                     has_moe_layers, is_moe_param, is_moe_param_path, routing,
                                     split_params_into_different_moe_groups_for_optimizer)
from deepspeed_tpu_torch.moe import sharded_moe as sm
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL = 1e-6
LAYER_TOL = 1e-5
S, E = 64, 8


@pytest.fixture(autouse=True)
def _clean_route():
    for mod in (routing, jax_routing):
        mod.set_default_route(None, None)
    for var in (routing.ENV_ROUTE, routing.ENV_KERNEL):
        os.environ.pop(var, None)
    yield
    for mod in (routing, jax_routing):
        mod.set_default_route(None, None)
    for var in (routing.ENV_ROUTE, routing.ENV_KERNEL):
        os.environ.pop(var, None)


def _logits(seed=0, s=S, e=E):
    return np.random.default_rng(seed).normal(size=(s, e)).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _jax_top1_draws(key, shape, noisy, use_rts):
    """The draws ``_top1_decisions`` takes from ``key``, in its split order."""
    gumbel = rts = None
    if noisy == "RSample":
        key, noise_key = jax.random.split(key)
        gumbel = jax.random.gumbel(noise_key, shape)
    if use_rts:
        key, rts_key = jax.random.split(key)
        rts = jax.random.uniform(rts_key, shape)
    return _t(gumbel), _t(rts)


def _jax_top2_draws(key, shape):
    _, noise_key = jax.random.split(key)
    return _t(jax.random.gumbel(noise_key, shape))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# capacity and the decision cores
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tokens,experts,cf,min_cap,drop,k", [
    (64, 8, 1.0, 4, True, 1), (64, 8, 1.25, 4, True, 1), (8, 8, 1.0, 4, True, 1),
    (64, 8, 1.0, 4, False, 1), (8192, 8, 1.25, 4, True, 1), (8192, 8, 2.0, 4, True, 1),
    (8192, 8, 1.25, 4, True, 2), (16, 4, 0.25, 1, True, 2)])
def test_capacity_matches_jax(tokens, experts, cf, min_cap, drop, k):
    assert sm._capacity(tokens, experts, cf, min_cap, drop) == jsm._capacity(
        tokens, experts, cf, min_cap, drop)
    assert sm._gate_capacity(tokens, experts, cf, min_cap, drop, k) == jsm._gate_capacity(
        tokens, experts, cf, min_cap, drop, k)
    assert sm.sec_signature(tokens, experts, cf, min_cap, k, drop) == jsm.sec_signature(
        tokens, experts, cf, min_cap, k, drop)


@pytest.mark.parametrize("cf", [0.5, 2.0])
@pytest.mark.parametrize("noisy,use_rts,used", [(None, False, False), (None, True, False),
                                                ("RSample", False, False), ("RSample", True, True),
                                                (None, False, True)])
def test_top1_decisions_match_jax(cf, noisy, use_rts, used):
    logits = _logits(1)
    key = jax.random.PRNGKey(3)
    used_token = (np.random.default_rng(2).random(S) < 0.8).astype(np.float32) if used else None
    want = jsm._top1_decisions(jnp.asarray(logits), cf, 2, None if used_token is None else
                               jnp.asarray(used_token), noisy, True, use_rts, key)
    gumbel, rts = _jax_top1_draws(key, (S, E), noisy, use_rts)
    got = sm._top1_decisions(torch.from_numpy(logits), cf, 2, _t(used_token), noisy, True,
                             use_rts, gumbel, rts)
    l_aux, gates_masked, mask1, indices1_s, locations1_s, exp_counts, capacity = got
    np.testing.assert_allclose(l_aux.item(), float(want[0]), rtol=RTOL)
    np.testing.assert_allclose(gates_masked.numpy(), np.asarray(want[1]), rtol=RTOL, atol=1e-7)
    for g, w in zip((mask1, indices1_s, locations1_s, exp_counts), want[2:6]):
        _eq(g, w)
    assert capacity == want[6]
    if cf == 0.5:
        assert int(mask1.sum()) < int(exp_counts.sum())  # capacity dropped tokens


@pytest.mark.parametrize("cf", [0.25, 4.0])
@pytest.mark.parametrize("noise", [False, True])
def test_top2_decisions_match_jax(cf, noise):
    logits = _logits(4)
    key = jax.random.PRNGKey(5) if noise else None
    want = jsm._top2_decisions(jnp.asarray(logits), cf, 1, True, key)
    got = sm._top2_decisions(torch.from_numpy(logits), cf, 1, True,
                             _jax_top2_draws(key, (S, E)) if noise else None)
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=RTOL)
    for i in (1, 3, 4):  # masks, indices, locations
        for g, w in zip(got[i], want[i]):
            _eq(g, w)
    for g, w in zip(got[5], want[5]):  # normalized gates
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-7)
    _eq(got[6], want[6])
    assert got[7] == want[7]


@pytest.mark.parametrize("use_rts", [False, True])
def test_top1_gating_and_routing_match_jax(use_rts):
    logits = _logits(6)
    key = jax.random.PRNGKey(7)
    _, rts = _jax_top1_draws(key, (S, E), None, use_rts)
    lg = torch.from_numpy(logits)
    w_dense = jsm.top1gating(jnp.asarray(logits), 1.0, 1, use_rts=use_rts, rng=key)
    g_dense = sm.top1gating(lg, 1.0, 1, use_rts=use_rts, rts=rts)
    np.testing.assert_allclose(g_dense[0].item(), float(w_dense[0]), rtol=RTOL)
    np.testing.assert_allclose(g_dense[1].numpy(), np.asarray(w_dense[1]), rtol=RTOL, atol=1e-7)
    _eq(g_dense[2], w_dense[2])
    _eq(g_dense[3], w_dense[3])
    w_sorted = jsm.top1routing(jnp.asarray(logits), 1.0, 1, use_rts=use_rts, rng=key)
    g_sorted = sm.top1routing(lg, 1.0, 1, use_rts=use_rts, rts=rts)
    for field in ("expert", "slot", "keep"):
        _eq(getattr(g_sorted[1], field), getattr(w_sorted[1], field))
        assert getattr(g_sorted[1], field).dtype == torch.int32
    np.testing.assert_allclose(g_sorted[1].weight.numpy(), np.asarray(w_sorted[1].weight),
                               rtol=RTOL, atol=1e-7)
    _eq(g_sorted[2], w_sorted[2])


def test_top2_gating_and_routing_match_jax():
    logits = _logits(8)
    key = jax.random.PRNGKey(9)
    gumbel = _jax_top2_draws(key, (S, E))
    lg = torch.from_numpy(logits)
    w_dense = jsm.top2gating(jnp.asarray(logits), 1.0, 1, rng=key)
    g_dense = sm.top2gating(lg, 1.0, 1, gumbel=gumbel)
    np.testing.assert_allclose(g_dense[1].numpy(), np.asarray(w_dense[1]), rtol=RTOL, atol=1e-7)
    _eq(g_dense[2], w_dense[2])
    w_sorted = jsm.top2routing(jnp.asarray(logits), 1.0, 1, rng=key)
    g_sorted = sm.top2routing(lg, 1.0, 1, gumbel=gumbel)
    for field in ("expert", "slot", "keep"):
        _eq(getattr(g_sorted[1], field), getattr(w_sorted[1], field))
    np.testing.assert_allclose(g_sorted[1].weight.numpy(), np.asarray(w_sorted[1].weight),
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(g_sorted[0].item(), float(w_sorted[0]), rtol=RTOL)


def test_overflow_without_rts_keeps_the_lowest_indices():
    """Every token prefers expert 0 and the priority is the 0/1 mask, all
    ties: the first ``capacity`` tokens survive, as ``jax.lax.top_k``
    keeps the lowest indices among equal values."""
    logits = np.tile(np.array([[5.0, 0.0, 0.0, 0.0]], np.float32), (16, 1))
    logits[[3, 9], 1] = 9.0  # two tokens go to expert 1 instead
    _, combine, dispatch, _ = sm.top1gating(torch.from_numpy(logits), 1.0, 1, use_rts=False)
    capacity = sm._capacity(16, 4, 1.0, 1)
    kept = dispatch.sum(dim=(1, 2)).numpy()
    want_kept = [i for i in range(16) if i not in (3, 9)][:capacity] + [3, 9]
    assert sorted(np.nonzero(kept)[0].tolist()) == sorted(want_kept)
    _, _, jdispatch, _ = jsm.top1gating(jnp.asarray(logits), 1.0, 1, use_rts=False)
    _eq(dispatch, jdispatch)
    # the same with the tie-prone priority handed to the helper directly
    mask = torch.zeros(10, 2, dtype=torch.int64)
    mask[:, 0] = 1
    kept = sm._keep_top_capacity(mask, mask.float(), 3)
    assert kept[:, 0].tolist() == [1, 1, 1] + [0] * 7


def test_used_token_masks_tokens_out_of_routing():
    logits = _logits(10)
    used = np.ones(S, np.float32)
    used[::3] = 0.0
    _, _, dispatch, counts = sm.top1gating(torch.from_numpy(logits), 4.0, 1, _t(used),
                                           use_rts=False)
    assert int(counts.sum()) == int(used.sum())
    assert not dispatch[torch.from_numpy(used == 0)].any()
    _, _, jdispatch, jcounts = jsm.top1gating(jnp.asarray(logits), 4.0, 1, jnp.asarray(used),
                                              use_rts=False)
    _eq(dispatch, jdispatch)
    _eq(counts, jcounts)


def test_multiplicative_jitter_matches_jax():
    x = _logits(11, 16, 32)
    key = jax.random.PRNGKey(12)
    noise = jax.random.uniform(key, x.shape, jnp.float32, 1.0 - sm.JITTER_EPS, 1.0 + sm.JITTER_EPS)
    want = jsm.multiplicative_jitter(jnp.asarray(x), key)
    got = sm.multiplicative_jitter(torch.from_numpy(x), _t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("k,noisy,use_rts,fields", [
    (1, None, True, ("rts",)), (1, "RSample", False, ("gumbel",)),
    (1, "Jitter", True, ("jitter", "rts")), (2, None, True, ("gumbel",)), (1, None, False, ())])
def test_gate_draws_follow_the_config_and_the_seed(k, noisy, use_rts, fields):
    gate = TopKGate(8, 4, k=k, noisy_gate_policy=noisy, use_rts=use_rts)
    tokens = torch.zeros(1, 16, 8)
    assert gate.needs_noise(False) == bool(fields) and not gate.needs_noise(True)
    draw = lambda seed: gate.draw_noise(torch.Generator().manual_seed(seed), tokens)
    a, b, c = draw(0), draw(0), draw(1)
    for name in ("jitter", "gumbel", "rts"):
        got = getattr(a, name)
        assert (got is not None) == (name in fields), name
        if got is not None:
            assert torch.equal(got, getattr(b, name)) and not torch.equal(got, getattr(c, name))
    if a.jitter is not None:
        assert a.jitter.min() >= 1 - sm.JITTER_EPS and a.jitter.max() <= 1 + sm.JITTER_EPS


def test_gate_rounds_wg_to_the_compute_dtype():
    gate = TopKGate(16, 4, dtype=torch.bfloat16)
    with torch.no_grad():
        gate.wg.copy_(torch.from_numpy(_logits(13, 16, 4)) / 7)
    x = torch.from_numpy(_logits(14, 10, 16))[None]
    _, combine, _, _ = gate(x, deterministic=True)
    logits = x[0] @ gate.wg.to(torch.bfloat16).float()
    torch.testing.assert_close(combine[0], sm.top1gating(logits, 1.0, 8)[1], rtol=0, atol=0)
    assert not torch.equal(logits, x[0] @ gate.wg)


# ---------------------------------------------------------------------------
# the layer against JAX, and the two routes against each other
# ---------------------------------------------------------------------------
M = 16
CFG = dict(n_embd=M, n_head=4, dropout=0.0)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= LAYER_TOL * max(np.abs(want).max(), 1e-30), (what, err)


def _x(seed=2):
    return np.random.default_rng(seed).normal(size=(2, 8, M)).astype(np.float32)


def _jax_layer(module, x, deterministic):
    """The JAX layer's params, output, aux loss and gradients, each a jitted
    call (one compile, not one per primitive)."""
    variables = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = nn.unbox(variables["params"])

    def loss(p, xx):
        out, l_aux, _ = module.apply({"params": p}, xx, deterministic=deterministic)
        return (out**2).sum() + l_aux, (out, l_aux)

    (lv, (out, l_aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    return jax.device_get(params), out, l_aux, jax.device_get(gp), gx


def _port_layer(module, params, x, deterministic, **kwargs):
    state = {k: torch.from_numpy(np.array(v)) for k, v in flatten_tree(params, ".").items()}
    module.load_state_dict(state, strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    out, l_aux, counts = module(xt, deterministic=deterministic, **kwargs)
    ((out**2).sum() + l_aux).backward()
    grads = {name: p.grad for name, p in module.named_parameters()}
    return out, l_aux, grads, xt.grad


@pytest.mark.parametrize("route", ["sorted", "dense"])
@pytest.mark.parametrize("k,deterministic,cf", [(1, True, 2.0), (2, True, 1.0), (1, False, 0.5),
                                                (1, False, 4.0)])
def test_moe_layer_matches_jax(route, k, deterministic, cf):
    """GPT-2 MLP experts, fp32. Training-mode calls run without RTS (no
    draws), so the JAX layer needs no rng; cf 0.5 drops tokens."""
    jcfg = jax_config("test", **CFG)
    x = _x()
    jlayer = jsm.MOELayer(expert=JaxMLP(jcfg), model_dim=M, num_experts=4, k=k,
                          capacity_factor=cf, eval_capacity_factor=cf, min_capacity=1,
                          use_rts=False, route=route)
    params, out, l_aux, gp, gx = _jax_layer(jlayer, x, deterministic)
    layer = MOELayer(MLP(get_gpt2_config("test", **CFG), "cpu"), M, 4, k=k, capacity_factor=cf,
                     eval_capacity_factor=cf, min_capacity=1, use_rts=False, route=route)
    got_out, got_aux, grads, got_gx = _port_layer(layer, params, x, deterministic)
    _close(got_out.detach(), out, "out")
    np.testing.assert_allclose(got_aux.item(), float(l_aux), rtol=RTOL)
    for name, g in flatten_tree(gp, ".").items():
        _close(grads[name], g, name)
    _close(got_gx, gx, "dx")
    assert int(layer.exp_counts.sum()) == 16
    assert int(layer.kept_counts.sum()) <= k * 16


@pytest.mark.parametrize("route", ["sorted", "dense"])
def test_moe_with_residual_matches_jax(route):
    jcfg = jax_config("test", **CFG)
    x = _x(3)
    jmoe = JaxMoE(hidden_size=M, expert=JaxMLP(jcfg), num_experts=4, k=1, use_residual=True,
                  min_capacity=1, capacity_factor=1.0, eval_capacity_factor=1.0, route=route)
    params, out, l_aux, gp, gx = _jax_layer(jmoe, x, True)
    assert set(params) == {"deepspeed_moe", "mlp", "coefficient"}
    moe = MoE(M, MLP(get_gpt2_config("test", **CFG), "cpu"), num_experts=4, k=1,
              use_residual=True, min_capacity=1, capacity_factor=1.0, eval_capacity_factor=1.0,
              route=route)
    got_out, got_aux, grads, got_gx = _port_layer(moe, params, x, True)
    _close(got_out.detach(), out, "out")
    for name, g in flatten_tree(gp, ".").items():
        _close(grads[name], g, name)
    _close(got_gx, gx, "dx")


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("deterministic,use_rts", [(True, True), (False, True), (False, False)])
@pytest.mark.parametrize("cf", [0.25, 4.0])
def test_sorted_route_matches_dense_route(k, deterministic, use_rts, cf):
    """Same decisions, same draws: the sorted route's output and gradients
    equal the dense einsum route's, fp32 reassociation aside (rtol and atol
    2e-5, the JAX package's dense-vs-sorted tolerance); the plain gather and
    ``PermuteRows`` agree exactly."""
    cfg = get_gpt2_config("test", **CFG)
    torch.manual_seed(0)
    ref = MOELayer(MLP(cfg, "cpu"), M, 4, k=k, capacity_factor=cf, eval_capacity_factor=cf,
                   min_capacity=1, use_rts=use_rts)
    with torch.no_grad():
        for p in ref.parameters():
            p.normal_(0.0, 0.3)
    x = torch.from_numpy(_x(4))
    noise = None
    if ref.gate.needs_noise(deterministic):
        noise = ref.gate.draw_noise(torch.Generator().manual_seed(1), x.reshape(1, -1, M))
    results = {}
    for route, kernel in (("dense", None), ("sorted", "xla"), ("sorted", "pallas")):
        ref.route, ref.route_kernel = route, kernel
        ref.zero_grad()
        xt = x.clone().requires_grad_()
        out, l_aux, _ = ref(xt, deterministic=deterministic, gate_noise=noise)
        ((out**2).sum() + l_aux).backward()
        results[(route, kernel)] = [out.detach(), l_aux.detach(), xt.grad] + [
            p.grad.clone() for p in ref.parameters()]
    for d, s in zip(results[("dense", None)], results[("sorted", "xla")]):
        torch.testing.assert_close(s, d, rtol=2e-5, atol=2e-5)
    for a, b in zip(results[("sorted", "xla")], results[("sorted", "pallas")]):
        assert torch.equal(a, b)


def test_gpt2_moe_forward_matches_jax():
    """The whole model, deterministic: logits and the scaled aux loss of a
    4-layer GPT-2 with PR-MoE top-2 blocks in layers 1 and 3."""
    from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2
    from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
    kw = dict(n_layer=4, moe_num_experts=4, moe_k=2, moe_use_residual=True)
    jmodel = JaxGPT2(jax_config("test", **kw))
    ids = np.random.default_rng(5).integers(0, 256, (2, 24)).astype(np.int32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(ids))
    params = jax.device_get(nn.unbox(variables["params"]))
    logits, aux = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(ids))
    model = deepspeed_tpu_torch.GPT2LMHeadModel(get_gpt2_config("test", **kw), device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got_logits, got_aux = model(torch.from_numpy(ids).long())
    _close(got_logits, logits, "logits")
    np.testing.assert_allclose(got_aux.item(), float(aux), rtol=RTOL)
    assert [type(b.moe).__name__ if b.use_moe else None for b in model.blocks] == [
        None, "MoE", None, "MoE"]


# ---------------------------------------------------------------------------
# routing, validation, utilities
# ---------------------------------------------------------------------------
def test_route_resolution_layers_match_jax():
    for mod in (routing, jax_routing):
        assert mod.resolve_route() == ("sorted", "auto", "default")
        mod.set_default_route("dense", "xla")
        assert mod.resolve_route() == ("dense", "xla", "config")
        assert mod.resolve_intended_route() == "dense"
    os.environ[routing.ENV_ROUTE] = "sorted"
    os.environ[routing.ENV_KERNEL] = "pallas"
    for mod in (routing, jax_routing):
        assert mod.resolve_route() == ("sorted", "pallas", "env")
        assert mod.resolve_intended_route() == "dense"
        assert mod.resolve_route(route="dense", kernel="xla") == ("dense", "xla", "explicit")
        mod.set_default_route(None, None)
    del os.environ[routing.ENV_ROUTE], os.environ[routing.ENV_KERNEL]
    assert routing.resolve_route() == ("sorted", "auto", "default")
    assert routing.get_default_route() == (None, None)


def test_route_resolution_validates():
    with pytest.raises(ValueError, match="route"):
        routing.resolve_route(route="einsum")
    with pytest.raises(ValueError, match="kernel"):
        routing.resolve_route(kernel="cuda")
    with pytest.raises(ValueError, match="route"):
        routing.set_default_route("blocksparse")


def test_moe_validates_its_arguments():
    expert = MLP(get_gpt2_config("test", **CFG), "cpu")
    with pytest.raises(ValueError, match="noisy_gate_policy"):
        MoE(M, expert, num_experts=4, noisy_gate_policy="Gaussian")
    with pytest.raises(ValueError, match="top-1 and top-2"):
        MoE(M, expert, num_experts=4, k=3)
    with pytest.raises(ValueError, match="divisible"):
        MoE(M, expert, num_experts=3, ep_size=2)
    with pytest.raises(NotImplementedError, match="later slice"):
        MoE(M, expert, num_experts=4, ep_size=2)
    with pytest.raises(TypeError, match="stacked"):
        MoE(M, torch.nn.Linear(M, M), num_experts=4)
    layer = MOELayer(expert, M, 4, use_rts=True)
    assert layer.gate.wg.device == expert.c_fc.kernel.device
    with pytest.raises(ValueError, match="gate_generator"):
        layer(torch.zeros(1, 4, M), deterministic=False)


def test_moe_param_utils():
    model = deepspeed_tpu_torch.GPT2LMHeadModel(
        get_gpt2_config("test", moe_num_experts=2, moe_min_capacity=1), device="cpu")
    names = dict(model.named_parameters())
    experts = [n for n in names if is_moe_param_path(n)]
    assert experts and all(".deepspeed_experts." in n for n in experts)
    assert not is_moe_param_path("h_1.moe.deepspeed_moe.gate.wg")
    assert is_moe_param_path(("h_1", "moe", "deepspeed_moe", "experts", "deepspeed_experts"))
    assert all(is_moe_param(names[n]) == (n in experts) for n in names)
    assert has_moe_layers(model)
    assert not has_moe_layers(deepspeed_tpu_torch.GPT2LMHeadModel(get_gpt2_config("test"),
                                                                  device="cpu"))
    assert has_moe_layers(torch.nn.Sequential(MoE(M, MLP(get_gpt2_config("test", **CFG), "cpu"),
                                                  num_experts=2)))
    groups = split_params_into_different_moe_groups_for_optimizer(model)
    assert [g["name"] for g in groups] == ["dense", "experts"] and groups[1]["moe"]
    assert sum(len(g["params"]) for g in groups) == len(names)
    assert {id(p) for p in groups[1]["params"]} == {id(names[n]) for n in experts}
    FusedAdam(groups, lr=1e-3)  # the groups are optimizer-ready


def test_mappings_are_the_identity_on_one_device():
    x = torch.arange(6.0).reshape(2, 3)
    assert drop_tokens(x, 1) is x and gather_tokens(x) is x
