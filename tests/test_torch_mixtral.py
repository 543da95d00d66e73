"""Mixtral (LLaMA blocks with top-2 of N SwiGLU experts) in the port against
the JAX package.

The ``"mixtral-test"`` preset (2 layers, both MoE, 4 experts, top-2), fp32
on the CPU, the JAX model's seeded tree carried over by ``params_from_jax``.
Eval logits and the eval loss within 1e-5 relative of JAX's (the aux loss
too); the config inferred from the tree and ``params_to_jax`` giving the
tree back; one training-mode forward and backward with JAX's top-2
decisions (its Gumbel-sampled second choices, recorded by a
``jax.debug.callback`` around JAX's ``top2routing``) injected through
``testing.injected_routing``: the loss and every gradient within 1e-5 of
JAX's; 5 engine steps that lower the loss, as JAX's
``test_mixtral_style_llama_moe_trains_and_serves`` asserts, bit-equal with
remat on and off, with ``moe_gate_stats`` over both MoE layers, a
``save_16bit_model`` file that the JAX package's loader reads under its own
tree, and the engine's ``"moe"`` block reaching the layers; greedy lockstep
``generate`` token for token against the JAX ``InferenceEngine``; and both
schedulers refusing the family.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

import deepspeed_tpu.moe.sharded_moe as jax_sharded_moe
from deepspeed_tpu.checkpoint.zero_to_fp32 import load_state_dict_from_npz
from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.inference.serving import ContinuousBatchingScheduler as JaxScheduler
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.models.llama import get_llama_config as jax_config
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
import deepspeed_tpu_torch
from deepspeed_tpu_torch import LlamaForCausalLM, get_llama_config, init_inference
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler
from deepspeed_tpu_torch.models.common import cross_entropy_loss
from deepspeed_tpu_torch.models.llama import param_shapes
from deepspeed_tpu_torch.moe import set_default_route
from deepspeed_tpu_torch.moe.sharded_moe import SortedRouting
from deepspeed_tpu_torch.testing import injected_routing

RTOL = 1e-5
PRESET = "mixtral-test"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ids(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.int32)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX model and its seeded tree (numpy), with no mesh topology."""
    set_topology(None)
    module = JaxLlama(jax_config(PRESET))
    tree = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return module, jax.device_get(nn.meta.unbox(tree))


def _port_model(tree, **overrides):
    cfg = get_llama_config(PRESET, **overrides)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg), strict=True)
    return model


def _jax_loss(logits, ids):
    """The mean next-token cross-entropy of fp32 logits (the port's
    ``cross_entropy_loss`` over ``ids`` as labels)."""
    lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
    return -jnp.take_along_axis(lp, jnp.asarray(ids)[:, 1:, None], axis=-1)[..., 0].mean()


def test_eval_logits_and_loss_match_jax(jax_model):
    module, tree = jax_model
    ids = _ids(1, 2, 48)
    logits, aux = jax.jit(lambda p: module.apply({"params": p}, jnp.asarray(ids)))(tree)
    want, want_aux = np.asarray(logits), float(aux)
    model = _port_model(tree)
    with torch.no_grad():
        got, got_aux = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    assert abs(float(got_aux) - want_aux) <= RTOL * abs(want_aux)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config={"train_batch_size": 2, "optimizer": {"type": "AdamW"}}, device="cpu")
    loss = float(engine.eval_batch({"input_ids": ids}))
    want_loss = float(_jax_loss(logits, ids))  # eval: the cross-entropy alone
    assert abs(loss - want_loss) <= RTOL * want_loss


def test_params_round_trip_and_config_inference(jax_model):
    _, tree = jax_model
    sd = params_from_jax(tree)  # the config inferred from the tree
    cfg = get_llama_config(PRESET)
    assert {k: (tuple(v.shape), v.dtype) for k, v in sd.items()} == param_shapes(cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()} == param_shapes(cfg)
    flat = params_to_jax(sd)
    assert "layers_1/moe/deepspeed_moe/experts/deepspeed_experts/down_proj/kernel" in flat
    assert "layers_0/moe/deepspeed_moe/gate/wg" in flat and not any("/mlp/" in p for p in flat)
    for path, arr in flat.items():
        node = tree
        for part in path.split("/"):
            node = node[part]
        np.testing.assert_array_equal(arr, node)
    # every other layer MoE, 8 experts: inferred from the gates
    from deepspeed_tpu_torch.checkpoint.from_jax import _infer_config
    other = get_llama_config(PRESET, num_hidden_layers=4, moe_layer_freq=2, moe_num_experts=8)
    inferred = _infer_config(LlamaForCausalLM(other, device="cpu").state_dict())
    assert (inferred.moe_num_experts, inferred.moe_layer_freq, inferred.intermediate_size,
            inferred.num_hidden_layers) == (8, 2, 128, 4)


def _jax_grads_and_routing(module, tree, ids):
    """JAX's training-mode loss (cross-entropy plus the scaled aux loss),
    its gradients, and the top-2 decisions of each layer's gate call, by
    layer: the gate calls are traced in layer order, and each callback
    carries the index of its trace. One token group: no mesh topology."""
    set_topology(None)
    record, traced = {}, []
    free = jax_sharded_moe.top2routing

    def top2(*args, **kwargs):
        out = free(*args, **kwargs)
        r = out[1]

        def keep(e, s, k, layer=len(traced)):
            record[layer] = (np.array(e), np.array(s), np.array(k))

        traced.append(None)
        jax.debug.callback(keep, r.expert, r.slot, r.keep)
        return out

    def loss_fn(params):
        logits, aux = module.apply({"params": params}, jnp.asarray(ids), deterministic=False,
                                   rngs={"gating": jax.random.PRNGKey(3)})
        return _jax_loss(logits, ids) + aux

    jax_sharded_moe.top2routing = top2
    try:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(tree)
        jax.effects_barrier()
    finally:
        jax_sharded_moe.top2routing = free
    return float(loss), jax.device_get(grads), record


def test_training_step_grads_match_jax_under_jax_routing(jax_model):
    module, tree = jax_model
    ids = _ids(2, 2, 32)
    want_loss, want_grads, record = _jax_grads_and_routing(module, tree, ids)
    assert sorted(record) == [0, 1]  # one gate call per layer
    routing = {f"layers_{i}.moe.deepspeed_moe.gate": SortedRouting(
        expert=torch.from_numpy(e).int(), slot=torch.from_numpy(s).int(), weight=None,
        keep=torch.from_numpy(k).int()) for i, (e, s, k) in record.items()}
    model = _port_model(tree)
    gen = torch.Generator().manual_seed(0)
    own = {}
    with injected_routing(routing, record=own, model=model):
        logits, aux = model(torch.from_numpy(ids).long(), deterministic=False, generator=gen)
        loss = cross_entropy_loss(logits[:, :-1], torch.from_numpy(ids[:, 1:])) + aux
    loss.backward()
    assert sorted(own) == sorted(routing) and all(len(calls) == 1 for calls in own.values())
    assert abs(float(loss.detach()) - want_loss) <= RTOL * want_loss
    want = params_from_jax(want_grads)
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= RTOL * max(np.abs(ref).max(), 1e-30), (name, err, np.abs(ref).max())
    for i in range(2):  # the injected decisions were followed
        used = model.blocks[i].moe.deepspeed_moe.last_routing
        assert torch.equal(used.expert[0], torch.from_numpy(record[i][0]).int())


def _train(remat, steps=5, **config):
    """JAX's Mixtral test recipe in the port: 5 AdamW steps at lr 1e-3 on
    one seeded [8, 32] batch."""
    model = LlamaForCausalLM(get_llama_config(PRESET, remat=remat), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu",
        config={"train_batch_size": 8, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                "steps_per_print": 10**9, **config})
    batch = {"input_ids": _ids(0, 8, 32)}
    return [float(engine.train_batch(batch)) for _ in range(steps)], engine


def test_training_lowers_the_loss_with_and_without_remat(tmp_path):
    losses, engine = _train(remat=False)
    assert losses[-1] < losses[0], losses
    stats = engine.moe_gate_stats({"input_ids": _ids(0, 8, 32)})
    assert sorted(stats) == ["layers_0.moe.deepspeed_moe", "layers_1.moe.deepspeed_moe"]
    assert all(int(s["routed_counts"].sum()) == 2 * 8 * 32 for s in stats.values())
    remat, _ = _train(remat=True)
    assert remat == losses
    # the 16-bit export reads back in the JAX package under its own tree
    tree = load_state_dict_from_npz(engine.save_16bit_model(str(tmp_path)))
    flat = params_to_jax(engine.module.state_dict())
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert sorted("/".join(k.key for k in path) for path, _ in got) == sorted(flat)
    # the engine's "moe" block reaches the Mixtral layers: the dense route
    try:
        _, dense = _train(remat=False, steps=1, moe={"route": "dense"})
        assert all(m.last_routing is None for m in
                   (dense.module.layers_0.moe.deepspeed_moe, dense.module.layers_1.moe.deepspeed_moe))
    finally:
        set_default_route(None)


@pytest.fixture(scope="module")
def engines(jax_model):
    set_topology(None)
    module, tree = jax_model
    topo = MeshTopology(tensor=1, data=1, fsdp=1, devices=jax.devices()[:1])
    jax_engine = JaxEngine(module, JaxInferenceConfig(replace_with_kernel_inject=False),
                           params=tree, topology=topo)
    port_engine = init_inference(LlamaForCausalLM(get_llama_config(PRESET), device="cpu"),
                                 params=params_from_jax(tree), device="cpu")
    yield jax_engine, port_engine
    set_topology(None)


def test_generate_gives_jax_tokens(engines):
    """A 20-token prompt: one 16-token prefill chunk, four 1-token calls,
    then the token loop."""
    jax_engine, port_engine = engines
    ids = _ids(5, 2, 20)
    want = np.asarray(jax_engine.generate(ids, max_new_tokens=6))
    np.testing.assert_array_equal(port_engine.generate(ids, max_new_tokens=6).numpy(), want)


def test_both_schedulers_refuse_mixtral(engines):
    jax_engine, port_engine = engines
    with pytest.raises(NotImplementedError, match="LlamaForCausalLM"):
        JaxScheduler(jax_engine)
    with pytest.raises(NotImplementedError, match="LlamaForCausalLM"):
        ContinuousBatchingScheduler(port_engine)
