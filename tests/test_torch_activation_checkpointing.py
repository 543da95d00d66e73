"""Remat policies, the activation-checkpointing API and the ``program``
block of the port against the JAX package's.

The six policy names equal JAX's ``POLICIES``; under each, GPT-2 "test"
(fp32, 2 layers) gives remat-off's gradients (within 1e-6 of max |g|:
the recompute runs the same ops); the products a policy keeps, counted at
dispatch, are ordered as the names say (nothing < dots without batch dims
< dots < everything). The ``program`` block resolves to JAX's
``model_updates`` on the same dicts, lands on the model's config (its
submodules see it), takes the ``DS_REMAT_POLICY`` env layer, refuses a
knob the family lacks as JAX does, and trains GPT-2 "test" under
``dots_saveable`` with the split projections on JAX's curve (1e-5 a step).
"""

import numpy as np
import pytest

import jax
import torch

import deepspeed_tpu
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jax_ckpt
from deepspeed_tpu.runtime.config import ProgramConfig as JaxProgramConfig
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
from deepspeed_tpu_torch.runtime.config import ProgramConfig


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MODEL = dict(n_layer=2, n_embd=64, n_head=4, n_positions=64)
POLICY_NAMES = sorted(jax_ckpt.POLICIES)


def test_policy_names_equal_jax():
    assert sorted(checkpointing.POLICIES) == POLICY_NAMES
    assert checkpointing.get_remat_policy(None) is None
    for bad in ("dots", "offload"):
        with pytest.raises(ValueError, match="unknown remat policy"):
            checkpointing.get_remat_policy(bad)
        with pytest.raises(ValueError, match="unknown remat policy"):
            jax_ckpt.get_remat_policy(bad)


def _grads(seed_batch, **cfg_kw):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", **MODEL, **cfg_kw)
    model = deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(seed_batch).integers(0, 256, (2, 64)))
    logits = model(ids)
    loss = deepspeed_tpu_torch.runtime.engine.default_causal_lm_loss(logits, {"input_ids": ids})
    loss.backward()
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()])


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_gradients_under_each_policy_equal_remat_off(policy):
    want = _grads(1)
    got = _grads(1, remat=True, remat_policy=policy)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_kept_products_are_ordered_by_policy(monkeypatch):
    saved = {}
    real = checkpointing._policy_fn

    def counting(which, ctx, op, *args, **kwargs):
        decision = real(which, ctx, op, *args, **kwargs)
        if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            saved[key] = saved.get(key, 0) + 1
        return decision

    monkeypatch.setattr(checkpointing, "_policy_fn", counting)
    for key in ("nothing_saveable", "dots_with_no_batch_dims_saveable", "dots_saveable",
                "everything_saveable"):
        saved[key] = 0
        _grads(2, remat=True, remat_policy=key)
    assert saved["nothing_saveable"] == 0
    assert 0 < saved["dots_with_no_batch_dims_saveable"] < saved["dots_saveable"]
    assert saved["dots_saveable"] < saved["everything_saveable"]


def test_configure_reset_and_checkpoint_api():
    checkpointing.reset()
    assert not checkpointing.is_configured()
    checkpointing.configure(deepspeed_config={"activation_checkpointing": {
        "partition_activations": True, "number_checkpoints": 4}}, policy="dots_saveable")
    assert checkpointing.is_configured() and checkpointing._State.policy_name == "dots_saveable"
    assert checkpointing._State.num_checkpoints == 4
    x = torch.randn(3, 4, requires_grad=True)
    w = torch.randn(4, 4, requires_grad=True)
    y = checkpointing.checkpoint(lambda a, b: torch.tanh(a @ b), x, w)
    y.sum().backward()
    gx = x.grad.clone()
    x.grad = None
    torch.tanh(x @ w).sum().backward()
    assert torch.equal(gx, x.grad)
    checkpointing.reset()
    checkpointing.configure(checkpoint_in_cpu=True)  # taken: test_torch_cpu_checkpointing.py
    assert checkpointing.is_configured() and checkpointing._State.cpu_checkpointing
    checkpointing.reset()
    checkpointing.model_parallel_cuda_manual_seed(7)
    tracker = checkpointing.get_rng_state_tracker()
    with tracker.fork():
        a = torch.rand(3)
    with tracker.fork():
        b = torch.rand(3)
    checkpointing.model_parallel_cuda_manual_seed(7)
    with tracker.fork():
        assert torch.equal(torch.rand(3), a) and not torch.equal(a, b)


PROGRAMS = [{}, {"remat": True, "remat_policy": "none"}, {"remat_every": 2, "lm_head_chunk": 0},
            {"remat_policy": "dots_saveable", "fused_qkv": False, "fused_attn_out": False},
            {"lm_head_chunk": 32, "remat": False}]


@pytest.mark.parametrize("block", PROGRAMS)
def test_program_block_resolves_as_jax(block):
    assert ProgramConfig(block).model_updates() == JaxProgramConfig(**block).model_updates()


def test_program_block_lands_on_the_model(monkeypatch):
    model = deepspeed_tpu_torch.GPT2LMHeadModel(deepspeed_tpu_torch.get_gpt2_config("test", **MODEL),
                                                device="cpu")
    engine = deepspeed_tpu_torch.initialize(model=model, device="cpu", config={
        "train_batch_size": 4, "program": {"remat": True, "remat_policy": "dots_saveable",
                                           "fused_qkv": False, "lm_head_chunk": 32}})[0]
    cfg = engine.module.config
    assert (cfg.remat, cfg.remat_policy, cfg.attn_fused_qkv, cfg.fused_head_loss_chunk) == (
        True, "dots_saveable", False, 32)
    assert engine.module.h_1.attn.c_attn.cfg is cfg and engine.module.ln_f.cfg is cfg
    monkeypatch.setenv("DS_REMAT_POLICY", "everything_saveable")
    model = deepspeed_tpu_torch.GPT2LMHeadModel(deepspeed_tpu_torch.get_gpt2_config("test", **MODEL),
                                                device="cpu")
    engine = deepspeed_tpu_torch.initialize(model=model, device="cpu", config={
        "train_batch_size": 4, "program": {"remat_policy": "dots_saveable"}})[0]
    assert (engine.module.config.remat, engine.module.config.remat_policy) == (True,
                                                                               "everything_saveable")
    monkeypatch.delenv("DS_REMAT_POLICY")
    llama = deepspeed_tpu_torch.LlamaForCausalLM(deepspeed_tpu_torch.get_llama_config("test"),
                                                 device="cpu")
    with pytest.raises(ValueError, match="attn_fused_qkv"):
        deepspeed_tpu_torch.initialize(model=llama, device="cpu",
                                       config={"train_batch_size": 4, "program": {"fused_qkv": False}})


def test_program_curve_matches_jax():
    config = {"train_batch_size": 4, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "gradient_clipping": 1.0, "steps_per_print": 10**9,
              "program": {"remat": True, "remat_policy": "dots_saveable", "fused_qkv": False,
                          "fused_attn_out": False}}
    jax_engine = deepspeed_tpu.initialize(model=JaxGPT2(jax_config("test", dropout=0.0, **MODEL)),
                                          config=dict(config),
                                          topology=MeshTopology(data=1, devices=jax.devices()[:1]))[0]
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (4, 64)).astype(np.int32) for _ in range(4)]
    jax_engine.initialize_state({"input_ids": batches[0]})
    init = jax.device_get(jax_engine.state.params)
    want = [float(jax_engine.train_batch({"input_ids": b})) for b in batches]
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", **MODEL)
    engine = deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu"),
        model_parameters=params_from_jax(init, cfg), config=config, device="cpu")[0]
    got = [float(engine.train_batch({"input_ids": b})) for b in batches]
    assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) <= 1e-5, (got, want)
