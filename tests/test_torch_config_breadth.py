"""The port's training config against JAX's ``DeepSpeedConfig``, key by key.

Every key this slice takes resolves to JAX's value on the same dict (the
``fp16`` block and its bounds, the scalars, the ``checkpoint``,
``activation_checkpointing``, ``attention`` and ``progressive_layer_drop``
blocks, the optimizer types), and every key JAX reads that the port
refuses raises, naming the key and its reason.
"""

import pytest
import torch

from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.engine import _comm_dtype as jax_comm_dtype
import deepspeed_tpu_torch
from deepspeed_tpu_torch.runtime.config import REFUSED_KEYS, DeepSpeedConfig, comm_dtype


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BASE = {"train_batch_size": 8}

TAKEN = {
    "fp16-defaults": {"fp16": {"enabled": True}},
    "fp16-static": {"fp16": {"enabled": True, "loss_scale": 128.0, "auto_cast": True,
                             "fp16_master_weights_and_grads": True}},
    "fp16-dynamic": {"fp16": {"enabled": "true", "initial_scale_power": 12, "loss_scale_window": 50,
                              "hysteresis": 4, "consecutive_hysteresis": True,
                              "min_loss_scale": 0.5}},
    "fp16-auto": {"fp16": {"enabled": True, "initial_scale_power": "auto"}},
    "scalars": {"dump_state": True, "wall_clock_breakdown": True, "memory_breakdown": True,
                "prescale_gradients": True, "gradient_predivide_factor": 2.0,
                "sparse_gradients": True, "communication_data_type": "bf16",
                "disable_allgather": True},
    "checkpoint": {"checkpoint": {"tag_validation": "Fail", "use_node_local_storage": True,
                                  "parallel_write": {"pipeline_stage": True}}},
    "activation-checkpointing": {"activation_checkpointing": {
        "partition_activations": True, "contiguous_memory_optimization": True,
        "number_checkpoints": 3, "synchronize_checkpoint_boundary": True, "profile": True}},
    "attention-policy": {"attention": {"policy": "recompute"}},
    "pld": {"progressive_layer_drop": {"enabled": True, "theta": 0.3, "gamma": 0.01}},
    "lamb": {"optimizer": {"type": "LAMB", "params": {"lr": 2e-3, "max_coeff": 5.0}}},
    "adagrad": {"optimizer": {"type": "Adagrad", "params": {"lr": 1e-2, "eps": 1e-9}}},
    "sgd": {"optimizer": {"type": "sgd", "params": {"lr": 0.1, "momentum": 0.5}}},
    "lion": {"optimizer": {"type": "Lion", "params": {"b1": 0.8, "weight_decay": 0.0}}},
}

#: (port attribute, JAX attribute) pairs, the fields of the config objects read
FIELDS = [("fp16_enabled",) * 2, ("fp16_auto_cast",) * 2, ("loss_scale",) * 2,
          ("initial_dynamic_scale",) * 2, ("dynamic_loss_scale_args",) * 2,
          ("bfloat16_enabled",) * 2, ("dump_state",) * 2, ("wall_clock_breakdown",) * 2,
          ("memory_breakdown",) * 2, ("prescale_gradients",) * 2,
          ("gradient_predivide_factor",) * 2, ("sparse_gradients_enabled",) * 2,
          ("communication_data_type",) * 2, ("disable_allgather",) * 2, ("pld_enabled",) * 2,
          ("pld_params",) * 2, ("optimizer_name",) * 2, ("optimizer_params",) * 2]
BLOCKS = {"fp16_config": ("enabled", "auto_cast", "loss_scale", "initial_scale_power",
                          "loss_scale_window", "hysteresis", "consecutive_hysteresis",
                          "min_loss_scale", "fp16_master_weights_and_grads"),
          "checkpoint_config": ("tag_validation", "load_universal", "use_node_local_storage",
                                "parallel_write"),
          "activation_checkpointing_config": ("partition_activations",
                                              "contiguous_memory_optimization", "cpu_checkpointing",
                                              "number_checkpoints", "synchronize_checkpoint_boundary",
                                              "profile"),
          "attention_config": ("policy",),
          "program_config": ("remat", "remat_every", "remat_policy", "lm_head_chunk", "fused_qkv",
                             "fused_attn_out")}


@pytest.mark.parametrize("case", TAKEN)
def test_taken_keys_resolve_as_jax(case):
    raw = dict(BASE, **TAKEN[case])
    port, jax_cfg = DeepSpeedConfig(dict(raw)), JaxConfig(dict(raw), world_size=1)
    for ours, theirs in FIELDS:
        assert getattr(port, ours) == getattr(jax_cfg, theirs), (case, ours)
    for block, keys in BLOCKS.items():
        for key in keys:
            assert getattr(getattr(port, block), key) == getattr(getattr(jax_cfg, block), key), \
                (case, block, key)


@pytest.mark.parametrize("block", [{"fp16": {"loss_scale": -1.0}}, {"fp16": {"loss_scale_window": 0}},
                                   {"fp16": {"hysteresis": -1}}, {"fp16": {"min_loss_scale": -0.5}},
                                   {"fp16": {"initial_scale_power": -2}}, {"fp16": {"loss_scal": 1}},
                                   {"program": {"remat_every": 0}}, {"program": {"lm_head_chunk": -1}},
                                   {"attention": {"block_q": 4}}, {"checkpoint": {"tag": "x"}}])
def test_out_of_bounds_values_raise_as_jax(block):
    with pytest.raises(ValueError):
        JaxConfig(dict(BASE, **block), world_size=1)
    with pytest.raises((ValueError, NotImplementedError)):
        DeepSpeedConfig(dict(BASE, **block))


@pytest.mark.parametrize("name", ["fp16", "FLOAT16", "half", "bf16", "bfloat16", "fp32", "float",
                                  None, "int8", "fp8"])
def test_communication_data_type_as_jax(name):
    jax_cfg = JaxConfig(dict(BASE, communication_data_type=name), world_size=1)
    try:
        want = jax_comm_dtype(jax_cfg)
    except ValueError as e:
        with pytest.raises(ValueError, match="expected fp16/bf16/fp32"):
            DeepSpeedConfig(dict(BASE, communication_data_type=name))
        assert "expected fp16/bf16/fp32" in str(e)
        return
    assert comm_dtype(name) == (None if want is None else want.__name__)


@pytest.mark.parametrize("key", sorted(REFUSED_KEYS))
def test_refused_keys_name_themselves(key):
    with pytest.raises(NotImplementedError, match=f"config key '{key}' belongs to a later slice"):
        DeepSpeedConfig(dict(BASE, **{key: {"enabled": True}}))


@pytest.mark.parametrize("block,match", [
    ({"attention": {"block_q": 128}}, "attention.block_q: the JAX flash kernel's TPU block geometry"),
    ({"attention": {"bwd_skip": "none"}}, "attention.bwd_skip"),
    ({"attention": {"cache_file": "x.json"}}, "attention.cache_file"),
    ({"attention": {"block_k_bwd": 64}}, "attention.block_k_bwd"),
    ({"checkpoint": {"load_universal": True}}, "checkpoint.load_universal"),
    ({"optimizer": {"type": "Adam", "legacy_fusion": True}}, "optimizer.legacy_fusion"),
    ({"optimizer": {"type": "ZeroOneAdam"}}, "one-bit"),
    ({"no_such_key": 1}, "no key of the JAX package's config"),
])
def test_refused_values_name_the_key_and_reason(block, match):
    with pytest.raises(NotImplementedError, match=match):
        DeepSpeedConfig(dict(BASE, **block))


def test_fp16_with_bf16_raises_and_the_model_dtype_must_match():
    with pytest.raises(deepspeed_tpu_torch.runtime.config.DeepSpeedConfigError, match="simultaneously"):
        DeepSpeedConfig(dict(BASE, fp16={"enabled": True}, bf16={"enabled": True}))
    model = deepspeed_tpu_torch.GPT2LMHeadModel(deepspeed_tpu_torch.get_gpt2_config("test"), device="cpu")
    with pytest.raises(ValueError, match="float16"):
        deepspeed_tpu_torch.initialize(model=model, device="cpu", config=dict(BASE, fp16={"enabled": True}))


def test_wall_clock_breakdown_times_train_batch():
    import numpy as np
    model = deepspeed_tpu_torch.GPT2LMHeadModel(deepspeed_tpu_torch.get_gpt2_config("test"), device="cpu")
    engine = deepspeed_tpu_torch.initialize(model=model, device="cpu", config=dict(
        BASE, wall_clock_breakdown=True, steps_per_print=10**9))[0]
    assert engine.wall_clock_breakdown()
    engine.train_batch(np.zeros((8, 16), np.int32))
    assert engine.timers("train_batch").elapsed(reset=False) > 0.0
    assert "train_batch" in engine.timers.log(["train_batch"])
    off = deepspeed_tpu_torch.initialize(model=model, device="cpu", config=dict(BASE))[0]
    assert off.timers("train_batch").elapsed() == 0


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_attention_policy_is_the_engines_own(family, monkeypatch):
    """``attention.policy`` lands on the model's config as
    ``attention_policy`` and reaches each flash call of that model; an
    engine built later without the block keeps the default, and an unknown
    policy raises when the engine is built."""
    import numpy as np
    from deepspeed_tpu_torch.ops.cuda import flash_attention

    seen = []
    apply = flash_attention.FlashAttention.apply
    monkeypatch.setattr(flash_attention.FlashAttention, "apply",
                        lambda *args: seen.append(args[-1]) or apply(*args))

    def engine(extra):
        if family == "gpt2":
            cfg = deepspeed_tpu_torch.get_gpt2_config("test", n_layer=2, attention_backend="flash")
            model = deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu")
        else:
            cfg = deepspeed_tpu_torch.get_llama_config("test", num_hidden_layers=2,
                                                       attention_backend="flash")
            model = deepspeed_tpu_torch.LlamaForCausalLM(cfg, device="cpu")
        return deepspeed_tpu_torch.initialize(model=model, device="cpu",
                                              config=dict(BASE, steps_per_print=10**9, **extra))[0]

    batch = np.zeros((8, 16), np.int32)
    recompute = engine({"attention": {"policy": "recompute"}})
    assert recompute.module.config.attention_policy == "recompute"
    recompute.train_batch(batch)
    assert seen and set(seen) == {"recompute"}
    seen.clear()
    plain = engine({})
    assert plain.module.config.attention_policy is None
    plain.train_batch(batch)
    recompute.train_batch(batch)
    assert seen == ["lse"] * (len(seen) // 2) + ["recompute"] * (len(seen) // 2)
    with pytest.raises(ValueError, match="unknown flash backward policy 'keep'"):
        engine({"attention": {"policy": "keep"}})
