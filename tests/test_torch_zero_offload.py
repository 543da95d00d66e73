"""ZeRO-Offload and ZeRO-Infinity in the port's engine against the JAX
package's.

GPT-2 "test" (2 layers, 64 wide, seq 64, batch 4, AdamW 1e-3, clipping 1.0,
fp32, remat on) trains 5 steps of seeded numpy batches under
``offload_optimizer`` cpu (stage 2), ``offload_param`` cpu (stage 3) and
both, through ``deepspeed_tpu.initialize`` on one device and the port's
``initialize`` from the same initial weights: the port's loss within 1e-5
of JAX's at every step (the engine-parity limit of
``tests/test_torch_engine.py``), and the same for a LLaMA "test" curve
under both offloads. Within the port: ``offload_param`` gives dense stage
3's bits, stages 1-3 give stage 0's, the nvme tiers give their cpu tiers'
bits (swap files named as JAX names them, the host window held, parameters
released between steps, a fetch equal to the live values), the contract
errors carry JAX's messages, and a checkpoint written under offload resumes
bit-exactly. JAX's own ``test_offload_param_checkpoint_roundtrip`` fails in
the JAX package, so the round trip is held to the port's uninterrupted run.
``tests/test_torch_zero_offload_cuda.py`` holds what only the card shows:
where the bytes live on it.
"""

import logging
import os

import numpy as np
import pytest

import jax
import torch

import deepspeed_tpu
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_gpt2_config
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.models.llama import get_llama_config as jax_llama_config
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
from deepspeed_tpu.runtime.zero.config import DeepSpeedZeroConfig as JaxZeroConfig
from deepspeed_tpu.runtime.zero.config import (DeepSpeedZeroOffloadOptimizerConfig as JaxOffOpt,
                                               DeepSpeedZeroOffloadParamConfig as JaxOffParam)
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import load_state_dict_from_npz
from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.runtime import zero
from deepspeed_tpu_torch.runtime.swap_tensor import NVMeAdam
from deepspeed_tpu_torch.runtime.zero.config import (DeepSpeedZeroConfig,
                                                     DeepSpeedZeroOffloadOptimizerConfig,
                                                     DeepSpeedZeroOffloadParamConfig)
from deepspeed_tpu_torch.runtime.zero.param_offload import PartitionedParamSwapper


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PARITY_RTOL = 1e-5
STEPS = 5
GPT2 = dict(n_layer=2, n_embd=64, n_head=4, n_positions=64, remat=True)
LLAMA = dict(remat=True, max_position_embeddings=64)
CONFIG = {"train_batch_size": 4, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
          "gradient_clipping": 1.0, "steps_per_print": 10**9}
COMBOS = {"offload_optimizer": {"stage": 2, "offload_optimizer": {"device": "cpu"}},
          "offload_param": {"stage": 3, "offload_param": {"device": "cpu"}},
          "both": {"stage": 3, "offload_param": {"device": "cpu"},
                   "offload_optimizer": {"device": "cpu"}}}


def _batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (4, 64)).astype(np.int32) for _ in range(n)]


def _config(zero_block, **over):
    return dict(CONFIG, zero_optimization=zero_block, **over)


def _jax_curve(module, zero_block):
    set_topology(None)
    engine, _, _, _ = deepspeed_tpu.initialize(
        model=module, topology=MeshTopology(data=1, devices=jax.devices()[:1]),
        config=_config(zero_block))
    batches = _batches()
    engine.initialize_state({"input_ids": batches[0]})
    # copies: on the CPU the JAX host Adam updates masters that may share
    # the initial arrays' buffers
    init = jax.tree.map(np.array, jax.device_get(engine.state.params))
    losses = [float(engine.train_batch({"input_ids": b})) for b in batches]
    set_topology(None)
    return init, losses


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's curves under each offload combination (GPT-2 "test") and under
    both offloads (LLaMA "test"), with their initial weights."""
    runs = {name: _jax_curve(JaxGPT2(jax_gpt2_config("test", dropout=0.0, **GPT2)), block)
            for name, block in COMBOS.items()}
    runs["llama-both"] = _jax_curve(JaxLlama(jax_llama_config("test", **LLAMA)), COMBOS["both"])
    return runs


def _gpt2(tree=None, generator=None, **over):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", **dict(GPT2, **over))
    model = deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu", generator=generator)
    if tree is not None:
        model.load_state_dict(params_from_jax(tree, cfg))
    return model


def _engine(zero_block, model=None, **cfg_over):
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model if model is not None else _gpt2(), config=_config(zero_block, **cfg_over),
        device="cpu")
    return engine


def _train(engine, batches):
    return [float(engine.train_batch(b)) for b in batches]


def _params(engine):
    engine._ensure_params_resident()
    return {k: p.detach().clone() for k, p in engine.module.named_parameters()}


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


@pytest.mark.parametrize("combo", COMBOS)
def test_offload_curve_matches_jax(jax_runs, combo):
    init, want = jax_runs[combo]
    engine = _engine(COMBOS[combo], model=_gpt2(init))
    got = _train(engine, _batches())
    print(f"fp32 loss curve {combo}: max relative difference to JAX {_rel(got, want):.3e}")
    assert _rel(got, want) <= PARITY_RTOL, (got, want)
    assert engine.global_steps == STEPS


def test_llama_curve_under_both_offloads_matches_jax(jax_runs):
    init, want = jax_runs["llama-both"]
    cfg = deepspeed_tpu_torch.get_llama_config("test", **LLAMA)
    model = deepspeed_tpu_torch.LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(init, cfg))
    engine = _engine(COMBOS["both"], model=model)
    got = _train(engine, _batches())
    assert _rel(got, want) <= PARITY_RTOL, (got, want)
    assert isinstance(engine.optimizer, DeepSpeedCPUAdam)


#: model variants of the bit-equality checks: remat on and off, the flash
#: backend (its plain versions here) with the fused head, two micro-batches
VARIANTS = {"remat": ({}, 1), "no-remat": (dict(remat=False), 1),
            "flash-fused-gas2": (dict(attention_backend="flash", fused_head_loss_chunk=48), 2)}


@pytest.mark.parametrize("variant", VARIANTS)
def test_offload_param_gives_dense_stage3_bits(variant):
    over, gas = VARIANTS[variant]
    runs = {}
    for name, block in (("dense", {"stage": 3}),
                        ("offload", {"stage": 3, "offload_param": {"device": "cpu"}})):
        engine = _engine(block, model=_gpt2(**over), gradient_accumulation_steps=gas)
        runs[name] = (_train(engine, _batches(3)), _params(engine),
                      float(engine.eval_batch(_batches(1)[0])))
    assert runs["offload"][0] == runs["dense"][0]
    assert _same(runs["offload"][1], runs["dense"][1])
    assert runs["offload"][2] == runs["dense"][2]  # eval_batch streams too


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stages_give_stage0_bits(stage):
    ref = _engine({"stage": 0})
    want = _train(ref, _batches(3))
    engine = _engine({"stage": stage})
    assert _train(engine, _batches(3)) == want
    assert _same(_params(engine), _params(ref))
    assert engine.zero_optimization_stage() == stage and isinstance(engine.optimizer, FusedAdam)


def test_where_the_state_lives():
    """offload_optimizer: no FusedAdam, host masters of their own, moments
    numpy arrays; offload_param: every parameter a host tensor with no
    .grad, the blocks streamed inside their remat regions (twice a step:
    forward and recompute), the other leaves once."""
    opt = _engine(COMBOS["offload_optimizer"])
    assert isinstance(opt.optimizer, DeepSpeedCPUAdam) and opt.zero_offload_optimizer().device == "cpu"
    _train(opt, _batches(1))
    for m, p in zip(opt._host_masters, opt.module.parameters()):
        assert m.device.type == "cpu" and m.data_ptr() != p.data_ptr() and torch.equal(m, p.detach())
    assert all(isinstance(v, np.ndarray) for st in opt.optimizer.state.values() for v in st.values())
    par = _engine(COMBOS["offload_param"])
    assert isinstance(par.optimizer, FusedAdam) and par.zero_offload_param().device == "cpu"
    par.initialize_state()
    par._streamer.reset_counters()
    _train(par, _batches(1))
    named = dict(par.module.named_parameters())
    assert all(p.device.type == "cpu" and p.grad is None for p in named.values())
    n_block = sum(k.startswith("h_") for k in named)
    assert par._streamer.copies == 2 * n_block + (len(named) - n_block)
    both = _engine(COMBOS["both"])
    _train(both, _batches(1))
    assert all(m is p for m, p in zip(both._host_masters, both.module.parameters()))


def test_nvme_optimizer_gives_cpu_offload_bits(tmp_path):
    cpu = _engine(COMBOS["offload_optimizer"])
    want = _train(cpu, _batches(3))
    nvme = _engine({"stage": 2, "offload_optimizer": {"device": "nvme", "nvme_path": str(tmp_path)}})
    assert isinstance(nvme.optimizer, NVMeAdam)
    assert _train(nvme, _batches(3)) == want
    assert _same(_params(nvme), _params(cpu))
    n = len(list(nvme.module.parameters()))
    assert sorted(os.listdir(tmp_path / "optimizer")) == sorted(
        [f"exp_avg_{i}.bin" for i in range(n)] + [f"exp_avg_sq_{i}.bin" for i in range(n)])


def test_nvme_params_window_release_and_fetch(tmp_path):
    ref = _engine(COMBOS["both"])
    want = _train(ref, _batches(3))
    block = {"stage": 3, "offload_param": {"device": "nvme", "nvme_path": str(tmp_path),
                                           "max_in_cpu": 50000},
             "offload_optimizer": {"device": "cpu"}}
    engine = _engine(block)
    got = _train(engine, _batches(2))
    sw = engine._param_swapper
    # between steps the host holds the window alone (JAX's max_in_cpu contract)
    assert engine.params_released and 0 < sw.resident_bytes() <= 50000
    assert all(p.numel() == 0 for p in engine.module.parameters())
    n = len(list(engine.module.parameters()))
    assert sorted(os.listdir(tmp_path / "params")) == sorted(f"param_{i}.bin" for i in range(n))
    fetched = sw.fetch_all()
    engine._ensure_params_resident()
    for a, p in zip(fetched, engine.module.parameters()):
        assert a.tobytes() == p.detach().numpy().tobytes()
    got += _train(engine, _batches(3)[2:])
    assert got == want
    assert _same(_params(engine), _params(ref))


def test_param_swapper_round_trip(tmp_path):
    sw = PartitionedParamSwapper(str(tmp_path), window_bytes=300)
    leaves = [np.arange(10, dtype=np.float32), np.ones((4, 4), np.float32),
              np.arange(6, dtype=np.int32).reshape(2, 3)]
    sw.initialize(leaves)
    for a, b in zip(sw.fetch_all(), leaves):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    updated = [leaf * 2 for leaf in leaves]
    sw.write_back(updated)
    assert sw.resident_bytes() <= 300
    for a, b in zip(sw.fetch_all(), updated):
        assert np.array_equal(a, b)
    sw.close()


CONTRACT_ERRORS = {
    "param-needs-stage3": ({"stage": 2, "offload_param": {"device": "cpu"}}, ValueError,
                           "offload_param requires ZeRO stage 3"),
    "param-with-quantized-weights": ({"stage": 3, "offload_param": {"device": "cpu"},
                                      "zero_quantized_weights": True}, ValueError,
                                     "does not compose with zero_quantized_weights"),
    "bad-device": ({"stage": 2, "offload_optimizer": {"device": "disk"}}, ValueError,
                   "must be one of"),
    "bad-stage": ({"stage": 4}, ValueError, "must be one of"),
    "unknown-key": ({"stage": 2, "bucket": 1}, ValueError, "unknown keys"),
    "hpz": ({"stage": 3, "zero_hpz_partition_size": 2}, NotImplementedError, "item 8"),
    "mics": ({"stage": 3, "mics_shard_size": 4}, NotImplementedError, "item 8"),
    "quantized-weights": ({"stage": 3, "zero_quantized_weights": True}, NotImplementedError, "item 8"),
    "quantized-gradients": ({"stage": 2, "zero_quantized_gradients": True}, NotImplementedError,
                            "item 8"),
}


@pytest.mark.parametrize("case", CONTRACT_ERRORS)
def test_contract_errors(case):
    block, exc, match = CONTRACT_ERRORS[case]
    with pytest.raises(exc, match=match):
        _engine(block)


@pytest.mark.parametrize("cls,jax_cls", [(DeepSpeedZeroConfig, JaxZeroConfig),
                                         (DeepSpeedZeroOffloadParamConfig, JaxOffParam),
                                         (DeepSpeedZeroOffloadOptimizerConfig, JaxOffOpt)],
                         ids=["zero", "offload_param", "offload_optimizer"])
def test_zero_config_keys_and_defaults_are_jax(cls, jax_cls):
    """Every key of JAX's block with JAX's default (and ``"auto"`` taking it)."""
    theirs = jax_cls()
    ours = cls()
    keys = set(jax_cls.model_fields)
    assert keys == set(cls.FIELDS) | set(getattr(cls, "OFFLOAD", {}))
    for key in keys:
        want = getattr(theirs, key)
        want = getattr(want, "value", want)
        assert getattr(ours, key) == want, key
    auto = cls({k: "auto" for k in cls.FIELDS})
    assert all(getattr(auto, k) == getattr(ours, k) for k in cls.FIELDS)


def test_zero_config_reads_what_jax_reads():
    raw = {"stage": 3, "overlap_comm": False, "reduce_bucket_size": 5e7,
           "stage3_gather_fp16_weights_on_model_save": True,
           "offload_param": {"device": "nvme", "nvme_path": "/x", "max_in_cpu": 1e6,
                             "pin_memory": "true"},
           "offload_optimizer": {"device": "cpu", "pipeline_read": True}}
    ours, theirs = DeepSpeedZeroConfig(raw), JaxZeroConfig(**raw)
    for key in ("stage", "overlap_comm", "reduce_bucket_size",
                "stage3_gather_16bit_weights_on_model_save"):
        assert getattr(ours, key) == getattr(theirs, key), key
    for block in ("offload_param", "offload_optimizer"):
        for key in getattr(DeepSpeedZeroConfig.OFFLOAD[block], "FIELDS"):
            want = getattr(getattr(theirs, block), key)
            assert getattr(getattr(ours, block), key) == getattr(want, "value", want), (block, key)
    assert ours.offload_optimizer.pipeline and theirs.offload_optimizer.pipeline
    assert DeepSpeedZeroConfig({"stage": 3}).overlap_comm is True


CKPT_COMBOS = {"offload_optimizer": COMBOS["offload_optimizer"], "both": COMBOS["both"],
               "nvme-optimizer": {"stage": 2, "offload_optimizer": {"device": "nvme"}}}


@pytest.mark.parametrize("combo", CKPT_COMBOS)
def test_checkpoint_round_trip_under_offload_is_bit_exact(tmp_path, combo):
    block = dict(CKPT_COMBOS[combo])
    if combo.startswith("nvme"):
        block["offload_optimizer"] = dict(block["offload_optimizer"], nvme_path=str(tmp_path / "swap"))
    ref = _engine(block)
    want = _train(ref, _batches(4))
    first = _engine(block)
    _train(first, _batches(4)[:2])
    first.save_checkpoint(str(tmp_path / "ckpt"))
    assert os.path.isfile(tmp_path / "ckpt" / "global_step2" / "state" / "host_optimizer.pt")
    if combo.startswith("nvme"):  # the resumed engine swaps elsewhere
        block["offload_optimizer"] = dict(block["offload_optimizer"], nvme_path=str(tmp_path / "swap2"))
    fresh = _engine(block, model=_gpt2(generator=torch.Generator().manual_seed(9)))
    tag, _ = fresh.resume(str(tmp_path / "ckpt"))
    assert tag == "global_step2" and fresh.optimizer.step_count == 2
    assert _train(fresh, _batches(4)[2:]) == want[2:]
    assert _same(_params(fresh), _params(ref))


def test_a_tag_without_offload_rebuilds_the_host_optimizer(tmp_path, caplog):
    """JAX's rebuild rule: the parameters load, the masters follow them, the
    host moments reset (as a fresh host optimizer's from these weights)."""
    dense = _engine({"stage": 0})
    _train(dense, _batches(2))
    dense.save_checkpoint(str(tmp_path))
    engine = _engine(COMBOS["offload_optimizer"], model=_gpt2(generator=torch.Generator().manual_seed(5)))
    _train(engine, _batches(1))
    with caplog.at_level(logging.WARNING):
        engine.load_checkpoint(str(tmp_path))
    assert "rebuilt from the loaded parameters" in caplog.text
    assert _same(_params(engine), _params(dense))
    assert engine.optimizer.step_count == 0
    assert all(torch.equal(m, p.detach()) for m, p in zip(engine._host_masters,
                                                         engine.module.parameters()))
    twin = _engine(COMBOS["offload_optimizer"], model=_gpt2())
    twin.module.load_state_dict(dense.module.state_dict())
    twin._load_host_optimizer(None, reset=True)
    assert _train(engine, _batches(2)[1:]) == _train(twin, _batches(2)[1:])


def test_save_16bit_model_with_released_parameters(tmp_path):
    block = {"stage": 3, "offload_param": {"device": "nvme", "nvme_path": str(tmp_path / "swap"),
                                           "max_in_cpu": 0}}
    engine = _engine(block)
    _train(engine, _batches(1))
    assert engine.params_released
    path = engine.save_16bit_model(str(tmp_path / "out"))
    sd = params_from_jax(load_state_dict_from_npz(path), engine.module.config)
    for k, p in engine.module.named_parameters():
        assert torch.equal(sd[k], p.detach().to(torch.bfloat16)), k


def test_zero_init_and_gathered_parameters():
    """Stage-3 user code written against upstream runs unchanged."""
    assert zero.partition_parameters.get_active_init() is None
    with zero.Init(config_dict_or_path=_config({"stage": 3}), remote_device="cpu") as ctx:
        assert zero.partition_parameters.get_active_init() is ctx
        model = _gpt2()
    assert zero.partition_parameters.get_active_init() is None
    engine = _engine({"stage": 3, "offload_param": {"device": "cpu"}}, model=model)
    zero.register_external_parameter(engine.module, engine.module.wte)
    zero.unregister_external_parameter(engine.module, engine.module.wte)
    with zero.GatheredParameters(engine.module.ln_f.scale, modifier_rank=0) as p:
        with torch.no_grad():
            p.fill_(2.0)
    assert torch.equal(engine.module.ln_f.scale.detach(), torch.full_like(p, 2.0))
    assert np.isfinite(_train(engine, _batches(1))[0])
    with zero.GatheredParameters(None) as nothing:
        assert nothing is None


def test_load_optimizer_state_into_the_host_optimizer():
    """A named optimizer state (``checkpoint.from_jax.opt_state_from_jax``'s
    form) loads into the host Adam: its moments and count."""
    dense = _engine({"stage": 0})
    _train(dense, _batches(2))
    state = dense.optimizer.named_state(dict(dense.module.named_parameters()))
    engine = _engine(COMBOS["offload_optimizer"])
    engine.load_optimizer_state(state)
    assert engine.optimizer.step_count == 2
    for i, name in enumerate(dict(engine.module.named_parameters())):
        st = engine.optimizer.state[i]
        assert np.array_equal(st["m"], state["exp_avg"][name].reshape(-1).numpy())
        assert np.array_equal(st["v"], state["exp_avg_sq"][name].reshape(-1).numpy())


def test_hybrid_engine_refuses_offload_param():
    with pytest.raises(NotImplementedError, match="item 8"):
        _engine(COMBOS["offload_param"], hybrid_engine={"enabled": True, "max_out_tokens": 8})


def test_tensor_fragment_under_offload():
    """The fp32 getters and setter and the optimizer-state getter by name
    reach the host optimizer: a parameter set outside the step is its
    master's value at the next step, as on the device path."""
    from deepspeed_tpu_torch.utils import tensor_fragment as tf

    runs = {}
    for name, block in (("dense", {"stage": 0}), ("offload", COMBOS["offload_optimizer"])):
        engine = _engine(block)
        _train(engine, _batches(1))
        tf.safe_set_full_fp32_param(engine, "ln_f.scale", torch.full((64,), 0.5))
        assert torch.equal(tf.safe_get_full_fp32_param(engine, "ln_f.scale"), torch.full((64,), 0.5))
        runs[name] = (_train(engine, _batches(2)[1:]), _params(engine),
                      tf.safe_get_full_optimizer_state(engine, "wte", "exp_avg"))
    assert runs["offload"][0][0] == runs["dense"][0][0]
    torch.testing.assert_close(runs["offload"][1]["ln_f.scale"], runs["dense"][1]["ln_f.scale"],
                               rtol=0, atol=1e-6)
    # the two Adams round apart (JAX's host-Adam tolerance); the moment is the host one
    torch.testing.assert_close(runs["offload"][2], runs["dense"][2], rtol=2e-5, atol=1e-7)
