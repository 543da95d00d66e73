"""fp16 training through the port's ``initialize`` against the JAX engine.

GPT-2 "test", LLaMA "test" and the GPT-2 "test" MoE (4 experts in layer 1,
top-1, RTS off) compute in fp16 over fp32 masters, from the same initial
weights (``params_from_jax``), under fp16 with a scale window of 2 (the
scale doubles every two good steps): the loss at every step within
``FP16_RTOL`` of JAX's (fp16 rounds at other places in the two frameworks;
measured at most 4.6e-5, ``pytest -s`` prints it) and the loss scale and
the skipped steps equal at every step. Then JAX's overflow-skip test
(``tests/unit/runtime/test_engine.py:116-131``) mirrored: a 2^40 scale with
hysteresis 1 skips the step, cuts the scale to 2^39 as JAX's does and
leaves the parameters bit-equal; an fp16 tag resumes bit-exact (the
scaler's state travels in it); fp16 composes with ``offload_optimizer``
(JAX's curve and scales, and an overflow that skips the host update); and
the flash backend's plain versions in fp16 against JAX's flash kernels in
interpret mode on fp16 inputs, forward and backward, within 2e-3 of max
|ref| (both compute in fp32 and round their outputs to fp16).
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_gpt2_config
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.models.llama import get_llama_config as jax_llama_config
from deepspeed_tpu.moe import routing as jax_routing
from deepspeed_tpu.parallel.topology import MeshTopology
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.moe import routing
from deepspeed_tpu_torch.ops.cuda import flash_attention as port_flash

jax_flash = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_route():
    routing.set_default_route(None, None)
    jax_routing.set_default_route(None, None)
    yield
    routing.set_default_route(None, None)


FP16_RTOL = 1e-3
STEPS = 6
FP16 = {"enabled": True, "loss_scale_window": 2}
CONFIG = {"train_batch_size": 4, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
          "gradient_clipping": 1.0, "zero_optimization": {"stage": 0}, "steps_per_print": 10**9,
          "fp16": FP16}
GPT2 = dict(n_layer=2, n_embd=64, n_head=4, n_positions=64)
MODELS = {
    "gpt2": (lambda: JaxGPT2(jax_gpt2_config("test", dropout=0.0, dtype=jnp.float16, **GPT2)),
             lambda: deepspeed_tpu_torch.get_gpt2_config("test", dtype=torch.float16, **GPT2),
             deepspeed_tpu_torch.GPT2LMHeadModel),
    "llama": (lambda: JaxLlama(jax_llama_config("test", dtype=jnp.float16, max_position_embeddings=64)),
              lambda: deepspeed_tpu_torch.get_llama_config("test", dtype=torch.float16,
                                                           max_position_embeddings=64),
              deepspeed_tpu_torch.LlamaForCausalLM),
    "gpt2-moe": (lambda: JaxGPT2(jax_gpt2_config("test", dropout=0.0, dtype=jnp.float16, moe_num_experts=4,
                                                 moe_layer_freq=2, moe_k=1, moe_use_rts=False, **GPT2)),
                 lambda: deepspeed_tpu_torch.get_gpt2_config("test", dtype=torch.float16, moe_num_experts=4,
                                                             moe_layer_freq=2, moe_k=1, moe_use_rts=False,
                                                             **GPT2),
                 deepspeed_tpu_torch.GPT2LMHeadModel),
}


def _batches(n=STEPS, vocab=256):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (4, 64)).astype(np.int32) for _ in range(n)]


def _jax_engine(family, config):
    return deepspeed_tpu.initialize(model=MODELS[family][0](), config=dict(config),
                                    topology=MeshTopology(data=1, devices=jax.devices()[:1]))[0]


def _jax_curve(family, config, n=STEPS):
    engine = _jax_engine(family, config)
    batches = _batches(n)
    engine.initialize_state({"input_ids": batches[0]})
    init = jax.device_get(engine.state.params)
    rows = []
    for b in batches:
        loss = float(engine.train_batch({"input_ids": b}))
        rows.append((loss, engine.cur_scale, engine.skipped_steps))
    return init, rows


@pytest.fixture(scope="module")
def jax_gpt2():
    """JAX's GPT-2 curve at ``CONFIG`` and its initial weights, from an
    engine without offload (under ``offload_optimizer`` JAX's state holds
    the compute-dtype copies): one JAX run that the curve, resume and
    offload tests share."""
    return _jax_curve("gpt2", CONFIG)


def _port_engine(family, tree, config):
    cfg = MODELS[family][1]()
    model = MODELS[family][2](cfg, device="cpu")
    return deepspeed_tpu_torch.initialize(model=model, model_parameters=params_from_jax(tree, cfg),
                                          config=config, device="cpu")[0]


def _port_rows(engine, batches):
    rows = []
    for b in batches:
        loss = float(engine.train_batch({"input_ids": b}))
        rows.append((loss, engine.cur_scale, engine.skipped_steps))
    return rows


def _check_rows(rows, want, what):
    rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(rows, want))
    print(f"fp16 {what}: max relative loss difference to JAX {rel:.3e}")  # pytest -s
    assert rel <= FP16_RTOL, (rows, want)
    assert [r[1:] for r in rows] == [w[1:] for w in want], (rows, want)


@pytest.mark.parametrize("family", MODELS)
def test_fp16_curve_and_scale_match_jax(family, jax_gpt2):
    init, want = jax_gpt2 if family == "gpt2" else _jax_curve(family, CONFIG)
    assert [w[1] for w in want] == [2.0**16, 2.0**17, 2.0**17, 2.0**18, 2.0**18, 2.0**19]
    engine = _port_engine(family, init, CONFIG)
    assert engine.fp16_enabled() and engine.dynamic_loss_scale() and engine.cur_scale == 2.0**16
    _check_rows(_port_rows(engine, _batches()), want, family)
    assert engine.get_loss_scale() == want[-1][1]
    assert engine.communication_data_type == torch.float16


def test_fp16_overflow_skips_step_as_jax_does():
    cfg = dict(CONFIG, fp16={"enabled": True, "loss_scale": 0, "initial_scale_power": 40,
                             "hysteresis": 1})
    jax_engine = _jax_engine("gpt2", cfg)
    batch = {"input_ids": _batches(1)[0]}
    jax_engine.initialize_state(batch)
    init = jax.device_get(jax_engine.state.params)
    jax_engine.train_batch(batch)
    engine = _port_engine("gpt2", init, cfg)
    before = {k: p.detach().clone() for k, p in engine.module.named_parameters()}
    scale_before = engine.cur_scale
    engine.train_batch(batch)
    assert engine.cur_scale < scale_before and engine.cur_scale == jax_engine.cur_scale == 2.0**39
    assert engine.skipped_steps == jax_engine.skipped_steps == 1
    assert all(torch.equal(p, before[k]) for k, p in engine.module.named_parameters())
    assert engine.optimizer.count == 0
    assert ("Train/consecutive_overflow_skips", 1, 1) in engine.overflow_events


def test_fp16_tag_resumes_bit_exact(tmp_path, jax_gpt2):
    init = jax_gpt2[0]
    batches = _batches()
    engine = _port_engine("gpt2", init, CONFIG)
    _port_rows(engine, batches[:3])
    engine.save_checkpoint(str(tmp_path))
    want = _port_rows(engine, batches[3:])
    # a fresh engine from other weights: every bit of the state comes from the tag
    other = _port_engine("gpt2", jax.tree.map(lambda x: x * 0.5, init), CONFIG)
    other.load_checkpoint(str(tmp_path))
    assert other.loss_scale_state == _port_engine("gpt2", init, CONFIG).loss_scale_state._replace(
        loss_scale=2.0**17, good_steps=3)
    assert _port_rows(other, batches[3:]) == want
    for (k, p), q in zip(engine.module.named_parameters(), other.module.parameters()):
        assert torch.equal(p, q), k
    assert other.loss_scale_state == engine.loss_scale_state


OFFLOAD = {"stage": 2, "offload_optimizer": {"device": "cpu"}}


def test_fp16_under_offload_optimizer_matches_jax(jax_gpt2):
    cfg = dict(CONFIG, zero_optimization=OFFLOAD)
    _, want = _jax_curve("gpt2", cfg, n=4)
    engine = _port_engine("gpt2", jax_gpt2[0], cfg)
    assert type(engine.optimizer).__name__ == "DeepSpeedCPUAdam"
    _check_rows(_port_rows(engine, _batches(4)), want, "offload_optimizer")


def test_fp16_overflow_under_offload_skips_the_host_update(jax_gpt2):
    cfg = dict(CONFIG, zero_optimization=OFFLOAD,
               fp16={"enabled": True, "initial_scale_power": 40, "hysteresis": 1})
    _, want = _jax_curve("gpt2", cfg, n=1)
    engine = _port_engine("gpt2", jax_gpt2[0], cfg)
    masters = [m.clone() for m in engine._host_masters]
    _check_rows(_port_rows(engine, _batches(1)), want, "offload overflow")
    assert engine.skipped_steps == 1 and engine.cur_scale == 2.0**39
    assert all(torch.equal(a, b) for a, b in zip(masters, engine._host_masters))
    assert engine.optimizer.step_count == 0


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 24)])
def test_plain_flash_in_fp16_matches_jax_flash(causal, window):
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal((2, 64, 2, 64)).astype(np.float16) for _ in range(4))
    kw = dict(causal=causal, window=window)
    out, vjp = jax.vjp(lambda a, b, c: jax_flash.flash_attention(a, b, c, interpret=True, **kw),
                       *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = port_flash.flash_attention(tq, tk, tv, **kw)
    got.backward(torch.from_numpy(do))
    assert got.dtype == torch.float16 and tq.grad.dtype == torch.float16
    for g, r in zip((got, tq.grad, tk.grad, tv.grad), (out,) + tuple(grads)):
        r = np.asarray(r, np.float32)
        err = np.abs(g.detach().float().numpy() - r).max()
        assert err <= 2e-3 * np.abs(r).max(), err
