"""The port's training engine on a LLaMA model against the JAX package's.

LLaMA "test" (2 layers, hidden 64, GQA 4/2, seq 64, batch 4, AdamW 1e-3,
clipping 1.0, fp32, remat on, 8 steps of seeded numpy batches) through
``deepspeed_tpu.initialize`` and the port's ``initialize``, from the same
initial weights (``params_from_jax``), with the plain [B, L, V] head and
with the fused head on the untied [E, V] kernel (chunk 100), on the
``"flash"`` backend (the port's plain versions on the CPU, JAX's Pallas
kernels in interpret mode). The port's loss must stay within 1e-5 of JAX's
at every step (fp32 sums in another order; the GPT-2 curve of
``test_torch_engine.py`` holds the same limit). Both packages' schedulers
refuse a LLaMA engine.
"""

import numpy as np
import pytest

import jax
import torch

import deepspeed_tpu
from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.inference.serving import ContinuousBatchingScheduler as JaxScheduler
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.models.llama import get_llama_config as jax_config
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler

PARITY_RTOL = 1e-5
STEPS = 8
MODEL = dict(remat=True, attention_backend="flash", max_position_embeddings=64)
CONFIG = {"train_batch_size": 4, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
          "gradient_clipping": 1.0, "zero_optimization": {"stage": 0}, "steps_per_print": 10**9}
#: head variants: the plain head, and the fused head on the [E, V] kernel
HEADS = {"plain-head": {}, "fused-head": dict(fused_head_loss_chunk=100)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(n=STEPS):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (4, 64)).astype(np.int32) for _ in range(n)]


def _jax_curve(head):
    set_topology(None)
    module = JaxLlama(jax_config("test", **MODEL, **HEADS[head]))
    engine, _, _, _ = deepspeed_tpu.initialize(
        model=module, topology=MeshTopology(data=1, devices=jax.devices()[:1]), config=dict(CONFIG))
    batches = _batches()
    engine.initialize_state({"input_ids": batches[0]})
    init = jax.device_get(engine.state.params)
    losses = [float(engine.train_batch({"input_ids": b})) for b in batches]
    set_topology(None)
    return init, losses


@pytest.mark.parametrize("head", HEADS)
def test_loss_curve_matches_jax(head):
    init, want = _jax_curve(head)
    cfg = deepspeed_tpu_torch.get_llama_config("test", **MODEL, **HEADS[head])
    model = deepspeed_tpu_torch.LlamaForCausalLM(cfg, device="cpu")
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params_from_jax(init, cfg), config=CONFIG, device="cpu")
    losses = [float(engine.train_batch({"input_ids": b})) for b in _batches()]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    print(f"fp32 LLaMA loss curve {head}: max relative difference to JAX {rel:.3e}")  # pytest -s
    assert rel <= PARITY_RTOL, (losses, want)
    assert losses[-1] < losses[0] and engine.global_steps == STEPS


def test_both_schedulers_refuse_llama():
    set_topology(None)
    topo = MeshTopology(tensor=1, data=1, fsdp=1, devices=jax.devices()[:1])
    jax_engine = JaxEngine(JaxLlama(jax_config("test")),
                           JaxInferenceConfig(replace_with_kernel_inject=False), topology=topo)
    with pytest.raises(NotImplementedError, match="LlamaForCausalLM"):
        JaxScheduler(jax_engine)
    set_topology(None)
    model = deepspeed_tpu_torch.LlamaForCausalLM(deepspeed_tpu_torch.get_llama_config("test"),
                                                 device="cpu")
    engine = deepspeed_tpu_torch.init_inference(model, device="cpu")
    with pytest.raises(NotImplementedError, match="LlamaForCausalLM"):
        ContinuousBatchingScheduler(engine)


def test_engine_refuses_an_fp32_model_under_bf16():
    model = deepspeed_tpu_torch.LlamaForCausalLM(deepspeed_tpu_torch.get_llama_config("test"),
                                                 device="cpu")
    with pytest.raises(ValueError, match="LlamaConfig.dtype=torch.bfloat16"):
        deepspeed_tpu_torch.initialize(model=model, config=dict(CONFIG, bf16={"enabled": True}),
                                       device="cpu")
