"""Layer reduction and knowledge distillation through the port's engine
against the JAX package's.

JAX's ``test_distillation_end_to_end_loss_decreases_and_gates_observed``:
a 4-layer GPT-2 "test" teacher (JAX's weights) seeds a 2-layer student
(``teacher_layer`` [1, 3], ``wte`` and ``ln_f`` copied), then trains 6 steps
on one fixed batch with KD (``kd_coef`` 0.5, T 2, ``layerwise_coef`` 0.1
from step 2). The port's 6 losses stay within 1e-5 of JAX's, with the
teacher given as a module and as a ``(module, state_dict)`` pair; steps 0
and 1 are bit-equal to the port's own run of the seeded student without
KD, and every later step differs from it.
"""

import flax.linen as fnn
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
from deepspeed_tpu.compression.compress import init_compression as jax_init_compression
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_gpt2_config
from deepspeed_tpu.parallel.topology import MeshTopology
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.compression import init_compression, student_initialization


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CONFIG = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
          "steps_per_print": 10**9}
LR_BLOCK = {"layer_reduction": {"enabled": True, "keep_number_layer": 2,
                                "module_name_prefix": "transformer.h", "teacher_layer": [1, 3],
                                "other_module_name": ["transformer.wte", "transformer.ln_f"]}}
KD_BLOCK = {"compression_training": {
    **LR_BLOCK, "knowledge_distillation": {"enabled": True, "kd_coef": 0.5, "temperature": 2.0,
                                           "layerwise_coef": 0.1, "schedule_offset": 2}}}


def _batch():
    return {"input_ids": np.random.RandomState(3).randint(0, 256, (8, 16)).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_run():
    """JAX's teacher, the student's initial weights and its 6 KD losses."""
    t_module = JaxGPT2(jax_gpt2_config("test", n_layer=4))
    init_fn = jax.jit(lambda key, ids: t_module.init(key, ids, deterministic=True))
    t_params = jax.device_get(fnn.meta.unbox(init_fn(jax.random.PRNGKey(7),
                                                     jnp.zeros((1, 8), jnp.int32))["params"]))
    engine, _, _, _ = deepspeed_tpu.initialize(
        model=JaxGPT2(jax_gpt2_config("test", n_layer=2)), config=dict(CONFIG, **KD_BLOCK),
        topology=MeshTopology(data=1, devices=jax.devices()[:1]))
    engine.initialize_state({"input_ids": np.zeros((8, 16), np.int32)})
    init = jax.device_get(engine.state.params)
    jax_init_compression(engine, KD_BLOCK, teacher_model=(t_module, t_params))
    return t_params, init, [float(engine.train_batch(_batch())) for _ in range(6)]


def _student(init, config):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", n_layer=2)
    return deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu"),
        model_parameters=params_from_jax(init, cfg), config=config, device="cpu")[0]


def _teacher(t_params):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", n_layer=4)
    model = deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu")
    state = params_from_jax(t_params, cfg)
    model.load_state_dict(state)
    return model, state


@pytest.mark.parametrize("form", ["module", "pair"])
def test_kd_losses_match_jax_and_gate_at_the_offset(jax_run, form):
    t_params, init, want = jax_run
    teacher, state = _teacher(t_params)
    if form == "pair":
        # the pair's weights run in the module's place: the module's own stay unused
        for p in teacher.parameters():
            torch.nn.init.zeros_(p)
        teacher = (teacher, state)
    engine = _student(init, dict(CONFIG, **KD_BLOCK))
    init_compression(engine, KD_BLOCK, teacher_model=teacher)
    got = [float(engine.train_batch(_batch())) for _ in range(6)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    assert rel <= 1e-5, (got, want)
    assert got[-1] < got[2]

    ref = _student(init, dict(CONFIG))
    ref.module.load_state_dict(student_initialization(ref.module.state_dict(), state,
                                                      {"compression_training": LR_BLOCK}))
    plain = [float(ref.train_batch(_batch())) for _ in range(6)]
    assert got[:2] == plain[:2], (got, plain)
    assert all(a != b for a, b in zip(got[2:], plain[2:])), (got, plain)
