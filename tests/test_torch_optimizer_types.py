"""The port's optimizer types against the JAX package's.

``FusedLamb``, ``Adagrad``, ``SGD`` (with and without momentum) and ``Lion``
(``runtime/optimizers.py``) against JAX's ``fused_lamb``, device
``adagrad``, ``optax.sgd`` and ``optax.lion`` (updates under ``jax.jit``) on
a random tree of fp32 leaves and random gradients, five steps, constant and
scheduled learning rates: every parameter and state leaf within 1e-6 of
max |ref| (fp32 sums in another order; the trust ratio's norms). Then four
steps of the GPT-2 "test" engine per type against the JAX engine's curve
(1e-5 per step, as the Adam curves), each optimizer's state through a
checkpoint tag, and the refusals: the one-bit types, keys JAX's
constructor does not take, and a type other than Adam under offload.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.ops.adagrad.cpu_adagrad import adagrad as jax_adagrad
from deepspeed_tpu.ops.lamb.fused_lamb import fused_lamb as jax_fused_lamb
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu.runtime.lr_schedules import get_lr_schedule as jax_get_lr_schedule
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-6
SHAPES = ((7, 5), (13,), (3, 4, 2))
WARMUP = dict(warmup_min_lr=0.0, warmup_max_lr=0.05, warmup_num_steps=4, warmup_type="linear")

#: name -> (the port's type and params, JAX's transformation from lr, the state slots)
CASES = {
    "lamb": ("lamb", dict(weight_decay=0.01, betas=(0.8, 0.99), max_coeff=3.0, min_coeff=0.05),
             lambda lr: jax_fused_lamb(lr=lr, weight_decay=0.01, betas=(0.8, 0.99), max_coeff=3.0,
                                       min_coeff=0.05)),
    "lamb-no-correction": ("lamb", dict(bias_correction=False),
                           lambda lr: jax_fused_lamb(lr=lr, bias_correction=False)),
    "adagrad": ("adagrad", dict(weight_decay=0.02, eps=1e-8),
                lambda lr: jax_adagrad(lr=lr, weight_decay=0.02, eps=1e-8)),
    "sgd": ("sgd", {}, lambda lr: optax.sgd(learning_rate=lr, momentum=None)),
    "sgd-momentum": ("sgd", dict(momentum=0.9), lambda lr: optax.sgd(learning_rate=lr, momentum=0.9)),
    "lion": ("lion", dict(b1=0.95, b2=0.98, weight_decay=0.1),
             lambda lr: optax.lion(learning_rate=lr, b1=0.95, b2=0.98, weight_decay=0.1)),
    "lion-defaults": ("lion", {}, lambda lr: optax.lion(learning_rate=lr)),
}


def _close(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1.0), err


@pytest.mark.parametrize("schedule", [False, True], ids=["constant", "warmup"])
@pytest.mark.parametrize("case", CASES)
def test_update_matches_jax(case, schedule):
    name, params, make = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    leaves = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    lr = 0.03
    port_lr = get_lr_schedule("WarmupLR", WARMUP) if schedule else None
    jax_lr = jax_get_lr_schedule("WarmupLR", WARMUP) if schedule else lr
    tx = make(jax_lr)
    jparams = [jnp.asarray(x) for x in leaves]
    jstate = tx.init(jparams)

    @jax.jit
    def jstep(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    tparams = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in leaves]
    opt = build_optimizer(name, tparams, dict(params, lr=lr), lr_schedule=port_lr)
    for _ in range(5):
        grads = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        jparams, jstate = jstep(jparams, jstate, [jnp.asarray(g) for g in grads])
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for p, w in zip(tparams, jparams):
            _close(p, w)
    for slot in opt.slots:
        jslot = {"exp_avg": "exp_avg", "exp_avg_sq": "exp_avg_sq", "accum": "accum"}.get(slot)
        if jslot is not None:
            for p, w in zip(tparams, getattr(jstate, jslot)):
                _close(opt.state[p][slot], w)


MODEL = dict(n_layer=2, n_embd=64, n_head=4, n_positions=64)
CONFIG = {"train_batch_size": 4, "gradient_clipping": 1.0, "zero_optimization": {"stage": 0},
          "steps_per_print": 10**9}
ENGINE_CASES = {"lamb": {"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}},
                "adagrad": {"type": "Adagrad", "params": {"lr": 1e-2}},
                "sgd": {"type": "SGD", "params": {"lr": 0.05, "momentum": 0.9}},
                "lion": {"type": "Lion", "params": {"lr": 1e-4}}}


def _batches(n=4):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (4, 64)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_engine_curve_matches_jax(case, tmp_path):
    config = dict(CONFIG, optimizer=ENGINE_CASES[case])
    jax_engine = deepspeed_tpu.initialize(model=JaxGPT2(jax_config("test", dropout=0.0, **MODEL)),
                                          config=dict(config),
                                          topology=MeshTopology(data=1, devices=jax.devices()[:1]))[0]
    batches = _batches()
    jax_engine.initialize_state({"input_ids": batches[0]})
    init = jax.device_get(jax_engine.state.params)
    want = [float(jax_engine.train_batch({"input_ids": b})) for b in batches]

    def port():
        cfg = deepspeed_tpu_torch.get_gpt2_config("test", **MODEL)
        return deepspeed_tpu_torch.initialize(
            model=deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu"),
            model_parameters=params_from_jax(init, cfg), config=config, device="cpu")[0]

    engine = port()
    got = [float(engine.train_batch({"input_ids": b})) for b in batches[:2]]
    engine.save_checkpoint(str(tmp_path))
    got += [float(engine.train_batch({"input_ids": b})) for b in batches[2:]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    assert rel <= 1e-5, (got, want)
    resumed = port()
    resumed.load_checkpoint(str(tmp_path))
    assert resumed.optimizer.count == 2
    assert [float(resumed.train_batch({"input_ids": b})) for b in batches[2:]] == got[2:]


def test_refusals_name_the_key():
    base = {"train_batch_size": 4}
    with pytest.raises(NotImplementedError, match="one-bit"):
        deepspeed_tpu_torch.DeepSpeedConfig(dict(base, optimizer={"type": "OneBitAdam"}))
    with pytest.raises(NotImplementedError, match="optimizer.params.nesterov"):
        deepspeed_tpu_torch.DeepSpeedConfig(dict(base, optimizer={"type": "SGD",
                                                                  "params": {"nesterov": True}}))
    with pytest.raises(NotImplementedError, match="optimizer.params.mask"):
        deepspeed_tpu_torch.DeepSpeedConfig(dict(base, optimizer={"type": "Lion",
                                                                  "params": {"mask": None}}))
    with pytest.raises(NotImplementedError, match="optimizer.params.max_coeff"):
        deepspeed_tpu_torch.DeepSpeedConfig(dict(base, optimizer={"type": "Adagrad",
                                                                  "params": {"max_coeff": 2.0}}))
    with pytest.raises(ValueError, match="unknown optimizer 'Shampoo'"):
        deepspeed_tpu_torch.DeepSpeedConfig(dict(base, optimizer={"type": "Shampoo"}))
    model = deepspeed_tpu_torch.GPT2LMHeadModel(deepspeed_tpu_torch.get_gpt2_config("test"),
                                                device="cpu")
    with pytest.raises(NotImplementedError, match="'lamb' under offload_optimizer"):
        deepspeed_tpu_torch.initialize(model=model, device="cpu", config=dict(
            base, optimizer={"type": "Lamb"},
            zero_optimization={"stage": 2, "offload_optimizer": {"device": "cpu"}}))


def test_client_optimizer_steps_and_resumes(tmp_path):
    """``initialize(optimizer=...)``: a ``torch.optim.Optimizer`` over the
    model's parameters is the engine's optimizer, and its state travels in
    the tag (a fresh engine's optimizer has no state before the load)."""
    batches = _batches()

    def client():
        model = deepspeed_tpu_torch.GPT2LMHeadModel(deepspeed_tpu_torch.get_gpt2_config("test"),
                                                    device="cpu")
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        engine, got, _, _ = deepspeed_tpu_torch.initialize(model=model, optimizer=opt, device="cpu",
                                                           config={"train_batch_size": 4})
        assert got is opt and engine.optimizer is opt
        return engine

    engine = client()
    engine.train_batch({"input_ids": batches[0]})
    engine.save_checkpoint(str(tmp_path))
    want = [float(engine.train_batch({"input_ids": b})) for b in batches[1:]]
    resumed = client()
    resumed.load_checkpoint(str(tmp_path))
    assert [float(resumed.train_batch({"input_ids": b})) for b in batches[1:]] == want
    other = torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=0.1)
    with pytest.raises(ValueError, match="model parameters"):
        deepspeed_tpu_torch.initialize(model=resumed.module, optimizer=other, device="cpu",
                                       config={"train_batch_size": 4})
    with pytest.raises(TypeError, match="torch.optim.Optimizer"):
        deepspeed_tpu_torch.initialize(model=resumed.module, optimizer=object(), device="cpu",
                                       config={"train_batch_size": 4})
