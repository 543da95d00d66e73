"""The port's training engine against the JAX package's.

``tools/parity_check.py``'s configuration (GPT-2 "test", 2 layers, 64 wide,
seq 64, batch 4, AdamW 1e-3, clipping 1.0, fp32, 8 steps of seeded numpy
batches) through ``deepspeed_tpu.initialize`` and the port's
``initialize``, from the same initial weights (``params_from_jax``). The
port's loss curve must stay within ``PARITY_RTOL`` of JAX's at every step,
with remat on and off, the fused head on and off, two gradient-accumulation
steps, and the ``"flash"`` backend (its plain versions on the CPU) as well
as ``"xla"``. Measured on this configuration (``pytest -s`` prints it): at
most 3.5e-7 (fp32 sums in another order), so the committed 1e-5 leaves
~30x headroom.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu.runtime.engine import default_causal_lm_loss as jax_default_loss
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import opt_state_from_jax, params_from_jax
from deepspeed_tpu_torch.models.common import maybe_remat
from deepspeed_tpu_torch.runtime.engine import default_causal_lm_loss

PARITY_RTOL = 1e-5
STEPS = 8
RESUME_AT = 3
MODEL = dict(n_layer=2, n_embd=64, n_head=4, n_positions=64)
CONFIG = {"train_batch_size": 4, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
          "gradient_clipping": 1.0, "zero_optimization": {"stage": 0}, "steps_per_print": 10**9}


def _batches(n=STEPS):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (4, 64)).astype(np.int32) for _ in range(n)]


def _jax_engine(config, dtype=jnp.float32, **kwargs):
    module = JaxGPT2(jax_config("test", dropout=0.0, dtype=dtype, **MODEL))
    engine, _, _, _ = deepspeed_tpu.initialize(
        model=module, topology=MeshTopology(data=1, devices=jax.devices()[:1]),
        config=dict(config), **kwargs)
    return engine


def _port_engine(tree, config=CONFIG, loss_fn=None, **overrides):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", **MODEL, **overrides)
    model = deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu")
    engine, optimizer, loader, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params_from_jax(tree, cfg), config=config, loss_fn=loss_fn,
        device="cpu")
    assert optimizer is engine.optimizer and loader is None
    return engine


def _rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


@pytest.fixture(scope="module")
def jax_run():
    """JAX's fp32 curve, its state after RESUME_AT steps, and its eval loss
    and gradient norm after the last step."""
    engine = _jax_engine(CONFIG)
    batches = _batches()
    engine.initialize_state({"input_ids": batches[0]})
    out = {"init": jax.device_get(engine.state.params), "losses": []}
    for i, b in enumerate(batches):
        if i == RESUME_AT:
            out["resume"] = (jax.device_get(engine.state.params),
                             jax.device_get(engine.state.opt_state))
        out["losses"].append(float(engine.train_batch({"input_ids": b})))
    out["final"] = jax.device_get(engine.state.params)
    out["eval"] = float(engine.eval_batch({"input_ids": batches[0]}))
    out["grad_norm"] = engine.get_global_grad_norm()
    return out


VARIANTS = {
    "xla": ({}, 1),
    "remat": (dict(remat=True), 1),
    "remat-every-2": (dict(remat=True, remat_every=2), 1),
    "fused-head": (dict(fused_head_loss_chunk=48), 1),
    "gas2": ({}, 2),
    "flash": (dict(attention_backend="flash"), 1),
    "flash-remat-fused-gas2": (dict(attention_backend="flash", remat=True,
                                    fused_head_loss_chunk=100), 2),
}


@pytest.mark.parametrize("variant", VARIANTS)
def test_loss_curve_matches_jax(jax_run, variant):
    overrides, gas = VARIANTS[variant]
    engine = _port_engine(jax_run["init"], dict(CONFIG, gradient_accumulation_steps=gas),
                          **overrides)
    assert engine.config.gradient_accumulation_steps == gas
    losses = [float(engine.train_batch({"input_ids": b})) for b in _batches()]
    rel = _rel(losses, jax_run["losses"])
    print(f"fp32 loss curve {variant}: max relative difference to JAX {rel:.3e}")  # pytest -s
    assert rel <= PARITY_RTOL, (losses, jax_run["losses"])
    assert engine.global_steps == STEPS and engine.optimizer.count == STEPS


def test_maybe_remat_honours_remat_every():
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", n_layer=4, remat=True, remat_every=2)
    block = torch.nn.Identity()
    wrapped = [maybe_remat(block, cfg, i) is not block for i in range(4)]
    assert wrapped == [True, False, True, False]
    assert maybe_remat(block, cfg, 0, enabled=False) is block
    x = torch.ones(3, requires_grad=True)
    maybe_remat(lambda t: t * 2, cfg, 0)(x).sum().backward()  # runs under checkpoint
    assert torch.equal(x.grad, torch.full((3,), 2.0))


def test_eval_grad_norm_and_params_match_jax(jax_run):
    engine = _port_engine(jax_run["init"])
    for b in _batches():
        engine.train_batch(b)
    np.testing.assert_allclose(float(engine.eval_batch({"input_ids": _batches()[0]})),
                               jax_run["eval"], rtol=PARITY_RTOL)
    np.testing.assert_allclose(engine.get_global_grad_norm(), jax_run["grad_norm"], rtol=1e-4)
    want = params_from_jax(jax_run["final"])
    for name, p in engine.module.state_dict().items():
        # Adam divides each gradient by its own running rms, so last-bit
        # differences of tiny gradients move a weight by up to ~1% of lr
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=5e-5, rtol=0, err_msg=name)


def test_resume_from_jax_optimizer_state(jax_run):
    params, opt_state = jax_run["resume"]
    engine = _port_engine(params)
    engine.load_optimizer_state(opt_state_from_jax(opt_state))
    assert engine.optimizer.count == RESUME_AT
    losses = [float(engine.train_batch(b)) for b in _batches()[RESUME_AT:]]
    assert _rel(losses, jax_run["losses"][RESUME_AT:]) <= PARITY_RTOL
    assert engine.optimizer.count == STEPS


def test_bf16_curve_matches_jax():
    """bf16 compute over fp32 masters, fused head, remat, AdamW with decay:
    both packages round each parameter and activation to bf16 at the same
    places, but their products round their fp32 sums on their own; held to
    1e-3 relative per step (measured 3.1e-5)."""
    config = dict(CONFIG, bf16={"enabled": True},
                  optimizer={"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}})
    jengine = _jax_engine(config, dtype=jnp.bfloat16)
    batches = _batches(4)
    jengine.initialize_state({"input_ids": batches[0]})
    engine = _port_engine(jax.device_get(jengine.state.params), config, dtype=torch.bfloat16,
                          remat=True, fused_head_loss_chunk=64)
    want = [float(jengine.train_batch({"input_ids": b})) for b in batches]
    got = [float(engine.train_batch({"input_ids": b})) for b in batches]
    print(f"bf16 loss curve: max relative difference to JAX {_rel(got, want):.3e}")  # pytest -s
    assert _rel(got, want) <= 1e-3, (got, want)


def test_non_finite_gradient_step_is_skipped_as_in_jax():
    """A loss scaled by inf in step 2 gives a non-finite gradient norm: the
    update is skipped (parameters and the Adam count stay), the step counter
    still advances, and step 3 trains on as in JAX."""
    poison = [np.ones(4, np.float32), np.full(4, np.inf, np.float32), np.ones(4, np.float32)]
    jengine = _jax_engine(CONFIG, loss_fn=lambda out, mb: jax_default_loss(out, mb) * mb["poison"][0])
    batches = [{"input_ids": b, "poison": p} for b, p in zip(_batches(3), poison)]
    jengine.initialize_state(batches[0])
    engine = _port_engine(jax.device_get(jengine.state.params),
                          loss_fn=lambda out, mb: default_causal_lm_loss(out, mb) * mb["poison"][0])
    want = [float(jengine.train_batch(b)) for b in batches]
    got = []
    for i, b in enumerate(batches):
        before = {k: v.clone() for k, v in engine.module.state_dict().items()}
        got.append(float(engine.train_batch(b)))
        if i == 1:
            assert all(torch.equal(before[k], v) for k, v in engine.module.state_dict().items())
    assert np.isinf(want[1]) and np.isinf(got[1])
    assert _rel([got[0], got[2]], [want[0], want[2]]) <= PARITY_RTOL
    assert engine.optimizer.count == int(jengine.state.opt_state.count) == 2
    assert engine.global_steps == int(jengine.state.step) == 3
    assert engine.skipped_steps == jengine.skipped_steps == 1


def test_train_batches_runs_the_steps_in_order(jax_run):
    engine = _port_engine(jax_run["init"])
    losses = engine.train_batches({"input_ids": np.stack(_batches())})
    assert losses.shape == (STEPS,)
    assert _rel(losses.tolist(), jax_run["losses"]) <= PARITY_RTOL


def test_dropout_is_seeded_and_survives_remat(jax_run):
    """Dropout draws from the engine's seeded generator: the same seed gives
    the same curve, with remat on or off (each block re-seeds its own
    generator, so a recomputed block draws the same masks); eval is
    deterministic; the flash backend refuses dropout."""
    curves = {}
    for remat in (False, True):
        engine = _port_engine(jax_run["init"], dropout=0.1, remat=remat)
        curves[remat] = [float(engine.train_batch(b)) for b in _batches(3)]
        assert engine.eval_batch(_batches(1)[0]) == engine.eval_batch(_batches(1)[0])
    assert curves[False] == curves[True]
    assert _rel(curves[False], jax_run["losses"][:3]) > PARITY_RTOL  # dropout did act
    engine = _port_engine(jax_run["init"], dropout=0.1, attention_backend="flash")
    with pytest.raises(ValueError, match="dropout"):
        engine.train_batch(_batches(1)[0])


@pytest.mark.parametrize("block", [dict(fp16={"enabled": True}), dict(zero_optimization={"stage": 1}),
                                   dict(zero_optimization={"stage": 0,
                                                           "offload_optimizer": {"device": "cpu"}}),
                                   dict(optimizer={"type": "Lamb", "params": {}}),
                                   dict(pipeline={"stages": 2})],
                         ids=["fp16", "zero1", "offload", "lamb", "pipeline"])
def test_config_refuses_later_slices(jax_run, block):
    with pytest.raises(NotImplementedError, match="slice"):
        _port_engine(jax_run["init"], dict(CONFIG, **block))


def test_engine_refuses_an_fp32_model_under_bf16(jax_run):
    with pytest.raises(ValueError, match="bfloat16"):
        _port_engine(jax_run["init"], dict(CONFIG, bf16={"enabled": True}))


def test_initialize_raises_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = deepspeed_tpu_torch.GPT2LMHeadModel(deepspeed_tpu_torch.get_gpt2_config("test"),
                                                device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=model, config=CONFIG)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=CONFIG, device="cpu")
    assert engine.device.type == "cpu"
