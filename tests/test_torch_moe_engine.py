"""GPT-2 MoE training through the port's engine against the JAX package's.

The parity configuration of ``tests/test_torch_engine.py`` (GPT-2 "test", 2
layers, 64 wide, seq 64, batch 4, AdamW 1e-3, clipping 1.0, fp32, 8 seeded
steps) with an MoE FFN of 4 experts in layer 1 (``moe_layer_freq=2``, top-1,
RTS off, so that training-mode routing draws no noise and both packages
route alike), from the same initial weights (``params_from_jax``). The
port's loss curve must stay within ``PARITY_RTOL`` of JAX's at every step
with remat on and off, the fused head on and off, and both routes (the
sorted one with K5's plain version through ``PermuteRows`` and with the
plain gather). Top-2 with RTS on draws noise from the engine's generator:
its curve is compared with itself (same seed, remat on and off).
"""

import numpy as np
import pytest

import jax
import torch

import deepspeed_tpu
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.moe import routing as jax_routing
from deepspeed_tpu.parallel.topology import MeshTopology
import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.from_jax import opt_state_from_jax, params_from_jax
from deepspeed_tpu_torch.moe import routing
from deepspeed_tpu_torch.ops.cuda import LAUNCHES, reset_launches

PARITY_RTOL = 1e-5
STEPS = 8
RESUME_AT = 3
MODEL = dict(n_layer=2, n_embd=64, n_head=4, n_positions=64, moe_num_experts=4,
             moe_layer_freq=2, moe_k=1, moe_use_rts=False)
CONFIG = {"train_batch_size": 4, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
          "gradient_clipping": 1.0, "zero_optimization": {"stage": 0}, "steps_per_print": 10**9}


@pytest.fixture(autouse=True)
def _clean_route():
    routing.set_default_route(None, None)
    yield
    routing.set_default_route(None, None)


def _batches(n=STEPS):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (4, 64)).astype(np.int32) for _ in range(n)]


def _port_engine(tree, config=CONFIG, **overrides):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", **dict(MODEL, **overrides))
    model = deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu")
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params_from_jax(tree, cfg), config=config, device="cpu")
    return engine


def _rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


@pytest.fixture(scope="module")
def jax_run():
    """JAX's fp32 MoE curve (its default sorted route), its state after
    RESUME_AT steps and its eval loss after the last step."""
    jax_routing.set_default_route(None, None)
    module = JaxGPT2(jax_config("test", dropout=0.0, **MODEL))
    engine, _, _, _ = deepspeed_tpu.initialize(
        model=module, topology=MeshTopology(data=1, devices=jax.devices()[:1]), config=dict(CONFIG))
    batches = _batches()
    engine.initialize_state({"input_ids": batches[0]})
    out = {"init": jax.device_get(engine.state.params), "losses": []}
    for i, b in enumerate(batches):
        if i == RESUME_AT:
            out["resume"] = (jax.device_get(engine.state.params),
                             jax.device_get(engine.state.opt_state))
        out["losses"].append(float(engine.train_batch({"input_ids": b})))
    out["eval"] = float(engine.eval_batch({"input_ids": batches[0]}))
    return out


VARIANTS = {
    "sorted": ({}, {}),
    "sorted-remat": ({}, dict(remat=True)),
    "sorted-fused": ({}, dict(fused_head_loss_chunk=48)),
    "sorted-remat-fused": ({}, dict(remat=True, fused_head_loss_chunk=100)),
    "sorted-plain-gather": ({"moe": {"kernel": "xla"}}, {}),
    "dense": ({"moe": {"route": "dense"}}, {}),
    "dense-remat": ({"moe": {"route": "dense"}}, dict(remat=True)),
    "dense-fused": ({}, dict(moe_route="dense", fused_head_loss_chunk=48)),
    "dense-remat-fused": ({}, dict(moe_route="dense", remat=True, fused_head_loss_chunk=100)),
}


@pytest.mark.parametrize("variant", VARIANTS)
def test_moe_loss_curve_matches_jax(jax_run, variant):
    block, overrides = VARIANTS[variant]
    reset_launches()
    engine = _port_engine(jax_run["init"], dict(CONFIG, **block), **overrides)
    losses = [float(engine.train_batch({"input_ids": b})) for b in _batches()]
    rel = _rel(losses, jax_run["losses"])
    print(f"fp32 MoE loss curve {variant}: max relative difference to JAX {rel:.3e}")  # pytest -s
    assert rel <= PARITY_RTOL, (losses, jax_run["losses"])
    assert LAUNCHES["moe_permute"] == 0  # the CPU computes the plain versions
    moe = engine.module.h_1.moe.deepspeed_moe
    assert int(moe.exp_counts.sum()) == 4 * 64 and moe.capacity_slots == 80
    assert (moe.last_routing is None) == (variant.startswith("dense"))


def test_moe_eval_loss_matches_jax_and_drops_the_aux_loss(jax_run):
    engine = _port_engine(jax_run["init"])
    for b in _batches():
        engine.train_batch(b)
    got = float(engine.eval_batch({"input_ids": _batches()[0]}))
    np.testing.assert_allclose(got, jax_run["eval"], rtol=PARITY_RTOL)
    # eval is pure cross-entropy: the logits forward's aux term is left out
    with torch.no_grad():
        logits, aux = engine.module(torch.from_numpy(_batches()[0]).long())
    assert float(aux) > 0
    want = deepspeed_tpu_torch.models.gpt2.cross_entropy_loss(
        logits[:, :-1], torch.from_numpy(_batches()[0][:, 1:]))
    np.testing.assert_allclose(got, float(want), rtol=1e-6)


def test_moe_trains_with_training_mode_gating_at_dropout_zero(jax_run):
    """At dropout 0 the first training loss is the train-capacity loss plus
    the aux term, not the eval loss (eval capacity factor, no aux)."""
    engine = _port_engine(jax_run["init"])
    ids = _batches(1)[0]
    eval_loss = float(engine.eval_batch(ids))
    train_loss = float(engine.train_batch(ids))
    assert abs(train_loss - jax_run["losses"][0]) <= PARITY_RTOL * abs(jax_run["losses"][0])
    assert train_loss != eval_loss


def test_resume_moe_from_jax_optimizer_state(jax_run):
    params, opt_state = jax_run["resume"]
    engine = _port_engine(params)
    state = opt_state_from_jax(opt_state)
    assert "h_1.moe.deepspeed_moe.experts.deepspeed_experts.c_fc.kernel" in state["exp_avg"]
    engine.load_optimizer_state(state)
    losses = [float(engine.train_batch(b)) for b in _batches()[RESUME_AT:]]
    assert _rel(losses, jax_run["losses"][RESUME_AT:]) <= PARITY_RTOL


def test_params_from_jax_infers_the_moe_config(jax_run):
    sd = params_from_jax(jax_run["init"])
    cfg = deepspeed_tpu_torch.checkpoint.from_jax._infer_config(sd)
    assert (cfg.moe_num_experts, cfg.moe_layer_freq, cfg.moe_use_residual) == (4, 2, False)
    assert sd["h_1.moe.deepspeed_moe.experts.deepspeed_experts.c_proj.kernel"].shape == (4, 256, 64)


@pytest.mark.parametrize("route", ["sorted", "dense"])
def test_top2_rts_curve_is_seeded_and_survives_remat(jax_run, route):
    """Top-2 gating draws Gumbel noise from each block's gating generator,
    seeded from the engine's: the same seed gives the same curve with remat
    on and off (a recomputed block routes the same way), another seed
    another curve."""
    kw = dict(moe_k=2, moe_use_rts=True, moe_route=route)
    curves = {}
    for remat in (False, True):
        engine = _port_engine(jax_run["init"], **kw, remat=remat)
        curves[remat] = [float(engine.train_batch(b)) for b in _batches(3)]
    assert curves[False] == curves[True]
    engine = _port_engine(jax_run["init"], dict(CONFIG, seed=7), **kw)
    assert [float(engine.train_batch(b)) for b in _batches(3)] != curves[False]


def test_engine_installs_and_clears_the_moe_route(jax_run):
    _port_engine(jax_run["init"], dict(CONFIG, moe={"route": "dense", "kernel": "xla"}))
    assert routing.resolve_route() == ("dense", "xla", "config")
    _port_engine(jax_run["init"])
    assert routing.resolve_route() == ("sorted", "auto", "default")
    with pytest.raises(ValueError, match="moe"):
        _port_engine(jax_run["init"], dict(CONFIG, moe={"route": "blocksparse"}))
    with pytest.raises(ValueError, match="moe block"):
        _port_engine(jax_run["init"], dict(CONFIG, moe={"capacity": 2}))


def test_serving_an_moe_model_raises(jax_run):
    model = deepspeed_tpu_torch.GPT2LMHeadModel(
        deepspeed_tpu_torch.get_gpt2_config("test", **MODEL), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE-serving"):
        deepspeed_tpu_torch.init_inference(model, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE-serving"):
        deepspeed_tpu_torch.get_gpt2_config("test", serve_weight_dtype="int8", **MODEL)
    from deepspeed_tpu_torch.models.common import init_cache
    with pytest.raises(NotImplementedError, match="MoE-serving"):
        model(torch.zeros((1, 4), dtype=torch.long), init_cache(model, 1))
