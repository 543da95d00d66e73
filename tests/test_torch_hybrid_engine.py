"""The port's hybrid (RLHF) engine against the JAX package's.

``initialize`` with ``hybrid_engine.enabled`` returns a
``DeepSpeedHybridEngine``. Its core guarantee holds on the port alone:
train -> generate -> train gives the same loss bits as train -> train, on
the ``"xla"`` and ``"flash"`` backends (the flash kernels' plain versions
here) and for the fused-head model, which trains on a loss and serves
logits. Against JAX (GPT-2 "test", 2 layers, fp32, AdamW 1e-2 on one
repeated batch so that the served next-token choices are clear-cut): the
loss curve within 1e-5 per step, then greedy ``generate`` from the trained
weights token for token and ``infer_forward`` within 1e-5. Also the
``max_out_tokens`` budget, ``hybrid_stats``, ``fuse_lora_params`` against
JAX's on the same tree, the digest switch and the refused
``inference_tp_size``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
from deepspeed_tpu.runtime.hybrid_engine import fuse_lora_params as jax_fuse_lora_params
import deepspeed_tpu_torch
from deepspeed_tpu_torch import DeepSpeedEngine, DeepSpeedHybridEngine
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.runtime.hybrid_engine import fuse_lora_params

PARITY_ATOL = 1e-5
MODEL = dict(n_layer=2, dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(lr=1e-3, **hybrid):
    return {"train_batch_size": 8, "optimizer": {"type": "AdamW", "params": {"lr": lr}},
            "hybrid_engine": dict({"enabled": True, "max_out_tokens": 64}, **hybrid)}


def _engine(params=None, config=None, **overrides):
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", **MODEL, **overrides)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu"), model_parameters=params,
        config=config or _config(), device="cpu")
    return engine


def _batch(seed=1, n=8, seq=32):
    return {"input_ids": np.random.default_rng(seed).integers(0, 256, (n, seq)).astype(np.int64)}


def test_initialize_dispatches_on_the_block():
    assert isinstance(_engine(), DeepSpeedHybridEngine)
    plain = _engine(config=dict(_config(), hybrid_engine={"enabled": False}))
    assert type(plain) is DeepSpeedEngine
    with pytest.raises(NotImplementedError, match="item 8"):
        _engine(config=_config(inference_tp_size=2))
    with pytest.raises(ValueError, match="unknown keys"):
        _engine(config=_config(bogus=1))


VARIANTS = {"xla": {}, "flash": dict(attention_backend="flash"),
            "fused-head": dict(fused_head_loss_chunk=64)}


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_generate_train_is_bit_identical(variant):
    overrides = VARIANTS[variant]
    prompts = np.random.default_rng(3).integers(0, 256, (2, 8)).astype(np.int64)

    def run(with_generate):
        engine = _engine(**overrides)
        losses = []
        for step in range(3):
            losses.append(float(engine.train_batch(_batch())))
            if with_generate and step == 0:
                out = engine.generate(prompts, max_new_tokens=4)
                assert tuple(out.shape) == (2, 12)
                logits = engine.infer_forward(prompts)
                assert tuple(logits.shape) == (2, 8, 256)  # logits, also for the fused head
                # the view holds its own tensors
                view = engine._infer_engine.module.state_dict()
                train = engine.module.state_dict()
                assert all(view[k].data_ptr() != train[k].data_ptr() for k in train)
        return losses, engine.generator.get_state()

    control, control_rng = run(False)
    mixed, mixed_rng = run(True)
    assert control == mixed, f"generation perturbed training: {control} vs {mixed}"
    assert torch.equal(control_rng, mixed_rng)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's hybrid engine: 3 steps on one repeated batch, then greedy
    tokens and logits from its inference view."""
    set_topology(None)
    engine, *_ = deepspeed_tpu.initialize(
        model=JaxGPT2(jax_config("test", **MODEL)),
        topology=MeshTopology(data=1, devices=jax.devices()[:1]), config=_config(lr=1e-2))
    batch = _repeated_batch()
    engine.initialize_state({"input_ids": batch["input_ids"].astype(np.int32)})
    out = {"init": jax.device_get(engine.state.params)}
    out["losses"] = [float(engine.train_batch({"input_ids": batch["input_ids"].astype(np.int32)}))
                     for _ in range(3)]
    prompts = batch["input_ids"][:2, :8].astype(np.int32)
    out["tokens"] = np.asarray(engine.generate(prompts, max_new_tokens=8))
    out["logits"] = np.asarray(engine.infer_forward(prompts))
    yield out
    set_topology(None)


def _repeated_batch():
    rows = [(np.arange(32) * 3 + 11 * i) % 256 for i in range(8)]
    return {"input_ids": np.stack(rows).astype(np.int64)}


def test_generate_after_training_matches_jax(jax_run):
    engine = _engine(params_from_jax(jax_run["init"]), config=_config(lr=1e-2))
    batch = _repeated_batch()
    losses = [float(engine.train_batch(batch)) for _ in range(3)]
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=0, atol=PARITY_ATOL)
    prompts = batch["input_ids"][:2, :8]
    np.testing.assert_array_equal(engine.generate(prompts, max_new_tokens=8).numpy(),
                                  jax_run["tokens"])
    np.testing.assert_allclose(engine.infer_forward(prompts).numpy(), jax_run["logits"],
                               rtol=0, atol=PARITY_ATOL)
    # one more step: the view follows the training weights
    before = engine.infer_forward(prompts)
    engine.train_batch(batch)
    assert not torch.equal(engine.infer_forward(prompts), before)
    # built at the first generate, refreshed once since
    assert engine.weight_sync_generation == 1 and engine.last_weight_sync["digest"]


def test_max_out_tokens_stats_and_digest_switch(monkeypatch):
    engine = _engine(config=_config(max_out_tokens=16))
    engine.train_batch(_batch())
    prompts = np.zeros((2, 4), np.int64)
    with pytest.raises(ValueError, match="max_tokens=16"):
        engine.generate(prompts, max_new_tokens=20)
    out = engine.generate(prompts, max_new_tokens=6)
    assert tuple(out.shape) == (2, 10)
    stats = engine.hybrid_stats()
    assert stats["iters"] == 1 and stats["generate_latency_s"] > 0
    assert stats["training_latency_s"] > 0
    engine.release_inference_cache()
    monkeypatch.setenv("DS_RLHF_SYNC_DIGEST", "0")
    engine.train_batch(_batch())
    engine.generate(prompts, max_new_tokens=2)
    assert "digest" not in engine.last_weight_sync and engine.last_weight_sync["execute_s"] >= 0
    assert engine.last_weight_sync["gather_bytes"] == 0


def test_fuse_lora_params_matches_jax():
    rng = np.random.default_rng(0)
    kernel = rng.normal(size=(4, 6)).astype(np.float32)   # [in, out]
    a = rng.normal(size=(2, 4)).astype(np.float32)        # [rank, in]
    b = rng.normal(size=(6, 2)).astype(np.float32)        # [out, rank]
    for scaling in (None, 0.5):
        tree = {"dense": {"kernel": jnp.asarray(kernel), "lora_a": jnp.asarray(a),
                          "lora_b": jnp.asarray(b)}, "other": {"kernel": jnp.asarray(kernel)}}
        state = {"dense.kernel": torch.from_numpy(kernel), "dense.lora_a": torch.from_numpy(a),
                 "dense.lora_b": torch.from_numpy(b), "other.kernel": torch.from_numpy(kernel)}
        if scaling is not None:
            tree["dense"]["lora_scaling"] = scaling
            state["dense.lora_scaling"] = scaling
        want = jax_fuse_lora_params(tree, fuse=True)
        got = fuse_lora_params(state)
        np.testing.assert_allclose(got["dense.kernel"].numpy(), np.asarray(want["dense"]["kernel"]),
                                   rtol=1e-6, atol=1e-6)
        assert got["other.kernel"] is state["other.kernel"]
        np.testing.assert_array_equal(state["dense.kernel"].numpy(), kernel)  # pure
        assert fuse_lora_params(state, fuse=False)["dense.kernel"] is state["dense.kernel"]


def test_lora_fuse_flags_mark_the_view_stale():
    engine = _engine()
    engine.train_batch(_batch())
    prompts = np.zeros((1, 8), np.int64)
    base = engine.infer_forward(prompts)
    engine.fuse_lora_weight()  # GPT-2 has no adapters: a no-op that must not fail
    assert engine.is_lora_fused and engine._infer_params_stale
    assert torch.equal(engine.infer_forward(prompts), base)
    engine.unfuse_lora_weight_non_pinned()
    assert not engine.is_lora_fused
