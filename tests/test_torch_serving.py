"""The PyTorch port's serving path against the JAX package's.

Both engines hold the same seeded GPT-2 ``test`` weights (carried over with
``params_from_jax``), in fp32 on the CPU. Greedy ``generate`` must give the
same tokens; a scripted arrival trace through both continuous-batching
schedulers (the JAX one on its XLA attention backend and with prefix
caching off, for speed and because the port has no prefix cache yet) must
give the same tokens per request and the same tick mix, with fp and int8
served weights, no block leak and strict FIFO admission.
"""

import numpy as np
import pytest

import jax
import torch

from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.inference.serving import (ContinuousBatchingScheduler as JaxScheduler,
                                             Request as JaxRequest, ServingConfig as JaxServingConfig)
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.serving import (FINISHED, QUEUED, REFUSED,
                                                   ContinuousBatchingScheduler, Request,
                                                   ServingConfig)


class SimClock:
    """Deterministic clock: advances only when the test says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def engines():
    set_topology(None)
    cfg = jax_config("test", n_layer=2)
    topo = MeshTopology(tensor=1, data=1, fsdp=1, devices=jax.devices()[:1])
    jax_engine = JaxEngine(JaxGPT2(cfg), JaxInferenceConfig(replace_with_kernel_inject=False),
                           topology=topo)
    state = params_from_jax(jax.device_get(jax_engine.params))
    model = GPT2LMHeadModel(get_gpt2_config("test", n_layer=2), device="cpu")
    port_engine = init_inference(model, params=state, device="cpu")
    flash_engine = init_inference(model, params=state, device="cpu", kernel_inject=True,
                                  use_flash_prefill=True)
    yield jax_engine, port_engine, flash_engine
    set_topology(None)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (p,)).astype(np.int32) for p in lengths]


def test_generate_greedy_tokens_match_jax(engines):
    jax_engine, port_engine, flash_engine = engines
    ids = np.stack(_prompts([20, 20, 20], seed=1))  # 16-token chunk + 4 single-token remainders
    ref = np.asarray(jax_engine.generate(ids, max_new_tokens=6))
    assert flash_engine.module.config.attention_backend == "flash"
    for engine in (port_engine, flash_engine):
        out = engine.generate(ids, max_new_tokens=6).numpy()
        np.testing.assert_array_equal(out, ref)


LENGTHS = [5, 23, 9, 40, 17, 3, 12]
MAX_NEW = [4, 6, 3, 5, 8, 2, 6]


def _drive(scheduler_cls, request_cls, engine, scfg):
    clock = SimClock()
    sched = scheduler_cls(engine, scfg, clock=clock)
    reqs = [request_cls(p, max_new_tokens=n) for p, n in zip(_prompts(LENGTHS, seed=2), MAX_NEW)]
    for r in reqs:
        sched.submit(r)
    admitted = []
    for _ in range(500):
        if not (sched.in_flight or len(sched.queue)):
            break
        sched.step()
        clock.t += 1.0
        for r in reqs:
            if r.state != QUEUED and r.request_id not in admitted:
                admitted.append(r.request_id)
    return sched, reqs, admitted


@pytest.mark.parametrize("weight_dtype", [None, "int8"])
def test_scheduler_trace_matches_jax(engines, weight_dtype):
    jax_engine, port_engine, _ = engines
    common = dict(slots=4, prefill_chunk=8, page_size=16, kv_pool_tokens=128,
                  weight_dtype=weight_dtype)
    j_sched, j_reqs, _ = _drive(JaxScheduler, JaxRequest, jax_engine,
                                JaxServingConfig(prefix_cache="off", **common))
    sched, reqs, admitted = _drive(ContinuousBatchingScheduler, Request, port_engine,
                                   ServingConfig(**common))
    assert [r.output for r in reqs] == [r.output for r in j_reqs]
    assert all(r.state == FINISHED and len(r.output) == n for r, n in zip(reqs, MAX_NEW))
    # the same admission / prefill / decode decisions, tick for tick
    assert sched.ticks["prefill"] == j_sched.ticks["prefill"]
    assert sched.ticks["decode"] == j_sched.ticks["decode"]
    # strict FIFO: requests entered slots in submission order
    assert admitted == [r.request_id for r in reqs]
    # no KV block leak
    pool = sched.stats()["pool"]
    assert pool["used_blocks"] == 0 and pool["total_allocs"] == pool["total_frees"] == len(reqs)
    assert pool["peak_used_blocks"] <= pool["num_blocks"] == 8
    assert sched.stats()["weight_dtype"] == (weight_dtype or "fp")


def test_flash_backend_scheduler_matches_xla_backend(engines):
    """The kernels' plain versions on the serving path give the XLA-backend tokens."""
    _, port_engine, flash_engine = engines
    scfg = ServingConfig(slots=4, prefill_chunk=8, weight_dtype="int8")
    _, plain_reqs, _ = _drive(ContinuousBatchingScheduler, Request, port_engine, scfg)
    sched, flash_reqs, _ = _drive(ContinuousBatchingScheduler, Request, flash_engine, scfg)
    assert [r.output for r in flash_reqs] == [r.output for r in plain_reqs]
    sched.warmup()  # parked slots only: no request accounting changes
    assert sched.stats()["pool"]["used_blocks"] == 0


def test_sampling_scheduler_is_seeded(engines):
    _, port_engine, _ = engines
    scfg = ServingConfig(slots=4, prefill_chunk=8, do_sample=True, temperature=0.8, top_k=20,
                         top_p=0.9)
    outs = []
    for _ in range(2):
        sched = ContinuousBatchingScheduler(port_engine, scfg, clock=SimClock(), seed=7)
        reqs = [Request(p, max_new_tokens=4) for p in _prompts([6, 11, 3], seed=3)]
        assert sched.serve(reqs) == 0
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert all(0 <= t < 256 for out in outs[0] for t in out)


def test_queue_refuses_what_can_never_fit(engines):
    _, port_engine, _ = engines
    sched = ContinuousBatchingScheduler(port_engine, ServingConfig(slots=2, max_queue=1,
                                                                   kv_pool_tokens=64))
    too_long = sched.submit(Request(np.zeros(120, np.int32), max_new_tokens=20))
    assert too_long.state == REFUSED and "context capacity" in too_long.refuse_reason
    too_big = sched.submit(Request(np.zeros(60, np.int32), max_new_tokens=20))
    assert too_big.state == REFUSED and "whole pool" in too_big.refuse_reason
    assert sched.submit(Request(np.zeros(4, np.int32), max_new_tokens=2)).state == QUEUED
    full = sched.submit(Request(np.zeros(4, np.int32), max_new_tokens=2))
    assert full.state == REFUSED and "queue full" in full.refuse_reason


@pytest.mark.parametrize("kwargs", [dict(prefix_cache="on"), dict(speculation={"enabled": True})])
def test_later_slice_serving_features_raise(kwargs):
    with pytest.raises(NotImplementedError, match="later slice"):
        ServingConfig(**kwargs)


@pytest.mark.parametrize("kwargs,exc", [(dict(dtype="int8"), NotImplementedError),
                                        (dict(mp_size=2), NotImplementedError),
                                        (dict(checkpoint="weights.npz"), NotImplementedError),
                                        (dict(dtype="fp8"), ValueError)])
def test_inference_config_refuses_later_slices(kwargs, exc):
    with pytest.raises(exc):
        DeepSpeedInferenceConfig.from_dict(kwargs)


def test_init_inference_aliases_and_conflicts():
    cfg = DeepSpeedInferenceConfig.from_dict(dict(kernel_inject=True, max_out_tokens=64,
                                                  dtype="bf16", use_flash_prefill=True))
    assert cfg.replace_with_kernel_inject and cfg.max_tokens == 64 and cfg.dtype == torch.bfloat16
    model = GPT2LMHeadModel(get_gpt2_config("test"), device="cpu")
    with pytest.raises(ValueError, match="both"):
        init_inference(model, cfg, device="cpu", dtype="fp32")
    engine = init_inference(model, cfg, device="cpu")
    assert engine.module.config.dtype == torch.bfloat16
    assert engine.module.config.attention_backend == "flash"
    logits = engine(np.zeros((1, 4), np.int64))
    assert logits.dtype == torch.bfloat16 and tuple(logits.shape) == (1, 4, 256)
