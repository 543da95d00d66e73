"""K3's int8 operand form, and the serving path that hands it the int8 KV pool.

``flash_decode(q, k_codes, v_codes, lengths, k_scale=..., v_scale=...)`` reads
an int8 KV pool with per-(slot, position, head) scales. On CPU tensors the
wrapper computes its plain version: the pool dequantised exactly as the
serving model dequantised it before K3 took the codes (``codes.to(q.dtype) *
scale``), then ``flash_decode_plain``, bit for bit. That is held to the JAX
package's Pallas decode kernel (interpret mode) over the same dequantised
pool within 1e-5, and a 2-layer GPT-2 served with int8 KV on the ``"flash"``
backend, whose decode attention now receives the codes, gives the JAX
scheduler's greedy tokens. The kernel itself is held to this plain version
on the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.inference.serving import (ContinuousBatchingScheduler as JaxScheduler,
                                             Request as JaxRequest, ServingConfig as JaxServingConfig)
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.inference.serving import (FINISHED, ContinuousBatchingScheduler, Request,
                                                   ServingConfig)
from deepspeed_tpu_torch.ops.cuda import flash_attention as port_flash
from deepspeed_tpu_torch.ops.transformer.attention import dot_product_attention


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


jax_flash = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")

P_LEN = 32
DECODE_CASES = [
    dict(lq=1, lengths=[1, 5, 32, 17]),
    dict(lq=4, lengths=[0, 2, 3, 30]),       # length 0; rows with position < 0
    dict(lq=1, lengths=[33, 31, 7, 0]),      # parked: length > P
    dict(lq=4, lengths=[36, 11, 0, 32]),     # parked with Lq = 4 (P + Lq)
    dict(lq=16, lengths=[16, 32, 1, 48]),    # a prefill chunk
]


def _pool(seed, lengths, lq, h=2, d=64):
    """q [S, lq, h, d] and an int8 KV pool [S, P, h, d] with scales [S, P, h, 1]."""
    rng = np.random.default_rng(seed)
    s = len(lengths)
    q = rng.standard_normal((s, lq, h, d), dtype=np.float32)
    codes = rng.integers(-127, 128, (2, s, P_LEN, h, d)).astype(np.int8)
    scales = (rng.random((2, s, P_LEN, h, 1)) * 0.05 + 1e-3).astype(np.float32)
    return q, codes[0], codes[1], scales[0], scales[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: f"lq={c['lq']}-lengths={c['lengths']}")
def test_int8_form_is_dequantise_then_plain(case, dtype):
    q, kc, vc, ks, vs = _pool(1, case["lengths"], case["lq"])
    q, ks, vs = (torch.from_numpy(a).to(dtype) for a in (q, ks, vs))
    kc, vc = torch.from_numpy(kc), torch.from_numpy(vc)
    lens = torch.tensor(case["lengths"], dtype=torch.int32)
    want = port_flash.flash_decode_plain(q, kc.to(dtype) * ks, vc.to(dtype) * vs, lens, scale=0.125)
    got = port_flash.flash_decode(q, kc, vc, lens, k_scale=ks, v_scale=vs)
    assert got.dtype == dtype and torch.equal(got, want)
    backend = dot_product_attention(q, kc, vc, backend="flash", causal=False, decode_lengths=lens,
                                    k_scale=ks, v_scale=vs)
    assert torch.equal(backend, want)


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: f"lq={c['lq']}-lengths={c['lengths']}")
def test_int8_form_matches_jax_decode(case):
    q, kc, vc, ks, vs = _pool(2, case["lengths"], case["lq"])
    out = port_flash.flash_decode(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                                  torch.tensor(case["lengths"], dtype=torch.int32),
                                  k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)).numpy()
    ref = jax_flash.flash_decode(jnp.asarray(q), jnp.asarray(kc, jnp.float32) * jnp.asarray(ks),
                                 jnp.asarray(vc, jnp.float32) * jnp.asarray(vs),
                                 jnp.asarray(case["lengths"], jnp.int32), interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=0)


def test_scales_are_a_decode_operand():
    q, kc, vc, ks, vs = (torch.from_numpy(a) for a in _pool(3, [4, 8], 1))
    with pytest.raises(ValueError, match="cache-decode operand"):
        dot_product_attention(q, kc, vc, backend="flash", causal=True, k_scale=ks, v_scale=vs)


@pytest.fixture(scope="module")
def engines():
    set_topology(None)
    cfg = jax_config("test", n_layer=2)
    topo = MeshTopology(tensor=1, data=1, fsdp=1, devices=jax.devices()[:1])
    jax_engine = JaxEngine(JaxGPT2(cfg), JaxInferenceConfig(replace_with_kernel_inject=False),
                           topology=topo)
    state = params_from_jax(jax.device_get(jax_engine.params))
    model = GPT2LMHeadModel(get_gpt2_config("test", n_layer=2), device="cpu")
    flash_engine = init_inference(model, params=state, device="cpu", kernel_inject=True,
                                  use_flash_prefill=True)
    yield jax_engine, flash_engine
    set_topology(None)


def _serve(scheduler_cls, request_cls, engine, scfg):
    rng = np.random.default_rng(5)
    reqs = [request_cls(rng.integers(0, 256, (p,)).astype(np.int32), max_new_tokens=n)
            for p, n in zip([5, 23, 9, 40, 17, 3, 12], [4, 6, 3, 5, 8, 2, 6])]
    sched = scheduler_cls(engine, scfg)
    for r in reqs:
        sched.submit(r)
    for _ in range(500):
        if not (sched.in_flight or len(sched.queue)):
            break
        sched.step()
    return sched, reqs


@pytest.mark.parametrize("weight_dtype", [None, "int8"])
def test_flash_serving_with_int8_kv_matches_jax(engines, weight_dtype, monkeypatch):
    """The served tokens with int8 KV on the flash backend, whose every
    decode attention call gets the pool's int8 codes and their scales."""
    jax_engine, flash_engine = engines
    assert flash_engine.module.config.attention_backend == "flash"
    common = dict(slots=4, prefill_chunk=8, page_size=16, kv_pool_tokens=128, kv_quant=True,
                  weight_dtype=weight_dtype)
    _, j_reqs = _serve(JaxScheduler, JaxRequest, jax_engine,
                       JaxServingConfig(prefix_cache="off", **common))
    operands = []
    decode = port_flash.flash_decode

    def recording(q, k, v, lengths, **kw):
        operands.append((k.dtype, v.dtype, kw.get("k_scale") is not None))
        return decode(q, k, v, lengths, **kw)

    monkeypatch.setattr(port_flash, "flash_decode", recording)
    sched, reqs = _serve(ContinuousBatchingScheduler, Request, flash_engine, ServingConfig(**common))
    assert [r.output for r in reqs] == [r.output for r in j_reqs]
    assert all(r.state == FINISHED for r in reqs)
    assert operands and set(operands) == {(torch.int8, torch.int8, True)}
    assert sched.stats()["pool"]["used_blocks"] == 0
