"""Engine-wide int8 weights (``runtime/weight_quantizer.py``,
``init_inference(dtype="int8")`` and the ``quant`` block) against the JAX
package's.

``quantize_data`` and ``model_quantize`` run on the same seeded leaves in
both packages: the int8 codes must be identical, the scales equal within
1e-6 relative, and the same leaves skipped (embeddings, position tables,
vectors). The int8 engines of both packages serve the same LLaMA and GPT-2
"test" weights: their logits must agree within ``INT8_ATOL`` (bf16 compute
for ``dtype="int8"``, measured at most 4.9e-3, bf16 roundings in another
order; fp32 compute under ``quant`` alone, measured 2.6e-7, held to 1e-5),
and their greedy tokens must be identical; against the port's own
full-precision engine they must meet JAX's test bounds (correlation >
0.99, top-1 agreement >= 0.5 on the last position).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_gpt2_config
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama, get_llama_config as jax_llama_config
from deepspeed_tpu.parallel.topology import set_topology
from deepspeed_tpu.runtime.weight_quantizer import WeightQuantization as JaxWeightQuantization
from deepspeed_tpu_torch import (GPT2LMHeadModel, LlamaForCausalLM, get_gpt2_config,
                                 get_llama_config, init_inference)
from deepspeed_tpu_torch.checkpoint.from_jax import jax_paths, params_from_jax
from deepspeed_tpu_torch.models.common import flatten_tree
from deepspeed_tpu_torch.runtime.weight_quantizer import WeightQuantization, dequantize_tree

INT8_ATOL = {"int8": 3e-2, "quant": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_quantize_data_codes_match_jax():
    w = np.random.default_rng(0).normal(size=(64, 96)).astype(np.float32)
    for bits, groups in ((8, 8), (8, 96), (4, 16)):
        jq, js = JaxWeightQuantization().quantize_data(jnp.asarray(w), bits, groups)
        q, s = WeightQuantization().quantize_data(torch.from_numpy(w), bits, groups)
        assert q.dtype == torch.int8 and tuple(s.shape) == (groups,)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)


FAMILIES = {"gpt2": (lambda: JaxGPT2(jax_gpt2_config("test", n_layer=2)),
                     lambda: GPT2LMHeadModel(get_gpt2_config("test", n_layer=2), device="cpu")),
            "llama": (lambda: JaxLlama(jax_llama_config("test")),
                      lambda: LlamaForCausalLM(get_llama_config("test"), device="cpu"))}


@pytest.fixture(scope="module")
def trees():
    """Each family's seeded JAX fp32 weights (numpy tree) and its fp engine."""
    set_topology(None)
    out = {}
    for name, (make_jax, _) in FAMILIES.items():
        ref = deepspeed_tpu.init_inference(make_jax())
        out[name] = (jax.device_get(ref.params), ref)
    yield out
    set_topology(None)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("group_size,extra", [(64, True), (32, False)])
def test_model_quantize_matches_jax(trees, family, group_size, extra):
    tree, _ = trees[family]
    jq, jscales = jax.jit(lambda t: JaxWeightQuantization(mlp_extra_grouping=extra).model_quantize(
        t, group_size=group_size))(jax.tree.map(jnp.asarray, tree))
    state = params_from_jax(tree)
    q, scales = WeightQuantization(mlp_extra_grouping=extra).model_quantize(
        state, group_size=group_size)
    paths = jax_paths(state)
    assert sorted(paths[k] for k in scales) == sorted(jscales)
    jflat = flatten_tree(jax.device_get(jq), "/")
    for name, leaf in q.items():
        want = np.asarray(jflat[paths[name]])
        if name in scales:
            assert leaf.dtype == torch.int8
            np.testing.assert_array_equal(leaf.numpy(), want)
            np.testing.assert_allclose(scales[name].numpy(), np.asarray(jscales[paths[name]]),
                                       rtol=1e-6)
        else:  # skipped: untouched
            assert leaf is state[name]
    deq = dequantize_tree(q, scales, torch.float32)
    assert set(deq) == set(scales)
    for name, w in deq.items():
        step = 1.0 / float(scales[name].min())
        assert float((w - state[name]).abs().max()) <= step


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("how", ["int8", "quant"])
def test_int8_engine_matches_jax(trees, family, how):
    tree, jax_fp = trees[family]
    make_jax, make_port = FAMILIES[family]
    kwargs = ({"dtype": "int8"} if how == "int8"
              else {"quant": {"enabled": True, "bits": 8, "group_size": 64}})
    set_topology(None)
    jax_q = deepspeed_tpu.init_inference(make_jax(), params=jax_fp.params, **kwargs)
    state = params_from_jax(tree)
    port_q = init_inference(make_port(), params=state, device="cpu", **kwargs)
    port_fp = init_inference(make_port(), params=state, device="cpu")
    int8 = [k for k, v in port_q.params.items() if v.dtype == torch.int8]
    assert int8 and all(port_q.params[k].device.type == "cpu" for k in int8)
    # the module holds no full-precision copy of a quantized weight
    assert all(port_q.module.get_parameter(k).numel() == 0 for k in int8)
    prompt = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(np.int32)
    want = np.asarray(jax_q.forward(prompt), np.float32)
    got = port_q.forward(prompt).float().numpy()
    err = np.abs(got - want).max()
    print(f"{family} {how}: max |port - JAX| int8 logits {err:.3e}")  # pytest -s
    assert err <= INT8_ATOL[how], err
    lr = port_fp.forward(prompt).float().numpy()
    corr = np.corrcoef(lr.ravel(), got.ravel())[0, 1]
    assert corr > 0.99, corr
    assert (lr[:, -1].argmax(-1) == got[:, -1].argmax(-1)).mean() >= 0.5
    out = port_q.generate(prompt[:, :8], max_new_tokens=4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_q.generate(prompt[:, :8],
                                                                         max_new_tokens=4)))
