"""The PyTorch port's quantization against the JAX package's.

``quantize_lastaxis`` and ``quantize_params`` must give codes identical to
JAX's (int8, and int4 packing); the port's ``quant_matmul`` and
``quant_dense_general`` (on CPU tensors: the plain version of kernel K2)
are held to JAX ``_xla_quant_matmul`` in fp32 with ``atol=1e-5`` (the
Pallas interpret path is not the yardstick: it fails on the seed tree), and
bit for bit, in bf16 and fp32, on ``testing.quant_matmul_probe``'s inputs,
which a bf16 product over an unrounded dequantised weight gets wrong.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.ops.quantizer import core as jax_core
from deepspeed_tpu.ops.quantizer import weights as jax_weights
from deepspeed_tpu_torch.models.common import flatten_tree
from deepspeed_tpu_torch.ops.cuda import quant_matmul as port_qmm
from deepspeed_tpu_torch.ops.quantizer import core, weights
from deepspeed_tpu_torch.testing import quant_matmul_probe


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


jax_qmm = importlib.import_module("deepspeed_tpu.ops.pallas.quant_matmul")

ATOL = 1e-5


def test_quantize_lastaxis_codes_identical():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16), dtype=np.float32)
    # exact .5 ties after scaling (absmax 127 -> scale 1): half-to-even must agree
    x[0, 0, 0, :4] = [127.0, 2.5, -3.5, 0.5]
    x[0, 0, 1] = 0.0  # absmax 0 -> scale 1
    codes, scale = core.quantize_lastaxis(torch.from_numpy(x))
    jcodes, jscale = jax_core.quantize_lastaxis(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert codes.dtype == torch.int8


def test_pack_unpack_int4_identical():
    rng = np.random.default_rng(1)
    q = rng.integers(-7, 8, size=(6, 10)).astype(np.int8)
    packed = core.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_core.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(core.unpack_int4(packed).numpy(), q)
    rows = weights.pack_rows(torch.from_numpy(q))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jax_weights.pack_rows(jnp.asarray(q))))
    np.testing.assert_array_equal(weights.unpack_rows(rows).numpy(), q)
    with pytest.raises(ValueError):
        core.pack_int4(torch.zeros(3, 3, dtype=torch.int8))


@pytest.mark.parametrize("size,target", [(1024, 64), (4096, 64), (96, 64), (100, 7), (3, 64)])
def test_divisor_groups_matches_jax(size, target):
    assert core.divisor_groups(size, target) == jax_core.divisor_groups(size, target)


@pytest.fixture(scope="module")
def gpt2_tree():
    cfg = jax_config("test")
    params = JaxGPT2(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    import flax.linen as nn
    return jax.device_get(nn.meta.unbox(params))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_quantize_params_codes_identical(gpt2_tree, weight_dtype):
    jq, js = jax_weights.quantize_params(gpt2_tree, weight_dtype, 64)
    tq, ts = weights.quantize_params(_torch_tree(gpt2_tree), weight_dtype, 64)
    jq_flat, tq_flat = flatten_tree(jax.device_get(jq), "/"), flatten_tree(tq, "/")
    js_flat, ts_flat = flatten_tree(jax.device_get(js), "/"), flatten_tree(ts, "/")
    assert sorted(jq_flat) == sorted(tq_flat) and sorted(js_flat) == sorted(ts_flat)
    assert len(ts_flat) == 2 * 4  # four projection kernels per layer, two layers
    for key in jq_flat:
        np.testing.assert_array_equal(tq_flat[key].numpy(), np.asarray(jq_flat[key]), err_msg=key)
    for key in js_flat:
        np.testing.assert_array_equal(ts_flat[key].numpy(), np.asarray(js_flat[key]), err_msg=key)
    # the dequantized view agrees too
    bits = weights.quant_bits(weight_dtype)
    key = "h_0/attn/c_proj/kernel"
    deq = weights.dequantize_leaf(tq_flat[key], ts_flat["h_0/attn/c_proj/kernel_scale"], bits)
    jdeq = jax_weights.dequantize_leaf(jnp.asarray(jq_flat[key]),
                                       jnp.asarray(js_flat["h_0/attn/c_proj/kernel_scale"]), bits)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))


def test_quantize_params_fp_passthrough(gpt2_tree):
    tree = _torch_tree(gpt2_tree)
    out, scales = weights.quantize_params(tree, "fp")
    assert out is tree and scales is None


def _quant_operands(seed, m, k, n, bits, group):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n), dtype=np.float32) * 0.05
    codes, scale = jax_weights.quantize_leaf(jnp.asarray(w), bits, group)
    x = rng.standard_normal((m, k), dtype=np.float32)
    return x, np.array(codes), np.array(scale)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n,group", [(1, 64, 96, 64), (8, 128, 64, 32), (5, 256, 48, 64)])
def test_quant_matmul_matches_jax_xla(bits, m, k, n, group):
    x, codes, scale = _quant_operands(2, m, k, n, bits, group)
    ref = jax_qmm._xla_quant_matmul(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scale), bits)
    out = port_qmm.quant_matmul(torch.from_numpy(x), torch.from_numpy(codes),
                                torch.from_numpy(scale), bits=bits)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)
    # and the full-dequant reference
    full = x @ np.asarray(jax_weights.dequantize_leaf(jnp.asarray(codes), jnp.asarray(scale), bits))
    np.testing.assert_allclose(out.numpy(), full, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,n_contract", [((64, 3, 4, 16), 1), ((4, 16, 64), 2), ((64, 256), 1)])
def test_quant_dense_general_matches_jax(bits, shape, n_contract):
    rng = np.random.default_rng(3)
    kernel = rng.standard_normal(shape, dtype=np.float32) * 0.05
    codes, scale = jax_weights.quantize_leaf(jnp.asarray(kernel), bits, 64)
    x_shape = (2, 3) + shape[:n_contract]
    x = rng.standard_normal(x_shape, dtype=np.float32)
    ref = jax_qmm.quant_dense_general(jnp.asarray(x), codes, scale, bits=bits,
                                      n_contract=n_contract, impl="xla")
    out = port_qmm.quant_dense_general(torch.from_numpy(x), torch.from_numpy(np.array(codes)),
                                       torch.from_numpy(np.array(scale)), bits=bits,
                                       n_contract=n_contract)
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("bad", ["bits", "groups", "rows"])
def test_quant_matmul_validates(bad):
    x = torch.zeros(2, 64)
    codes = torch.zeros(64, 8, dtype=torch.int8)
    scale = torch.ones(1, 8)
    if bad == "bits":
        kwargs = dict(bits=3)
    elif bad == "groups":
        scale, kwargs = torch.ones(3, 8), {}
    else:
        codes, kwargs = torch.zeros(32, 8, dtype=torch.int8), dict(bits=8)
    with pytest.raises(ValueError):
        port_qmm.quant_matmul(x, codes, scale, **kwargs)


def test_split_k_covers_k():
    for m, k, n in [(8, 1024, 4096), (128, 4096, 1024), (8, 64, 96), (1, 33, 5)]:
        k_chunk, splits = port_qmm.split_k(m, k, n)
        assert k_chunk % 32 == 0 and splits >= 1
        assert (splits - 1) * k_chunk < k <= splits * k_chunk


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)])
def test_quant_matmul_probe_is_exact_and_sees_the_rounding(bits, dtype, jdtype):
    """On the probe every summation order gives the same bits: the plain
    version equals JAX's reference bit for bit, and in bf16 a product over
    the dequantised weight left unrounded differs from it in some outputs,
    so the kernels' bit-for-bit check on the card sees a skipped rounding."""
    p = quant_matmul_probe(16, 256, 64, bits, seed=bits, dtype=dtype)
    out = port_qmm.quant_matmul(p["x"], p["qw"], p["scale"], bits=bits)
    ref = jax_qmm._xla_quant_matmul(jnp.asarray(p["x"].float().numpy(), jdtype),
                                    jnp.asarray(p["qw"].numpy()), jnp.asarray(p["scale"].numpy()), bits)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    w = p["codes"].float().reshape(4, 64, 64) * p["scale"][:, None, :]
    unrounded = (p["x"].float() @ w.reshape(256, 64)).to(dtype)
    assert (unrounded != out).any() == (dtype == torch.bfloat16)
