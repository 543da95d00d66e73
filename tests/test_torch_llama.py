"""The PyTorch port's LLaMA family against the JAX package's.

The JAX model's seeded weights go through ``params_from_jax`` into the
port's model (and back with ``params_to_jax``); the same seeded numpy inputs
then go through both, in fp32 on the CPU. The pieces: ``rms_norm`` and
``rotary_embedding`` within 1e-6 (fp32 elementwise maths; sin and cos of
angles up to 2047 radians in two libraries), the fused head on the untied
[E, V] kernel (loss, dx and dW) within 1e-6 relative (fp32 sums in another
order). The model: logits on the "test" preset (GQA 4/2) on the ``"xla"``
and ``"flash"`` backends (the port's flash wrappers compute their plain
versions on CPU tensors; JAX runs its Pallas kernels in interpret mode, as
``tests/unit/ops/test_flash_attention.py`` does), with ``attention_bias``
(random biases), with ``sliding_window`` 32 at seq 64, and a 1-layer model
of hidden 256 with 2 heads (head dim 128), all within ``atol=1e-4`` as the
GPT-2 comparisons; the decode cache against the full forward at
``test_models.py``'s 2e-4; greedy ``generate`` token for token against the
JAX ``InferenceEngine``. And the head dims the CUDA kernels take: 64 and
128, any other refused with ``ValueError`` before a build or a launch.
"""

import functools

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.models.common import fused_lm_head_loss as jax_fused_loss
from deepspeed_tpu.models.common import rms_norm as jax_rms_norm
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.models.llama import get_llama_config as jax_config
from deepspeed_tpu.models.llama import rotary_embedding as jax_rotary
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
from deepspeed_tpu_torch import LlamaForCausalLM, get_llama_config, init_inference
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler
from deepspeed_tpu_torch.models.common import fused_lm_head_loss, init_cache, rms_norm
from deepspeed_tpu_torch.models.llama import param_shapes, rotary_embedding
from deepspeed_tpu_torch.ops.cuda import LAUNCHES, build
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.cuda.attention_geometry import KERNEL_HEAD_DIMS, check_head_dim

ATOL = 1e-4
#: the 1-layer head-dim-128 model: hidden 256, 2 query heads over 1 kv head
D128 = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=1, num_attention_heads=2,
            num_key_value_heads=1)
#: model variants: JAX/port config overrides of the "test" preset
VARIANTS = {
    "gqa-xla": {},
    "gqa-flash": dict(attention_backend="flash"),
    "bias": dict(attention_bias=True),
    "window-flash": dict(sliding_window=32, attention_backend="flash"),
    "d128-xla": D128,
    "d128-flash": dict(D128, attention_backend="flash"),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ids(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.int32)


def _jax_params(overrides, seed=0):
    """The JAX model and its seeded params (numpy); with ``attention_bias``
    the zero-initialized q/k/v biases are replaced by seeded random ones, so
    that the comparison sees them."""
    module = JaxLlama(jax_config("test", **overrides))
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.device_get(nn.meta.unbox(params))
    if overrides.get("attention_bias"):
        rng = np.random.default_rng(seed)
        for layer in params.values():
            for name in ("q_proj", "k_proj", "v_proj"):
                if isinstance(layer, dict) and "self_attn" in layer:
                    b = layer["self_attn"][name]["bias"]
                    layer["self_attn"][name]["bias"] = rng.normal(0, 0.1, b.shape).astype(np.float32)
    return module, params


def _port_model(tree, overrides):
    cfg = get_llama_config("test", **overrides)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg), strict=True)
    return model


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_matches_jax(out_dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 5, 64)).astype(np.float32)
    w = rng.normal(1, 0.1, (64,)).astype(np.float32)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, jdt).astype(jnp.float32))
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6, out_dtype)
    assert got.dtype == out_dtype
    tol = 1e-6 if out_dtype == torch.float32 else 0.0  # bf16: the same rounding of one fp32 value
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [16, 128])
def test_rotary_embedding_matches_jax(d):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 7, 3, d)).astype(np.float32)
    positions = rng.integers(0, 2048, (2, 7)).astype(np.int32)
    want = np.asarray(jax_rotary(jnp.asarray(x), jnp.asarray(positions), 10000.0))
    got = rotary_embedding(torch.from_numpy(x), torch.from_numpy(positions), 10000.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_fused_head_loss_untied_kernel_matches_jax():
    """The [E, V] layout (JAX ``vocab_major=False``): value, dx and dW."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 33, 64)).astype(np.float32)
    w = rng.normal(0, 0.05, (64, 256)).astype(np.float32)
    labels = rng.integers(0, 256, (2, 33)).astype(np.int32)
    labels[0, :5] = -100

    def jloss(x_, w_):
        return jax_fused_loss(x_, w_, jnp.asarray(labels), chunk=16, vocab_major=False)

    want, (wdx, wdw) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jnp.asarray(x),
                                                                          jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = fused_lm_head_loss(xt, wt, torch.from_numpy(labels), chunk=16, vocab_major=False)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for g, r in ((xt.grad, wdx), (wt.grad, wdw)):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-6 * np.abs(r).max()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_state_dict_matches_param_shapes_and_round_trips():
    module, tree = _jax_params(dict(attention_bias=True))
    cfg = get_llama_config("test", attention_bias=True)
    model = LlamaForCausalLM(cfg, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()} == param_shapes(cfg)
    sd = params_from_jax(tree)  # the config inferred from the tree
    assert set(sd) == set(param_shapes(cfg))
    flat = params_to_jax(sd)
    assert "layers_1/self_attn/q_proj/bias" in flat and "lm_head/kernel" in flat
    for path, arr in flat.items():
        node = tree
        for part in path.split("/"):
            node = node[part]
        np.testing.assert_array_equal(arr, node)


def test_params_from_jax_refuses_a_misshapen_tree():
    _, tree = _jax_params({})
    del tree["layers_1"]["mlp"]["up_proj"]
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(tree, get_llama_config("test"))


@pytest.mark.parametrize("variant", VARIANTS)
def test_logits_match_jax(variant):
    overrides = VARIANTS[variant]
    module, tree = _jax_params(overrides)
    ids = _ids(3, 2, 64)
    want = np.asarray(jax.jit(module.apply)({"params": tree}, jnp.asarray(ids)))
    with torch.no_grad():
        got = _port_model(tree, overrides)(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["gqa-xla", "gqa-flash", "d128-flash"])
def test_decode_cache_matches_full_forward(variant):
    """Prefill 8 tokens into the lockstep cache, then decode 4 one at a
    time: the logits of the full forward (``test_models.py``'s 2e-4), and
    the JAX model's decode logits at each step."""
    overrides = VARIANTS[variant]
    module, tree = _jax_params(overrides)
    model = _port_model(tree, overrides)
    ids = _ids(4, 2, 12)
    with torch.no_grad():
        full = model(torch.from_numpy(ids).long()).numpy()
        cache = init_cache(model, 2)
        steps = [model(torch.from_numpy(ids[:, :8]).long(), cache).numpy()]
        steps += [model(torch.from_numpy(ids[:, t:t + 1]).long(), cache).numpy()
                  for t in range(8, 12)]
    assert int(cache["layers_0/self_attn/cache_index"]) == 12
    np.testing.assert_allclose(np.concatenate(steps, axis=1), full, rtol=2e-4, atol=2e-4)
    jcache = {"cache": jax.jit(functools.partial(module.init, decode=True))(
        jax.random.PRNGKey(0), jnp.zeros((2, 1), jnp.int32))["cache"]}
    jcache = jax.tree.map(jnp.zeros_like, jcache)
    step = jax.jit(functools.partial(module.apply, decode=True, mutable=["cache"]))
    for t0, t1, got in zip([0, 8, 9, 10, 11], [8, 9, 10, 11, 12], steps):
        out, jcache = step({"params": tree, **jcache}, jnp.asarray(ids[:, t0:t1]))
        np.testing.assert_allclose(got, np.asarray(out), atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_generate_greedy_tokens_match_jax(backend):
    """A 20-token prompt: one 16-token prefill chunk, four single-token
    prefill calls, then the token loop."""
    set_topology(None)
    cfg = jax_config("test")
    topo = MeshTopology(tensor=1, data=1, fsdp=1, devices=jax.devices()[:1])
    jax_engine = JaxEngine(JaxLlama(cfg), JaxInferenceConfig(replace_with_kernel_inject=False),
                           topology=topo)
    state = params_from_jax(jax.device_get(jax_engine.params), get_llama_config("test"))
    set_topology(None)
    ids = _ids(5, 2, 20)
    want = np.asarray(jax_engine.generate(ids, max_new_tokens=6))
    model = LlamaForCausalLM(get_llama_config("test"), device="cpu")
    kw = dict(kernel_inject=True, use_flash_prefill=True) if backend == "flash" else {}
    engine = init_inference(model, params=state, device="cpu", **kw)
    assert engine.module.config.attention_backend == backend
    assert engine._max_len == 128  # the preset's max_position_embeddings
    np.testing.assert_array_equal(engine.generate(ids, max_new_tokens=6).numpy(), want)


def test_scheduler_refuses_llama():
    """As the JAX scheduler does: LLaMA decodes against the lockstep cache only."""
    engine = init_inference(LlamaForCausalLM(get_llama_config("test"), device="cpu"), device="cpu")
    with pytest.raises(NotImplementedError, match="LlamaForCausalLM"):
        ContinuousBatchingScheduler(engine)


@pytest.mark.parametrize("field,value", [("remat_policy", "dots"),
                                         ("attention_blocks", "block_q=64")])
def test_later_slice_features_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        get_llama_config("test", **{field: value})


# ---------------------------------------------------------------------------
# head dims on the card: 64 and 128 have kernels, any other raises first
# ---------------------------------------------------------------------------
def _meta(*shape):
    """A tensor that is neither on the CPU (no plain version) nor on a card."""
    return torch.empty(*shape, device="meta", dtype=torch.bfloat16)


@pytest.mark.parametrize("d", [32, 80, 96, 256])
def test_kernel_wrappers_refuse_other_head_dims_before_any_launch(d):
    """K1, K4 and K3's wrappers check the head dim before anything else, so
    a head dim without a kernel raises ``ValueError`` without building or
    launching one (the tensors here lie on no device the port runs on)."""
    q = _meta(1, 8, 2, d)
    launches, loaded = dict(LAUNCHES), dict(build._loaded)
    with pytest.raises(ValueError, match=f"flash_fwd: head_dim {d} not in"):
        fa.flash_fwd(q, q, q, scale=0.125, causal=True)
    with pytest.raises(ValueError, match=f"flash_bwd: head_dim {d} not in"):
        fa.flash_bwd(q, q, q, q, _meta(1, 2, 8).float(), q, scale=0.125, causal=True)
    with pytest.raises(ValueError, match=f"flash_decode: head_dim {d} not in"):
        fa.flash_decode(q, q, q, torch.zeros(1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match=f"head_dim {d} not in"):
        check_head_dim("flash", d)
    assert LAUNCHES == launches and build._loaded == loaded


@pytest.mark.parametrize("d", KERNEL_HEAD_DIMS)
def test_kernel_head_dims_pass_the_head_dim_check(d):
    """64 and 128 pass the check: the same call then stops at the device
    check (a CUDA tensor would launch the kernel)."""
    assert KERNEL_HEAD_DIMS == (64, 128)
    check_head_dim("flash", d)
    q = _meta(1, 8, 2, d)
    with pytest.raises(ValueError, match="must lie on one CUDA device"):
        fa.flash_fwd(q, q, q, scale=0.125, causal=True)
    with pytest.raises(ValueError, match="must lie on one CUDA device"):
        fa.flash_decode(q, q, q, torch.zeros(1, dtype=torch.int32, device="meta"))
