"""The PyTorch port's GPT-2 against the JAX package's.

The JAX model's seeded weights go through ``params_from_jax`` into the
port's model; the same seeded numpy token ids then go through both, in fp32
on the CPU: full-sequence logits, lockstep decode (scalar cache index) and
per-slot decode with int8 KV codes and parked slots (compared on the live
slots; a parked slot's logits are discarded by the scheduler). Logits are
held to ``atol=1e-4``.
"""

import functools

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.inference.serving import programs as jax_programs
from deepspeed_tpu.inference.serving.scheduler import _quant_view as jax_quant_view
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.models.common import init_cache as jax_init_cache
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.inference.serving import programs
from deepspeed_tpu_torch.models.common import init_cache
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHeadModel, get_gpt2_config, param_shapes


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ATOL = 1e-4
CFG = dict(n_layer=2)


@pytest.fixture(autouse=True)
def no_graph():
    """These are inference comparisons: record no autograd graph."""
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def jax_side():
    cfg = jax_config("test", **CFG)
    module = JaxGPT2(cfg)
    params = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return module, jax.device_get(nn.meta.unbox(params))


def _port_model(tree, backend="xla", weight_dtype=None, scales=None):
    cfg = get_gpt2_config("test", attention_backend=backend, serve_weight_dtype=weight_dtype, **CFG)
    model = GPT2LMHeadModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg, scales=scales), strict=True)
    return model


def _ids(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.int32)


@pytest.mark.parametrize("weight_dtype", [None, "int8", "int4"])
def test_state_dict_matches_param_shapes(weight_dtype):
    cfg = get_gpt2_config("test", serve_weight_dtype=weight_dtype)
    model = GPT2LMHeadModel(cfg, device="cpu")
    got = {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}
    assert got == param_shapes(cfg)


def test_params_from_jax_refuses_missing_extra_and_misshapen(jax_side):
    _, tree = jax_side
    sd = params_from_jax(tree)
    assert "h_0.ln_1.scale" in sd and "h_1.attn.c_attn.kernel" in sd
    bad = jax.tree.map(lambda x: x, tree)
    del bad["h_1"]["mlp"]["c_fc"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(bad, get_gpt2_config("test", **CFG))
    extra = jax.tree.map(lambda x: x, tree)
    extra["h_0"]["attn"]["c_attn"]["surplus"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(extra)
    wrong = jax.tree.map(lambda x: x, tree)
    wrong["wpe"] = np.zeros((64, 64), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        params_from_jax(wrong, get_gpt2_config("test", **CFG))


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_full_sequence_logits_match_jax(jax_side, backend):
    module, tree = jax_side
    ids = _ids(0, 2, 24)
    ref = np.asarray(jax.jit(module.apply)({"params": tree}, jnp.asarray(ids)))
    out = _port_model(tree, backend)(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_quantized_logits_match_jax(jax_side, weight_dtype):
    module, tree = jax_side
    q_module, bundle = jax_quant_view(module, tree, weight_dtype, 64)
    bundle = jax.device_get(bundle)
    ids = _ids(1, 2, 16)
    ref = np.asarray(jax.jit(q_module.apply)(bundle, jnp.asarray(ids)))
    model = _port_model(bundle["params"], "flash", weight_dtype, scales=bundle["quant"])
    out = model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_lockstep_decode_matches_jax(jax_side, backend):
    """Chunked prefill then single tokens against a scalar cache index."""
    module, tree = jax_side
    ids = _ids(2, 2, 11)
    jcache = jax_init_cache(module, 2)
    model = _port_model(tree, backend)
    cache = init_cache(model, 2)
    step = jax.jit(functools.partial(module.apply, decode=True, mutable=["cache"]))
    for lo, hi in [(0, 8), (8, 9), (9, 10), (10, 11)]:
        ref, upd = step({"params": tree, "cache": jcache}, jnp.asarray(ids[:, lo:hi]))
        jcache = upd["cache"]
        out = model(torch.from_numpy(ids[:, lo:hi]).long(), cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert int(cache["position_index"]) == 11 and int(cache["h_1/attn/cache_index"]) == 11


def test_lockstep_decode_refuses_int8_kv(jax_side):
    _, tree = jax_side
    model = _port_model(tree)
    cache = programs.quantize_slot_cache(init_cache(model, 1))
    with pytest.raises(NotImplementedError):
        model(torch.zeros((1, 1), dtype=torch.long), cache)


# per-slot ticks: (write positions, tokens per slot this tick); P = 128 is
# the parked sentinel. Slot 2 joins late, slot 3 leaves after tick 1.
SLOT_TICKS = [([0, 0, 128, 0], 8), ([8, 8, 128, 128], 8), ([16, 11, 0, 128], 1),
              ([17, 12, 1, 128], 1)]


@pytest.mark.parametrize("backend,weight_dtype", [("xla", None), ("flash", None), ("flash", "int8")])
def test_slot_decode_int8_kv_matches_jax(jax_side, backend, weight_dtype):
    module, tree = jax_side
    params, scales = tree, None
    j_module = module
    if weight_dtype:
        j_module, bundle = jax_quant_view(module, tree, weight_dtype, 64)
        bundle = jax.device_get(bundle)
        params, scales = bundle["params"], bundle["quant"]
    jax_apply = jax_programs.make_apply_fn(j_module)
    jcache = jax_programs.make_slot_cache(j_module, 4, kv_quant=True)
    model = _port_model(params, backend, weight_dtype, scales=scales)
    apply_fn = programs.make_apply_fn(model)
    cache = programs.make_slot_cache(model, 4, kv_quant=True)
    assert programs.slot_capacity(cache) == jax_programs.slot_capacity(jcache) == 128
    assert cache["h_0/attn/cached_key"].dtype == torch.int8
    j_params = bundle if weight_dtype else tree
    for t, (write_pos, n) in enumerate(SLOT_TICKS):
        ids = _ids(10 + t, 4, n)
        wp = np.asarray(write_pos)
        ref, jcache = jax_apply(j_params, jax_programs.stamp_lengths(jcache, wp), jnp.asarray(ids))
        out = apply_fn(programs.stamp_lengths(cache, wp), torch.from_numpy(ids).long())
        live = wp < 128
        np.testing.assert_allclose(out.numpy()[live], np.asarray(ref)[live], atol=ATOL, rtol=0,
                                   err_msg=f"tick {t}")
        assert np.all(np.isfinite(out.numpy()))
    # parked writes dropped: slot 3 holds only its first 8 rows
    written = cache["h_0/attn/cached_key_scale"][3, :, :, 0].abs().sum(-1) > 0
    assert written[:8].all() and not written[8:].any()


@pytest.mark.parametrize("field,value", [("attention_blocks", "block_q=64")])
def test_later_slice_features_raise(field, value):
    with pytest.raises(NotImplementedError):
        get_gpt2_config("test", **{field: value})


@pytest.mark.parametrize("field,value", [("remat_policy", "dots_saveable"),
                                         ("progressive_layer_drop", True),
                                         ("attn_fused_qkv", False), ("attn_fused_out", False)])
def test_training_config_fields_are_taken(field, value):
    """The JAX fields that the remat-policy, PLD and program-form slice
    brought: taken, and an unknown remat policy raises as JAX's does."""
    assert getattr(get_gpt2_config("test", **{field: value}), field) == value
    with pytest.raises(ValueError, match="unknown remat policy"):
        get_gpt2_config("test", remat_policy="dots")
