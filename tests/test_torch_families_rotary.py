"""The PyTorch port's rotary decoder families (GPT-NeoX, GPT-J, Falcon)
against the JAX package's.

Each family's "test" preset (Falcon's both ways: "test", the 7B layout with
one kv head and one shared ``input_layernorm``, and "test-gqa", two kv
heads under ``new_decoder_architecture``; GPT-NeoX also with a serial
residual) holds the JAX model's seeded weights, re-drawn at N(0, 0.15) so
that greedy tokens and beams are well apart, carried by ``params_from_jax``.
The same seeded numpy ids then go through both in fp32 on the CPU: the
logits within 1e-5 of max |JAX|; the lockstep decode cache (an 8-token
prefill, then 4 single tokens) against JAX's decode logits (1e-5) and the
port's own full forward (2e-4, ``test_models.py``'s limit); ``generate``
token for token against the JAX ``InferenceEngine``, greedy on the
``"xla"`` backend and under kernel injection (the flash wrappers' plain
versions on CPU tensors) and with 2 beams. The JAX references are computed
once, in a module fixture. Beside them: the trees' round trip, the configs
read from the trees, sampled ``generate`` reproducible from its generator,
the flash backend's plain path at head dims 96 (GPT-NeoX-20b) and 256
(GPT-J-6b) against JAX's flash kernels in interpret mode, K4's refusal of
both, kernel injection holding one copy of the weights (and what that
means for a hot-swap and for the hybrid engine's view), and the JAX paths
that the npz manifest names.
"""

import functools
import json

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.models.common import init_cache as jax_init_cache
from deepspeed_tpu.models.falcon import FalconForCausalLM as JaxFalcon
from deepspeed_tpu.models.falcon import get_falcon_config as jax_falcon_config
from deepspeed_tpu.models.gpt_neox import GPTNeoXForCausalLM as JaxNeoX
from deepspeed_tpu.models.gpt_neox import get_gpt_neox_config as jax_neox_config
from deepspeed_tpu.models.gptj import GPTJForCausalLM as JaxGPTJ
from deepspeed_tpu.models.gptj import get_gptj_config as jax_gptj_config
from deepspeed_tpu.models.gptj import rotary_embedding_interleaved as jax_rotary_interleaved
from deepspeed_tpu.ops.transformer.attention import dot_product_attention as jax_attention
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
import deepspeed_tpu_torch
from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
from deepspeed_tpu_torch.checkpoint import zero_to_fp32
from deepspeed_tpu_torch.checkpoint.from_jax import _infer_config, jax_paths, params_from_jax, params_to_jax
from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler
from deepspeed_tpu_torch.models import (FalconForCausalLM, GPTJForCausalLM, GPTNeoXForCausalLM,
                                        get_falcon_config, get_gpt_neox_config, get_gptj_config)
from deepspeed_tpu_torch.models.common import flatten_tree, init_cache, nest_tree
from deepspeed_tpu_torch.models.gptj import rotary_embedding_interleaved
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer.attention import dot_product_attention

#: variant -> (JAX model, JAX config, port model, port config, preset, overrides)
VARIANTS = {
    "neox": (JaxNeoX, jax_neox_config, GPTNeoXForCausalLM, get_gpt_neox_config, "test", {}),
    "neox-serial": (JaxNeoX, jax_neox_config, GPTNeoXForCausalLM, get_gpt_neox_config, "test",
                    dict(use_parallel_residual=False)),
    "gptj": (JaxGPTJ, jax_gptj_config, GPTJForCausalLM, get_gptj_config, "test", {}),
    "falcon-mqa": (JaxFalcon, jax_falcon_config, FalconForCausalLM, get_falcon_config, "test", {}),
    "falcon-gqa": (JaxFalcon, jax_falcon_config, FalconForCausalLM, get_falcon_config, "test-gqa", {}),
}
#: the variants whose generate runs against the JAX engine (one per layout)
GENERATE = ("neox", "gptj", "falcon-mqa", "falcon-gqa")
PROMPT, NEW = 20, 6


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


def _spread(tree, seed):
    """Every float leaf re-drawn N(0, 0.15) (norm scales around 1), seeded."""
    rng = np.random.default_rng(seed)
    flat = flatten_tree(tree, "/")
    out = {}
    for key in sorted(flat):
        leaf = np.asarray(flat[key])
        scale = key.endswith("scale")
        out[key] = ((1.0 if scale else 0.0) + rng.normal(0, 0.1 if scale else 0.15, leaf.shape)).astype(leaf.dtype)
    return nest_tree(out, "/")


def _port(variant, tree, **over):
    _, _, cls, cfg_fn, preset, overrides = VARIANTS[variant]
    cfg = cfg_fn(preset, **overrides, **over)
    model = cls(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg), strict=True)
    return model


@pytest.fixture(scope="module")
def ref():
    """Per variant: the spread JAX tree, its logits on [2, 24] ids, its
    decode logits (8-token prefill, then 4 single tokens, of [2, 12] ids),
    and for ``GENERATE`` the JAX engine's greedy and 2-beam tokens."""
    set_topology(None)
    topo = MeshTopology(tensor=1, data=1, fsdp=1, devices=jax.devices()[:1])
    out = {}
    for i, (name, (jcls, jcfg, _, _, preset, overrides)) in enumerate(VARIANTS.items()):
        module = jcls(jcfg(preset, **overrides))
        params = jax.jit(module.init)(jax.random.PRNGKey(i), jnp.zeros((1, 8), jnp.int32))["params"]
        tree = _spread(jax.device_get(nn.meta.unbox(params)), seed=i)
        r = {"tree": tree, "logits": np.asarray(jax.jit(module.apply)({"params": tree}, jnp.asarray(_ids(1, 2, 24))))}
        step = jax.jit(functools.partial(module.apply, decode=True, mutable=["cache"]))
        cache = {"cache": jax_init_cache(module, 2)}
        dec_ids = _ids(2, 2, 12)
        steps = []
        for t0, t1 in ((0, 8), (8, 9), (9, 10), (10, 11), (11, 12)):
            logits, cache = step({"params": tree, **cache}, jnp.asarray(dec_ids[:, t0:t1]))
            steps.append(np.asarray(logits))
        r["decode"] = np.concatenate(steps, axis=1)
        if name in GENERATE:
            engine = JaxEngine(module, JaxInferenceConfig(replace_with_kernel_inject=False), params=tree,
                               topology=topo)
            prompts = _ids(3, 3, PROMPT)
            r["greedy"] = np.asarray(engine.generate(prompts, max_new_tokens=NEW))
            r["beam"] = np.asarray(engine.generate(prompts[:, :10], max_new_tokens=NEW, num_beams=2))
        out[name] = r
    set_topology(None)
    return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_logits_match_jax(ref, variant):
    want = ref[variant]["logits"]
    with torch.no_grad():
        got = _port(variant, ref[variant]["tree"])(torch.from_numpy(_ids(1, 2, 24)).long()).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_cache_matches_jax_and_the_full_forward(ref, variant):
    """The lockstep cache: an 8-token prefill, then 4 single tokens."""
    model = _port(variant, ref[variant]["tree"])
    ids = torch.from_numpy(_ids(2, 2, 12)).long()
    with torch.no_grad():
        full = model(ids).numpy()
        cache = init_cache(model, 2)
        steps = [model(ids[:, :8], cache).numpy()] + [model(ids[:, t:t + 1], cache).numpy()
                                                      for t in range(8, 12)]
    got = np.concatenate(steps, axis=1)
    want = ref[variant]["decode"]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, full, rtol=2e-4, atol=2e-4)
    assert all(int(v) == 12 for k, v in cache.items() if k.endswith("cache_index"))


@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("variant", GENERATE)
def test_generate_greedy_tokens_match_jax(ref, variant, backend):
    """A 20-token prompt (one 16-token prefill chunk, four single-token
    calls, then the token loop), through ``init_inference``; under kernel
    injection the flash backend's wrappers run their plain versions."""
    kw = dict(kernel_inject=True, use_flash_prefill=True) if backend == "flash" else {}
    engine = init_inference(_port(variant, ref[variant]["tree"]), device="cpu", **kw)
    assert engine.module.config.attention_backend == backend
    np.testing.assert_array_equal(engine.generate(_ids(3, 3, PROMPT), max_new_tokens=NEW).numpy(),
                                  ref[variant]["greedy"])


@pytest.mark.parametrize("variant", GENERATE)
def test_beam_search_matches_jax(ref, variant):
    engine = init_inference(_port(variant, ref[variant]["tree"]), device="cpu")
    got = engine.generate(_ids(3, 3, PROMPT)[:, :10], max_new_tokens=NEW, num_beams=2).numpy()
    np.testing.assert_array_equal(got, ref[variant]["beam"])


def test_sampled_generate_follows_its_generator(ref):
    """Sampled decoding draws from the generator it is given (JAX's and the
    port's streams differ, so the two are not compared token for token)."""
    engine = init_inference(_port("neox", ref["neox"]["tree"]), device="cpu")
    ids = _ids(4, 2, 9)
    runs = [engine.generate(ids, max_new_tokens=NEW, do_sample=True, top_k=8,
                            generator=torch.Generator().manual_seed(s)).numpy() for s in (5, 5, 6)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].shape == (2, 9 + NEW) and (runs[0][:, :9] == ids).all()
    assert not np.array_equal(runs[0], runs[2])


@pytest.mark.parametrize("variant", VARIANTS)
def test_tree_round_trips_and_names_its_family(ref, variant):
    tree = ref[variant]["tree"]
    _, _, cls, cfg_fn, preset, overrides = VARIANTS[variant]
    sd = params_from_jax(tree)  # the family and its widths read from the tree
    cfg = cfg_fn(preset, **overrides)
    inferred = _infer_config(sd)
    assert type(inferred) is type(cfg)
    for field in ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads"):
        assert getattr(inferred, field) == getattr(cfg, field), field
    if variant.startswith("falcon"):
        assert (inferred.num_kv_heads, inferred.new_decoder_architecture) == (
            cfg.num_kv_heads, cfg.new_decoder_architecture)
    flat = params_to_jax(sd)
    want = flatten_tree(tree, "/")
    assert set(flat) == set(want)
    for path, arr in flat.items():
        np.testing.assert_array_equal(arr, want[path])


def test_interleaved_rotary_matches_jax():
    """GPT-J's rotate-every-two RoPE (JAX ``gptj.py:65``), at positions up to
    2047 and in the partial form the model applies."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 7, 3, 64)).astype(np.float32)
    positions = rng.integers(0, 2048, (2, 7)).astype(np.int32)
    want = np.asarray(jax_rotary_interleaved(jnp.asarray(x), jnp.asarray(positions), 10000.0))
    got = rotary_embedding_interleaved(torch.from_numpy(x), torch.from_numpy(positions), 10000.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("d", [96, 256])
def test_flash_backend_plain_path_matches_jax_interpret(d):
    """The flash backend at head dims 96 (GPT-NeoX-20b) and 256 (GPT-J-6b):
    the port's wrappers on CPU tensors compute their plain versions, JAX's
    run its Pallas kernels in interpret mode. A causal prefill and a cache
    decode of 3 rows, within 1e-5 of max |JAX|."""
    rng = np.random.default_rng(d)
    q, k, v = (rng.normal(0, 1, (2, 32, 2, d)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), backend="flash",
                                    causal=True))
    got = dot_product_attention(*(torch.from_numpy(t) for t in (q, k, v)), backend="flash",
                                causal=True).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    lengths = np.array([20, 64], np.int32)
    qd = rng.normal(0, 1, (2, 3, 2, d)).astype(np.float32)
    kc, vc = (rng.normal(0, 1, (2, 64, 2, d)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_attention(jnp.asarray(qd), jnp.asarray(kc), jnp.asarray(vc), backend="flash",
                                    causal=False, decode_lengths=jnp.asarray(lengths)))
    got = dot_product_attention(*(torch.from_numpy(t) for t in (qd, kc, vc)), backend="flash",
                                causal=False, decode_lengths=torch.from_numpy(lengths)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("d", [96, 256])
def test_flash_backward_refuses_the_new_head_dims(d):
    """K4 is built for head dims 64 and 128; 96 and 256 raise before any
    build, naming the Queue B item that holds them."""
    q = torch.empty(1, 8, 2, d, device="meta", dtype=torch.bfloat16)
    lse = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match=f"head_dim {d} not in the kernel's .*Queue B item 2"):
        fa.flash_bwd(q, q, q, q, lse, q, scale=0.1, causal=True)


def _fresh_bytes(fn):
    """Run ``fn`` and count the bytes of every new storage its operations
    allocate off the meta device (outputs whose storage no input holds)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = {"bytes": 0}

    class Count(TorchDispatchMode):

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = {t.untyped_storage().data_ptr() for t in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor) and t.device.type != "meta"}
            for t in torch.utils._pytree.tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.device.type != "meta"
                        and t.untyped_storage().data_ptr() not in ins):
                    seen["bytes"] += t.untyped_storage().nbytes()
            return out

    with Count():
        result = fn()
    return result, seen["bytes"]


def test_injection_holds_one_copy_of_the_weights(monkeypatch):
    """Kernel injection builds its module on the meta device, draws no init
    and serves the caller's tensors where they already have the serving
    dtype: no parameter storage is allocated (the bound is one layer's
    bytes). Under a dtype change each weight is converted once."""
    model = GPTNeoXForCausalLM(get_gpt_neox_config("test"), device="cpu")
    draws = []
    monkeypatch.setattr(GPTNeoXForCausalLM, "reset_parameters",
                        lambda self, generator=None: draws.append(1))
    engine, fresh = _fresh_bytes(lambda: init_inference(model, device="cpu", kernel_inject=True,
                                                        use_flash_prefill=True))
    layer_bytes = sum(p.nbytes for p in model.layers_0.parameters())
    assert draws == [] and fresh < layer_bytes
    storages = lambda m: {p.untyped_storage().data_ptr() for p in m.parameters()}  # noqa: E731
    assert storages(engine.module) == storages(model)
    assert all(p.device.type == "cpu" for p in engine.module.parameters())
    assert engine.module.device == torch.device("cpu")
    half, fresh = _fresh_bytes(lambda: init_inference(model, device="cpu", dtype="bf16"))
    assert not storages(half.module) & storages(model)
    assert all(p.dtype == torch.bfloat16 for p in half.module.parameters())
    model_bytes = sum(p.nbytes for p in model.parameters())
    assert model_bytes // 2 <= fresh < model_bytes // 2 + layer_bytes


def test_a_hot_swap_writes_into_a_model_served_from_its_own_tensors():
    """``init_inference`` serves a weight already of the serving dtype from
    the caller's own tensor, so a scheduler's in-place hot-swap writes into
    the caller's model; a model served at another dtype stays as it was.
    (The scheduler serves GPT-2 and LLaMA: GPT-2 here.)"""
    model = GPT2LMHeadModel(get_gpt2_config("test", n_layer=2), device="cpu")
    engine = init_inference(model, device="cpu")
    new = {k: v + 1 for k, v in engine.params.items()}
    ContinuousBatchingScheduler(engine).swap_served_params(new)
    assert all(torch.equal(model.state_dict()[k], new[k]) for k in new)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    half = init_inference(model, device="cpu", dtype="bf16")
    ContinuousBatchingScheduler(half).swap_served_params({k: v * 2 for k, v in half.params.items()})
    assert all(torch.equal(model.state_dict()[k], before[k]) for k in before)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_the_hybrid_view_copies_only_the_tensors_it_would_share(dtype):
    """The hybrid engine's inference view must not move with the training
    step. Over fp32 masters served in bf16 every weight is cast, a new
    tensor already, and building the view allocates the bf16 model alone,
    no fp32 copy; served in fp32, each weight is copied once."""
    cfg = get_gpt2_config("test", n_layer=2, dtype=dtype)
    config = {"train_batch_size": 8, "bf16": {"enabled": dtype == torch.bfloat16},
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "hybrid_engine": {"enabled": True, "max_out_tokens": 64}}
    engine, *_ = deepspeed_tpu_torch.initialize(model=GPT2LMHeadModel(cfg, device="cpu"), config=config,
                                                device="cpu")
    view, fresh = _fresh_bytes(engine._build_inference_engine)
    storages = lambda m: {p.untyped_storage().data_ptr() for p in m.parameters()}  # noqa: E731
    assert not storages(view.module) & storages(engine.module)
    assert {p.dtype for p in view.module.parameters()} == {dtype}
    served = sum(p.nbytes for p in view.module.parameters())
    layer_bytes = sum(p.nbytes for p in view.module.h_0.parameters())
    assert served <= fresh < served + layer_bytes


@pytest.mark.parametrize("variant", VARIANTS)
def test_jax_paths_and_the_npz_manifest_name_the_tree(ref, variant, tmp_path, monkeypatch):
    """``jax_paths``, which the consolidated npz's manifest, compression and
    weight quantization read, gives the tree's own paths: the family's norms
    without GPT-2's ``LayerNorm_0`` scope."""
    tree = ref[variant]["tree"]
    sd = params_from_jax(tree)
    want = sorted(flatten_tree(tree, "/"))
    assert sorted(jax_paths(sd).values()) == want
    monkeypatch.setattr(zero_to_fp32, "get_fp32_state_dict_from_zero_checkpoint",
                        lambda checkpoint_dir, tag=None: sd)
    zero_to_fp32.convert_zero_checkpoint_to_fp32_state_dict("unused", str(tmp_path))
    assert json.loads((tmp_path / "manifest.json").read_text())["keys"] == want
