"""The PyTorch port's GPT-Neo, OPT and BLOOM against the JAX package's.

Each family's "test" preset, and beside it OPT's projection layout at
"test" width (``word_embed_proj_dim`` 32 with post-LN blocks, the 350m
preset's form) and BLOOM at 12 heads (hidden 96: non-power-of-two ALiBi
slopes), holds the JAX model's seeded weights, re-drawn at N(0, 0.15) so
that greedy tokens and beams are well apart, carried by ``params_from_jax``.
The same seeded numpy ids go through both in fp32 on the CPU: the logits
within 1e-5 of max |JAX| (GPT-Neo's also on the flash backend: its local
layer's window and unscaled logits through K1's plain version); the lockstep
decode cache against JAX's decode logits (1e-5) and, for the families
without a local layer, the port's own full forward (2e-4); GPT-Neo's
24-token ids and 20-token prompts run past its window of 8, and its decode
attends the whole cache, as JAX's does. ``generate`` token for token against
the JAX ``InferenceEngine``: greedy on ``"xla"`` and under kernel injection
(where BLOOM keeps ``"xla"`` by its class's ``xla_attention_reason``,
logged, as a subclass does), and with 2 beams. The JAX references are
computed once, in a module fixture. Beside them: the trees' round trip,
their JAX paths and the npz manifest's, the configs read from the trees
and the ALiBi slopes against JAX's.
"""

import functools
import json
import logging

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.models.bloom import BloomForCausalLM as JaxBloom
from deepspeed_tpu.models.bloom import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.models.bloom import get_bloom_config as jax_bloom_config
from deepspeed_tpu.models.common import init_cache as jax_init_cache
from deepspeed_tpu.models.gpt_neo import GPTNeoForCausalLM as JaxNeo
from deepspeed_tpu.models.gpt_neo import get_gpt_neo_config as jax_neo_config
from deepspeed_tpu.models.opt import OPTForCausalLM as JaxOPT
from deepspeed_tpu.models.opt import get_opt_config as jax_opt_config
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.checkpoint import zero_to_fp32
from deepspeed_tpu_torch.checkpoint.from_jax import _infer_config, jax_paths, params_from_jax, params_to_jax
from deepspeed_tpu_torch.models import (BloomForCausalLM, GPTNeoForCausalLM, OPTForCausalLM,
                                        get_bloom_config, get_gpt_neo_config, get_opt_config)
from deepspeed_tpu_torch.models.bloom import alibi_slopes
from deepspeed_tpu_torch.models.common import flatten_tree, init_cache, nest_tree
from deepspeed_tpu_torch.ops.transformer.attention import dot_product_attention

#: variant -> (JAX model, JAX config, port model, port config, preset, overrides)
VARIANTS = {
    "neo": (JaxNeo, jax_neo_config, GPTNeoForCausalLM, get_gpt_neo_config, "test", {}),
    "opt": (JaxOPT, jax_opt_config, OPTForCausalLM, get_opt_config, "test", {}),
    "opt-proj": (JaxOPT, jax_opt_config, OPTForCausalLM, get_opt_config, "test",
                 dict(word_embed_proj_dim=32, do_layer_norm_before=False)),
    "bloom": (JaxBloom, jax_bloom_config, BloomForCausalLM, get_bloom_config, "test", {}),
    "bloom-12": (JaxBloom, jax_bloom_config, BloomForCausalLM, get_bloom_config, "test",
                 dict(hidden_size=96, n_head=12)),
}
#: the variants whose generate runs against the JAX engine
GENERATE = ("neo", "opt", "opt-proj", "bloom-12")
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
        tree = _spread(jax.device_get(nn.meta.unbox(params)), seed=10 + i)
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


@pytest.mark.parametrize("variant", list(VARIANTS) + ["neo-flash"])
def test_logits_match_jax(ref, variant):
    """``neo-flash``: GPT-Neo on the flash backend (its local layer's window
    8 and scale 1.0 through K1's plain version) against JAX's ``"xla"``."""
    flash = variant == "neo-flash"
    variant = "neo" if flash else variant
    want = ref[variant]["logits"]
    model = _port(variant, ref[variant]["tree"], **(dict(attention_backend="flash") if flash else {}))
    with torch.no_grad():
        got = model(torch.from_numpy(_ids(1, 2, 24)).long()).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_cache_matches_jax_and_the_full_forward(ref, variant):
    """The lockstep cache: an 8-token prefill, then 4 single tokens. GPT-Neo
    decodes against the whole cache, so past its window of 8 its decode
    differs from its full forward, as JAX's does: it is held to JAX's decode
    alone."""
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
    if variant == "neo":
        np.testing.assert_allclose(got[:, :8], full[:, :8], rtol=2e-4, atol=2e-4)
        assert np.abs(got[:, 8:] - full[:, 8:]).max() > 1e-3  # past the window
    else:
        np.testing.assert_allclose(got, full, rtol=2e-4, atol=2e-4)
    indices = [int(v) for k, v in cache.items() if k.endswith("_index")]
    assert indices and all(i == 12 for i in indices)


@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("variant", GENERATE)
def test_generate_greedy_tokens_match_jax(ref, variant, backend, caplog):
    """A 20-token prompt (one 16-token prefill chunk, four single-token
    calls, then the token loop), through ``init_inference``. Under kernel
    injection BLOOM keeps ``"xla"`` by its class's rule, and says so."""
    kw = dict(kernel_inject=True, use_flash_prefill=True) if backend == "flash" else {}
    with caplog.at_level(logging.INFO, logger="deepspeed_tpu_torch.inference.engine"):
        engine = init_inference(_port(variant, ref[variant]["tree"]), device="cpu", **kw)
    bloom = variant.startswith("bloom")
    assert engine.module.config.attention_backend == ("xla" if bloom else backend)
    assert ("keeps attention_backend 'xla'" in caplog.text) == (bloom and backend == "flash")
    np.testing.assert_array_equal(engine.generate(_ids(3, 3, PROMPT), max_new_tokens=NEW).numpy(),
                                  ref[variant]["greedy"])


@pytest.mark.parametrize("variant", GENERATE)
def test_beam_search_matches_jax(ref, variant):
    engine = init_inference(_port(variant, ref[variant]["tree"]), device="cpu")
    got = engine.generate(_ids(3, 3, PROMPT)[:, :10], max_new_tokens=NEW, num_beams=2).numpy()
    np.testing.assert_array_equal(got, ref[variant]["beam"])


@pytest.mark.parametrize("variant", VARIANTS)
def test_tree_round_trips_and_names_its_family(ref, variant):
    tree = ref[variant]["tree"]
    _, _, cls, cfg_fn, preset, overrides = VARIANTS[variant]
    sd = params_from_jax(tree)  # the family and its widths read from the tree
    cfg = cfg_fn(preset, **overrides)
    inferred = _infer_config(sd)
    assert type(inferred) is type(cfg)
    assert (inferred.vocab_size, inferred.hidden_size) == (cfg.vocab_size, cfg.hidden_size)
    if variant.startswith("bloom"):
        assert (inferred.n_head, inferred.n_layer) == (cfg.n_head, cfg.n_layer)
    else:
        assert (inferred.num_attention_heads, inferred.num_hidden_layers) == (
            cfg.num_attention_heads, cfg.num_hidden_layers)
    if variant.startswith("opt"):
        assert inferred.embed_dim == cfg.embed_dim
    flat = params_to_jax(sd)
    want = flatten_tree(tree, "/")
    assert set(flat) == set(want)
    for path, arr in flat.items():
        np.testing.assert_array_equal(arr, want[path])


@pytest.mark.parametrize("n_head", [4, 6, 12, 20, 32, 112])
def test_alibi_slopes_match_jax(n_head):
    """The slopes, power-of-two head counts and the interleaved extras of
    the others (BLOOM-176b has 112 heads)."""
    np.testing.assert_array_equal(alibi_slopes(n_head).numpy(), np.asarray(jax_alibi_slopes(n_head)))


def test_flash_backend_refuses_alibi():
    """The flash backend takes no bias: a BLOOM model built on it raises at
    its first call, never falling back (kernel injection keeps BLOOM on
    ``"xla"``, the test above)."""
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="takes no bias"):
        dot_product_attention(q, q, q, backend="flash", bias=torch.zeros(1, 2, 1, 4))
    model = BloomForCausalLM(get_bloom_config("test", attention_backend="flash"), device="cpu")
    with pytest.raises(ValueError, match="takes no bias"):
        model(torch.zeros(1, 4, dtype=torch.long))


def test_injection_reads_the_xla_rule_from_the_model_class(caplog):
    """The rule is the model class's ``xla_attention_reason``: a subclass of
    BLOOM inherits it and keeps ``"xla"`` under kernel injection, with the
    reason logged."""
    class RenamedBloom(BloomForCausalLM):
        pass

    with caplog.at_level(logging.INFO, logger="deepspeed_tpu_torch.inference.engine"):
        engine = init_inference(RenamedBloom(get_bloom_config("test"), device="cpu"), device="cpu",
                                kernel_inject=True, use_flash_prefill=True)
    assert type(engine.module) is RenamedBloom
    assert engine.module.config.attention_backend == "xla"
    assert BloomForCausalLM.xla_attention_reason in caplog.text


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
