"""The port's beam search against the JAX engine's.

GPT-2 and LLaMA "test" models (2 layers) hold the same seeded weights in
both packages, re-drawn at N(0, 0.15) so that the beams' log-probabilities
are well apart (the init's 0.02 leaves near-uniform next-token
distributions, where fp32 rounding alone could reorder two candidates). A
batch of 3 prompts (padded to the pow2 bucket 4 in both engines) runs
``generate(num_beams=2 and 3, length_penalty 0.0 and 1.0, with and without
eos)`` in fp32 on the CPU: the tokens must be identical. ``num_beams=1`` is
greedy, ``do_sample`` with beams raises, and a refused call leaves the
engine's generator where it was.
"""

import numpy as np
import pytest

import jax
import torch

from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_gpt2_config
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama, get_llama_config as jax_llama_config
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
from deepspeed_tpu_torch import (GPT2LMHeadModel, LlamaForCausalLM, get_gpt2_config,
                                 get_llama_config, init_inference)
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.models.common import flatten_tree, nest_tree

PROMPT, NEW = 10, 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spread(tree, seed):
    """Every float leaf re-drawn N(0, 0.15) (norm scales around 1), seeded."""
    rng = np.random.default_rng(seed)
    flat = flatten_tree(jax.device_get(tree), "/")
    out = {}
    for key in sorted(flat):
        leaf = np.asarray(flat[key])
        if key.endswith("scale"):
            out[key] = (1.0 + rng.normal(0, 0.1, leaf.shape)).astype(leaf.dtype)
        else:
            out[key] = rng.normal(0, 0.15, leaf.shape).astype(leaf.dtype)
    return nest_tree(out, "/")


FAMILIES = {
    "gpt2": (lambda: JaxGPT2(jax_gpt2_config("test", n_layer=2)),
             lambda: GPT2LMHeadModel(get_gpt2_config("test", n_layer=2), device="cpu")),
    "llama": (lambda: JaxLlama(jax_llama_config("test")),
              lambda: LlamaForCausalLM(get_llama_config("test"), device="cpu")),
}


@pytest.fixture(scope="module")
def engines():
    set_topology(None)
    topo = MeshTopology(tensor=1, data=1, fsdp=1, devices=jax.devices()[:1])
    out = {}
    for name, (make_jax, make_port) in FAMILIES.items():
        module = make_jax()
        base = JaxEngine(module, JaxInferenceConfig(replace_with_kernel_inject=False),
                         topology=topo)
        tree = _spread(base.params, seed=7)
        jax_engine = JaxEngine(module, JaxInferenceConfig(replace_with_kernel_inject=False),
                               params=tree, topology=topo)
        port_engine = init_inference(make_port(), params=params_from_jax(tree), device="cpu")
        out[name] = (jax_engine, port_engine)
    yield out
    set_topology(None)


def _prompts(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (3, PROMPT)).astype(np.int32)


#: every beam count, length penalty and eos setting in each family, each
#: pair of the three once in GPT-2
CASES = [("gpt2", 2, 0.0, False), ("gpt2", 3, 1.0, False), ("gpt2", 2, 1.0, True),
         ("gpt2", 3, 0.0, True), ("llama", 2, 1.0, False), ("llama", 3, 0.0, True)]


@pytest.mark.parametrize("family,beams,length_penalty,with_eos", CASES)
def test_beam_tokens_match_jax(engines, family, beams, length_penalty, with_eos):
    jax_engine, port_engine = engines[family]
    ids = _prompts()
    eos = None
    if with_eos:
        # a token the eos-free search emits early in row 0, so beams finish
        free = np.asarray(jax_engine.generate(ids, max_new_tokens=NEW, num_beams=beams,
                                              length_penalty=length_penalty))
        eos = int(free[0, PROMPT + 1])
    kwargs = dict(max_new_tokens=NEW, num_beams=beams, length_penalty=length_penalty,
                  eos_token_id=eos)
    want = np.asarray(jax_engine.generate(ids, **kwargs))
    got = port_engine.generate(ids, **kwargs).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :PROMPT], ids)
    if with_eos:
        # the eos path was taken: a beam finished, and either it won or the
        # finished beam changed the search's outcome
        assert (got[:, PROMPT:] == eos).any() or not np.array_equal(got, free)


def test_one_beam_is_greedy(engines):
    _, port_engine = engines["gpt2"]
    ids = _prompts(1)
    greedy = port_engine.generate(ids, max_new_tokens=NEW)
    one = port_engine.generate(ids, max_new_tokens=NEW, num_beams=1)
    np.testing.assert_array_equal(one.numpy(), greedy.numpy())


def test_refused_calls_leave_the_generator(engines):
    _, port_engine = engines["gpt2"]
    before = port_engine.generator.get_state().clone()
    with pytest.raises(ValueError, match="do_sample"):
        port_engine.generate(_prompts(), max_new_tokens=2, num_beams=2, do_sample=True)
    with pytest.raises(ValueError, match="exceeds"):
        port_engine.generate(np.zeros((2, 120), np.int32), max_new_tokens=20, do_sample=True)
    assert torch.equal(port_engine.generator.get_state(), before)
    port_engine.generate(_prompts(), max_new_tokens=2, do_sample=True)
    assert not torch.equal(port_engine.generator.get_state(), before)
