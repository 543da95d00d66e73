"""Serving an MoE GPT-2 in the port against the JAX package.

GPT-2 ``test`` at 2 layers with 4 experts in layer 1 (``moe_layer_freq``
2), fp32 on the CPU. The JAX model's tree is re-drawn from a seeded numpy
generator at std 0.15 (the init's 0.02 makes a 2-layer model repeat one
token), loaded into the JAX ``InferenceEngine`` and, through
``params_from_jax``, into the port's. Then: ``forward`` returns plain logits
within 1e-5 relative of JAX's; lockstep ``generate`` gives JAX's tokens,
top-1 and top-2, with and without ``moe_use_residual`` (PR-MoE);
``ContinuousBatchingScheduler`` at the JAX defaults (prefix cache on, int8
KV) gives the JAX scheduler's tokens request for request, with fp and int8
served weights and with speculation (k 3, a 1-layer student drafter), on a
trace of 5 requests that share each tick's expert capacity; the int8 view
quantizes no leaf under ``moe``, as JAX's quantizer does not; and the
inference config's ``moe`` block is taken, with ``ep_size > 1`` refused.
Each JAX engine and scheduler run is built once per module.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax

from deepspeed_tpu.compression.compress import student_initialization as jax_student_initialization
from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.inference.serving import (ContinuousBatchingScheduler as JaxScheduler,
                                             Request as JaxRequest,
                                             ServingConfig as JaxServingConfig)
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.ops.quantizer.weights import quantize_params as jax_quantize_params
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.compression import student_initialization
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.serving import (FINISHED, ContinuousBatchingScheduler, Request,
                                                   ServingConfig)
from deepspeed_tpu_torch.models.common import flatten_tree

RTOL = 1e-5
#: the MoE variants served: GPT-2 "test" overrides of both packages
VARIANTS = {"top1": dict(moe_k=1), "top2": dict(moe_k=2),
            "top1-residual": dict(moe_k=1, moe_use_residual=True)}
MOE = dict(n_layer=2, moe_num_experts=4, moe_layer_freq=2)
SERVE_KW = dict(slots=4, prefill_chunk=8, page_size=16)
PROMPTS = [np.random.default_rng(8).integers(0, 256, (n,)).astype(np.int32)
           for n in (5, 12, 9, 17, 30)]
LAYER_REDUCTION = {"compression_training": {"layer_reduction": {
    "enabled": True, "module_name_prefix": "h", "teacher_layer": [0],
    "other_module_name": ["wte", "wpe", "ln_f"]}}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class SimClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _spread(tree, seed):
    """The tree with every float leaf re-drawn N(0, 0.15) (norm scales
    around 1), seeded: weights under which greedy tokens vary."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        leaf = np.asarray(leaf)
        if path[-1] == "scale":
            return (1.0 + rng.normal(0, 0.1, leaf.shape)).astype(leaf.dtype)
        return rng.normal(0, 0.15, leaf.shape).astype(leaf.dtype)

    flat = flatten_tree(tree, "/")
    out = {}
    for key in sorted(flat):
        node = out
        *scopes, name = key.split("/")
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[name] = draw(key.split("/"), flat[key])
    return out


def _engines(variant):
    """The JAX and the port engine of one variant, on the same weights."""
    set_topology(None)
    cfg = jax_config("test", **MOE, **VARIANTS[variant])
    module = JaxGPT2(cfg)
    init = module.init(jax.random.PRNGKey(0), np.zeros((1, 8), np.int32))["params"]
    tree = _spread(jax.device_get(nn.meta.unbox(init)), seed=1)
    topo = MeshTopology(tensor=1, data=1, fsdp=1, devices=jax.devices()[:1])
    jax_engine = JaxEngine(module, JaxInferenceConfig(replace_with_kernel_inject=False),
                           params=tree, topology=topo)
    port_engine = init_inference(GPT2LMHeadModel(get_gpt2_config("test", **MOE, **VARIANTS[variant]),
                                                 device="cpu"),
                                 params=params_from_jax(tree), device="cpu")
    set_topology(None)
    return jax_engine, port_engine, tree


@pytest.fixture(scope="module")
def engines():
    return {v: _engines(v) for v in VARIANTS}


def _drafters(tree):
    """The 1-layer student of both packages (the target's dense layer 0)."""
    d_jax = JaxGPT2(jax_config("test", n_layer=1))
    d_init = jax.device_get(nn.meta.unbox(jax.jit(d_jax.init)(jax.random.PRNGKey(1),
                                                              np.zeros((1, 8), np.int32))["params"]))
    d_params = jax_student_initialization(d_init, tree, LAYER_REDUCTION)
    d_state = student_initialization(params_from_jax(d_init), params_from_jax(tree),
                                     LAYER_REDUCTION)
    return (d_jax, d_params), (GPT2LMHeadModel(get_gpt2_config("test", n_layer=1), device="cpu"),
                               d_state)


def _serve(scheduler_cls, request_cls, config_cls, engine, drafter=None, **kw):
    sched = scheduler_cls(engine, config_cls(**SERVE_KW, **kw), drafter=drafter, clock=SimClock())
    reqs = [request_cls(prompt=p, max_new_tokens=9) for p in PROMPTS]
    for r in reqs:
        sched.submit(r)
    sched.run_until_drained(max_ticks=2000)
    return sched, reqs


#: the scheduler runs compared: ServingConfig overrides (fp and int8 weights,
#: speculation k 3 with the student drafter)
RUNS = {"fp": dict(weight_dtype="fp"), "int8": dict(weight_dtype="int8"),
        "fp-spec3": dict(weight_dtype="fp", speculation={"enabled": True, "k": 3})}


@pytest.fixture(scope="module")
def jax_runs(engines):
    jax_engine, _, tree = engines["top1"]
    drafter = _drafters(tree)[0]
    out = {}
    for name, kw in RUNS.items():
        out[name] = _serve(JaxScheduler, JaxRequest, JaxServingConfig, jax_engine,
                           drafter=drafter if "speculation" in kw else None, **kw)
    return out


def test_forward_returns_plain_logits_equal_to_jax(engines):
    jax_engine, port_engine, _ = engines["top1"]
    ids = np.random.default_rng(3).integers(0, 256, (2, 24)).astype(np.int32)
    want = np.asarray(jax_engine(ids))
    got = port_engine(ids)
    assert isinstance(got, torch.Tensor) and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("variant", VARIANTS)
def test_generate_gives_jax_tokens(engines, variant):
    """A 20-token prompt: one 16-token prefill chunk, four 1-token calls,
    then the token loop; batch 3 pads to 4 with a copy of row 0 in both
    packages, and that copy shares each call's expert capacity."""
    jax_engine, port_engine, _ = engines[variant]
    ids = np.random.default_rng(5).integers(0, 256, (3, 20)).astype(np.int32)
    want = np.asarray(jax_engine.generate(ids, max_new_tokens=8))
    got = port_engine.generate(ids, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:, 20:].ravel().tolist())) > 3  # the weights make tokens vary


@pytest.mark.parametrize("run", RUNS)
def test_scheduler_gives_jax_tokens(engines, jax_runs, run):
    _, port_engine, tree = engines["top1"]
    j_sched, j_reqs = jax_runs[run]
    drafter = _drafters(tree)[1] if "speculation" in RUNS[run] else None
    sched, reqs = _serve(ContinuousBatchingScheduler, Request, ServingConfig, port_engine,
                         drafter=drafter, **RUNS[run])
    assert all(r.state == FINISHED for r in reqs)
    assert [r.output for r in reqs] == [r.output for r in j_reqs]
    assert sched.ticks == j_sched.ticks
    assert (sched.drafted_total, sched.accepted_total) == (j_sched.drafted_total,
                                                           j_sched.accepted_total)
    assert sched.stats()["pool"]["used_blocks"] == 0
    if "speculation" in RUNS[run]:
        assert sched.drafted_total > 0


def test_int8_view_quantizes_no_moe_leaf(engines, jax_runs):
    """The port's int8 view holds codes and scales exactly where JAX's
    quantizer puts them: every projection outside ``moe``, none inside."""
    _, port_engine, tree = engines["top1-residual"]
    sched = ContinuousBatchingScheduler(port_engine, ServingConfig(**SERVE_KW, weight_dtype="int8"))
    state = sched.module.state_dict()
    scaled = {k[:-len(".kernel_scale")] for k in state if k.endswith(".kernel_scale")}
    _, j_scales = jax_quantize_params(tree, "int8", 64)
    want = {path[:-len("/kernel_scale")].replace("/", ".")
            for path in flatten_tree(j_scales, "/")}
    assert scaled == want and scaled and not any(".moe." in k for k in scaled)
    moe = {k: v for k, v in state.items() if ".moe." in k}
    assert moe and all(v.is_floating_point() for v in moe.values())
    for k in scaled:
        assert state[k + ".kernel"].dtype == torch.int8


def test_inference_moe_block_is_taken_and_ep_refused(engines):
    _, port_engine, _ = engines["top1"]
    model = port_engine.module
    engine = init_inference(model, moe={"enabled": True, "ep_size": 1, "num_experts": 4},
                            device="cpu")
    moe = engine.config.moe
    assert (moe.enabled, moe.ep_size, moe.moe_experts, moe.type) == (True, 1, 4, "standard")
    assert DeepSpeedInferenceConfig(moe=False).moe.enabled is False
    assert DeepSpeedInferenceConfig().moe.moe_experts == 1
    with pytest.raises(NotImplementedError, match="item 8"):
        init_inference(model, moe={"enabled": True, "ep_size": 2, "num_experts": 4},
                       device="cpu")
    with pytest.raises(ValueError, match="unknown keys"):
        DeepSpeedInferenceConfig(moe={"experts": 4})
