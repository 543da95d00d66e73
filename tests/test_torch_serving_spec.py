"""The port's speculative decoding against the JAX package's.

The drafter is the layer-reduced student of the target (GPT-2 ``test`` at
2 layers, fp32, weights through ``params_from_jax``): ``student_initialization``
seeds its one layer from the target's layer 0 and copies ``wte``, ``wpe``
and ``ln_f``, in both packages to the same tree. With ``k`` 3 both
schedulers give the same tokens and the same drafted and accepted totals,
and the port's tokens equal its own run without speculation; with int8
served weights the drafter is int8 too and stays lossless. The JAX runs
are shared across tests through a module fixture.
"""

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.compression.compress import student_initialization as jax_student_initialization
from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.inference.serving import (ContinuousBatchingScheduler as JaxScheduler,
                                             Request as JaxRequest,
                                             ServingConfig as JaxServingConfig)
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2, get_gpt2_config as jax_config
from deepspeed_tpu.parallel.topology import MeshTopology, set_topology
from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax
from deepspeed_tpu_torch.compression import layer_reduction_config, student_initialization
from deepspeed_tpu_torch.inference.serving import (FINISHED, ContinuousBatchingScheduler, Request,
                                                   ServingConfig)
from deepspeed_tpu_torch.inference.serving.programs import (build_verify_step, make_apply_fn,
                                                            make_slot_cache, serve_programs,
                                                            stamp_lengths)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class SimClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


LAYER_REDUCTION = {"compression_training": {"layer_reduction": {
    "enabled": True, "module_name_prefix": "h", "teacher_layer": [0],
    "other_module_name": ["wte", "wpe", "ln_f"]}}}


@pytest.fixture(scope="module")
def setup():
    """Both engines, the JAX student tree, and the port's drafter."""
    import flax.linen as nn
    set_topology(None)
    cfg = jax_config("test", n_layer=2)
    topo = MeshTopology(tensor=1, data=1, fsdp=1, devices=jax.devices()[:1])
    jax_engine = JaxEngine(JaxGPT2(cfg), JaxInferenceConfig(replace_with_kernel_inject=False),
                           topology=topo)
    teacher = jax.device_get(nn.meta.unbox(jax_engine.params))
    d_jax = JaxGPT2(jax_config("test", n_layer=1))
    d_init = jax.device_get(nn.meta.unbox(jax.jit(d_jax.init)(jax.random.PRNGKey(1),
                                                              np.zeros((1, 8), np.int32))["params"]))
    d_params = jax_student_initialization(d_init, teacher, LAYER_REDUCTION)
    port_engine = init_inference(GPT2LMHeadModel(get_gpt2_config("test", n_layer=2), device="cpu"),
                                 params=params_from_jax(teacher), device="cpu")
    d_model = GPT2LMHeadModel(get_gpt2_config("test", n_layer=1), device="cpu")
    d_state = student_initialization(params_from_jax(d_init), port_engine.module.state_dict(),
                                     LAYER_REDUCTION)
    yield dict(jax_engine=jax_engine, port_engine=port_engine, jax_drafter=(d_jax, d_params),
               jax_student=d_params, d_model=d_model, d_state=d_state)
    set_topology(None)


def test_student_initialization_gives_jax_tree(setup):
    want = params_from_jax(jax.device_get(setup["jax_student"]))
    got = setup["d_state"]
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    # seeded from the teacher's layer 0, embeddings and final norm
    teacher = setup["port_engine"].module.state_dict()
    assert torch.equal(got["h_0.attn.c_attn.kernel"], teacher["h_0.attn.c_attn.kernel"])
    assert torch.equal(got["wte"], teacher["wte"]) and torch.equal(got["ln_f.scale"],
                                                                  teacher["ln_f.scale"])


def test_student_initialization_refusals_match_jax(setup):
    assert layer_reduction_config({}) == {"enabled": False}
    assert student_initialization(setup["d_state"], {}, {}) is setup["d_state"]
    teacher = setup["port_engine"].module.state_dict()
    bad = {"compression_training": {"layer_reduction": {"enabled": True, "teacher_layer": [5]}}}
    with pytest.raises(KeyError, match="h_5"):
        student_initialization(setup["d_state"], teacher, bad)
    other = {"compression_training": {"layer_reduction": {
        "enabled": True, "teacher_layer": [0], "other_module_name": ["lm_head"]}}}
    with pytest.raises(KeyError, match="lm_head"):
        student_initialization(setup["d_state"], teacher, other)


PROMPTS = [np.random.default_rng(8).integers(0, 256, (n,)).astype(np.int32) for n in (5, 12, 9, 17)]


def _serve(scheduler_cls, request_cls, engine, scfg, drafter=None, max_new=9):
    sched = scheduler_cls(engine, scfg, drafter=drafter, clock=SimClock())
    sched.warmup()
    reqs = [request_cls(prompt=p, max_new_tokens=max_new) for p in PROMPTS]
    for r in reqs:
        sched.submit(r)
    sched.run_until_drained(max_ticks=2000)
    return sched, reqs


def _cfg(cls, weight_dtype, spec, k=3):
    return cls(slots=4, prefill_chunk=8, weight_dtype=weight_dtype,
               speculation={"enabled": spec, "k": k})


@pytest.fixture(scope="module")
def jax_runs(setup):
    return {wd: _serve(JaxScheduler, JaxRequest, setup["jax_engine"],
                       _cfg(JaxServingConfig, wd, True), drafter=setup["jax_drafter"])
            for wd in (None, "int8")}


@pytest.mark.parametrize("weight_dtype", [None, "int8"])
def test_speculation_matches_jax_and_is_lossless(setup, jax_runs, weight_dtype):
    engine = setup["port_engine"]
    j_sched, j_reqs = jax_runs[weight_dtype]
    sched, reqs = _serve(ContinuousBatchingScheduler, Request, engine,
                         _cfg(ServingConfig, weight_dtype, True),
                         drafter=(setup["d_model"], setup["d_state"]))
    _, plain = _serve(ContinuousBatchingScheduler, Request, engine,
                      _cfg(ServingConfig, weight_dtype, False))
    assert all(r.state == FINISHED and len(r.output) == 9 for r in reqs)
    assert [r.output for r in reqs] == [r.output for r in j_reqs] == [r.output for r in plain]
    st, j_st = sched.stats(), j_sched.stats()
    for key in ("drafted", "accepted", "acceptance_rate", "spec_k"):
        assert st[key] == j_st[key], key
    assert sched.ticks == j_sched.ticks
    assert [(r.drafted_tokens, r.accepted_tokens) for r in reqs] == \
        [(r.drafted_tokens, r.accepted_tokens) for r in j_reqs]
    assert st["drafted"] == sum(r.drafted_tokens for r in reqs) > 0
    assert all("acceptance_rate" in r.stats() for r in reqs)
    # the drafter is int8 whenever the target serves quantized weights
    assert (sched._drafter.config.serve_weight_dtype == "int8") == (weight_dtype == "int8")
    # fewer target passes than emitted tokens: the speed-up's mechanism
    assert st["ticks"]["spec"] < sum(len(r.output) for r in reqs)
    assert st["pool"]["used_blocks"] == 0


def test_speculation_with_prefix_cache_restores_both_roles(setup):
    """A shared prefix is restored into the target's and the drafter's
    caches; the tokens stay the non-speculative run's."""
    engine = setup["port_engine"]
    rng = np.random.default_rng(21)
    tmpl = rng.integers(0, 256, 40).astype(np.int32)
    prompts = [np.concatenate([tmpl, rng.integers(0, 256, 3 + i).astype(np.int32)])
               for i in range(3)]
    outs = []
    for spec in (False, True):
        sched = ContinuousBatchingScheduler(engine, _cfg(ServingConfig, None, spec),
                                            drafter=(setup["d_model"], setup["d_state"]),
                                            clock=SimClock())
        reqs = []
        for p in prompts:
            reqs.append(sched.submit(Request(prompt=p, max_new_tokens=7)))
            sched.run_until_drained()
        outs.append([r.output for r in reqs])
        assert [r.cached_prefix_tokens for r in reqs][1:] == [40, 40]
        payload = sched.pool._payload[next(iter(sched.pool._block_of))]
        assert sorted(payload) == (["drafter", "target"] if spec else ["target"])
    assert outs[0] == outs[1]


def test_verify_step_is_the_argmax_at_every_position(setup):
    module = setup["port_engine"].module
    block = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (4, 4)))
    pos = np.asarray([0, 5, 128, 60])
    cache = make_slot_cache(module, 4, kv_quant=True)
    greedy = build_verify_step(make_apply_fn(module))(stamp_lengths(cache, pos), block)
    cache = make_slot_cache(module, 4, kv_quant=True)
    logits = make_apply_fn(module)(stamp_lengths(cache, pos), block)
    assert tuple(greedy.shape) == (4, 4) and torch.equal(greedy, logits.argmax(-1))


def test_program_cache_keys_role_and_module(setup):
    """Each role's steps close over its own module: the target's and the
    drafter's step sets are distinct, and each computes its own module's
    greedy tokens."""
    kw = dict(do_sample=False, temperature=1.0, top_k=0, top_p=1.0, spec_k=3)
    sched = ContinuousBatchingScheduler(setup["port_engine"], _cfg(ServingConfig, None, True),
                                        drafter=(setup["d_model"], setup["d_state"]))
    assert sched.fns is not sched.dfns and "verify" in sched.fns and "verify" in sched.dfns
    block = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (4, 4)))
    pos = np.asarray([0, 5, 20, 60])
    for module, fns in ((sched.module, sched.fns), (sched._drafter, sched.dfns)):
        want = serve_programs(module, **kw)["verify"](
            stamp_lengths(make_slot_cache(module, 4), pos), block)
        got = fns["verify"](stamp_lengths(make_slot_cache(module, 4), pos), block)
        assert torch.equal(got, want)


def test_a_dropped_scheduler_frees_its_weights(setup):
    """Two int8 speculating schedulers on one engine: the first one's
    quantized target and drafter are collected once it is dropped (nothing
    engine-wide holds a scheduler's weights)."""
    import gc
    import weakref
    engine = setup["port_engine"]
    first = ContinuousBatchingScheduler(engine, _cfg(ServingConfig, "int8", True),
                                        drafter=(setup["d_model"], setup["d_state"]))
    refs = [weakref.ref(first.module), weakref.ref(first._drafter)]
    second = ContinuousBatchingScheduler(engine, _cfg(ServingConfig, "int8", True),
                                         drafter=(setup["d_model"], setup["d_state"]))
    assert second.module is not first.module
    del first
    gc.collect()
    assert [r() for r in refs] == [None, None]
    assert second.module.config.serve_weight_dtype == "int8"


def test_speculation_needs_greedy_and_a_drafter(setup):
    with pytest.raises(ValueError, match="lossless under greedy"):
        ServingConfig(do_sample=True, speculation={"enabled": True})
    with pytest.raises(ValueError, match="needs a drafter"):
        ContinuousBatchingScheduler(setup["port_engine"],
                                    ServingConfig(speculation={"enabled": True}))


def test_quantized_random_drafter_stays_lossless(setup):
    """An int8 target with a drafter of random weights (not the student):
    the drafter is served int8 and the tokens stay the plain int8 run's."""
    engine = setup["port_engine"]
    drafter = GPT2LMHeadModel(get_gpt2_config("test", n_layer=1), device="cpu",
                              generator=torch.Generator().manual_seed(1))
    sched, reqs = _serve(ContinuousBatchingScheduler, Request, engine,
                         _cfg(ServingConfig, "int8", True), drafter=drafter, max_new=6)
    _, plain = _serve(ContinuousBatchingScheduler, Request, engine,
                      _cfg(ServingConfig, "int8", False), max_new=6)
    assert [r.output for r in reqs] == [r.output for r in plain]
    st = sched.stats()
    assert st["drafted"] > 0 and 0.0 <= st["acceptance_rate"] <= 1.0
