"""A dropped model, training engine, inference engine, scheduler or fleet
of the port frees its memory at once, by reference counting alone.

None of them closes a reference cycle, so their tensors (on the card, its
memory) do not wait for Python's cyclic collector. Each case builds the
objects at the "test" size on the CPU, runs them, drops them with the
collector switched off, and checks through weak references that nothing
is left alive. (A dropped serving object held by the caller's own
reference cycles, a wrapper closing over the object it wraps, say, waits
for the collector all the same.)
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
from deepspeed_tpu_torch.inference.fleet import FleetRouter, LocalReplica
from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler, Request, ServingConfig


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(**kw):
    return GPT2LMHeadModel(get_gpt2_config("test", n_layer=2, n_positions=64, **kw), device="cpu")


def _serving(**kw):
    kw = {"slots": 2, "prefill_chunk": 8, "kv_quant": True, "prefix_cache": "on", **kw}
    return ServingConfig(**kw)


def _training(tmp_path):
    model = _model(dtype=torch.float16, remat=True, remat_policy="dots_saveable")
    engine = deepspeed_tpu_torch.initialize(model=model, device="cpu", config={
        "train_batch_size": 4, "fp16": {"enabled": True}, "wall_clock_breakdown": True,
        "progressive_layer_drop": {"enabled": True}, "steps_per_print": 10**9})[0]
    engine.train_batch(np.zeros((4, 16), np.int32))
    engine.save_checkpoint(str(tmp_path), tag="t")
    return [weakref.ref(model), weakref.ref(engine)]


def _scheduler(tmp_path):
    model = _model()
    engine = init_inference(model, device="cpu", kernel_inject=True, use_flash_prefill=True)
    sched = ContinuousBatchingScheduler(engine, _serving())
    sched.serve([Request(prompt=np.arange(5, dtype=np.int32), max_new_tokens=3),
                 Request(prompt=np.arange(9, dtype=np.int32), max_new_tokens=4)])
    return [weakref.ref(model), weakref.ref(engine), weakref.ref(sched)]


def _fleet(tmp_path):
    engine = init_inference(_model(), device="cpu", kernel_inject=True, use_flash_prefill=True)
    router = FleetRouter()
    replicas = [LocalReplica(f"r{i}", ContinuousBatchingScheduler(engine, _serving(slots=4)))
                for i in range(2)]
    for r in replicas:
        router.add_replica(r.name, r)
    rng = np.random.default_rng(0)
    for _ in range(4):
        router.submit(rng.integers(0, 256, 10).astype(np.int32), 4)
    for _ in range(3):
        router.step()
    replicas[0].sigterm(str(tmp_path / "bundle"))
    router.run_until_complete(max_rounds=500)
    assert len(router.completed) == 4
    return [weakref.ref(engine), weakref.ref(router)] + [weakref.ref(r.scheduler) for r in replicas]


@pytest.mark.parametrize("build", [_training, _scheduler, _fleet], ids=["training", "serving", "fleet"])
def test_dropped_objects_free_without_the_cyclic_collector(build, tmp_path):
    # a first run imports what torch loads lazily, and import-time garbage
    # can hold the calling frames (and their locals) until it is collected
    build(tmp_path / "first")
    gc.collect()
    gc.disable()
    try:
        refs = build(tmp_path / "second")
        alive = [type(r()).__name__ for r in refs if r() is not None]
    finally:
        gc.enable()
    assert not alive, f"held only by reference cycles: {alive}"
