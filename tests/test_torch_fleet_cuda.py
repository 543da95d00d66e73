"""Live KV migration on the GPU: a scheduler exports its in-flight
requests mid-flight, the bundle is written and read back, a peer restores
the rows (read back bit for bit from its pool), and every continuation
equals an uninterrupted run's tokens (fp32, GPT-2 "test" at head dim 64,
the flash backend: K3 and its int8 form on the card). Skips without a card; run on
the GPU host with ``python -m pytest --noconftest -m cuda
tests/test_torch_fleet_cuda.py``. ``tests/test_torch_fleet.py`` holds the
same path to the JAX package on the CPU.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import GPT2LMHeadModel, get_gpt2_config, init_inference
from deepspeed_tpu_torch.inference.fleet import receive_bundle, save_bundle
from deepspeed_tpu_torch.inference.serving import (ContinuousBatchingScheduler, Request,
                                                   ServingConfig)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sched(engine):
    return ContinuousBatchingScheduler(engine, ServingConfig(slots=4, prefill_chunk=8))


def test_migration_round_trip_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    # the "test" width at head dim 64, one the CUDA kernels are built for
    cfg = get_gpt2_config("test", n_layer=2, n_embd=128, n_head=2, n_positions=128)
    model = GPT2LMHeadModel(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():  # weights under which greedy tokens vary
        for p in model.parameters():
            p.normal_(0.0, 0.15, generator=torch.Generator(device="cuda").manual_seed(p.numel()))
    engine = init_inference(model, device="cuda", kernel_inject=True, use_flash_prefill=True)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, (10,)).astype(np.int32) for _ in range(4)]
    ref = _sched(engine)
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    for r in reqs:
        ref.submit(r)
    ref.run_until_drained()
    src = _sched(engine)
    for p in prompts:
        src.submit(Request(prompt=p, max_new_tokens=6))
    for _ in range(3):
        src.step()
    payloads = src.export_inflight()
    assert payloads and not src.in_flight and src.pool.used_blocks == 0
    peer = _sched(engine)
    admitted, refused = receive_bundle(peer, save_bundle(payloads, str(tmp_path / "bundle")))
    assert len(admitted) == len(payloads) and not refused
    for req, p in zip(admitted, payloads):
        slot = next(i for i, r in enumerate(peer._slot_req) if r is req)
        for name, rows in p["kv"]["target"].items():
            got = peer._cache[name][slot, :p["length"]].cpu()
            assert torch.equal(got.view(torch.uint8), rows.contiguous().view(torch.uint8)), name
    peer.run_until_drained()
    want = {tuple(r.prompt): r.output for r in reqs}
    assert all(req.output == want[tuple(req.prompt)] for req in admitted)
