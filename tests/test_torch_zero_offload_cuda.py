"""ZeRO-Offload and ZeRO-Infinity on the GPU: what the card holds between
steps (``torch.cuda.memory_allocated``). Under ``offload_optimizer`` no
moment lives on the card, only the fp32 parameters and their gradient
buffer; under both offloads the card holds the gradient buffer alone and no
copy of the parameters; and the card's run (pinned staging, a copy stream)
follows the CPU's. Skips without a card; run
on the GPU host with ``python -m pytest --noconftest -m cuda
tests/test_torch_zero_offload_cuda.py``. ``tests/test_torch_zero_offload.py``
holds the offload paths to the JAX package on the CPU.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch

pytestmark = pytest.mark.cuda

COMBOS = {"dense": {"stage": 0},
          "offload_optimizer": {"stage": 2, "offload_optimizer": {"device": "cpu"}},
          "both": {"stage": 3, "offload_param": {"device": "cpu"}, "offload_optimizer": {"device": "cpu"}}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _engine(combo, device):
    """The same seeded weights (drawn on the host) on ``device``."""
    cfg = deepspeed_tpu_torch.get_gpt2_config("test", n_layer=4, n_embd=256, n_head=4, n_positions=64,
                                              remat=True)
    weights = deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device="cpu").state_dict()
    model = deepspeed_tpu_torch.GPT2LMHeadModel(cfg, device=device)
    model.load_state_dict(weights)
    config = {"train_batch_size": 4, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "gradient_clipping": 1.0, "zero_optimization": COMBOS[combo]}
    return deepspeed_tpu_torch.initialize(model=model, config=config, device=device)[0]


@pytest.mark.parametrize("combo", ["offload_optimizer", "both"])
def test_what_the_card_holds_between_steps(combo):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    # a throwaway dense step first: the libraries' one-time workspaces are
    # not the engine's state
    warm = _engine("dense", "cuda")
    warm.train_batch(np.zeros((4, 64), np.int32))
    del warm
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    engine = _engine(combo, "cuda")
    n_bytes = sum(p.numel() for p in engine.module.parameters()) * 4
    rng = np.random.default_rng(0)
    for _ in range(2):
        engine.train_batch(rng.integers(0, 256, (4, 64)).astype(np.int32))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    want = (1 if combo == "both" else 2) * n_bytes  # the gradients (+ the fp32 parameters)
    assert want <= held <= want + (1 << 20), (held, want)


@pytest.mark.parametrize("combo", ["offload_optimizer", "both"])
def test_the_card_run_follows_the_cpu_run(combo):
    """fp32 losses on the card within 1e-4 of the CPU's (the products sum in
    another order; the host Adam updates both)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    curves = {}
    for device in ("cpu", "cuda"):
        engine = _engine(combo, device)
        rng = np.random.default_rng(1)
        curves[device] = [float(engine.train_batch(rng.integers(0, 256, (4, 64)).astype(np.int32)))
                          for _ in range(3)]
    np.testing.assert_allclose(curves["cuda"], curves["cpu"], rtol=1e-4)
