"""``deepspeed_tpu_torch.testing.injected_routing``, which the bf16 MoE
gradcheck of ``chip_smoke.py`` runs the card's step under: injecting a
call's own decisions changes nothing, bit for bit; injecting other
decisions routes every token where it was told, with the combine weight,
the load-balancing loss and the expert counts that follow from them on the
call's own logits; the gate is restored afterwards."""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.gpt2 import MLP, get_gpt2_config
from deepspeed_tpu_torch.moe import MOELayer
from deepspeed_tpu_torch.moe import sharded_moe as sm
from deepspeed_tpu_torch.testing import injected_routing


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


M = 16


def _layer(cf):
    torch.manual_seed(0)
    layer = MOELayer(MLP(get_gpt2_config("test", n_embd=M, n_head=4, dropout=0.0), "cpu"), M, 4,
                     k=1, capacity_factor=cf, eval_capacity_factor=cf, min_capacity=1,
                     use_rts=False, route="sorted")
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.3)
    return layer


def _step(layer, x):
    layer.zero_grad()
    xt = x.clone().requires_grad_()
    out, l_aux, counts = layer(xt)
    ((out**2).sum() + l_aux).backward()
    return [out.detach(), l_aux.detach(), counts, xt.grad] + [p.grad.clone()
                                                            for p in layer.parameters()]


@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_own_decisions_change_nothing(cf):
    layer = _layer(cf)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 8, M)).astype(np.float32))
    record = []
    with injected_routing(record=record):
        free = _step(layer, x)
    assert len(record) == 1 and torch.equal(record[0].expert, layer.last_routing.expert[0])
    with injected_routing(record[0]):
        injected = _step(layer, x)
    for a, b in zip(free, injected):
        assert torch.equal(a, b)
    assert sm.top1routing.__name__ == "top1routing"


def test_other_decisions_are_followed():
    layer = _layer(4.0)  # capacity for every token: none dropped
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 8, M)).astype(np.float32))
    record = []
    with injected_routing(record=record):
        free = _step(layer, x)
    own = record[0]
    moved = sm.SortedRouting((own.expert + 1) % 4, own.slot, own.weight, own.keep)
    # slots follow the new experts: position of each token among its expert's tokens
    e = moved.expert[:, 0].long()
    slot = torch.stack([(e[:i] == e[i]).sum() for i in range(len(e))]).int()[:, None]
    moved = moved._replace(slot=slot)
    with injected_routing(moved):
        got = _step(layer, x)
    assert torch.equal(layer.last_routing.expert[0], moved.expert)
    assert torch.equal(layer.last_routing.slot[0], moved.slot)
    logits = x.reshape(-1, M) @ layer.gate.wg.float()
    gates = torch.softmax(logits, dim=1)
    torch.testing.assert_close(layer.last_routing.weight[0], gates.gather(1, e[:, None]))
    assert torch.equal(got[2], torch.bincount(e, minlength=4).int())
    assert not torch.allclose(got[0], free[0])


@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_top2_own_decisions_change_nothing(cf):
    """Top-2 (the normalised pair of weights), by gate name: a model's gate
    recorded under its module name and given its own decisions back."""
    layer = _layer(cf)
    layer.gate.k = layer.k = 2
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 8, M)).astype(np.float32))
    record = {}
    with injected_routing(record=record, model=layer):
        free = _step(layer, x)
    assert list(record) == ["gate"] and record["gate"][0].expert.shape == (16, 2)
    with injected_routing({"gate": record["gate"][0]}, model=layer):
        injected = _step(layer, x)
    for a, b in zip(free, injected):
        assert torch.equal(a, b)
    assert sm.top2routing.__name__ == "top2routing"
    assert sm.TopKGate.forward.__qualname__ == "TopKGate.forward"
