"""The launch orders of K6's bf16 bodies (``ops/cuda/sparse_attention.py``
``launch_order``, cached by ``SparseSelfAttention``): for each side of a
layout, a permutation of the (head, unit) entries (a unit is a layout
block, half of one at block 128), longest list first with ties in natural
order, built once per ``(seq_len, device)``."""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import sparse_attention as sa
from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig, FixedSparsityConfig,
                                                      SparseSelfAttention, VariableSparsityConfig)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import launch_orders_on


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and the suite's parallel
    workers share the host's cores (a thread per core in each worker
    oversubscribes them many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CONFIGS = [
    (FixedSparsityConfig(num_heads=4, block=16, num_local_blocks=4, num_global_blocks=1,
                         attention="unidirectional"), 1024),
    (FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=3), 208),  # a tail tile
    (BigBirdSparsityConfig(num_heads=4, block=64, num_random_blocks=3, num_sliding_window_blocks=3,
                           num_global_blocks=2, different_layout_per_head=True, seed=1), 2048),
    (VariableSparsityConfig(num_heads=2, block=32, num_random_blocks=1, seed=2), 512),
    (BigBirdSparsityConfig(num_heads=2, block=128, num_random_blocks=1, seed=3), 1024),
]


def _unit_work(counts: np.ndarray, block: int) -> np.ndarray:
    """[h, n_units]: the list length of the layout block each unit of
    min(block, 64) rows lies in, row by row."""
    h, nb = counts.shape
    rows = min(block, 64)
    return np.stack([counts[:, (u * rows) // block] for u in range(nb * block // rows)], axis=1)


@pytest.mark.parametrize("cfg,l", CONFIGS, ids=lambda x: getattr(x, "__class__", type(x)).__name__)
def test_launch_orders_are_longest_first_permutations(cfg, l):
    layout = cfg.make_layout(l).astype(bool)
    orders = launch_orders_on(layout, cfg.block, "cpu")
    for order, counts in zip(orders, (layout.sum(axis=2), layout.sum(axis=1))):
        work = _unit_work(counts, cfg.block).reshape(-1)
        assert order.dtype == torch.int32
        got = order.numpy()
        assert sorted(got.tolist()) == list(range(work.size))  # every (head, unit) once
        w = work[got]
        assert (np.diff(w) <= 0).all()  # longest first
        ties = np.diff(w) == 0
        assert (np.diff(got)[ties] > 0).all()  # ties in natural order
    if isinstance(cfg, BigBirdSparsityConfig) and cfg.block == 64:
        # a global row, its list 8x longer than the rest, comes first
        first = orders[0].numpy()[0]
        assert _unit_work(layout.sum(axis=2), 64).reshape(-1)[first] == layout.shape[2]


def test_launch_orders_are_built_once_per_length_and_device():
    cfg = FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=2, attention="unidirectional")
    attn = SparseSelfAttention(cfg)
    q = torch.randn(1, 128, 2, 16)
    attn(q, q, q)
    orders = attn.get_launch_orders(128, "cpu")
    attn(q, q, q)
    assert list(attn._launch_orders) == [(128, torch.device("cpu"))]
    assert attn.get_launch_orders(128, torch.device("cpu")) is orders
    want = launch_orders_on(attn.get_layout(128), 16, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(orders, want))
    attn(torch.randn(1, 64, 2, 16), q[:, :64], q[:, :64])
    assert sorted(attn._launch_orders) == [(64, torch.device("cpu")), (128, torch.device("cpu"))]


def test_launch_order_ranks_units_by_their_list():
    counts = np.array([[1, 5, 2, 2, 9, 0, 3, 3]])[..., None]  # one head, 8 blocks
    want = [4, 1, 6, 7, 2, 3, 0, 5]
    for block in (16, 32, 64):  # a unit is a block
        assert sa.launch_order(counts, block).tolist() == want
    # at 128 a unit is half a block: both halves of block 4 first
    assert sa.launch_order(counts, 128).tolist() == [8, 9, 2, 3, 12, 13, 14, 15, 4, 5, 6, 7,
                                                      0, 1, 10, 11]
    two_heads = np.concatenate([counts, counts[:, ::-1]])
    assert sa.launch_order(two_heads, 16).tolist()[:2] == [4, 11]  # h * 8 + unit
