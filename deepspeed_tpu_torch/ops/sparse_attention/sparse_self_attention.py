"""Block-sparse flash attention (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``).

The layout compiles into per-row *active-block index lists*
(:func:`layout_index_lists`, the same numpy code as the JAX package's), and
K6 (``ops/cuda/sparse_attention.py``: ``csrc/sparse_fwd.cu`` and
``csrc/sparse_bwd.cu``) runs only over those entries, forward and backward,
so masked-out K blocks are skipped, not computed and masked.

:class:`SparseSelfAttention` caches the layout per sequence length, as the
JAX wrapper does, and also the index lists and the kernels' launch orders
(longest list first, :func:`launch_orders_on`) on the device per
``(seq_len, device)``: the JAX wrapper rebuilds the lists on every call,
where a copy from the host on every forward would be a sync here.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.cuda.sparse_attention import SparseAttention, launch_order
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import SparsityConfig

IndexLists = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
LaunchOrders = Tuple[torch.Tensor, torch.Tensor]


def layout_index_lists(layout: np.ndarray):
    """[H, nQ, nK] 0/1 → (kidx [H,nQ,maxA], kcnt [H,nQ,1]) active-K lists per
    Q row, and the transposed (qidx [H,nK,maxB], qcnt [H,nK,1]) per K row
    for the backward dk/dv pass. Padded entries are 0 and never visited."""
    layout = np.asarray(layout, dtype=bool)
    h, nq, nk = layout.shape
    max_a = max(int(layout.sum(axis=2).max()), 1)
    max_b = max(int(layout.sum(axis=1).max()), 1)
    kidx = np.zeros((h, nq, max_a), np.int32)
    kcnt = np.zeros((h, nq, 1), np.int32)
    qidx = np.zeros((h, nk, max_b), np.int32)
    qcnt = np.zeros((h, nk, 1), np.int32)
    for hi in range(h):
        for r in range(nq):
            cols = np.flatnonzero(layout[hi, r])
            kidx[hi, r, :len(cols)] = cols
            kcnt[hi, r, 0] = len(cols)
        for c in range(nk):
            rows = np.flatnonzero(layout[hi, :, c])
            qidx[hi, c, :len(rows)] = rows
            qcnt[hi, c, 0] = len(rows)
    return kidx, kcnt, qidx, qcnt


def index_lists_on(layout: np.ndarray, device) -> IndexLists:
    """:func:`layout_index_lists` as int32 tensors on ``device``."""
    return tuple(torch.as_tensor(x).to(device) for x in layout_index_lists(layout))


def launch_orders_on(layout: np.ndarray, block: int, device) -> LaunchOrders:
    """The kernels' longest-first launch orders of the query side (forward
    and dq: by each query block's count) and of the key side (dk/dv: by
    each key block's count), int32 on ``device``."""
    layout = np.asarray(layout, dtype=bool)
    return tuple(torch.as_tensor(launch_order(cnt, block)).to(device)
                 for cnt in (layout.sum(axis=2), layout.sum(axis=1)))


def _attend(q, k, v, lists: IndexLists, orders: LaunchOrders, block: int, causal: bool,
            scale: Optional[float]) -> torch.Tensor:
    if scale is None:
        scale = q.shape[-1]**-0.5
    return SparseAttention.apply(q, k, v, *lists, *orders, float(scale), bool(causal), int(block))


def _cache_key(seq_len: int, device) -> Tuple[int, torch.device]:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:  # "cuda" is the current card
        device = torch.device("cuda", torch.cuda.current_device())
    return seq_len, device


def _check_layout(q, layout: np.ndarray, block: int) -> None:
    """The JAX wrapper's layout-shape assertion, raised as AssertionError
    also under ``python -O``."""
    b, l, h, d = q.shape
    if layout.shape != (h, l // block, l // block):
        raise AssertionError(f"layout {layout.shape} != (heads {h}, {l // block}, {l // block})")


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     layout: np.ndarray, block: int, *,
                     causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Block-sparse attention over BLHD tensors with a static [H, nQ, nK]
    layout. ``block`` is the layout's block size (= kernel tile); the
    length must be a multiple of it. Differentiable through K6's backward."""
    layout = np.asarray(layout)
    _check_layout(q, layout, block)
    return _attend(q, k, v, index_lists_on(layout, q.device),
                   launch_orders_on(layout, block, q.device), block, causal, scale)


class SparseSelfAttention:
    """Reference-surface wrapper (``sparse_self_attention.py``
    ``SparseSelfAttention(sparsity_config, ...)``): holds a config, caches
    the layout per sequence length and its index lists and launch orders
    per sequence length and device, applies K6. ``key_padding_mask_mode``
    and ``attn_mask_mode`` are stored and unused, as in the JAX package."""

    def __init__(self, sparsity_config: SparsityConfig, key_padding_mask_mode="add",
                 attn_mask_mode="mul"):
        self.sparsity_config = sparsity_config
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self._layouts = {}
        self._index_lists: Dict[Tuple[int, torch.device], IndexLists] = {}
        self._launch_orders: Dict[Tuple[int, torch.device], LaunchOrders] = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def get_index_lists(self, seq_len: int, device) -> IndexLists:
        key = _cache_key(seq_len, device)
        if key not in self._index_lists:
            self._index_lists[key] = index_lists_on(self.get_layout(seq_len), key[1])
        return self._index_lists[key]

    def get_launch_orders(self, seq_len: int, device) -> LaunchOrders:
        key = _cache_key(seq_len, device)
        if key not in self._launch_orders:
            self._launch_orders[key] = launch_orders_on(self.get_layout(seq_len),
                                                        self.sparsity_config.block, key[1])
        return self._launch_orders[key]

    def __call__(self, query, key, value, *, causal: Optional[bool] = None,
                 scale: Optional[float] = None):
        seq_len = query.shape[1]
        if causal is None:
            causal = getattr(self.sparsity_config, "attention", "bidirectional") \
                == "unidirectional"
        block = self.sparsity_config.block
        _check_layout(query, self.get_layout(seq_len), block)
        return _attend(query, key, value, self.get_index_lists(seq_len, query.device),
                       self.get_launch_orders(seq_len, query.device), block, causal, scale)
