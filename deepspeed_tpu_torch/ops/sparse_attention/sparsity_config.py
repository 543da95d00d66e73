"""Block-sparse attention layout zoo: Dense/Fixed/Variable/BigBird/
BSLongformer/LocalSlidingWindow (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``, kept as the
port's own copy).

The code is numpy only and copied as it stands, so that for the same
arguments and ``seed`` every layout equals the JAX package's bit for bit
(``Variable`` and ``BigBird`` draw from ``np.random.default_rng(seed)`` in
the same order). ``make_layout`` → ``[num_heads, num_blocks, num_blocks]``
int64 0/1 array consumed by the block-sparse kernel K6
(``sparse_self_attention.py``), which *skips* fully-masked K blocks rather
than masking them.
"""

from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base: block size + per-head layout bookkeeping (reference
    sparsity_config.py:10)."""

    def __init__(self, num_heads: int, block: int = 16, different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(f"sequence length {seq_len} must be divisible by block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All-ones layout — the dense degenerate case (reference :63)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[...] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformer 'fixed' pattern (arXiv:1904.10509; reference :95):
    local windows of ``num_local_blocks`` + per-window global representative
    columns."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1, attention="bidirectional",
                 horizontal_global_attention=False, num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(f"num_local_blocks {num_local_blocks} must be divisible by "
                             f"num_global_blocks {num_global_blocks}")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError("attention must be uni/bidirectional")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("horizontal global attention needs bidirectional attention")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("multiple global patterns need different_layout_per_head=True")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError("num_different_global_patterns cannot exceed "
                             "num_local_blocks // num_global_blocks")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        row = np.arange(n)
        window = row // self.num_local_blocks
        # local: same-window blocks (lower triangle only when unidirectional)
        same_window = window[:, None] == window[None, :]
        local = same_window & ((row[None, :] <= row[:, None])
                               if self.attention == "unidirectional" else same_window)
        for h in range(self.num_layout_heads):
            layout[h][local] = 1
            # global representative columns: last num_global_blocks of each
            # window, shifted back per head pattern (reference :172)
            first = self.num_local_blocks - (
                1 + h % self.num_different_global_patterns) * self.num_global_blocks
            end = n - (n % self.num_local_blocks)
            starts = list(range(first, end, self.num_local_blocks))
            if end < n:  # short trailing window (reference :213)
                starts.append(min(end + first, n - self.num_global_blocks))
            for s in starts:
                cols = slice(s, s + self.num_global_blocks)
                first_row = 0 if self.attention == "bidirectional" else s
                layout[h, first_row:, cols] = 1
                if self.horizontal_global_attention:
                    layout[h, cols, :] = 1
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """'Variable' pattern (reference :239): random blocks + stacked local
    windows of varying sizes + explicit global column indices."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention="bidirectional", horizontal_global_attention=False,
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError("attention must be uni/bidirectional")
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("horizontal global attention needs bidirectional attention")
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None:
            assert len(self.global_block_indices) == len(global_block_end_indices)
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self._rng = np.random.default_rng(seed)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        for h in range(self.num_layout_heads):
            # random blocks per row (causally restricted when unidirectional)
            for r in range(n):
                hi = n if self.attention == "bidirectional" else r + 1
                k = min(self.num_random_blocks, hi)
                if k > 0:
                    layout[h, r, self._rng.choice(hi, size=k, replace=False)] = 1
            # stacked local windows: sizes cycle through local_window_blocks
            start = 0
            i = 0
            while start < n:
                size = self.local_window_blocks[min(i, len(self.local_window_blocks) - 1)]
                end = min(start + size, n)
                for r in range(start, end):
                    cend = (r + 1) if self.attention == "unidirectional" else end
                    layout[h, r, start:cend] = 1
                start, i = end, i + 1
            # globals
            if self.global_block_end_indices is None:
                for idx in self.global_block_indices:
                    if idx < n:
                        layout[h, :, idx] = 1
                        if self.horizontal_global_attention:
                            layout[h, idx, :] = 1
            else:
                for s, e in zip(self.global_block_indices, self.global_block_end_indices):
                    if s < n:
                        layout[h, :, s:min(e, n)] = 1
                        if self.horizontal_global_attention:
                            layout[h, s:min(e, n), :] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird (arXiv:2007.14062; reference :411): random + sliding window +
    ITC global first blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3, num_global_blocks=1,
                 attention="bidirectional", seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError("attention must be uni/bidirectional")
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self._rng = np.random.default_rng(seed)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        for name, need in (("random", self.num_random_blocks),
                           ("sliding window", self.num_sliding_window_blocks),
                           ("global", self.num_global_blocks)):
            if n < need:
                raise ValueError(f"number of {name} blocks, {need}, must be smaller than "
                                 f"overall number of blocks in a row, {n}")
        row = np.arange(n)
        w = self.num_sliding_window_blocks // 2
        sliding = np.abs(row[:, None] - row[None, :]) <= w
        for h in range(self.num_layout_heads):
            for r in range(n):
                hi = n if self.attention == "bidirectional" else r + 1
                layout[h, r, self._rng.choice(hi, size=min(self.num_random_blocks, hi),
                                              replace=False)] = 1
            layout[h][sliding] = 1
            layout[h, :self.num_global_blocks, :] = 1
            layout[h, :, :self.num_global_blocks] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer (reference :546): sliding window + global
    rows/columns at explicit block indices."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None:
            assert len(self.global_block_indices) == len(global_block_end_indices)
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        if n < self.num_sliding_window_blocks:
            raise ValueError(f"number of sliding window blocks, "
                             f"{self.num_sliding_window_blocks}, must be smaller than "
                             f"overall number of blocks in a row, {n}")
        row = np.arange(n)
        w = self.num_sliding_window_blocks // 2
        sliding = np.abs(row[:, None] - row[None, :]) <= w
        for h in range(self.num_layout_heads):
            layout[h][sliding] = 1
            if self.global_block_end_indices is None:
                for idx in self.global_block_indices:
                    if idx < n:
                        layout[h, idx, :] = 1
                        layout[h, :, idx] = 1
            else:
                for s, e in zip(self.global_block_indices, self.global_block_end_indices):
                    if s < n:
                        layout[h, s:min(e, n), :] = 1
                        layout[h, :, s:min(e, n)] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Purely-local sliding window (reference :674)."""

    def __init__(self, num_heads, block=16, num_sliding_window_blocks=3,
                 attention="unidirectional"):
        super().__init__(num_heads, block)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        if n < self.num_sliding_window_blocks:
            raise ValueError(f"number of sliding window blocks, "
                             f"{self.num_sliding_window_blocks}, must be smaller than "
                             f"overall number of blocks in a row, {n}")
        row = np.arange(n)
        w = self.num_sliding_window_blocks // 2
        back = row[:, None] - row[None, :]
        if self.attention == "bidirectional":
            keep = np.abs(back) <= w
        else:
            keep = (back >= 0) & (back <= w)
        for h in range(self.num_layout_heads):
            layout[h][keep] = 1
        return self.check_and_propagate_first_head_layout(layout)
