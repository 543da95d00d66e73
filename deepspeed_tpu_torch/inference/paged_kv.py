"""Paged KV cache: a shared page pool and per-sequence block tables
(counterpart of ``deepspeed_tpu/inference/paged_kv.py``, reference
``inference_context.h`` KV workspace management).

The pools are ``[layers, pages, page_size, heads, dim]`` tensors driven by
a host allocator (the serving scheduler's :class:`BlockPool`, so the
counters are one code path): a sequence owns a list of pages, freeing
returns them to the pool, and ``gather`` builds a dense ``[b, L, heads,
dim]`` view for attention with one ``index_select`` over the block table.
Memory scales with the tokens in flight, not batch x max length. By
default the pools hold int8 codes with one bf16 scale per (page, position,
head) (``ops/quantizer/core.quantize_lastaxis``), dequantized on read.
"""

from typing import List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.device import DeviceLike, host_to_device, resolve_device
from deepspeed_tpu_torch.inference.serving.blocks import BlockPool
from deepspeed_tpu_torch.ops.quantizer.core import quantize_lastaxis


class PagedKVCache:
    """The K and V pools of ``num_layers`` layers and their shared
    allocator."""

    def __init__(self, num_pages: int, page_size: int, num_heads: int, head_dim: int,
                 num_layers: int = 1, dtype: torch.dtype = torch.bfloat16, quantize: bool = True,
                 device: DeviceLike = None):
        """``quantize=True``: int8 pools with bf16 scales (the fp32
        exponent range, so an outlier K/V magnitude cannot overflow), twice
        the tokens a byte; ``gather`` dequantizes into ``dtype``.
        ``quantize=False`` keeps exact ``dtype`` pools."""
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_layers = num_layers
        self.quantize = quantize
        self.dtype = dtype
        self.device = resolve_device(device)
        shape = (num_layers, num_pages, page_size, num_heads, head_dim)
        pool_dtype = torch.int8 if quantize else dtype
        self.k_pool = torch.zeros(shape, dtype=pool_dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=pool_dtype, device=self.device)
        if quantize:
            sshape = shape[:-1] + (1,)
            self.k_scale = torch.zeros(sshape, dtype=torch.bfloat16, device=self.device)
            self.v_scale = torch.zeros(sshape, dtype=torch.bfloat16, device=self.device)
        self.pool = BlockPool(num_blocks=num_pages, block_size=page_size)

    # -- the allocator (host side) -----------------------------------------
    @property
    def free_pages(self) -> int:
        return self.pool.free_blocks

    def allocate(self, seq_id: int) -> None:
        self.pool.allocate(seq_id)

    def free(self, seq_id: int) -> None:
        """Return a sequence's pages to the pool."""
        self.pool.free(seq_id)

    def _ensure_capacity(self, seq_id: int, new_tokens: int) -> None:
        try:
            self.pool.ensure(seq_id, new_tokens)
        except RuntimeError:
            raise RuntimeError(f"KV page pool exhausted ({self.num_pages} pages of "
                               f"{self.page_size}); free finished sequences first") from None

    def seq_len(self, seq_id: int) -> int:
        return self.pool.seq_len(seq_id)

    def block_table(self, seq_id: int) -> List[int]:
        return self.pool.block_table(seq_id)

    def counters(self) -> dict:
        """Allocator accounting (allocs, frees, peak, fragmentation), shared
        with :class:`BlockPool`."""
        return self.pool.counters()

    def utilization(self) -> float:
        return self.pool.utilization()

    # -- the device side ---------------------------------------------------
    @staticmethod
    def _quant(vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        q, scale = quantize_lastaxis(vals, num_bits=8)
        return q, scale.to(torch.bfloat16)

    @torch.no_grad()
    def append(self, seq_id: int, k: torch.Tensor, v: torch.Tensor, layer: int = 0) -> None:
        """Write ``t`` new tokens ``[t, heads, dim]`` of one sequence and
        layer, split across page boundaries, each page's rows in place.
        Layer 0 reserves the pages; the last layer advances the length."""
        t = k.shape[0]
        if layer == 0:
            self._ensure_capacity(seq_id, t)
        start = self.pool.seq_len(seq_id)
        table = self.pool.block_table(seq_id)
        k, v = k.to(self.device), v.to(self.device)
        if self.quantize:
            k, k_s = self._quant(k)
            v, v_s = self._quant(v)
        off = 0
        while off < t:
            page = table[(start + off) // self.page_size]
            in_page = (start + off) % self.page_size
            n = min(self.page_size - in_page, t - off)
            rows = slice(in_page, in_page + n)
            self.k_pool[layer, page, rows] = k[off:off + n]
            self.v_pool[layer, page, rows] = v[off:off + n]
            if self.quantize:
                self.k_scale[layer, page, rows] = k_s[off:off + n]
                self.v_scale[layer, page, rows] = v_s[off:off + n]
            off += n
        if layer == self.num_layers - 1:
            # capacity was ensured at layer 0; this only advances the length
            self.pool.advance(seq_id, t)

    @torch.no_grad()
    def gather(self, seq_ids: List[int], layer: int = 0, pad_to: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Dense ``[b, L, heads, dim]`` K and V views and ``[b]`` int32
        lengths. ``pad_to`` fixes L (at least the longest sequence) so the
        consumer sees one shape across batch compositions; rows past a
        sequence's length are page 0's and must be masked by length."""
        max_len = max(self.pool.seq_len(s) for s in seq_ids)
        L = pad_to or max_len
        if L < max_len:
            raise ValueError(f"pad_to={pad_to} is shorter than the longest sequence ({max_len})")
        pages_per = (L + self.page_size - 1) // self.page_size
        table = np.zeros((len(seq_ids), pages_per), np.int64)
        for i, s in enumerate(seq_ids):
            for j, p in enumerate(self.pool.block_table(s)[:pages_per]):
                table[i, j] = p
        idx = host_to_device(table.reshape(-1), self.device)
        b = len(seq_ids)

        def take(pool):
            rows = pool[layer].index_select(0, idx)  # [b * pages, page, h, d]
            return rows.reshape(b, pages_per * self.page_size, *rows.shape[2:])[:, :L]

        k, v = take(self.k_pool), take(self.v_pool)
        if self.quantize:
            k = k.to(self.dtype) * take(self.k_scale).to(self.dtype)
            v = v.to(self.dtype) * take(self.v_scale).to(self.dtype)
        lengths = torch.tensor([self.pool.seq_len(s) for s in seq_ids], dtype=torch.int32,
                               device=self.device)
        return k, v, lengths
