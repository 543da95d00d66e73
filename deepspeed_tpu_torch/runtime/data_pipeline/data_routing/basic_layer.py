"""Random-LTD (random layer token drop, arXiv:2211.11586): counterpart of
``deepspeed_tpu/runtime/data_pipeline/data_routing/basic_layer.py``
``RandomLayerTokenDrop``.

In training only ``reserved_length`` tokens of each sequence go through the
wrapped layer; the rest pass it unchanged. The kept positions are sorted,
so a causal layer attends over the kept subsequence in its order (the
GPT-2 block's flash backend runs K1 and K4 on it). The gather is
``torch.gather`` and the write-back an out-of-place ``torch.scatter``
(JAX's ``x.at[b, idx].set(out)``): nothing autograd saved is written in
place, and the tokens that were not kept come through bit for bit.
"""

from typing import Optional

import torch
from torch import nn

from deepspeed_tpu_torch.ops.random_ltd.dropping_utils import (gpt_sample_tokens, token_gather,
                                                               token_scatter_)


class RandomLayerTokenDrop(nn.Module):
    """Wrap ``layer`` (called as ``layer(x, *args, deterministic=...,
    **kwargs)``) so that in training only ``reserved_length`` random tokens
    of each sequence pass through it.

    ``sampled_indices`` (``[B, r]`` or ``[1, B, r]``, sorted) injects the
    kept positions, e.g. to share one draw across layers as the reference
    does; without it the positions are drawn from ``generator``. A layer
    that returns a tuple gets its first element scattered back and the rest
    passed on."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        self.layer = layer

    def forward(self, x: torch.Tensor, *args, deterministic: bool = True,
                reserved_length: int = -1, sampled_indices: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, **kwargs):
        full_len = x.shape[1]
        if deterministic or reserved_length < 0 or reserved_length >= full_len:
            return self.layer(x, *args, deterministic=deterministic, **kwargs)
        if sampled_indices is None:
            sampled_indices, _ = gpt_sample_tokens(reserved_length, full_len, x.shape[0],
                                                   generator=generator, device=x.device)
        idx = sampled_indices.reshape(x.shape[0], -1)
        out = self.layer(token_gather(x, idx), *args, deterministic=deterministic, **kwargs)
        aux = None
        if isinstance(out, tuple):
            out, aux = out[0], out[1:]
        x = token_scatter_(x, out, idx)
        return x if aux is None else (x,) + aux
