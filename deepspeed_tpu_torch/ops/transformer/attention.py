"""Attention ops: the seam where attention backends plug in.

Counterpart of ``deepspeed_tpu/ops/transformer/attention.py``. Backends:

* ``xla``   — the plain PyTorch attention below (the JAX package's XLA
              reference backend; the name is kept so model configs carry
              over unchanged).
* ``flash`` — the hand-written CUDA kernels (``ops/cuda/flash_attention``).

All take ``[batch, length, heads, head_dim]`` (BLHD) tensors.
"""

from typing import Optional

import torch

NEG_INF = torch.finfo(torch.float32).min

_BACKENDS = {}


def register_backend(name):

    def deco(fn):
        _BACKENDS[name] = fn
        return fn

    return deco


def available_backends():
    return sorted(_BACKENDS)


@register_backend("xla")
def xla_attention(q: torch.Tensor,
                  k: torch.Tensor,
                  v: torch.Tensor,
                  *,
                  causal: bool = True,
                  bias: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None,
                  dropout_rate: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  decode_lengths: Optional[torch.Tensor] = None,
                  kv_lengths: Optional[torch.Tensor] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """Plain attention: softmax(q k^T * scale + bias) v.

    The logits and softmax run in fp32 whatever the input dtype; masked
    logits are set to ``finfo(float32).min``, so a row with no live key
    gets a uniform softmax (as in the JAX reference). ``decode_lengths``
    [B]: q holds the newest ``lq`` tokens of each sequence, and row i at
    position ``decode_lengths[b] - lq + i`` sees the cache positions at or
    before it. Dropout runs when ``dropout_rate > 0`` and a ``generator``
    is given (the JAX ``dropout_rng``)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    dev = q.device
    if scale is None:
        scale = d**-0.5
    if kv_lengths is not None:
        # [B] valid-prefix lengths (right padding) -> boolean K mask
        pad = (torch.arange(lk, device=dev)[None, :] < kv_lengths.to(dev)[:, None])[:, None, None, :]
        mask = pad if mask is None else torch.logical_and(mask.bool(), pad)
    if window is not None:
        # sliding window (Mistral semantics): k in (q_pos - window, q_pos]
        q_pos = torch.arange(lq, device=dev)[:, None] + (lk - lq)
        band = (torch.arange(lk, device=dev)[None, :] > q_pos - window)[None, None]
        mask = band if mask is None else torch.logical_and(mask.bool(), band)
    if decode_lengths is not None:
        q_pos = (decode_lengths.to(dev).long()[:, None] - lq
                 + torch.arange(lq, device=dev)[None, :])
        validity = torch.arange(lk, device=dev)[None, None, None, :] <= q_pos[:, None, :, None]
        mask = validity if mask is None else torch.logical_and(mask.bool(), validity)
        causal = False
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        q_pos = torch.arange(lq, device=dev)[:, None] + (lk - lq)
        k_pos = torch.arange(lk, device=dev)[None, :]
        logits = logits.masked_fill(~(q_pos >= k_pos)[None, None], NEG_INF)
    if mask is not None:
        logits = torch.where(mask.bool(), logits, torch.full((), NEG_INF, device=dev))
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and generator is not None:
        keep = torch.rand(probs.shape, generator=generator, device=dev) < (1.0 - dropout_rate)
        probs = torch.where(keep, probs / (1.0 - dropout_rate), torch.zeros((), device=dev))
    probs = probs.to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dot_product_attention(q, k, v, *, backend: str = "xla", **kwargs):
    """Dispatch to a registered attention backend."""
    if backend == "flash" and backend not in _BACKENDS:
        # registers the backend; imported lazily so plain use never pays for it
        from deepspeed_tpu_torch.ops.cuda import flash_attention  # noqa: F401
    if backend not in _BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; available: {available_backends()}")
    # None-valued kwargs mean "default"
    kwargs = {key: val for key, val in kwargs.items() if val is not None}
    return _BACKENDS[backend](q, k, v, **kwargs)
