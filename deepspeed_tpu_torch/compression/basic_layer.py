"""Compression primitives (counterpart of
``deepspeed_tpu/compression/basic_layer.py``): each technique is a pure
``(weight, step) -> weight`` function on a tensor, which the engine applies
to the masters at every training forward.

The kernels keep JAX's ``[in, out]`` layout, so the axes carry over
unchanged: a row is an output neuron (the last axis), a channel an input
(axis 0), a head a block of the output dim. A threshold keeps every entry
tied with it (``>=``), as JAX's does. The quantization levels ``2^(bits -
1) - 1`` are computed in float32; XLA's ``pow`` gives the exact power of
two at every integer width from 2 to 16 bits, so no XLA rounding has to be
copied here (MoQ's ``exp2`` is another matter, ``runtime/quantize.py``)."""

from typing import Union

import torch

from deepspeed_tpu_torch.ops.quantizer.core import divisor_groups

Bits = Union[float, int, torch.Tensor]


def _levels(bits: Bits) -> torch.Tensor:
    b = torch.as_tensor(bits, dtype=torch.float32)
    return torch.pow(torch.tensor(2.0), b - 1.0) - 1.0


def qdq_weight(w: torch.Tensor, bits: Bits, groups: int = 1, symmetric: bool = True) -> torch.Tensor:
    """Quantize and dequantize at ``bits`` with grouped scales (the groups
    through ``divisor_groups``), with the straight-through gradient: the
    value ``w + (qdq(w) - w)`` (JAX's expression, so the bits are JAX's),
    the gradient as if the identity."""
    flat = w.reshape(-1)
    g = divisor_groups(flat.numel(), max(flat.numel() // max(groups, 1), 1))
    grouped = flat.reshape(g, -1).float()
    levels = _levels(bits).to(w.device)
    if symmetric:
        scale = grouped.abs().amax(dim=-1, keepdim=True) / levels
        scale = torch.clamp_min(scale, 1e-12)
        q = torch.clamp(torch.round(grouped / scale), -levels - 1.0, levels)
        dq = q * scale
    else:
        lo = grouped.amin(dim=-1, keepdim=True)
        hi = grouped.amax(dim=-1, keepdim=True)
        scale = torch.clamp_min((hi - lo) / (2.0 * levels + 1.0), 1e-12)
        q = torch.clamp(torch.round((grouped - lo) / scale), torch.zeros_like(levels), 2.0 * levels + 1.0)
        dq = q * scale + lo
    out = dq.reshape(w.shape).to(w.dtype)
    return w + (out - w).detach()


def scheduled_bits(step: int, start_bits: int, target_bits: int, period: int) -> torch.Tensor:
    """The bit width at ``step`` steps past the offset: ``start_bits``
    halved every ``period`` steps, never below ``target_bits`` (float32)."""
    if start_bits <= target_bits:
        return torch.tensor(float(target_bits))
    n_halvings = max(int(step), 0) // max(period, 1)
    bits = torch.tensor(float(start_bits)) / torch.pow(torch.tensor(2.0), float(n_halvings))
    return torch.clamp_min(bits, float(target_bits))


def _kth_largest(scores: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(scores.reshape(-1)).values[-k]


def sparse_prune_mask(w: torch.Tensor, dense_ratio: float, method: str = "l1") -> torch.Tensor:
    """Unstructured magnitude mask keeping ``dense_ratio`` of the entries
    (and every entry tied with the threshold)."""
    flat = w.reshape(-1).float().abs()
    k = max(int(flat.numel() * dense_ratio), 1)
    return (w.abs() >= _kth_largest(flat, k).to(w.dtype)).to(w.dtype)


def row_prune_mask(w: torch.Tensor, dense_ratio: float) -> torch.Tensor:
    """Keep the output rows (the last axis) of highest l1 norm."""
    scores = w.float().abs().sum(dim=tuple(range(w.dim() - 1)))
    k = max(int(scores.numel() * dense_ratio), 1)
    keep = (scores >= _kth_largest(scores, k)).to(w.dtype)
    return keep.expand(w.shape)


def head_prune_mask(w: torch.Tensor, dense_ratio: float, num_heads: int) -> torch.Tensor:
    """Keep the ``num_heads`` blocks of the output dim (the last axis) of
    highest l1 norm, as JAX's does. These are heads only where the last
    axis holds them: on an attention-output kernel ``[H, D, E]`` they are
    blocks of E."""
    out_dim = w.shape[-1]
    assert out_dim % num_heads == 0, f"out dim {out_dim} not divisible by {num_heads} heads"
    blocks = w.reshape(-1, num_heads, out_dim // num_heads)
    scores = blocks.float().abs().sum(dim=(0, 2))
    k = max(int(num_heads * dense_ratio), 1)
    keep = (scores >= _kth_largest(scores, k)).to(w.dtype)
    return keep[None, :, None].expand(blocks.shape).reshape(w.shape)


def channel_prune_mask(w: torch.Tensor, dense_ratio: float) -> torch.Tensor:
    """Keep the input channels (axis 0) of highest l1 norm."""
    scores = w.float().abs().sum(dim=tuple(range(1, w.dim())))
    k = max(int(scores.numel() * dense_ratio), 1)
    keep = (scores >= _kth_largest(scores, k)).to(w.dtype)
    return keep.reshape((-1,) + (1,) * (w.dim() - 1)).expand(w.shape)


def quantize_activation(x: torch.Tensor, bits: int = 8, symmetric: bool = True) -> torch.Tensor:
    """Dynamic-range activation QDQ: one per-tensor scale, the
    straight-through gradient."""
    return qdq_weight(x, float(bits), groups=1, symmetric=symmetric)
