"""Grouped symmetric quantization helpers (the serving subset of
``deepspeed_tpu/ops/quantizer/core.py``): last-axis int8 quantization for the
KV cache, the group-count rule, and int4 nibble packing.

Rounding is ``torch.round``, which rounds half to even like ``jnp.rint``, so
the codes are identical to the JAX package's."""

from typing import Tuple

import torch


def divisor_groups(size: int, target_group_size: int) -> int:
    """Largest group count <= size/target that divides ``size`` exactly."""
    groups = max(1, size // max(target_group_size, 1))
    while groups > 1 and size % groups != 0:
        groups -= 1
    return groups


def quantize_lastaxis(x: torch.Tensor, num_bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization with one group per trailing-axis vector.
    Returns (int8 codes shaped like ``x``, fp32 scales ``x.shape[:-1] + (1,)``)."""
    qmax = float(2**(num_bits - 1) - 1)
    flat = x.float()
    absmax = flat.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones((), device=x.device))
    q = torch.clamp(torch.round(flat / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (int8 storage, range +-7 or 0..15) two per byte along
    the last dim (must be even): low nibble = even element."""
    if q.shape[-1] % 2 != 0:
        raise ValueError(f"pack_int4 needs an even trailing dim to pair nibbles; got shape "
                         f"{tuple(q.shape)} — pad the last axis or regroup before packing")
    lo = q[..., 0::2].to(torch.int16) & 0xF
    hi = q[..., 1::2].to(torch.int16) & 0xF
    # through uint8 so the byte keeps its bit pattern (values 128..255 read back negative)
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor, symmetric: bool = True) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; sign-extends when symmetric."""
    p = packed.to(torch.int16)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    out = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    if symmetric:
        out = torch.where(out > 7, out - 16, out)  # sign-extend the nibble
    return out.to(torch.int8)
