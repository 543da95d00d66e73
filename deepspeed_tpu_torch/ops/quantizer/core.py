"""Grouped quantization (counterpart of ``deepspeed_tpu/ops/quantizer/core.py``):
symmetric and asymmetric int8/int4 codes with per-group scales
(``quantize``, ``dequantize``, ``fake_quantize``), last-axis int8 for the KV
cache, the group-count rule, int4 nibble packing, and the two qgZ helpers
(``swizzle_quant``, ``quantized_reduction``).

Rounding is ``torch.round``, which rounds half to even like ``jnp.rint``, so
the codes are identical to the JAX package's. Stochastic rounding
(``floor(x + u)``, u uniform in [0, 1)) draws ``u`` from a
``torch.Generator``, not from JAX's threefry key, or takes it as ``noise``."""

from typing import NamedTuple, Optional, Tuple

import torch


class QuantParams(NamedTuple):
    """Per-group quantization metadata. ``offset`` is the asymmetric zero
    point (None: symmetric)."""
    scale: torch.Tensor  # [groups, 1] fp32
    offset: Optional[torch.Tensor]  # [groups, 1] fp32 or None


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


def _q_range(num_bits: int, symmetric: bool) -> Tuple[float, float]:
    if symmetric:
        q = float(2**(num_bits - 1) - 1)  # int8: +-127, int4: +-7
        return -q, q
    return 0.0, float(2**num_bits - 1)  # the unsigned range


def _round(x: torch.Tensor, stochastic_rounding: bool, generator: Optional[torch.Generator],
           noise: Optional[torch.Tensor]) -> torch.Tensor:
    if stochastic_rounding:
        if noise is None:
            noise = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                               device=x.device)
        return torch.floor(x + noise.reshape(x.shape))
    return torch.round(x)


def quantize(x: torch.Tensor, num_bits: int = 8, symmetric: bool = True, num_groups: int = 1,
             stochastic_rounding: bool = False, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, QuantParams]:
    """Grouped quantization of ``x`` (any shape, size divisible by
    ``num_groups``). Returns codes ``[groups, group_size]`` (int8 when
    symmetric, uint8 when not; int4 codes in the low nibble) and their
    :class:`QuantParams`. ``noise`` injects stochastic rounding's uniform
    draws (shaped like the codes)."""
    flat = x.reshape(num_groups, -1).float()
    qmin, qmax = _q_range(num_bits, symmetric)
    one = torch.ones((), device=x.device)
    if symmetric:
        absmax = flat.abs().amax(dim=1, keepdim=True)
        scale = torch.where(absmax > 0, absmax / qmax, one)
        q = torch.clamp(_round(flat / scale, stochastic_rounding, generator, noise), qmin, qmax)
        return q.to(torch.int8), QuantParams(scale=scale, offset=None)
    lo = flat.amin(dim=1, keepdim=True)
    hi = flat.amax(dim=1, keepdim=True)
    scale = torch.where(hi > lo, (hi - lo) / qmax, one)
    q = torch.clamp(_round((flat - lo) / scale, stochastic_rounding, generator, noise), qmin, qmax)
    return q.to(torch.uint8), QuantParams(scale=scale, offset=lo)


def dequantize(q: torch.Tensor, params: QuantParams, shape=None) -> torch.Tensor:
    """Inverse of :func:`quantize` (fp32)."""
    out = q.float() * params.scale
    if params.offset is not None:
        out = out + params.offset
    return out.reshape(shape) if shape is not None else out


def fake_quantize(x: torch.Tensor, num_bits: int = 8, symmetric: bool = True, num_groups: int = 1,
                  stochastic_rounding: bool = False, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize and dequantize in one step, back in ``x``'s dtype."""
    q, params = quantize(x, num_bits, symmetric, num_groups, stochastic_rounding, generator, noise)
    return dequantize(q, params, x.shape).to(x.dtype)


def swizzle_quant(x: torch.Tensor, num_bits: int = 8, num_groups: int = 1, pipeline_size: int = 1,
                  nodes: int = 1, devices_per_node: int = 1,
                  generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None):
    """Quantize with the hierarchical all-to-all swizzle: ``x`` viewed as
    ``[pipeline, nodes, devices_per_node, rest]`` with the node and device
    dims swapped, so that each node's traffic is contiguous for qgZ's first
    (intra-node) hop. Stochastic rounding when a generator or noise is
    given (JAX: when a key is given)."""
    chunk = x.numel() // (pipeline_size * nodes * devices_per_node)
    v = x.reshape(pipeline_size, nodes, devices_per_node, chunk).permute(0, 2, 1, 3)
    return quantize(v, num_bits=num_bits, symmetric=True, num_groups=num_groups,
                    stochastic_rounding=generator is not None or noise is not None,
                    generator=generator, noise=noise)


def quantized_reduction(q: torch.Tensor, params: QuantParams, num_bits_in: int, num_bits_out: int,
                        devices: int, generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None):
    """Dequantize ``devices`` chunks, average them and requantize at
    ``num_bits_out`` (qgZ's inter-node hop: int8 partials into int4)."""
    groups = q.shape[0]
    vals = dequantize(q, params).reshape(devices, groups // devices, -1).mean(dim=0)
    return quantize(vals, num_bits=num_bits_out, symmetric=True, num_groups=groups // devices,
                    stochastic_rounding=generator is not None or noise is not None,
                    generator=generator, noise=noise)
