"""Per-group weight quantization for serving (counterpart of
``deepspeed_tpu/ops/quantizer/weights.py``).

``quantize_params`` turns a served param tree (nested dicts of tensors, the
JAX package's names) into a tree of int8 codes — int4 packed two per byte
along the contraction axis — and a sparse mirror tree of per-(K-group,
output column) fp32 scales, one ``kernel_scale`` leaf beside each quantized
kernel. Only projection kernels are quantized: embeddings, positional
tables, LM heads, norms and biases stay fp.
"""

from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.quantizer.core import divisor_groups, pack_int4, unpack_int4

#: param leaves whose path contains any of these tokens are never quantized
SKIP_TOKENS = ("wte", "wpe", "embed", "lm_head", "head", "moe", "router")

#: scale-leaf name in the mirror tree
SCALE_NAME = "kernel_scale"

QMAX = {8: 127.0, 4: 7.0}


def quant_bits(weight_dtype: str) -> int:
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"no bit width for weight_dtype {weight_dtype!r}")
    return 8 if weight_dtype == "int8" else 4


def contract_dims(leaf_ndim: int) -> int:
    """Contraction-dim count of a GPT-2 projection kernel: 2-D ``[in, out]``
    and 4-D fused-QKV ``[E, 3, H, D]`` contract one leading dim; 3-D
    attention-out ``[H, D, E]`` contracts two."""
    return 2 if leaf_ndim == 3 else 1


def pack_rows(codes2d: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes ``[K, N]`` two per byte along K -> ``[K//2, N]``
    (rows 2i, 2i+1 -> low/high nibble of packed row i)."""
    return pack_int4(codes2d.t()).t().contiguous()


def unpack_rows(packed2d: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_rows`: ``[K//2, N]`` -> sign-extended int8
    codes ``[K, N]``."""
    return unpack_int4(packed2d.t()).t().contiguous()


def eligible(path, leaf: torch.Tensor) -> bool:
    """Quantize only floating projection kernels outside the skip list."""
    if path[-1] != "kernel" or leaf.dim() < 2:
        return False
    if not leaf.is_floating_point():
        return False
    joined = "/".join(str(p).lower() for p in path)
    return not any(tok in joined for tok in SKIP_TOKENS)


def quantize_leaf(leaf: torch.Tensor, bits: int, group_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One kernel -> (codes shaped as the serving module declares them,
    scales ``[G, N]`` fp32). Int4 packs along the last contraction axis,
    halving that axis in the stored shape."""
    nc = contract_dims(leaf.dim())
    shape = tuple(leaf.shape)
    k = 1
    for d in shape[:nc]:
        k *= d
    w = leaf.reshape(k, -1).float()
    g = divisor_groups(k, group_size)
    qmax = QMAX[bits]
    wg = w.reshape(g, k // g, w.shape[1])
    absmax = wg.abs().amax(dim=1)  # [g, N]
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones((), device=leaf.device)).float()
    codes = torch.clamp(torch.round(wg / scale[:, None, :]), -qmax, qmax)
    codes = codes.to(torch.int8).reshape(k, -1)
    if bits == 4:
        if shape[nc - 1] % 2 != 0:
            raise ValueError(f"int4 packing needs an even contraction axis; kernel shape "
                             f"{shape} has {shape[nc - 1]} at axis {nc - 1}")
        codes = pack_rows(codes)
        shape = shape[:nc - 1] + (shape[nc - 1] // 2,) + shape[nc:]
    return codes.reshape(shape), scale


def dequantize_leaf(codes: torch.Tensor, scale: torch.Tensor, bits: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Full-kernel dequantized view (tests and the plain reference; the
    serving GEMM never materializes it)."""
    nc = contract_dims(codes.dim())
    shape = tuple(codes.shape)
    k = 1
    for d in shape[:nc]:
        k *= d
    q2d = codes.reshape(k, -1)
    if bits == 4:
        q2d = unpack_rows(q2d)
        k *= 2
        shape = shape[:nc - 1] + (shape[nc - 1] * 2,) + shape[nc:]
    g = scale.shape[0]
    w = q2d.float().reshape(g, k // g, -1) * scale[:, None, :]
    return w.reshape(shape).to(dtype)


def quantize_params(params: Dict, weight_dtype: str,
                    group_size: int = 64) -> Tuple[Dict, Optional[Dict]]:
    """Quantize a served param tree. Returns ``(qparams, qscales)``:
    ``qparams`` mirrors ``params`` with eligible kernels replaced by codes;
    ``qscales`` holds a ``kernel_scale`` leaf at each quantized kernel's
    scope. ``weight_dtype="fp"`` returns ``(params, None)``."""
    if weight_dtype == "fp":
        return params, None
    bits = quant_bits(weight_dtype)

    def walk(tree, path):
        q, s = {}, {}
        for name, leaf in tree.items():
            sub = path + (name,)
            if isinstance(leaf, dict):
                qc, sc = walk(leaf, sub)
                q[name] = qc
                if sc:
                    s[name] = sc
            elif eligible(sub, leaf):
                q[name], s[SCALE_NAME] = quantize_leaf(leaf, bits, group_size)
            else:
                q[name] = leaf
        return q, s

    return walk(params, ())
