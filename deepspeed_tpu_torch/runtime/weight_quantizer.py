"""Engine-wide weight quantization for serving (counterpart of
``deepspeed_tpu/runtime/weight_quantizer.py``, reference
``WeightQuantization``): int8 codes plus per-group fp32 scales, applied
once when an inference engine is built with ``dtype="int8"`` or an enabled
``quant`` block.

Groups run over each leaf's flattened elements in the JAX layout (``[in,
out]`` kernels, GPT-2's fused ``[E, 3, H, D]`` QKV), with the reference's
scale ``2^bits / (2 max|g| + 1e-5)``. Leaves are keyed by the port's
state-dict names; the skip list and the MLP test read the JAX path of each
name (``checkpoint/from_jax.jax_paths``), so the same leaves are quantized,
with the same group counts, as in the JAX package. The serving engine keeps
the codes and scales on the card and dequantizes inside each call
(:func:`dequantize_tree`), as JAX's ``_mparams`` does in-graph. This format
is not kernel K2's (``ops/cuda/quant_matmul.py`` takes per-(K-group,
column) scales), so the dequantize is a plain PyTorch pass, the counterpart
of the XLA code JAX runs for it.
"""

import logging
from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.checkpoint.from_jax import jax_paths
from deepspeed_tpu_torch.ops.quantizer.core import divisor_groups

logger = logging.getLogger(__name__)

_SKIP_TOKENS = ("wte", "wpe", "embed", "shared", "lm_head", "word_embeddings",
                "position_embeddings", "token_type")


def _is_quantizable(path: str, leaf: torch.Tensor) -> bool:
    if leaf.dim() < 2 or not leaf.is_floating_point():
        return False
    low = path.lower()
    return not any(tok in low for tok in _SKIP_TOKENS)


class WeightQuantization:
    """The reference's API and the state-dict quantize of the JAX class."""

    def __init__(self, mlp_extra_grouping: bool = True, mp_size: int = 1):
        self.mlp_extra_grouping = mlp_extra_grouping
        self.mp_size = mp_size

    def quantize_data(self, data: torch.Tensor, quantize_bits: int, groups: int,
                      key: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Group-wise symmetric quantization of the flattened ``data``:
        (int8 codes shaped like ``data``, fp32 scales ``[groups]``)."""
        flat = data.float().reshape(groups, -1)
        max_d = torch.maximum(flat.amax(dim=-1, keepdim=True), flat.amin(dim=-1, keepdim=True).abs())
        scale = float(1 << quantize_bits) / (2.0 * max_d + 1e-5)
        qmin = -(1 << (quantize_bits - 1))
        qmax = (1 << (quantize_bits - 1)) - 1
        q = torch.clamp(torch.round(flat * scale), qmin, qmax)
        return q.reshape(data.shape).to(torch.int8), scale[:, 0]

    def is_mlp(self, data: torch.Tensor, merge_count: int = 1) -> bool:
        r0 = (self.mp_size * data.shape[0] * merge_count) / data.shape[1]
        r1 = (self.mp_size * data.shape[1] * merge_count) / data.shape[0]
        return r0 == 4 or r1 == 4

    def is_qkv(self, data: torch.Tensor) -> bool:
        r0 = (self.mp_size * data.shape[0]) / data.shape[1]
        r1 = (self.mp_size * data.shape[1]) / data.shape[0]
        return r0 == 3 or r1 == 3

    @torch.no_grad()
    def model_quantize(self, params: Dict[str, torch.Tensor], quantize_bits: int = 8,
                       group_size: int = 64, groups: Optional[int] = None
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Quantize every eligible leaf of a state dict. Returns the mixed
        int8/float state dict and ``{name: scales}``. ``group_size`` is
        elements per group; ``groups``, a fixed group count (the reference's
        ``quantize_grouping``), wins when given. MLP weights get twice the
        groups under ``mlp_extra_grouping``."""
        out, scales = {}, {}
        paths = jax_paths(params)
        for name, leaf in params.items():
            if not _is_quantizable(paths[name], leaf):
                out[name] = leaf
                continue
            n = leaf.numel()
            g = (divisor_groups(n, max(1, n // groups)) if groups
                 else divisor_groups(n, max(group_size, 1)))
            if self.mlp_extra_grouping and self.is_mlp(leaf):
                g = divisor_groups(n, max(1, n // (2 * g)))
            out[name], scales[name] = self.quantize_data(leaf, quantize_bits, g, name)
        logger.info(f"WeightQuantization: {len(scales)} tensors -> int{quantize_bits}")
        return out, scales


def dequantize_tree(params: Dict[str, torch.Tensor], scales: Dict[str, torch.Tensor],
                    dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The inverse of :meth:`WeightQuantization.model_quantize` on the
    quantized leaves: ``{name: weights in dtype}`` for each name in
    ``scales`` (a new tensor each call; the codes stay as they are)."""
    out = {}
    for name, s in scales.items():
        leaf = params[name]
        flat = leaf.float().reshape(s.shape[0], -1)
        out[name] = (flat / s[:, None]).reshape(leaf.shape).to(dtype)
    return out
