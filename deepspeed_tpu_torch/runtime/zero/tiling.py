"""Tiled linear layers (counterpart of ``deepspeed_tpu/runtime/zero/tiling.py``;
upstream ``TiledLinear`` and ``TiledLinearReturnBias``): ``y = x @ W + b``
as an ``out_splits x in_splits`` grid of tiles, each its own parameter
(``tile_{oi}_{ii}_kernel [in_i, out_o]`` and ``tile_{oi}_bias [out_o]``,
JAX's names), so that a parameter-partitioning scheme can hold one tile at
a time. Each output tile is the sum of its ``in_splits`` partial products,
each a plain ``torch.matmul`` in the compute dtype, as JAX's ``jnp.matmul``
is; the tiles' outputs are concatenated. ``kernel_axes`` names the JAX
kernel's sharding axes and is taken and inert on one card."""

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from deepspeed_tpu_torch.device import DeviceLike, resolve_device


def _split_sizes(dim: int, splits: int) -> Sequence[int]:
    """Near-equal integer chunks (upstream ``partition_uniform``)."""
    if splits < 1 or dim < splits:
        raise ValueError(f"cannot split dim {dim} into {splits} tiles")
    base, rem = divmod(dim, splits)
    return [base + (1 if i < rem else 0) for i in range(splits)]


class TiledLinear(nn.Module):
    """``y = x @ W + b`` over an ``out_splits x in_splits`` tile grid."""

    def __init__(self, in_features: int, out_features: int, in_splits: int = 1, out_splits: int = 1,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 kernel_axes: Tuple[Optional[str], Optional[str]] = ("embed", "mlp"),
                 kernel_init_scale: float = 0.02, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.in_sizes = _split_sizes(in_features, in_splits)
        self.out_sizes = _split_sizes(out_features, out_splits)
        self.use_bias, self.dtype, self.kernel_axes = use_bias, dtype, kernel_axes
        dev = self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        for oi, osize in enumerate(self.out_sizes):
            for ii, isize in enumerate(self.in_sizes):
                w = torch.empty((isize, osize), dtype=param_dtype, device=dev)
                w.normal_(0.0, kernel_init_scale, generator=generator)
                self.register_parameter(f"tile_{oi}_{ii}_kernel", nn.Parameter(w))
            if use_bias:
                self.register_parameter(f"tile_{oi}_bias", nn.Parameter(
                    torch.zeros(osize, dtype=param_dtype, device=dev)))

    def _tiled_forward(self, x: torch.Tensor):
        """(y without bias, the bias or None)."""
        if x.shape[-1] != self.in_features:
            raise ValueError(f"input feature dim {x.shape[-1]} != {self.in_features}")
        dt = self.dtype
        xs = torch.split(x.to(dt), self.in_sizes, dim=-1)
        outs, biases = [], []
        for oi in range(len(self.out_sizes)):
            acc = None
            for ii, x_i in enumerate(xs):
                part = torch.matmul(x_i, getattr(self, f"tile_{oi}_{ii}_kernel").to(dt))
                acc = part if acc is None else acc + part
            outs.append(acc)
            if self.use_bias:
                biases.append(getattr(self, f"tile_{oi}_bias").to(dt))
        return torch.cat(outs, dim=-1), (torch.cat(biases) if self.use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, bias = self._tiled_forward(x)
        return y if bias is None else y + bias


class TiledLinearReturnBias(TiledLinear):
    """Returns ``(y without bias, bias)``, for a block that adds the bias in
    a later fused op."""

    def forward(self, x: torch.Tensor):
        return self._tiled_forward(x)
