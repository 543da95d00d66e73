"""Spatial (diffusers / UNet) bias-add ops (counterpart of
``deepspeed_tpu/ops/spatial``; upstream's ``nhwc_bias_add``,
``nhwc_bias_add_add`` and ``nhwc_bias_add_bias_add`` bindings). Plain tensor
expressions, as in JAX: no kernel backs them. The activations are NHWC
(``[B, H, W, C]``) or, with ``layout="nchw"``, ``[B, C, H, W]``; the bias
``[C]`` broadcasts over the spatial dims either way."""

import torch


def _bias_shape(activations: torch.Tensor, bias: torch.Tensor, layout: str) -> torch.Tensor:
    if layout not in ("nhwc", "nchw"):
        raise ValueError(f"layout must be 'nhwc' or 'nchw', got {layout!r}")
    c = bias.shape[-1]
    if layout == "nhwc":
        if activations.shape[-1] != c:
            raise ValueError(f"bias {c} != channel dim {activations.shape[-1]} (nhwc)")
        return bias.reshape((1,) * (activations.dim() - 1) + (c,))
    if activations.shape[1] != c:
        raise ValueError(f"bias {c} != channel dim {activations.shape[1]} (nchw)")
    return bias.reshape((1, c) + (1,) * (activations.dim() - 2))


def nhwc_bias_add(activations: torch.Tensor, bias: torch.Tensor, layout: str = "nhwc") -> torch.Tensor:
    """``activation + bias``."""
    return activations + _bias_shape(activations, bias, layout).to(activations.dtype)


def nhwc_bias_add_add(activations: torch.Tensor, bias: torch.Tensor, other: torch.Tensor,
                      layout: str = "nhwc") -> torch.Tensor:
    """``activation + bias + other``, the UNet residual."""
    return (activations + _bias_shape(activations, bias, layout).to(activations.dtype)
            + other.to(activations.dtype))


def nhwc_bias_add_bias_add(activations: torch.Tensor, bias: torch.Tensor, other: torch.Tensor,
                           other_bias: torch.Tensor, layout: str = "nhwc") -> torch.Tensor:
    """``(activation + bias) + (other + other_bias)``, the double residual,
    summed left to right as JAX sums it."""
    return (activations + _bias_shape(activations, bias, layout).to(activations.dtype)
            + other.to(activations.dtype)
            + _bias_shape(other, other_bias, layout).to(activations.dtype))
