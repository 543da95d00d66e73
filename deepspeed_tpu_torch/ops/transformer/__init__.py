"""Attention backends and the training encoder layer (counterpart of
``deepspeed_tpu/ops/transformer``)."""

from deepspeed_tpu_torch.ops.transformer.attention import (available_backends, dot_product_attention,
                                                           register_backend, xla_attention)
from deepspeed_tpu_torch.ops.transformer.transformer import (DeepSpeedTransformerConfig,
                                                             DeepSpeedTransformerLayer)

__all__ = ["DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer", "available_backends",
           "dot_product_attention", "register_backend", "xla_attention"]
