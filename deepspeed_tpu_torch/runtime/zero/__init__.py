"""ZeRO at one card (counterpart of ``deepspeed_tpu/runtime/zero``): the
``zero_optimization`` block, parameter offload and streaming, and the
stage-3 construction API, and the tiled linear layers."""

from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.partition_parameters import (GatheredParameters, Init,
                                                                   ZeroParamStatus,
                                                                   register_external_parameter,
                                                                   unregister_external_parameter)
from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear, TiledLinearReturnBias

__all__ = ["DeepSpeedZeroConfig", "GatheredParameters", "Init", "TiledLinear",
           "TiledLinearReturnBias", "ZeroParamStatus",
           "register_external_parameter", "unregister_external_parameter"]
