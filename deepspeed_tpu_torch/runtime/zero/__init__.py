"""ZeRO at one card (counterpart of ``deepspeed_tpu/runtime/zero``): the
``zero_optimization`` block, parameter offload and streaming, and the
stage-3 construction API."""

from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.partition_parameters import (GatheredParameters, Init,
                                                                   ZeroParamStatus,
                                                                   register_external_parameter,
                                                                   unregister_external_parameter)

__all__ = ["DeepSpeedZeroConfig", "GatheredParameters", "Init", "ZeroParamStatus",
           "register_external_parameter", "unregister_external_parameter"]
