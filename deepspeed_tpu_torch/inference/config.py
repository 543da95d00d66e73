"""Inference config (counterpart of ``deepspeed_tpu/inference/config.py``):
the same field names, as a dataclass.

Fields that belong to tensor parallelism, checkpoint loading, MoE or engine
weight quantization are later slices of the port and raise when set."""

import dataclasses
from typing import Any, Optional

import torch

_DTYPES = {"fp32": torch.float32, "float32": torch.float32, "float": torch.float32,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp16": torch.float16, "float16": torch.float16, "half": torch.float16}

#: legacy / reference names accepted by :meth:`DeepSpeedInferenceConfig.from_dict`
_ALIASES = {"kernel_inject": "replace_with_kernel_inject", "max_out_tokens": "max_tokens",
            "tp": "tensor_parallel", "min_tokens": "min_out_tokens",
            "injection_dict": "injection_policy"}


def resolve_dtype(value) -> Optional[torch.dtype]:
    if value is None or (isinstance(value, str) and value in ("", "auto")):
        return None
    if isinstance(value, torch.dtype):
        key = str(value).replace("torch.", "")
    else:
        key = str(value).lower().replace("torch.", "")
    if key == "int8":
        raise NotImplementedError("dtype=int8 (engine-wide weight quantization) is a later slice "
                                  "of the port; serve int8 weights through "
                                  "ServingConfig(weight_dtype='int8')")
    if key not in _DTYPES:
        raise ValueError(f"unknown dtype {value!r}; accepted: {sorted(_DTYPES)}")
    return _DTYPES[key]


@dataclasses.dataclass
class DeepSpeedInferenceConfig:
    replace_with_kernel_inject: bool = False
    dtype: Any = None
    #: with kernel injection, attention runs the CUDA flash kernels
    use_flash_prefill: bool = False
    max_tokens: int = 1024
    min_out_tokens: int = 1
    max_new_tokens: int = 64
    # later slices of the port: must stay unset
    tensor_parallel: Optional[dict] = None
    moe: Any = None
    quant: Optional[dict] = None
    checkpoint: Any = None
    injection_policy: Optional[dict] = None

    def __post_init__(self):
        self.dtype = resolve_dtype(self.dtype)
        tp = self.tensor_parallel or {}
        if int(tp.get("tp_size", 1)) > 1:
            raise NotImplementedError("tensor parallelism is a later slice of the PyTorch port")
        moe_on = self.moe.get("enabled", True) if isinstance(self.moe, dict) else bool(self.moe)
        if moe_on:
            raise NotImplementedError("MoE inference is a later slice of the PyTorch port")
        if self.quant and self.quant.get("enabled", False):
            raise NotImplementedError("engine weight quantization is a later slice of the port; "
                                      "use ServingConfig(weight_dtype=...)")
        if self.checkpoint is not None:
            raise NotImplementedError("checkpoint loading is a later slice of the port; pass a "
                                      "state dict (checkpoint.from_jax.params_from_jax) as params=")
        if self.injection_policy is not None:
            raise NotImplementedError("injection_policy (tensor slicing) is a later slice of the port")

    @classmethod
    def from_dict(cls, values: dict) -> "DeepSpeedInferenceConfig":
        """Build from a dict or kwargs, mapping the reference's alias names
        (``kernel_inject``, ``max_out_tokens``, ``mp_size``...)."""
        out = {}
        for key, val in values.items():
            if key == "mp_size":
                out.setdefault("tensor_parallel", {})["tp_size"] = val
                continue
            out[_ALIASES.get(key, key)] = val
        return cls(**out)
