"""Inference config (counterpart of ``deepspeed_tpu/inference/config.py``):
the same field names, as a dataclass.

The ``moe`` block is JAX's ``DeepSpeedMoEConfig`` (a bool, a dict or None);
expert parallelism over several cards (``ep_size > 1``) raises. The
``quant`` block is JAX's ``QuantizationConfig``; ``dtype="int8"`` means
int8-quantized weights served at bf16 (JAX ``engine.py:151-158``), not a
cast. ``checkpoint`` (joined to ``base_dir``) names the serving weights:
an ``.npz``, an engine checkpoint directory, or ``{"checkpoint_dir": ...,
"tag": ...}``. Tensor parallelism (``tp_size > 1``) and ``injection_policy``
are later slices of the port and raise when set."""

import dataclasses
from typing import Any, Optional

import torch

_DTYPES = {"fp32": torch.float32, "float32": torch.float32, "float": torch.float32,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp16": torch.float16, "float16": torch.float16, "half": torch.float16,
           "int8": torch.int8}

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
    if key not in _DTYPES:
        raise ValueError(f"unknown dtype {value!r}; accepted: {sorted(_DTYPES)}")
    return _DTYPES[key]


@dataclasses.dataclass
class DeepSpeedMoEConfig:
    """The inference ``moe`` block (JAX ``DeepSpeedMoEConfig``, its
    defaults): ``num_experts`` is the alias of ``moe_experts``. Serving an
    MoE model needs no block: the model's config carries its experts."""
    enabled: bool = True
    ep_size: int = 1
    moe_experts: Any = 1
    type: str = "standard"

    def __post_init__(self):
        if int(self.ep_size) > 1:
            raise NotImplementedError(
                f"moe.ep_size={self.ep_size}: expert parallelism over several cards belongs to "
                f"a later slice of the PyTorch port (ROADMAP.md Queue A item 8)")

    @classmethod
    def from_value(cls, value) -> "DeepSpeedMoEConfig":
        """A bool, a dict (``num_experts`` or ``moe_experts``), None or a
        config, as JAX's ``moe`` field takes them."""
        if isinstance(value, cls):
            return value
        if value is None:
            return cls()
        if isinstance(value, bool):
            return cls(enabled=value)
        if not isinstance(value, dict):
            raise ValueError(f"moe must be a bool, a dict or a DeepSpeedMoEConfig, got {value!r}")
        values = dict(value)
        if "num_experts" in values:
            if "moe_experts" in values:
                raise ValueError("moe: give num_experts or its alias moe_experts, not both")
            values["moe_experts"] = values.pop("num_experts")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(values) - known)
        if unknown:
            raise ValueError(f"moe: unknown keys {unknown}; accepted: enabled, ep_size, "
                             f"num_experts (moe_experts), type")
        return cls(**values)


@dataclasses.dataclass
class QuantizationConfig:
    """The inference ``quant`` block (JAX ``QuantizationConfig``):
    engine-wide weight quantization (``runtime/weight_quantizer.py``),
    ``group_size`` elements a group."""
    enabled: bool = False
    bits: int = 8
    group_size: int = 64

    @classmethod
    def from_value(cls, value) -> "QuantizationConfig":
        if isinstance(value, cls):
            return value
        if value is None:
            return cls()
        if not isinstance(value, dict):
            raise ValueError(f"quant must be a dict or a QuantizationConfig, got {value!r}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(value) - known)
        if unknown:
            raise ValueError(f"quant: unknown keys {unknown}; accepted: {sorted(known)}")
        return cls(**value)


@dataclasses.dataclass
class DeepSpeedInferenceConfig:
    replace_with_kernel_inject: bool = False
    dtype: Any = None
    #: with kernel injection, attention runs the CUDA flash kernels
    use_flash_prefill: bool = False
    max_tokens: int = 1024
    min_out_tokens: int = 1
    max_new_tokens: int = 64
    moe: Any = None
    quant: Any = None
    checkpoint: Any = None
    base_dir: str = ""
    # later slices of the port: must stay unset
    tensor_parallel: Optional[dict] = None
    injection_policy: Optional[dict] = None

    def __post_init__(self):
        self.dtype = resolve_dtype(self.dtype)
        tp = self.tensor_parallel or {}
        if int(tp.get("tp_size", 1)) > 1:
            raise NotImplementedError("tensor parallelism is a later slice of the PyTorch port "
                                      "(ROADMAP.md Queue A item 8)")
        self.moe = DeepSpeedMoEConfig.from_value(self.moe)
        self.quant = QuantizationConfig.from_value(self.quant)
        if self.injection_policy is not None:
            raise NotImplementedError("injection_policy (tensor slicing) is a later slice of the "
                                      "PyTorch port (ROADMAP.md Queue A item 8)")

    @property
    def quantize_weights(self) -> bool:
        """Engine-wide int8 weights: ``dtype="int8"`` or an enabled ``quant``."""
        return bool(self.quant.enabled) or self.dtype == torch.int8

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
