"""``init_inference`` (counterpart of ``deepspeed_tpu/inference/entry.py``)."""

from typing import Optional

from deepspeed_tpu_torch.device import DeviceLike
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine


def init_inference(model, config=None, params: Optional[dict] = None, device: DeviceLike = None,
                   seed: int = 0, **kwargs) -> InferenceEngine:
    """Build an :class:`InferenceEngine` on ``device`` (CUDA unless
    ``device="cpu"``). ``config`` is a dict or a
    :class:`DeepSpeedInferenceConfig`; keyword arguments (``dtype=``,
    ``kernel_inject=``, ``use_flash_prefill=``...) are folded into a dict
    config and may not be combined with a config object."""
    if isinstance(config, DeepSpeedInferenceConfig):
        if kwargs:
            raise ValueError(f"init_inference got both a DeepSpeedInferenceConfig and kwargs "
                             f"{sorted(kwargs)}; fold the kwargs into the config")
        ds_config = config
    else:
        ds_config = DeepSpeedInferenceConfig.from_dict({**dict(config or {}), **kwargs})
    return InferenceEngine(model, ds_config, params=params, device=device, seed=seed)
