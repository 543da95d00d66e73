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
    config and may not be combined with a config object.

    A weight (of ``model`` or ``params``) that already has the serving
    dtype and lies on ``device`` is served from its own tensor, not a copy:
    the engine shares it with the caller, and what writes into the served
    weights in place (``ContinuousBatchingScheduler.swap_served_params``)
    writes into the caller's model too. A weight of another dtype or device
    is served from a converted copy."""
    if isinstance(config, DeepSpeedInferenceConfig):
        if kwargs:
            raise ValueError(f"init_inference got both a DeepSpeedInferenceConfig and kwargs "
                             f"{sorted(kwargs)}; fold the kwargs into the config")
        ds_config = config
    else:
        ds_config = DeepSpeedInferenceConfig.from_dict({**dict(config or {}), **kwargs})
    return InferenceEngine(model, ds_config, params=params, device=device, seed=seed)
