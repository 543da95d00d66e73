"""``initialize`` (counterpart of ``deepspeed_tpu/runtime/entry.py``)."""

from typing import Callable, Optional

import torch

from deepspeed_tpu_torch.device import DeviceLike
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine


def initialize(args=None, model=None, optimizer=None, model_parameters=None, training_data=None,
               lr_scheduler: Optional[Callable[[int], float]] = None, config=None,
               config_params=None, loss_fn: Optional[Callable] = None,
               collate_fn: Optional[Callable] = None, device: DeviceLike = None):
    """Build the training engine on ``device`` (CUDA unless
    ``device="cpu"``; the model must already live there). Returns
    ``(engine, optimizer, training_dataloader, lr_scheduler)``, the
    dataloader ``engine.deepspeed_io(training_data, collate_fn=...)`` or
    None without ``training_data``. ``config`` is a dict or a JSON path
    (``args.deepspeed_config`` is honoured); ``model_parameters`` is a
    state dict loaded into the model first. ``optimizer`` is a client
    ``torch.optim.Optimizer`` over the model's parameters, which the engine
    steps in place of the config's ``optimizer`` block (JAX takes a client
    optax transformation the same way); the returned optimizer is it. With
    ``hybrid_engine.enabled`` the engine is a :class:`DeepSpeedHybridEngine`
    (JAX ``entry.py:72-75``), which also serves ``generate()`` and RLHF
    rollouts. The config blocks of the pipeline and autotuning engines
    belong to later slices and raise."""
    if model is None:
        raise ValueError("initialize requires a model")
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError("initialize requires config= (or args.deepspeed_config)")
    if optimizer is not None and not isinstance(optimizer, torch.optim.Optimizer):
        raise TypeError(f"initialize(optimizer=...) takes a torch.optim.Optimizer over the model's "
                        f"parameters, got {type(optimizer).__name__}")
    if model_parameters is not None:
        model.load_state_dict(model_parameters, strict=True)
    ds_config = DeepSpeedConfig(config)
    cls = DeepSpeedHybridEngine if ds_config.hybrid_engine_config.enabled else DeepSpeedEngine
    engine = cls(model, ds_config, loss_fn=loss_fn, lr_scheduler=lr_scheduler, device=device,
                 training_data=training_data, collate_fn=collate_fn, optimizer=optimizer)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler
