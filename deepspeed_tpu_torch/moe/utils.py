"""MoE utilities (counterpart of ``deepspeed_tpu/moe/utils.py``): finding
expert parameters by name or tag, finding MoE layers, and splitting a
model's parameters into optimizer groups."""

from typing import Iterable, List, Tuple, Union

import torch
from torch import nn


def is_moe_param_path(path: Union[str, Iterable]) -> bool:
    """True if a parameter path (``"h_1.moe.deepspeed_moe.experts.
    deepspeed_experts.c_fc.kernel"``, or its parts) names an expert
    parameter: a ``deepspeed_experts`` part. Gate parameters are dense."""
    parts = path.split(".") if isinstance(path, str) else [str(p) for p in path]
    return "deepspeed_experts" in parts


def is_moe_param(param: torch.Tensor) -> bool:
    """The reference's test: an expert parameter carries ``allreduce =
    False`` (set by ``sharded_moe.Experts``)."""
    return getattr(param, "allreduce", True) is False


def has_moe_layers(module: nn.Module) -> bool:
    """True if ``module`` contains an MoE layer, or its config asks for
    experts (``moe_num_experts``)."""
    from deepspeed_tpu_torch.moe.layer import MoE
    from deepspeed_tpu_torch.moe.sharded_moe import MOELayer

    cfg = getattr(module, "config", None)
    if cfg is not None and getattr(cfg, "moe_num_experts", 0):
        return True
    return any(isinstance(m, (MoE, MOELayer)) for m in module.modules())


def split_params_into_different_moe_groups_for_optimizer(
        named_params: Union[nn.Module, Iterable[Tuple[str, torch.Tensor]]]) -> List[dict]:
    """Optimizer parameter groups ``[{"name": "dense", "params": [...]},
    {"name": "experts", "moe": True, "params": [...]}]`` (the second only
    when there are experts), so experts can get their own settings; the
    counterpart of the JAX package's expert/dense masks."""
    if isinstance(named_params, nn.Module):
        named_params = named_params.named_parameters()
    dense, experts = [], []
    for name, p in named_params:
        (experts if is_moe_param_path(name) else dense).append(p)
    groups = [{"name": "dense", "params": dense}]
    if experts:
        groups.append({"name": "experts", "moe": True, "params": experts})
    return groups
