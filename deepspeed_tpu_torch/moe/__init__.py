"""Mixture of experts on one device (counterpart of ``deepspeed_tpu/moe/``)."""

from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.moe.mappings import drop_tokens, gather_tokens
from deepspeed_tpu_torch.moe.routing import resolve_route, set_default_route
from deepspeed_tpu_torch.moe.sharded_moe import (Experts, GateNoise, MOELayer, SortedRouting,
                                                 TopKGate, top1gating, top1routing, top2gating,
                                                 top2routing)
from deepspeed_tpu_torch.moe.utils import (has_moe_layers, is_moe_param, is_moe_param_path,
                                           split_params_into_different_moe_groups_for_optimizer)

__all__ = [
    "MoE", "MOELayer", "TopKGate", "Experts", "SortedRouting", "GateNoise",
    "top1gating", "top2gating", "top1routing", "top2routing",
    "resolve_route", "set_default_route", "drop_tokens", "gather_tokens",
    "has_moe_layers", "is_moe_param", "is_moe_param_path",
    "split_params_into_different_moe_groups_for_optimizer",
]
