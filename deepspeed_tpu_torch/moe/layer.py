"""The user-facing MoE module (counterpart of ``deepspeed_tpu/moe/layer.py``):
the constructor knobs of ``deepspeed.moe.layer.MoE`` (``num_experts``,
``ep_size``, ``k``, capacity factors, ``use_residual`` PR-MoE, the noisy
gate policy, RTS) and its return ``(output, l_aux, exp_counts)``.

On one device ``ep_size`` must be 1: expert parallelism over several cards
is a later slice of the port and raises.
"""

import copy
from typing import Optional

import torch
from torch import nn

from deepspeed_tpu_torch.moe.sharded_moe import GateNoise, MOELayer


class MoE(nn.Module):
    """Mixture-of-experts layer around ``expert``, a module mapping ``[...,
    hidden] -> [..., hidden]`` that offers ``stacked(num_experts)`` (see
    ``sharded_moe.Experts``; the GPT-2 ``MLP`` does). ``dtype`` is the
    compute dtype the gate and the PR-MoE coefficient round their fp32
    parameters to before using them in fp32. Parameters start at zero
    (``expert``'s keep their values); a model's ``reset_parameters`` or a
    state dict fills them."""

    def __init__(self, hidden_size: int, expert: nn.Module, num_experts: int = 1,
                 ep_size: int = 1, k: int = 1, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 use_residual: bool = False, noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, use_rts: bool = True, route: Optional[str] = None,
                 route_kernel: Optional[str] = None, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if noisy_gate_policy not in (None, "None", "Jitter", "RSample"):
            raise ValueError(f"Unsupported noisy_gate_policy: {noisy_gate_policy}")
        if k not in (1, 2):
            raise ValueError(f"Only top-1 and top-2 gatings are supported (got k={k})")
        if num_experts % ep_size != 0:
            raise ValueError(f"num_experts ({num_experts}) must be divisible by "
                             f"ep_size ({ep_size})")
        if ep_size > 1:
            raise NotImplementedError("expert parallelism over several cards (ep_size > 1) "
                                      "belongs to a later slice of the PyTorch port")
        if device is None:
            device = next(expert.parameters()).device
        self.use_residual = use_residual
        self.dtype = dtype
        self.deepspeed_moe = MOELayer(
            expert, hidden_size, num_experts, k=k, capacity_factor=capacity_factor,
            eval_capacity_factor=eval_capacity_factor, min_capacity=min_capacity,
            noisy_gate_policy=None if noisy_gate_policy == "None" else noisy_gate_policy,
            drop_tokens=drop_tokens, use_rts=use_rts, route=route, route_kernel=route_kernel,
            dtype=dtype, device=device)
        if use_residual:
            # PR-MoE: a dense copy of the expert beside the MoE path, mixed
            # by a learned fp32 2-way coefficient
            self.mlp = _ResidualExpertWrapper(expert)
            self.coefficient = _Coefficient(hidden_size, device)

    def forward(self, hidden_states: torch.Tensor, used_token: Optional[torch.Tensor] = None,
                deterministic: bool = True, *, gate_generator: Optional[torch.Generator] = None,
                gate_noise: Optional[GateNoise] = None,
                generator: Optional[torch.Generator] = None):
        """``(output, l_aux, exp_counts)``; the keyword arguments as in
        ``MOELayer.forward`` (``generator`` also drives the residual
        expert's dropout)."""
        output, l_aux, exp_counts = self.deepspeed_moe(
            hidden_states, used_token, deterministic, gate_generator=gate_generator,
            gate_noise=gate_noise, generator=generator)
        if self.use_residual:
            mlp_out = self.mlp(hidden_states, generator)
            coef = self.coefficient(hidden_states, self.dtype)
            coef = torch.softmax(coef, dim=-1).to(output.dtype)
            output = output * coef[..., 0:1] + mlp_out * coef[..., 1:2]
        return output, l_aux, exp_counts


class _ResidualExpertWrapper(nn.Module):
    """A dense copy of the expert for the PR-MoE residual path (state-dict
    scope ``mlp.residual_mlp``, the JAX path)."""

    def __init__(self, expert: nn.Module):
        super().__init__()
        self.residual_mlp = copy.deepcopy(expert)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.residual_mlp(x, generator)


class _Coefficient(nn.Module):
    """flax ``nn.Dense(2, dtype=float32)``: fp32 ``kernel`` [M, 2] and
    ``bias`` [2], computed in fp32 on the fp32 input after the parameters
    are rounded to the compute dtype."""

    def __init__(self, hidden_size: int, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros((hidden_size, 2), dtype=torch.float32,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(2, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return x.float() @ self.kernel.to(dtype).float() + self.bias.to(dtype).float()
