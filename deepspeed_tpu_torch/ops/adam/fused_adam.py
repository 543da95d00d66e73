"""Adam/AdamW (counterpart of ``deepspeed_tpu/ops/adam/fused_adam.py``).

The JAX package expresses the update as one chain of elementwise ops that
XLA fuses; it has no Pallas kernel, so the port keeps it as tensor code:
``torch._foreach_*`` over the parameter list (one multi-tensor launch per
op on the GPU). The arithmetic follows the JAX update formula by formula:

    count += 1;  lr_t = lr(count) if lr is a schedule
    g = g + wd * p                                  (L2 mode, wd > 0)
    m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g^2
    bc1 = 1 - b1^count;  bc2 = 1 - b2^count          (fp32; 1 without correction)
    upd = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p (AdamW mode, wd > 0)
    p = p + (-lr_t * upd)

Decay applies to every parameter, biases and norms included.
``torch.optim.AdamW`` is equal in algebra but not in rounding (it decays as
``p * (1 - lr wd)``, divides by ``sqrt(v) / sqrt(bc2) + eps`` and computes
its corrections in float64 on the host), so it is not used.
"""

from typing import Dict, Iterable, Tuple

import torch

from deepspeed_tpu_torch.ops.optimizer_base import NamedStateOptimizer, ScalarOrSchedule
from deepspeed_tpu_torch.ops.optimizer_base import fp32 as _fp32


class FusedAdam(NamedStateOptimizer):
    """Adam with decoupled (``adam_w_mode=True``) or L2 weight decay over
    fp32 parameters. ``lr`` is a float or a ``count -> lr`` schedule read
    at the incremented count. The state is one ``count`` shared by every
    parameter (the JAX ``AdamState.count``) and per parameter fp32
    ``exp_avg`` and ``exp_avg_sq`` (on ``state_device`` when given),
    allocated here (as ``optimizer.init`` does) so that a state can be
    loaded before the first step."""

    SLOTS = ("exp_avg", "exp_avg_sq")

    def __init__(self, params: Iterable[torch.Tensor], lr: ScalarOrSchedule = 1e-3,
                 bias_correction: bool = True, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, adam_w_mode: bool = True, weight_decay: float = 0.0,
                 amsgrad: bool = False, state_device=None):
        if amsgrad:
            raise NotImplementedError("FusedAdam does not support the AMSGrad variant "
                                      "(parity with the reference)")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=tuple(betas), eps=eps,
                        adam_w_mode=adam_w_mode, weight_decay=weight_decay)
        super().__init__(params, defaults, state_device=state_device)

    @torch.no_grad()
    def step_resting(self, grads: Dict[int, torch.Tensor], device) -> None:
        """The step of parameters that rest off ``device`` (``offload_param``
        with the moments on the card, ``state_device=device``): each
        parameter is copied to ``device``, updated there with its gradient
        ``grads[id(p)]`` by the same arithmetic as :meth:`step`, and copied
        back to its resting place."""
        self.count += 1
        for group in self.param_groups:
            for p in group["params"]:
                work = p.to(device)
                self._update(group, [work], [grads[id(p)]], state_of=p)
                p.copy_(work)

    def _update(self, group: dict, params, grads, state_of=None) -> None:
        """The update of ``params`` (a list) in place with ``grads`` at
        ``self.count``; the moments are those of ``params`` (or of the one
        parameter ``state_of``)."""
        keys = params if state_of is None else [state_of]
        count = _fp32(self.count)
        ms = [self.state[p]["exp_avg"] for p in keys]
        vs = [self.state[p]["exp_avg_sq"] for p in keys]
        b1, b2 = group["betas"]
        wd, eps = group["weight_decay"], group["eps"]
        lr = self.lr_at(group, self.count)
        if not group["adam_w_mode"] and wd > 0.0:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, wd))
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        if group["bias_correction"]:
            bc1 = float(1 - _fp32(b1) ** count)
            bc2 = float(1 - _fp32(b2) ** count)
        else:
            bc1 = bc2 = 1.0
        denom = torch._foreach_sqrt(torch._foreach_div(vs, bc2))
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(torch._foreach_div(ms, bc1), denom)
        if group["adam_w_mode"] and wd > 0.0:
            torch._foreach_add_(upd, torch._foreach_mul(params, wd))
        torch._foreach_add_(params, torch._foreach_mul(upd, -lr))
