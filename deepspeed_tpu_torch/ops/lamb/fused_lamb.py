"""LAMB (counterpart of ``deepspeed_tpu/ops/lamb/fused_lamb.py``): Adam's
moments, then a per-tensor trust ratio ``||p|| / ||update||`` clamped to
``[min_coeff, max_coeff]`` (1 where either norm is 0), formula by formula:

    count += 1;  lr_t = lr(count) if lr is a schedule
    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    bc1 = 1 - b1^count;  bc2 = 1 - b2^count         (fp32; 1 without correction)
    u = (m / bc1) / (sqrt(v / bc2) + eps) + wd p    (wd > 0)
    p = p + (-lr_t * trust(p, u)) * u

The JAX package has no Pallas kernel for it (XLA fuses the chain), so the
port keeps it as tensor code: ``torch._foreach_*`` over the parameters, the
norms with ``torch._foreach_norm``.
"""

from typing import Iterable, Tuple

import torch

from deepspeed_tpu_torch.ops.optimizer_base import NamedStateOptimizer, ScalarOrSchedule, fp32


class FusedLamb(NamedStateOptimizer):

    SLOTS = ("exp_avg", "exp_avg_sq")

    def __init__(self, params: Iterable[torch.Tensor], lr: ScalarOrSchedule = 1e-3,
                 bias_correction: bool = True, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, max_coeff: float = 10.0,
                 min_coeff: float = 0.01):
        super().__init__(params, dict(lr=lr, bias_correction=bias_correction, betas=tuple(betas),
                                      eps=eps, weight_decay=weight_decay, max_coeff=max_coeff,
                                      min_coeff=min_coeff))

    def _update(self, group, params, grads):
        ms, vs = self._slot(params, "exp_avg"), self._slot(params, "exp_avg_sq")
        b1, b2 = group["betas"]
        wd, eps = group["weight_decay"], group["eps"]
        lr = self.lr_at(group, self.count)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        if group["bias_correction"]:
            count = fp32(self.count)
            bc1, bc2 = float(1 - fp32(b1) ** count), float(1 - fp32(b2) ** count)
        else:
            bc1 = bc2 = 1.0
        denom = torch._foreach_sqrt(torch._foreach_div(vs, bc2))
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(torch._foreach_div(ms, bc1), denom)
        if wd > 0.0:
            torch._foreach_add_(upd, torch._foreach_mul(params, wd))
        w_norms = torch._foreach_norm(params)
        u_norms = torch._foreach_norm(upd)
        for p, u, wn, un in zip(params, upd, w_norms, u_norms):
            trust = torch.where((wn > 0) & (un > 0),
                                (wn / un).clamp(group["min_coeff"], group["max_coeff"]),
                                torch.ones_like(wn))
            p.add_((-lr * trust) * u)
