"""Adagrad on the device (counterpart of the device ``adagrad`` of
``deepspeed_tpu/ops/adagrad/cpu_adagrad.py:16-31``; the host
``DeepSpeedCPUAdagrad`` of ZeRO-Offload is ``ops/adam/cpu_adam.py``):

    g = g + wd p                                    (wd > 0)
    a = a + g^2
    p = p + (-lr_t g) / (sqrt(a) + eps)             (lr_t = lr(count + 1))

as ``torch._foreach_*`` tensor code (the JAX package leaves it to XLA).
"""

from typing import Iterable

import torch

from deepspeed_tpu_torch.ops.optimizer_base import NamedStateOptimizer, ScalarOrSchedule


class Adagrad(NamedStateOptimizer):

    SLOTS = ("accum",)

    def __init__(self, params: Iterable[torch.Tensor], lr: ScalarOrSchedule = 1e-2,
                 eps: float = 1e-10, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, eps=eps, weight_decay=weight_decay))

    def _update(self, group, params, grads):
        acc = self._slot(params, "accum")
        wd = group["weight_decay"]
        if wd > 0.0:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, wd))
        torch._foreach_add_(acc, torch._foreach_mul(grads, grads))
        lr = self.lr_at(group, self.count)
        denom = torch._foreach_sqrt(acc)
        torch._foreach_add_(denom, group["eps"])
        torch._foreach_add_(params, torch._foreach_div(torch._foreach_mul(grads, -lr), denom))
