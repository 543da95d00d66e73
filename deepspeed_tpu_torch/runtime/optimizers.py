"""The engine's optimizer dispatch (JAX ``engine.py:440-493``) and the two
optimizers the JAX package takes from optax, with ``optax.sgd``'s and
``optax.lion``'s exact updates as ``torch._foreach_*`` tensor code.

optax reads a learning-rate schedule at the step count before the update
(0 at the first step), where the package's own optimizers (Adam, LAMB,
Adagrad) read it at the incremented count; both are kept.
"""

from typing import Iterable, Optional

import torch

from deepspeed_tpu_torch.ops.adagrad.adagrad import Adagrad
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.ops.optimizer_base import NamedStateOptimizer, ScalarOrSchedule

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
ADAGRAD_OPTIMIZER = "adagrad"
SGD_OPTIMIZER = "sgd"
LION_OPTIMIZER = "lion"
ONEBIT_OPTIMIZERS = ("onebitadam", "zerooneadam", "onebitlamb")

#: each optimizer type's parameters, as JAX's constructors name them
#: (``lr`` comes out first; Adam's ``torch_adam`` and ``fused`` flags are
#: taken and mean nothing, as in JAX)
OPTIMIZER_PARAMS = {
    ADAM_OPTIMIZER: ("lr", "betas", "eps", "weight_decay", "adam_w_mode", "bias_correction",
                     "torch_adam", "fused"),
    LAMB_OPTIMIZER: ("lr", "bias_correction", "betas", "eps", "weight_decay", "max_coeff",
                     "min_coeff"),
    ADAGRAD_OPTIMIZER: ("lr", "eps", "weight_decay"),
    SGD_OPTIMIZER: ("lr", "momentum"),
    LION_OPTIMIZER: ("lr", "b1", "b2", "weight_decay"),
}
OPTIMIZER_PARAMS[ADAMW_OPTIMIZER] = OPTIMIZER_PARAMS[ADAM_OPTIMIZER]

#: parameters a JAX optimizer takes that the port refuses, with the reason
REFUSED_PARAMS = {
    SGD_OPTIMIZER: "JAX builds optax.sgd(learning_rate, momentum) and drops every other key",
    LION_OPTIMIZER: "optax.lion's mu_dtype and mask are JAX dtypes and pytrees",
}


class SGD(NamedStateOptimizer):
    """``optax.sgd(lr, momentum)``: with momentum ``m = g + momentum * m``
    and ``p = p + (-lr_t) * m``; without it ``p = p + (-lr_t) * g``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: ScalarOrSchedule = 1e-3,
                 momentum: Optional[float] = None):
        super().__init__(params, dict(lr=lr, momentum=momentum),
                         slots=("trace",) if momentum else ())

    def _update(self, group, params, grads):
        lr = self.lr_at(group, self.count - 1)
        if group["momentum"]:
            trace = self._slot(params, "trace")
            torch._foreach_mul_(trace, group["momentum"])
            torch._foreach_add_(trace, grads)
            grads = trace
        torch._foreach_add_(params, torch._foreach_mul(grads, -lr))


class Lion(NamedStateOptimizer):
    """``optax.lion``: ``u = sign((1 - b1) g + b1 mu)``, ``mu = (1 - b2) g +
    b2 mu``, ``u = u + wd p`` and ``p = p + (-lr_t) u`` (optax's default
    ``weight_decay`` is 1e-3)."""

    SLOTS = ("mu",)

    def __init__(self, params: Iterable[torch.Tensor], lr: ScalarOrSchedule = 1e-3,
                 b1: float = 0.9, b2: float = 0.99, weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, weight_decay=weight_decay))

    def _update(self, group, params, grads):
        mus = self._slot(params, "mu")
        b1, b2, wd = group["b1"], group["b2"], group["weight_decay"]
        upd = torch._foreach_sign(torch._foreach_add(torch._foreach_mul(grads, 1.0 - b1),
                                                     torch._foreach_mul(mus, b1)))
        new_mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - b2), torch._foreach_mul(mus, b2))
        for m, n in zip(mus, new_mu):
            m.copy_(n)
        if wd:
            torch._foreach_add_(upd, torch._foreach_mul(params, wd))
        torch._foreach_add_(params, torch._foreach_mul(upd, -self.lr_at(group, self.count - 1)))


def check_optimizer_params(name: str, params: dict) -> None:
    """Refuse, one key at a time, a parameter the optimizer ``name`` does
    not take (JAX's names, ``OPTIMIZER_PARAMS``)."""
    known = OPTIMIZER_PARAMS[name]
    for key in sorted(set(params) - set(known)):
        reason = REFUSED_PARAMS.get(name, f"JAX's {name} takes {list(known)}")
        raise NotImplementedError(f"optimizer.params.{key} of type {name!r}: {reason}")


def build_optimizer(name: str, parameters, params: dict, lr_schedule=None,
                    state_device=None) -> torch.optim.Optimizer:
    """The optimizer of type ``name`` over ``parameters`` from the config's
    ``params`` (``lr`` default 1e-3; ``lr_schedule`` replaces it), as JAX's
    ``_configure_optimizer`` builds it."""
    params = dict(params)
    check_optimizer_params(name, params)
    lr = params.pop("lr", 1e-3)
    if lr_schedule is not None:
        lr = lr_schedule
    if name in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER):
        adam_w_mode = params.pop("adam_w_mode", name == ADAMW_OPTIMIZER)
        params.pop("torch_adam", None)
        params.pop("fused", None)
        if "betas" in params:
            params["betas"] = tuple(params["betas"])
        return FusedAdam(parameters, lr=lr, adam_w_mode=adam_w_mode, state_device=state_device,
                         **params)
    if state_device is not None:
        raise NotImplementedError(f"optimizer {name!r} under offload_param: only Adam updates "
                                  f"host-resting parameters (FusedAdam.step_resting)")
    if name == LAMB_OPTIMIZER:
        if "betas" in params:
            params["betas"] = tuple(params["betas"])
        return FusedLamb(parameters, lr=lr, **params)
    if name == ADAGRAD_OPTIMIZER:
        return Adagrad(parameters, lr=lr, **params)
    if name == SGD_OPTIMIZER:
        return SGD(parameters, lr=lr, momentum=params.get("momentum", 0.0) or None)
    if name == LION_OPTIMIZER:
        return Lion(parameters, lr=lr, **params)
    raise ValueError(f"unknown optimizer {name!r}")
