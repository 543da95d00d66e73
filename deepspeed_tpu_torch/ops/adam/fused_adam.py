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

from typing import Callable, Dict, Iterable, Tuple, Union

import torch

ScalarOrSchedule = Union[float, Callable[[int], float]]


def _fp32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


class FusedAdam(torch.optim.Optimizer):
    """Adam with decoupled (``adam_w_mode=True``) or L2 weight decay over
    fp32 parameters. ``lr`` is a float or a ``count -> lr`` schedule read
    at the incremented count. The state is one ``count`` shared by every
    parameter (the JAX ``AdamState.count``) and per parameter fp32
    ``exp_avg`` and ``exp_avg_sq``, allocated here (as ``optimizer.init``
    does) so that a state can be loaded before the first step."""

    def __init__(self, params: Iterable[torch.Tensor], lr: ScalarOrSchedule = 1e-3,
                 bias_correction: bool = True, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, adam_w_mode: bool = True, weight_decay: float = 0.0,
                 amsgrad: bool = False):
        if amsgrad:
            raise NotImplementedError("FusedAdam does not support the AMSGrad variant "
                                      "(parity with the reference)")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=tuple(betas), eps=eps,
                        adam_w_mode=adam_w_mode, weight_decay=weight_decay)
        super().__init__(params, defaults)
        self.count = 0
        for group in self.param_groups:
            for p in group["params"]:
                if p.dtype != torch.float32:
                    raise ValueError(f"FusedAdam updates fp32 master parameters, got {p.dtype}")
                self.state[p] = {"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("FusedAdam.step takes no closure")
        self.count += 1
        count = _fp32(self.count)
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            ms = [self.state[p]["exp_avg"] for p in params]
            vs = [self.state[p]["exp_avg_sq"] for p in params]
            b1, b2 = group["betas"]
            wd, eps = group["weight_decay"], group["eps"]
            lr = float(group["lr"](self.count)) if callable(group["lr"]) else float(group["lr"])
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

    def named_state(self, named_params: Dict[str, torch.Tensor]) -> dict:
        """The state keyed by the parameter names of ``named_params``, the
        inverse of :meth:`load_named_state`: ``{"count": int, "exp_avg":
        {name: tensor}, "exp_avg_sq": {name: tensor}}``, holding the live
        moment tensors (not copies)."""
        out = {"count": self.count}
        for key in ("exp_avg", "exp_avg_sq"):
            out[key] = {name: self.state[p][key] for name, p in named_params.items()}
        return out

    def load_named_state(self, named_params: Dict[str, torch.Tensor], state: dict) -> None:
        """Load ``{"count": int, "exp_avg": {name: tensor}, "exp_avg_sq":
        {name: tensor}}`` (``checkpoint/from_jax.opt_state_from_jax``) for
        the parameters ``named_params`` names. Raises ``KeyError`` on a
        missing or extra name."""
        for key in ("exp_avg", "exp_avg_sq"):
            if set(state[key]) != set(named_params):
                missing = sorted(set(named_params) - set(state[key]))
                extra = sorted(set(state[key]) - set(named_params))
                raise KeyError(f"optimizer state {key}: missing {missing[:8]}, extra {extra[:8]}")
        with torch.no_grad():
            for name, p in named_params.items():
                for key in ("exp_avg", "exp_avg_sq"):
                    self.state[p][key].copy_(state[key][name])
        self.count = int(state["count"])
