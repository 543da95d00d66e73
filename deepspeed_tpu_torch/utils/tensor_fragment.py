"""Full-precision access to a training engine's parameters, optimizer state
and gradients by parameter name (counterpart of
``deepspeed_tpu/utils/tensor_fragment.py``, after upstream
``safe_get_full_fp32_param`` and its kin).

On one card each fp32 master parameter is whole, so a name addresses its
tensor directly: ``"h_0.attn.c_attn.kernel"``, the state-dict key (the JAX
path with dots and without flax's ``LayerNorm_0`` scope). The getters
return copies; the setter writes into the live parameter in place, so the
optimizer and the gradient buffer keep their references to it.
"""

import logging
from typing import List, Optional

import torch

logger = logging.getLogger(__name__)

#: optax's names for the Adam moments, accepted as in the JAX version
_MOMENT_ALIASES = {"mu": "exp_avg", "nu": "exp_avg_sq"}


def list_param_names(engine) -> List[str]:
    """Every parameter name, sorted."""
    return sorted(name for name, _ in engine.module.named_parameters())


def _param(engine, name: str) -> torch.nn.Parameter:
    params = dict(engine.module.named_parameters())
    if name not in params:
        close = [k for k in params if name in k or k in name][:5]
        raise KeyError(f"no parameter named {name!r}; close matches: {close}")
    return params[name]


def safe_get_full_fp32_param(engine, name: str) -> torch.Tensor:
    """A copy of the fp32 master value of parameter ``name``."""
    return _param(engine, name).detach().clone()


def safe_set_full_fp32_param(engine, name: str, value) -> None:
    """Overwrite parameter ``name`` in place with ``value`` (a tensor or
    array of its shape)."""
    p = _param(engine, name)
    value = torch.as_tensor(value)
    if tuple(value.shape) != tuple(p.shape):
        raise ValueError(f"shape mismatch for {name}: {tuple(value.shape)} vs {tuple(p.shape)}")
    with torch.no_grad():
        p.copy_(value)


def safe_get_full_optimizer_state(engine, name: str, optim_state_key: str) -> torch.Tensor:
    """A copy of parameter ``name``'s optimizer state ``optim_state_key``
    (``"exp_avg"``/``"exp_avg_sq"``, or optax's ``"mu"``/``"nu"``)."""
    key = _MOMENT_ALIASES.get(optim_state_key, optim_state_key)
    state = engine.optimizer.state[_param(engine, name)]
    if key not in state:
        raise KeyError(f"optimizer state has no field {optim_state_key!r}; it has {sorted(state)}")
    return state[key].detach().clone()


def safe_get_full_grad(engine, name: str) -> Optional[torch.Tensor]:
    """A copy of parameter ``name``'s gradient from the last optimizer step:
    averaged over the gradient-accumulation window, before clipping. Needs
    ``engine.retain_grads(True)`` before the step; without it, returns None
    with a warning, as the JAX version does."""
    grad = engine.retained_grad(name)
    if grad is None:
        logger.warning("gradients are not retained: call engine.retain_grads(True) before the "
                       "step to use safe_get_full_grad")
        return None
    return grad.clone()
