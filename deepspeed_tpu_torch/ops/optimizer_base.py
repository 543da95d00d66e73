"""The shared shape of the port's device optimizers (``FusedAdam``,
``FusedLamb``, ``Adagrad``, ``SGD``, ``Lion``): fp32 parameters, one step
count shared by every parameter (the count of JAX's optimizer states), and
per-parameter fp32 state slots allocated at construction, as the JAX
optimizer's ``init`` allocates them, so that a checkpoint loads before the
first step. The engine reads and writes the state by parameter name."""

from typing import Callable, Dict, Iterable, Union

import torch

ScalarOrSchedule = Union[float, Callable[[int], float]]


def fp32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


class NamedStateOptimizer(torch.optim.Optimizer):
    """``SLOTS``: the names of the per-parameter state tensors."""

    SLOTS = ()

    def __init__(self, params: Iterable[torch.Tensor], defaults: dict, slots=None,
                 state_device=None):
        super().__init__(params, defaults)
        self.count = 0
        self.slots = tuple(self.SLOTS if slots is None else slots)
        for group in self.param_groups:
            for p in group["params"]:
                if p.dtype != torch.float32:
                    raise ValueError(f"{type(self).__name__} updates fp32 master parameters, "
                                     f"got {p.dtype}")
                dev = p.device if state_device is None else state_device
                self.state[p] = {k: torch.zeros(p.shape, dtype=p.dtype, device=dev)
                                 for k in self.slots}

    def lr_at(self, group: dict, count: int) -> float:
        lr = group["lr"]
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError(f"{type(self).__name__}.step takes no closure")
        self.count += 1
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                self._update(group, params, [p.grad for p in params])

    def _update(self, group: dict, params, grads) -> None:
        raise NotImplementedError

    def _slot(self, params, key):
        return [self.state[p][key] for p in params]

    def named_state(self, named_params: Dict[str, torch.Tensor]) -> dict:
        """``{"count": int, <slot>: {name: tensor}}`` (the live tensors)."""
        out = {"count": self.count}
        for key in self.slots:
            out[key] = {name: self.state[p][key] for name, p in named_params.items()}
        return out

    def load_named_state(self, named_params: Dict[str, torch.Tensor], state: dict) -> None:
        """Load what :meth:`named_state` gives; ``KeyError`` on a missing or
        extra name."""
        for key in self.slots:
            if set(state[key]) != set(named_params):
                missing = sorted(set(named_params) - set(state[key]))
                extra = sorted(set(state[key]) - set(named_params))
                raise KeyError(f"optimizer state {key}: missing {missing[:8]}, extra {extra[:8]}")
        with torch.no_grad():
            for name, p in named_params.items():
                for key in self.slots:
                    self.state[p][key].copy_(state[key][name])
        self.count = int(state["count"])
